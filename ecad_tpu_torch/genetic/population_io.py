"""Population IO: the on-disk contract between the evolutionary loop and
candidate evaluation (the port's own copy of
``ecad_tpu/genetic/population_io.py``; both packages write the same bytes).

Directory layout is byte-compatible with the reference
(ecad/genetic/population_io_manager.py:147-182,355-358) so populations are
resumable/interchangeable across implementations:

    <populations>/<name>/gen_NNN/candidates/cand_III.json   (full schedules)
    <populations>/<name>/gen_NNN/manager_config.json
    <populations>/<name>/gen_NNN/checkpoint.npz             (ours; reference
                                                             uses dill .pkl)
    <benchmarks>/<name>/gen_NNN/candidates/cand_III/scores*.json

Objectives (population_io_manager.py:227-260): F[:,0] = 1 − ImageReward
(negate-to-minimize), F[:,1] = total_macs_T read from each candidate JSON's
metrics (negated when maximize_macs). Constraint G = min_diff −
hamming(X, default).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Optional, Type

import numpy as np
import numpy.typing as npt

from ..macs import attach_metrics
from ..schedules import (
    FLUX_NUM_BLOCKS,
    FLUX_NUM_SINGLE_BLOCKS,
    CacheSchedule,
    FluxCacheSchedule,
    PixArtCacheSchedule,
)

DEFAULT_POPULATIONS_DIR = Path("results/genetic/populations")
DEFAULT_BENCHMARKS_DIR = Path("results/benchmark/genetic/populations")

CONFIG_FILENAME = "manager_config.json"
CHECKPOINT_FILENAME = "checkpoint.npz"
SCORE_KEY = "total_score"
METRIC_KEY = "total_macs_T"

_CAND_RE = re.compile(r"^cand_(?P<index>\d+)(\.json)?$")


class PopulationIOManager:
    """Owns the generation directory layout, candidate (de)serialization and
    objective assembly. Schedule-class specifics are parameterized rather
    than subclass-forked (reference has PixArt/Flux subclasses)."""

    schedule_cls: Type[CacheSchedule] = PixArtCacheSchedule

    def __init__(
        self,
        name: str,
        all_populations_dir: Path | str = DEFAULT_POPULATIONS_DIR,
        all_benchmarks_dir: Path | str = DEFAULT_BENCHMARKS_DIR,
        generation_num: Optional[int] = None,
        num_inference_steps: int = 20,
        min_diff_from_default: int = 1,
        population_size: int = 72,
        default_schedule: Optional[CacheSchedule] = None,
        maximize_macs: bool = False,
        candidate_config: Optional[dict[str, Any]] = None,
        **schedule_kwargs: Any,
    ) -> None:
        self.name = name
        self.population_dir = Path(all_populations_dir) / name
        self.population_dir.mkdir(parents=True, exist_ok=True)
        self.benchmark_dir = Path(all_benchmarks_dir) / name
        self.benchmark_dir.mkdir(parents=True, exist_ok=True)

        if generation_num is None:
            existing = [
                int(p.name.split("_")[1])
                for p in self.population_dir.iterdir()
                if p.is_dir() and p.name.startswith("gen_")
                and p.name.split("_")[1].isdigit()
            ]
            generation_num = max(existing) if existing else 1
        self.generation_num = generation_num

        self.num_inference_steps = num_inference_steps
        self.min_diff_from_default = min_diff_from_default
        self.population_size = population_size
        self.maximize_macs = maximize_macs
        self.candidate_config = candidate_config or {}
        self.schedule_kwargs = schedule_kwargs

        if default_schedule is None:
            default_schedule = self._default_schedule()
        self.default_schedule = default_schedule

    # -- schedule-class plumbing ------------------------------------------

    def _default_schedule(self) -> CacheSchedule:
        return self.schedule_cls.default(
            num_inference_steps=self.num_inference_steps
        )

    @property
    def n_var(self) -> int:
        return int(self.default_schedule.to_numpy(flatten=True).shape[0])

    def vector_to_schedule(
        self, x: npt.NDArray, index: int
    ) -> CacheSchedule:
        extra: dict[str, Any] = {}
        if hasattr(self.default_schedule, "num_single_blocks"):
            extra["num_single_blocks"] = self.default_schedule.num_single_blocks
        sched = self.schedule_cls.from_numpy(
            np.asarray(x, dtype=bool),
            self.num_inference_steps,
            self.default_schedule.num_blocks,
            name=f"{self.name}_gen_{self.generation_num:03d}_cand_{index:03d}",
            top_level_config=dict(self.candidate_config),
            **extra,
        )
        sched.attributes = sched.compute_diff_attributes(self.default_schedule)
        return sched

    # -- directories -------------------------------------------------------

    def generation_dir(self, generation: Optional[int] = None) -> Path:
        g = self.generation_num if generation is None else generation
        d = self.population_dir / f"gen_{g:03d}"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def candidates_dir(self, generation: Optional[int] = None) -> Path:
        d = self.generation_dir(generation) / "candidates"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def candidate_filename(
        self, index: int, generation: Optional[int] = None
    ) -> Path:
        return self.candidates_dir(generation) / f"cand_{index:03d}.json"

    def score_dir(self, generation: Optional[int] = None) -> Path:
        g = self.generation_num if generation is None else generation
        return self.benchmark_dir / f"gen_{g:03d}" / "candidates"

    def checkpoint_path(self) -> Path:
        return self.generation_dir() / CHECKPOINT_FILENAME

    # -- save/load population ---------------------------------------------

    def save_population(
        self, population: npt.NDArray, generation: Optional[int] = None
    ) -> list[Path]:
        paths = []
        for i, x in enumerate(population):
            sched = self.vector_to_schedule(x, i)
            p = self.candidate_filename(i, generation)
            sched.to_json(p)
            paths.append(p)
        return paths

    def load_population_schedules(
        self, generation: Optional[int] = None
    ) -> list[tuple[int, CacheSchedule]]:
        out = []
        for p in sorted(self.candidates_dir(generation).glob("cand_*.json")):
            m = _CAND_RE.match(p.name)
            if not m:
                continue
            out.append((int(m.group("index")), self.schedule_cls.from_json(p)))
        return out

    def load_population_vectors(
        self, generation: Optional[int] = None
    ) -> npt.NDArray[np.bool_]:
        pop = self.load_population_schedules(generation)
        return np.array([s.to_numpy(flatten=True) for _, s in pop])

    # -- objectives --------------------------------------------------------

    def ask(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        X = self.load_population_vectors()
        F = self.load_evaluation_scores()
        G = self.constraint_violations(X)
        return X, F, G

    def constraint_violations(self, X: npt.NDArray) -> npt.NDArray:
        default = self.default_schedule.to_numpy(flatten=True)
        diff = np.sum(X != default, axis=1)
        return (self.min_diff_from_default - diff).reshape(-1, 1)

    def load_evaluation_scores(
        self, generation: Optional[int] = None
    ) -> npt.NDArray[np.float64]:
        scores = self._load_scores(generation)
        metrics = self._load_metrics(generation)
        if scores.keys() != metrics.keys():
            raise ValueError(
                f"candidate indices mismatch: scores {sorted(scores)} vs "
                f"metrics {sorted(metrics)}"
            )
        # rows positionally aligned with load_population_vectors' sorted
        # candidate order (robust to non-contiguous candidate indices)
        F = np.zeros((len(scores), 2))
        for row, i in enumerate(sorted(scores)):
            F[row, 0] = 1.0 - scores[i]  # negate-to-minimize ImageReward
            F[row, 1] = -metrics[i] if self.maximize_macs else metrics[i]
        return F

    def _load_scores(
        self, generation: Optional[int] = None
    ) -> dict[int, float]:
        results: dict[int, float] = {}
        for d in sorted(self.score_dir(generation).glob("cand_*")):
            if not d.is_dir():
                continue
            m = _CAND_RE.match(d.name)
            jsons = sorted(d.glob("scores*.json"))
            if not m or not jsons:
                continue
            with jsons[0].open() as f:
                results[int(m.group("index"))] = json.load(f)[SCORE_KEY]
        return results

    def _load_metrics(
        self, generation: Optional[int] = None
    ) -> dict[int, float]:
        results: dict[int, float] = {}
        for p in sorted(self.candidates_dir(generation).glob("cand_*.json")):
            m = _CAND_RE.match(p.name)
            if not m:
                continue
            with p.open() as f:
                metrics = json.load(f).get("metrics", {})
            if METRIC_KEY in metrics:
                results[int(m.group("index"))] = metrics[METRIC_KEY]
            elif "total_macs" in metrics:
                results[int(m.group("index"))] = metrics["total_macs"] / 1e12
        return results

    def compute_macs_for_generation(
        self, generation: Optional[int] = None
    ) -> None:
        """In-process replacement for the compute_macs.py subprocess step:
        write analytic metrics into every candidate JSON."""
        for idx, sched in self.load_population_schedules(generation):
            attach_metrics(sched)
            sched.to_json(self.candidate_filename(idx, generation))

    def check_offline_eval(self, generation: Optional[int] = None) -> bool:
        """Every candidate needs a scores JSON and MACs metrics
        (population_io_manager.py:360-391)."""
        sd = self.score_dir(generation)
        cand_dirs = [d for d in sd.glob("cand_*") if d.is_dir()]
        for d in cand_dirs:
            if not list(d.glob("scores*.json")):
                return False
        cand_jsons = list(self.candidates_dir(generation).glob("cand_*.json"))
        if len(cand_dirs) != len(cand_jsons):
            return False
        for p in cand_jsons:
            try:
                with p.open() as f:
                    metrics = json.load(f).get("metrics", {})
                if METRIC_KEY not in metrics and "total_macs" not in metrics:
                    return False
            except Exception:
                return False
        return True

    # -- manager config ----------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        d = {
            "name": self.name,
            "population_dir": str(self.population_dir),
            "benchmark_dir": str(self.benchmark_dir),
            "generation_num": self.generation_num,
            "num_inference_steps": self.num_inference_steps,
            "min_diff_from_default": self.min_diff_from_default,
            "population_size": self.population_size,
            "schedule_class": type(self).__name__,
            # resume-critical state (flipping the objective sign or the
            # genome geometry on --load-from would corrupt the search)
            "maximize_macs": self.maximize_macs,
            "candidate_config": self.candidate_config,
            "num_blocks": self.default_schedule.num_blocks,
        }
        if hasattr(self.default_schedule, "num_single_blocks"):
            d["num_single_blocks"] = self.default_schedule.num_single_blocks
        return d

    def save_config(self) -> Path:
        p = self.generation_dir() / CONFIG_FILENAME
        with p.open("w") as f:
            json.dump(self.to_dict(), f, indent=4)
        return p

    @classmethod
    def from_json(cls, file_path: Path | str) -> "PopulationIOManager":
        with Path(file_path).open() as f:
            config = json.load(f)
        kwargs = dict(
            name=config["name"],
            all_populations_dir=Path(config["population_dir"]).parent,
            all_benchmarks_dir=Path(config["benchmark_dir"]).parent,
        )
        for key in (
            "generation_num",
            "num_inference_steps",
            "min_diff_from_default",
            "population_size",
            "maximize_macs",
            "candidate_config",
        ):
            if key in config:
                kwargs[key] = config[key]
        if "num_blocks" in config:
            sched_kwargs = dict(
                num_inference_steps=config.get("num_inference_steps", 20),
                num_blocks=config["num_blocks"],
            )
            if "num_single_blocks" in config:
                sched_kwargs["num_single_blocks"] = config["num_single_blocks"]
            kwargs["default_schedule"] = cls.schedule_cls.default(**sched_kwargs)
        return cls(**kwargs)


class PixArtPopulationIOManager(PopulationIOManager):
    schedule_cls = PixArtCacheSchedule


class FluxPopulationIOManager(PopulationIOManager):
    schedule_cls = FluxCacheSchedule

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        kwargs.setdefault("population_size", 24)  # flux default (reference :37)
        super().__init__(*args, **kwargs)

    def _default_schedule(self) -> CacheSchedule:
        return FluxCacheSchedule.default(
            num_inference_steps=self.num_inference_steps,
            num_blocks=FLUX_NUM_BLOCKS,
            num_single_blocks=FLUX_NUM_SINGLE_BLOCKS,
            top_level_config=dict(self.candidate_config)
            or {"height": 256, "width": 256, "guidance_scale": 5},
        )
