"""Cache-schedule data model (the port's own copy of
``ecad_tpu/schedules/cache_schedule.py``; same JSON contract, same
``to_numpy()`` genome view).

A cache schedule answers, for every inference step *t*, block *b* and cacheable
component *c*: recompute (True) or reuse the cached output from the previous
step (False). On disk we keep the reference's JSON contract exactly
(ecad/schedulers/cache_scheduler/cache_schedule.py:75-112):

    {"cache_schedule": {"num_blocks": .., "num_inference_steps": .., "name": ..,
                        "attributes": {..},
                        "schedule": {"000": {"<block>": {"<comp>": bool, ..}}}},
     "config": {..}, "metrics": {..}}

In memory the source of truth is an immutable ``numpy`` bool array ``mask``
of shape ``(steps, num_slots)`` where a *slot* is a (block, component) pair in
the class's canonical flatten order. There is no mutable step cursor (the
reference's ``_last_step`` / ``per_step_callback`` machinery,
cache_schedule.py:58-73) — the denoising loop consumes mask rows directly as
Python bools.

Per-block custom compute-fn hooks (``custom_compute_attn``/``custom_compute_ff``,
used by the TGATE schedules; ecad/types.py:50-64) are preserved as a sparse
``{(step, block): {slot_kind: {"name":…, "kwargs":…}}}`` mapping.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import numpy.typing as npt

CustomFuncDict = dict[str, Any]  # {"name": str, "kwargs": {...}}


class CacheSchedule:
    """Base class; subclasses define the block/component vocabulary.

    Subclasses must define:
      * ``slot_names(num_blocks, **dims) -> list[(block_key, component)]`` —
        the canonical flatten order (one slot per genome gene).
      * ``components`` — component names per regular block.
    """

    # component names per (full) block, e.g. ("attn1","attn2","ff") for PixArt
    components: tuple[str, ...] = ()

    def __init__(
        self,
        num_blocks: int,
        num_inference_steps: int,
        name: str = "",
        mask: npt.NDArray[np.bool_] | None = None,
        attributes: dict[str, Any] | None = None,
        metrics: dict[str, Any] | None = None,
        top_level_config: dict[str, Any] | None = None,
        custom_funcs: dict[tuple[int, str], dict[str, CustomFuncDict]] | None = None,
        **extra_dims: int,
    ) -> None:
        self.num_blocks = int(num_blocks)
        self.num_inference_steps = int(num_inference_steps)
        self.name = name
        self.attributes = dict(attributes or {})
        self.metrics = dict(metrics or {})
        self.top_level_config = dict(top_level_config or {})
        self.custom_funcs = dict(custom_funcs or {})
        self._extra_dims = extra_dims
        self._slots = self.slot_names()
        self._slot_index = {s: i for i, s in enumerate(self._slots)}
        if mask is None:
            mask = np.ones(
                (self.num_inference_steps, len(self._slots)), dtype=np.bool_
            )
        mask = np.asarray(mask, dtype=np.bool_)
        if mask.shape != (self.num_inference_steps, len(self._slots)):
            raise ValueError(
                f"mask shape {mask.shape} != "
                f"({self.num_inference_steps}, {len(self._slots)})"
            )
        mask.setflags(write=False)
        self.mask = mask

    # ---- vocabulary -----------------------------------------------------

    def slot_names(self) -> list[tuple[str, str]]:
        """Canonical (block_key, component) order. Default: per step, block
        0..N-1 × components — matches the PixArt genome layout
        (ecad/schedulers/cache_scheduler/pixart_cache_schedule.py:15-27)."""
        return [
            (str(b), c)
            for b in range(self.num_blocks)
            for c in self.components
        ]

    def block_keys(self) -> list[str]:
        seen: dict[str, None] = {}
        for b, _ in self._slots:
            seen.setdefault(b)
        return list(seen)

    @property
    def num_slots(self) -> int:
        return len(self._slots)

    # ---- queries ---------------------------------------------------------

    def get_recompute(self, step: int, block_key: str, component: str) -> bool:
        """Stateless equivalent of the reference's cursor-based
        get_recompute (cache_schedule.py:68-73)."""
        return bool(self.mask[step, self._slot_index[(block_key, component)]])

    def step_mask(self, step: int) -> npt.NDArray[np.bool_]:
        return self.mask[step]

    def step_key(self, step: int) -> bytes:
        """Hashable compilation key for one step's recompute pattern."""
        return np.packbits(self.mask[step]).tobytes()

    def get_custom_compute(
        self, step: int, block_key: str, kind: str
    ) -> CustomFuncDict:
        """kind is 'attn' or 'ff' (pixart_cache_schedule.py:29-37)."""
        return self.custom_funcs.get((step, block_key), {}).get(
            f"custom_compute_{kind}", {}
        )

    def to_numpy(self, flatten: bool = False) -> npt.NDArray[np.bool_]:
        """Genome view. PixArt: (steps, blocks, 3); Flux overrides to the
        concatenated layout. ``flatten=True`` gives the NSGA-II gene vector."""
        arr = self.mask.reshape(
            self.num_inference_steps, self.num_blocks, len(self.components)
        ).copy()
        return arr.flatten() if flatten else arr

    @classmethod
    def from_numpy(
        cls,
        arr: npt.NDArray,
        num_inference_steps: int,
        num_blocks: int,
        name: str = "",
        **kwargs: Any,
    ) -> "CacheSchedule":
        """Inverse of ``to_numpy(flatten=True)`` — genome → schedule
        (reference: binary_vector_to_schedule_dict,
        ecad/genetic/pixart_population_io_manager.py:213-240)."""
        sched = cls(
            num_blocks=num_blocks,
            num_inference_steps=num_inference_steps,
            name=name,
            **kwargs,
        )
        mask = np.asarray(arr, dtype=np.bool_).reshape(
            num_inference_steps, sched.num_slots
        )
        return cls(
            num_blocks=num_blocks,
            num_inference_steps=num_inference_steps,
            name=name,
            mask=mask,
            **kwargs,
        )

    # ---- diff / attributes ------------------------------------------------

    def hamming_to(self, other: "CacheSchedule") -> int:
        return int(np.sum(self.mask != other.mask))

    def compute_diff_attributes(self, default: "CacheSchedule") -> dict[str, int]:
        """Diff-vs-default attributes stamped into candidate JSONs
        (ecad/genetic/pixart_population_io_manager.py:186-211)."""
        diff = self.mask != default.mask
        steps_mask = diff.any(axis=1)
        slot_diff = diff.any(axis=0)
        blocks_affected = {
            self._slots[i][0] for i in np.nonzero(slot_diff)[0]
        }
        return {
            "num_affected_steps": int(steps_mask.sum()),
            "num_affected_blocks": len(
                {b for b in blocks_affected if not b.startswith("single_")}
            ),
            "total_num_affected_blocks": int(diff.sum()),
        }

    # ---- JSON ------------------------------------------------------------

    def _schedule_dict(self) -> dict[str, dict[str, dict[str, Any]]]:
        out: dict[str, dict[str, dict[str, Any]]] = {}
        for step in range(self.num_inference_steps):
            block_sched: dict[str, dict[str, Any]] = {}
            for i, (block, comp) in enumerate(self._slots):
                block_sched.setdefault(block, {})[comp] = bool(
                    self.mask[step, i]
                )
            for (s, block), funcs in self.custom_funcs.items():
                if s == step:
                    block_sched.setdefault(block, {}).update(funcs)
            out[f"{step:03}"] = block_sched
        return out

    def _header(self) -> dict[str, Any]:
        return {
            "num_blocks": self.num_blocks,
            "num_inference_steps": self.num_inference_steps,
            "name": self.name,
            "attributes": self.attributes,
        }

    def to_dict(self) -> dict[str, Any]:
        return {
            "cache_schedule": {
                **self._header(),
                "schedule": self._schedule_dict(),
            },
            "config": self.top_level_config,
            "metrics": self.metrics,
        }

    def to_json(self, file_path: Path | str) -> None:
        Path(file_path).parent.mkdir(parents=True, exist_ok=True)
        with Path(file_path).open("w") as f:
            json.dump(self.to_dict(), f, indent=4)

    @classmethod
    def _extra_init_kwargs(cls, header: Mapping[str, Any]) -> dict[str, Any]:
        """Subclass hook for extra header fields (e.g. Flux num_single_blocks)."""
        return {}

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "CacheSchedule":
        header = data["cache_schedule"]
        schedule = header["schedule"]
        num_blocks = int(header["num_blocks"])
        steps = int(header["num_inference_steps"])
        extra = cls._extra_init_kwargs(header)
        probe = cls(num_blocks=num_blocks, num_inference_steps=steps, **extra)
        mask = np.zeros((steps, probe.num_slots), dtype=np.bool_)
        custom_funcs: dict[tuple[int, str], dict[str, CustomFuncDict]] = {}
        for step_key, block_sched in schedule.items():
            s = int(step_key)
            if s >= steps:
                # Some reference artifacts carry more schedule entries than
                # num_inference_steps (e.g. flux default_…_steps_08.json has 50
                # entries); only the first num_inference_steps are ever
                # consulted, so extra rows are dropped on load.
                continue
            for block, comp_sched in block_sched.items():
                for comp, val in comp_sched.items():
                    if comp.startswith("custom_compute_"):
                        custom_funcs.setdefault((s, block), {})[comp] = val
                    else:
                        mask[s, probe._slot_index[(block, comp)]] = bool(val)
        return cls(
            num_blocks=num_blocks,
            num_inference_steps=steps,
            name=header.get("name", ""),
            mask=mask,
            attributes=header.get("attributes") or {},
            metrics=data.get("metrics") or {},
            top_level_config=data.get("config") or {},
            custom_funcs=custom_funcs,
            **extra,
        )

    @classmethod
    def from_json(cls, file_path: Path | str) -> "CacheSchedule":
        with Path(file_path).open("r") as f:
            return cls.from_dict(json.load(f))

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, CacheSchedule)
            and type(self) is type(other)
            and self.num_blocks == other.num_blocks
            and self.num_inference_steps == other.num_inference_steps
            and bool(np.array_equal(self.mask, other.mask))
        )

    def __repr__(self) -> str:
        frac = float(self.mask.mean()) if self.mask.size else 0.0
        return (
            f"{type(self).__name__}(name={self.name!r}, steps="
            f"{self.num_inference_steps}, blocks={self.num_blocks}, "
            f"recompute_frac={frac:.3f})"
        )
