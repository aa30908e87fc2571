"""The port's search CLI (`python -m ecad_tpu_torch.genetic.train`) on the
CPU: a tiny PixArt mini-run of two cycles and its resume (mirroring the JAX
package's test in tests/test_genetic.py), one tiny FLUX cycle, the flags
that wait for a later ROADMAP.md queue 1 item, and the no-silent-CPU rule."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ecad_tpu_torch.genetic import train
from ecad_tpu_torch.macs import compute_schedule_metrics
from ecad_tpu_torch.schedules import FluxCacheSchedule, PixArtCacheSchedule

REPO = Path(__file__).resolve().parent.parent


def _run(args, tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "ecad_tpu_torch.genetic.train", *args,
         "--populations-dir", str(tmp_path / "pops"),
         "--benchmarks-dir", str(tmp_path / "bench")],
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def _check_generations(tmp_path, name, evaluated, last, cls, pop):
    """Every evaluated generation has a scores.json per candidate and MACs
    in every candidate JSON equal to the port's analytic ones; the last
    generation's candidates and checkpoint exist."""
    root = tmp_path / "pops" / name
    for g in evaluated:
        cands = sorted((root / f"gen_{g:03d}" / "candidates").glob("cand_*.json"))
        assert len(cands) == pop
        for p in cands:
            sched = cls.from_json(p)
            got = json.loads(p.read_text())["metrics"]["total_macs_T"]
            assert got == compute_schedule_metrics(sched)["total_macs_T"]
            score = tmp_path / "bench" / name / f"gen_{g:03d}/candidates" / p.stem / "scores.json"
            total = json.loads(score.read_text())["total_score"]
            assert np.isfinite(total)
    assert len(list((root / f"gen_{last:03d}" / "candidates").glob("cand_*.json"))) == pop
    assert (root / f"gen_{last:03d}" / "checkpoint.npz").exists()
    cfg = json.loads((root / f"gen_{last:03d}" / "manager_config.json").read_text())
    assert cfg["generation_num"] == last and cfg["population_size"] == pop


def test_train_cli_mini_run_and_resume(tmp_path):
    """Two cycles of the loop on the tiny PixArt with the fidelity scorer,
    then a resume for a third from the saved checkpoint."""
    base = ["--name", "smoke", "--population-size", "6", "--num-inference-steps", "4",
            "--num-prompts", "2", "--random-seed-gen-0", "--tiny-model",
            "--device", "cpu", "--scorer", "fidelity"]
    out = _run(base + ["--num-cycles", "2"], tmp_path)
    assert "Generation 3 saved" in out
    _check_generations(tmp_path, "smoke", (1, 2), 3, PixArtCacheSchedule, 6)
    out = _run(base + ["--num-cycles", "1"], tmp_path)
    assert "Resumed algorithm from" in out and "Generation 4 saved" in out
    _check_generations(tmp_path, "smoke", (1, 2, 3), 4, PixArtCacheSchedule, 6)


def test_train_cli_flux_cycle(tmp_path):
    """One cycle on the tiny FLUX (2 dual + 3 single blocks) with the mock
    scorer."""
    out = _run(["--name", "fx", "--model-family", "flux", "--population-size", "4",
                "--num-inference-steps", "3", "--num-prompts", "1", "--random-seed-gen-0",
                "--tiny-model", "--device", "cpu", "--num-cycles", "1"], tmp_path)
    assert "Generation 2 saved" in out
    _check_generations(tmp_path, "fx", (1,), 2, FluxCacheSchedule, 4)


WAITING = [
    (["--weights-root", "w"], 5),
    (["--transformer-weights", "PixArt-alpha/PixArt-XL-2-256x256"], 5),
    (["--prompt-file", "prompts.txt"], 5),
    (["--scorer", "image_reward"], 6),
    (["--scorer", "clip"], 6),
    (["--image-reward-dir", "ir"], 6),
    (["--quant", "int8"], 4),
    (["--dp", "2"], 8),
    (["--tp", "2"], 8),
    (["--sp", "2"], 8),
]


@pytest.mark.parametrize("flags,item", WAITING, ids=[" ".join(f) for f, _ in WAITING])
def test_waiting_flags_raise_with_their_item(tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=f"queue 1 item {item}\\b"):
        train.main(["--name", "w", "--tiny-model", "--device", "cpu",
                    "--populations-dir", str(tmp_path / "p"), *flags])
    assert not (tmp_path / "p").exists()


def test_pixart_rejects_cache_dtype(tmp_path):
    with pytest.raises(ValueError, match="FLUX option"):
        train.main(["--name", "c", "--tiny-model", "--device", "cpu",
                    "--cache-dtype", "float8_e4m3fn", "--random-seed-gen-0",
                    "--populations-dir", str(tmp_path / "p"),
                    "--benchmarks-dir", str(tmp_path / "b")])


def test_default_device_is_cuda_and_refuses_cpu(tmp_path, monkeypatch):
    """Without a GPU and without --device cpu, the search raises before it
    writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--name", "n", "--tiny-model", "--random-seed-gen-0",
                    "--populations-dir", str(tmp_path / "p")])
    assert not (tmp_path / "p").exists()
