"""The port's search CLI (`python -m ecad_tpu_torch.genetic.train`) on the
CPU: a tiny PixArt mini-run of two cycles and its resume (mirroring the JAX
package's test in tests/test_genetic.py), one tiny FLUX cycle, a cycle
served from a tiny checkpoint tree under each checkpoint flag, the flags
that raise at startup (a weight-backed scorer without its weights, and
those that wait for a later ROADMAP.md queue 1 item), and the
no-silent-CPU rule."""

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


# flags that raise at startup, before anything is written, with what they
# name: a weight-backed scorer without its weights (the reference's
# missing-weights errors; --image-reward-dir with --scorer image_reward),
# and the flags whose module waits for a later ROADMAP.md queue 1 item
WAITING = [
    (["--scorer", "image_reward"], "--scorer image_reward needs weights"),
    (["--scorer", "clip"], "ECAD_CLIP_MODEL_DIR"),
    (["--image-reward-dir", "ir"], "ImageReward.pt not found"),
    (["--dp", "2"], "queue 1 item 8\\b"),
    (["--tp", "2"], "queue 1 item 8\\b"),
    (["--sp", "2"], "queue 1 item 8\\b"),
]


@pytest.mark.parametrize("flags,item", WAITING, ids=[" ".join(f) for f, _ in WAITING])
def test_waiting_flags_raise_with_their_item(tmp_path, monkeypatch, flags, item):
    from ecad_tpu_torch.scoring import clip_score, image_reward

    for var in (image_reward.ENV_CHECKPOINT, image_reward.ENV_TOKENIZER,
                clip_score.ENV_MODEL_DIR):
        monkeypatch.delenv(var, raising=False)
    scorer = ["--scorer", "image_reward"] if flags[0] == "--image-reward-dir" else []
    with pytest.raises((NotImplementedError, SystemExit), match=item):
        train.main(["--name", "w", "--tiny-model", "--device", "cpu",
                    "--populations-dir", str(tmp_path / "p"), *flags, *scorer])
    assert not (tmp_path / "p").exists()


CHECKPOINT_FLAGS = ["--weights-root", "--transformer-weights", "--prompt-file"]


@pytest.mark.parametrize("flag", CHECKPOINT_FLAGS)
def test_checkpoint_flags_run_on_the_tiny_tree(tmp_path, monkeypatch, flag):
    """One cycle of the search served from a tiny checkpoint tree
    (tests/test_torch_checkpoints.py, the generators resized to it): the
    model, VAE and, with --prompt-file, T5 come from the tree, and every
    candidate's images go through the checkpoint's VAE. --transformer-weights
    names a transformer repo that only it can reach; --prompt-file's prompts
    are the evaluator's."""
    from test_torch_checkpoints import PIXART_256, patch_tiny, write_pixart_tree

    from ecad_tpu_torch.models.vae import VAEDecoderPipeline

    patch_tiny(monkeypatch, reference=False)
    root = write_pixart_tree(tmp_path / "w")
    decoded = []
    decode = VAEDecoderPipeline.decode_device
    monkeypatch.setattr(VAEDecoderPipeline, "decode_device",
                        lambda self, z: decoded.append(len(z)) or decode(self, z))
    extra = ["--weights-root", str(root)]
    if flag == "--transformer-weights":
        (root / "local").mkdir()
        (root / PIXART_256).rename(root / "local" / "tuned")
        extra += [flag, "local/tuned"]
    elif flag == "--prompt-file":
        (tmp_path / "prompts.txt").write_text("a red cat\n\nphoto of a dog on the mat\n")
        extra += [flag, str(tmp_path / "prompts.txt")]
    seen = {}
    build = train.build_evaluator
    monkeypatch.setattr(train, "build_evaluator", lambda a, m: seen.setdefault(
        "evaluator", build(a, m)))
    train.main(["--name", "ck", "--population-size", "4", "--num-inference-steps", "3",
                "--num-prompts", "2", "--random-seed-gen-0", "--tiny-model",
                "--device", "cpu", "--num-cycles", "1",
                "--populations-dir", str(tmp_path / "pops"),
                "--benchmarks-dir", str(tmp_path / "bench"), *extra])
    _check_generations(tmp_path, "ck", (1,), 2, PixArtCacheSchedule, 4)
    assert sum(decoded) == 4 * 2  # candidates × prompts, all through the VAE
    prompts = seen["evaluator"].prompts
    if flag == "--prompt-file":
        assert prompts == ["a red cat", "photo of a dog on the mat"]
    else:
        assert prompts == ["prompt_0", "prompt_1"]


def test_checkpoint_flux_cycle_with_prompt_file(tmp_path, monkeypatch):
    """The FLUX search served from a tiny FLUX.1-dev tree in the public
    layout: its prompts encoded by T5 (text_encoder_2/) and CLIP, every
    candidate decoded by its 16-channel VAE."""
    from test_torch_checkpoints import patch_tiny, write_flux_tree

    from ecad_tpu_torch.models.vae import VAEDecoderPipeline

    patch_tiny(monkeypatch, reference=False)
    root = write_flux_tree(tmp_path / "w", public=True)
    decoded = []
    decode = VAEDecoderPipeline.decode_device
    monkeypatch.setattr(VAEDecoderPipeline, "decode_device",
                        lambda self, z: decoded.append(z.shape) or decode(self, z))
    (tmp_path / "prompts.txt").write_text("a red cat\nphoto of a dog on the mat\n")
    train.main(["--name", "fk", "--model-family", "flux", "--population-size", "4",
                "--num-inference-steps", "3", "--random-seed-gen-0", "--tiny-model",
                "--device", "cpu", "--num-cycles", "1",
                "--populations-dir", str(tmp_path / "pops"),
                "--benchmarks-dir", str(tmp_path / "bench"),
                "--weights-root", str(root), "--prompt-file", str(tmp_path / "prompts.txt")])
    _check_generations(tmp_path, "fk", (1,), 2, FluxCacheSchedule, 4)
    assert sum(s[0] for s in decoded) == 4 * 2 and all(s[-1] == 16 for s in decoded)


@pytest.mark.parametrize("flag", ["--transformer-weights", "--prompt-file"])
def test_checkpoint_flags_need_weights_root(tmp_path, flag):
    with pytest.raises(SystemExit, match="need --weights-root"):
        train.main(["--name", "w", "--tiny-model", "--device", "cpu",
                    "--populations-dir", str(tmp_path / "p"), flag, "x"])
    assert not (tmp_path / "p").exists()


@pytest.mark.parametrize("family", ["pixart", "flux"])
def test_train_cli_quant_cycle(tmp_path, family):
    """One cycle with the evaluator's model built under --quant int8 (the
    tiny PixArt) or int8_w (the tiny FLUX)."""
    quant, cls = {"pixart": ("int8", PixArtCacheSchedule),
                  "flux": ("int8_w", FluxCacheSchedule)}[family]
    out = _run(["--name", "q", "--model-family", family, "--population-size", "4",
                "--num-inference-steps", "3", "--num-prompts", "1", "--random-seed-gen-0",
                "--tiny-model", "--device", "cpu", "--num-cycles", "1", "--quant", quant],
               tmp_path)
    assert "Generation 2 saved" in out
    _check_generations(tmp_path, "q", (1,), 2, cls, 4)


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
