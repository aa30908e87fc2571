"""The port's inference CLI (tiny generator, --device cpu) against the
reference CLI: the same output layout, file names and embeddings; and the
no-silent-CPU rule of the port's entry points."""

from pathlib import Path

import numpy as np
import pytest
import torch

from ecad_tpu.inference import cli as jcli
from ecad_tpu_torch.inference import cli as tcli
from ecad_tpu_torch.utils.io import load_embedding_dir

ARGS = [
    "TinyPixArtImageGenerator",
    "--num-inference-steps", "2",
    "--images-per-prompt", "2",
    "--start-seed", "5",
    "--seed-step", "3",
]


def _files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_same_outputs_as_reference_cli(tmp_path):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("first prompt\nsecond prompt here\n")
    jcli.main([*ARGS, "--prompt-file", str(prompts), "--output-dir", str(tmp_path / "jax")])
    tcli.main([*ARGS, "--prompt-file", str(prompts), "--output-dir",
               str(tmp_path / "torch"), "--device", "cpu"])
    files = _files(tmp_path / "torch")
    assert files == _files(tmp_path / "jax")
    assert sum(f.startswith("images/") for f in files) == 4  # 2 prompts × 2 seeds
    assert {f.split("image_seed:")[1] for f in files if "image_seed" in f} == {
        "005.png", "008.png"
    }
    # the hash encoder gives both packages the same embeddings
    j = load_embedding_dir(tmp_path / "jax" / "embeddings")
    t = load_embedding_dir(tmp_path / "torch" / "embeddings")
    for a, b in zip(j, t):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])


def test_entry_points_default_to_cuda_and_refuse_cpu(tmp_path, monkeypatch):
    """With no GPU and no explicit --device cpu, the entry points raise
    instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["TinyPixArtImageGenerator", "--prompt", "x",
                   "--output-dir", str(tmp_path)])
    assert not (tmp_path / "images").exists()

    from ecad_tpu_torch.models.pixart import PixArtConfig, init_model
    from ecad_tpu_torch.models.vae import random_decoder_pipeline

    with pytest.raises(RuntimeError):
        init_model(PixArtConfig.tiny())
    with pytest.raises(RuntimeError):
        random_decoder_pipeline()


@pytest.mark.parametrize("flag", [["--quant", "int8"], ["--cache-dtype", "float8_e4m3fn"]])
def test_unported_options_rejected(tmp_path, flag):
    with pytest.raises(SystemExit):
        tcli.main(["TinyPixArtImageGenerator", "--prompt", "x", "--device", "cpu",
                   "--output-dir", str(tmp_path), *flag])


def test_guidance_override_rejected(tmp_path):
    with pytest.raises(SystemExit):
        tcli.main(["TinyPixArtImageGenerator", "--prompt", "x", "--device", "cpu",
                   "--output-dir", str(tmp_path), "--guidance-scale", "7"])
