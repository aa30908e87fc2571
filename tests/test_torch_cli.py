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


@pytest.mark.parametrize("flag", [["--quant", "fp4"], ["--cache-dtype", "float8_e4m3fn"]])
def test_unported_options_rejected(tmp_path, flag):
    """A quant mode outside the reference's four choices, and fp8 caches for
    a PixArt generator, exit before any work."""
    with pytest.raises(SystemExit):
        tcli.main(["TinyPixArtImageGenerator", "--prompt", "x", "--device", "cpu",
                   "--output-dir", str(tmp_path), *flag])
    assert not (tmp_path / "images").exists()


@pytest.mark.parametrize("generator,quant", [("TinyPixArtImageGenerator", "int8_static"),
                                             ("TinyFluxImageGenerator", "int8_w_static"),
                                             ("TinyPixArtImageGenerator", "int8_w")])
def test_quant_modes_write_their_images(tmp_path, capsys, generator, quant):
    """--quant through the CLI: the generator calibrates a static mode when
    it builds its model, every image of the prompt file is written, and the
    generator's description names the mode."""
    from ecad_tpu_torch.ops import launch_counts, reset_launch_counts

    prompts = tmp_path / "prompts.txt"
    prompts.write_text("first prompt\nsecond prompt here\n")
    reset_launch_counts()
    tcli.main([generator, "--prompt-file", str(prompts), "--num-inference-steps", "2",
               "--device", "cpu", "--quant", quant, "--output-dir", str(tmp_path)])
    pngs = sorted((tmp_path / "images").glob("*.png"))
    assert [p.name for p in pngs] == [f"{i:03d}__prompt_seed:000__image_seed:000.png"
                                      for i in range(2)]
    assert f"'quant': '{quant}'" in capsys.readouterr().out
    assert launch_counts()["int8_matmul"] > 0


def test_guidance_override_rejected(tmp_path):
    with pytest.raises(SystemExit):
        tcli.main(["TinyPixArtImageGenerator", "--prompt", "x", "--device", "cpu",
                   "--output-dir", str(tmp_path), "--guidance-scale", "7"])


# ---------------------------------------------------------------------------
# schedules that pick the pipeline, the topology and the 1024² checkpoint
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent.parent
ALPHA = REPO / "schedules" / "alpha_cache_schedules"
SCHEDULES_1024 = sorted(
    str(p.relative_to(ALPHA))
    for p in [*ALPHA.glob("gen_tgate_1024/*.json"),
              *ALPHA.glob("gen_default_1024x1024/*.json")]
)


def _tiny_schedule(tmp_path: Path, kind: str) -> Path:
    """A 2-block, 4-step schedule for the tiny generator: TGATE gating at
    step 2 (the JSON's config.pipeline, as in the repo's TGATE schedules),
    or a DiT topology schedule that reverses the blocks from step 2."""
    from ecad_tpu.graph import DiTSchedule, default_config, reverse
    from ecad_tpu.schedules.pixart import PixArtCacheSchedule

    path = tmp_path / f"{kind}.json"
    if kind == "tgate":
        genome = np.ones((4, 2, 3), bool)
        genome[1, :, 1:] = False
        sched = PixArtCacheSchedule.from_numpy(genome.reshape(4, -1), 4, 2)
        sched.name = "tiny_tgate"
        sched.top_level_config = {"pipeline": {"name": "tgate", "kwargs": {"gate_step": 2}}}
        sched.to_json(path)
    else:
        steps = {s: (default_config(2) if s < 2 else reverse(2, 0, 1)) for s in range(4)}
        DiTSchedule(2, 4, "tiny_reverse", steps).to_json(path)
    return path


@pytest.mark.parametrize("kind", ["tgate", "dit"])
def test_schedule_driven_cli_same_outputs_as_reference(tmp_path, kind):
    """The tiny generator served a TGATE schedule (pipeline from the JSON,
    with its gate_step) or a DiT topology schedule writes the JAX CLI's
    files."""
    schedule = _tiny_schedule(tmp_path, kind)
    args = ["TinyPixArtImageGenerator", "--prompt", "a small house",
            "--schedule", str(schedule), "--batch-size", "2"]
    jcli.main([*args, "--output-dir", str(tmp_path / "jax")])
    tcli.main([*args, "--output-dir", str(tmp_path / "torch"), "--device", "cpu"])
    files = _files(tmp_path / "torch")
    assert files == _files(tmp_path / "jax")
    assert files == [
        "embeddings/000__prompt_seed:000.pt",
        "images/000__prompt_seed:000__image_seed:000.png",
    ]


@pytest.mark.parametrize("name", SCHEDULES_1024)
def test_1024_schedules_resolve_like_reference(name):
    """Each of the repo's 1024² schedules gives the 1024 configuration
    (128×128 latents, size conditions) and the pipeline (with kwargs) the
    JAX generator gives. The full-size model is not built here."""
    from ecad_tpu.image_generators import pixart as jgen
    from ecad_tpu.pipelines.registry import pipeline_from_config as jpick
    from ecad_tpu_torch.image_generators import pixart as tgen
    from ecad_tpu_torch.pipelines.registry import pipeline_from_config as tpick

    path = ALPHA / name
    j = jgen.PixArtAlphaImageGenerator(schedule_path=path, random_weights=True)
    t = tgen.PixArtAlphaImageGenerator(schedule_path=path, random_weights=True,
                                       device="cpu")
    jc, tc = j.model_config(), t.model_config()
    assert (tc.sample_size, tc.use_additional_conditions, tc.tokens) == (
        jc.sample_size, jc.use_additional_conditions, jc.tokens) == (128, True, 4096)
    assert (t.height, t.width, t.num_inference_steps, t.pipeline_name) == (
        j.height, j.width, j.num_inference_steps, j.pipeline_name)
    jcls, jkw = jpick(j.pipeline_name or "pixart_alpha", j.pipeline_kwargs)
    tcls, tkw = tpick(t.pipeline_name or "pixart_alpha", t.pipeline_kwargs)
    assert tcls.__name__ == jcls.__name__ and tkw == jkw
    want = "TGATEPixArtPipeline" if "tgate" in name else "PixArtPipeline"
    assert tcls.__name__ == want
