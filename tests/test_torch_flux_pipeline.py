"""The port's FLUX pipeline, flow-match sampler, generators, CLI and
16-channel VAE against the reference on the CPU (tiny configurations,
fp32, bridged weights).

Noise and embeddings come from numpy with a fixed seed and go to both sides
(jax.random and torch.Generator give different numbers from one seed)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from ecad_tpu.models import flux as jfx
from ecad_tpu.pipelines import flux_pipeline as jfp
from ecad_tpu.pipelines import samplers as jsamp
from ecad_tpu.schedules import FluxCacheSchedule as JSched
from ecad_tpu_torch.models import flux as tfx
from ecad_tpu_torch.models.bridge import flux_state_dict
from ecad_tpu_torch.pipelines import flux_pipeline as tfp
from ecad_tpu_torch.pipelines import samplers as tsamp
from ecad_tpu_torch.schedules import FluxCacheSchedule as TSched

REPO = Path(__file__).resolve().parent.parent
STEPS = 4
SIDE = 64  # 4×4 packed tokens


@pytest.mark.parametrize("steps,seq_len", [(20, 256), (20, 4096), (4, 16), (50, 1024)])
def test_flow_schedule_matches_reference(steps, seq_len):
    """Dynamic shift μ linear in image tokens, float64 sigmas: identical."""
    j = jsamp.make_flow_schedule(steps, seq_len)
    t = tsamp.make_flow_schedule(steps, seq_len)
    assert t.num_steps == j.num_steps == steps
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    assert t.sigmas[-1] == 0.0 and t.sigmas.dtype == np.float64


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flow_step_matches_reference(dtype):
    """x + (σ_{i+1} − σ_i)·v in fp32, cast to x's dtype: bit-identical."""
    rng = np.random.default_rng(0)
    x, v = (rng.standard_normal((2, 16, 64), dtype=np.float32) for _ in range(2))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (
        jnp.bfloat16, torch.bfloat16)
    sched = jsamp.make_flow_schedule(20, 4096)
    for i in (0, 7, 19):
        want = jsamp.flow_step(sched, i, jnp.asarray(v, jdt), jnp.asarray(x, jdt))
        got = tsamp.flow_step(tsamp.make_flow_schedule(20, 4096), i,
                              torch.from_numpy(v).to(tdt), torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.fixture(scope="module")
def tiny():
    jcfg = jfx.FluxConfig.tiny(dtype=jnp.float32)
    _, params = jfx.init_flux_params(jcfg, 0)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    tcfg = tfx.FluxConfig.tiny(dtype=torch.float32)
    model = tfx.FluxTransformer(tcfg).eval().requires_grad_(False)
    model.load_state_dict(flux_state_dict(params), strict=True)
    return jcfg, params, tcfg, model


def _schedules(jcfg, kind):
    if kind == "default":
        kw = dict(num_inference_steps=STEPS, num_blocks=jcfg.num_blocks,
                  num_single_blocks=jcfg.num_single_blocks)
        return JSched.default(**kw), TSched.default(**kw)
    # ours_fast-like: about a third of the slots recomputed after step 0
    n = (jcfg.num_blocks + jcfg.num_single_blocks) * 3
    genome = np.random.default_rng(1).random(STEPS * n) < 0.32
    return tuple(
        S.from_numpy(genome, STEPS, jcfg.num_blocks, num_single_blocks=jcfg.num_single_blocks)
        for S in (JSched, TSched)
    )


def _inputs(cfg, b=2):
    rng = np.random.default_rng(2)
    return (
        rng.standard_normal((b, (SIDE // 16) ** 2, cfg.in_channels), dtype=np.float32),
        rng.standard_normal((b, cfg.text_len, cfg.joint_dim), dtype=np.float32),
        rng.standard_normal((b, cfg.pooled_dim), dtype=np.float32),
    )


@pytest.mark.parametrize("schedule", ["default", "ours_fast_like"])
def test_trajectory_matches_build_denoise_fn(tiny, schedule):
    """Four flow-match Euler steps at guidance 5 from the same injected
    noise; fp32 throughout, so the packed final latents agree within 1e-4."""
    jcfg, params, tcfg, model = tiny
    jsched, tsched = _schedules(jcfg, schedule)
    jpipe = jfp.FluxPipeline(
        jfp.FluxPipelineConfig(jcfg, STEPS, height=SIDE, width=SIDE), params, jsched)
    tpipe = tfp.FluxPipeline(
        tfp.FluxPipelineConfig(tcfg, STEPS, height=SIDE, width=SIDE), model, tsched)
    assert tpipe.masks == jpipe.masks
    np.testing.assert_array_equal(tpipe.flow.sigmas, jpipe.flow.sigmas)
    noise, txt, pooled = _inputs(jcfg)
    want = jpipe.build_denoise_fn(donate=False)(params, noise, txt, pooled)
    got = tpipe.build_denoise_fn()(*(torch.from_numpy(a) for a in (noise, txt, pooled)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # unpacked as the reference unpacks: (B, H/8, W/8, 16)
    gh, gw = tpipe.config.grid_hw
    np.testing.assert_array_equal(
        tfx.unpack_latents(got, gh, gw).numpy(),
        np.asarray(jfx.unpack_latents(jnp.asarray(got.numpy()), gh, gw)),
    )


def test_generate_latents_modes_and_set_schedule(tiny):
    """Both mode names run one loop from one seeded torch.Generator;
    set_schedule swaps the masks of a resident pipeline and refuses a
    schedule of another length, as the reference does."""
    jcfg, params, tcfg, model = tiny
    pipe = tfp.FluxPipeline(tfp.FluxPipelineConfig(tcfg, STEPS, height=SIDE, width=SIDE), model)
    _, txt, pooled = (torch.from_numpy(a) for a in _inputs(jcfg))
    outs = [pipe.generate_latents(txt, pooled, seed=3, mode=m) for m in tfp.MODES]
    assert outs[0].shape == (2, SIDE // 8, SIDE // 8, tcfg.in_channels // 4)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with pytest.raises(ValueError):
        pipe.generate_latents(txt, pooled, mode="population")
    jsched, tsched = _schedules(jcfg, "ours_fast_like")
    pipe.set_schedule(tsched)
    jpipe = jfp.FluxPipeline(
        jfp.FluxPipelineConfig(jcfg, STEPS, height=SIDE, width=SIDE), params)
    jpipe.set_schedule(jsched)
    assert pipe.masks == jpipe.masks
    for p, S in ((pipe, TSched), (jpipe, JSched)):
        with pytest.raises(ValueError, match="steps"):
            p.set_schedule(S.default(num_inference_steps=3, num_blocks=2, num_single_blocks=3))


def test_float8_cache_trajectory_tracks_bf16_cache(tiny):
    """The fp8 cache storage through a whole trajectory: the reference's
    bound on the drift from the unrounded caches (relative L2 < 0.1,
    tests/test_flux_model.py), met by both packages, and the two fp8
    trajectories agree with each other far more closely than that."""
    import dataclasses

    jcfg, params, tcfg, model = tiny
    jsched, tsched = _schedules(jcfg, "ours_fast_like")
    noise, txt, pooled = _inputs(jcfg)
    base = tfp.FluxPipeline(tfp.FluxPipelineConfig(tcfg, STEPS, height=SIDE, width=SIDE),
                            model, tsched)
    ref = base.denoise(*(torch.from_numpy(a) for a in (noise, txt, pooled))).numpy()
    tcfg8 = dataclasses.replace(tcfg, cache_dtype=torch.float8_e4m3fn)
    model8 = tfx.FluxTransformer(tcfg8).eval().requires_grad_(False)
    model8.load_state_dict(model.state_dict())
    got = tfp.FluxPipeline(tfp.FluxPipelineConfig(tcfg8, STEPS, height=SIDE, width=SIDE),
                           model8, tsched).denoise(
        *(torch.from_numpy(a) for a in (noise, txt, pooled))).numpy()
    jcfg8 = dataclasses.replace(jcfg, cache_dtype=jnp.float8_e4m3fn)
    want = np.asarray(jfp.FluxPipeline(
        jfp.FluxPipelineConfig(jcfg8, STEPS, height=SIDE, width=SIDE), params, jsched,
    ).build_denoise_fn(donate=False)(params, noise, txt, pooled))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert np.isfinite(got).all()
    assert rel(got, ref) < 0.1 and rel(want, ref) < 0.1
    assert rel(got, want) < 0.25 * rel(want, ref)


SCHEDULE_FILES = sorted(
    str(p.relative_to(REPO / "schedules"))
    for p in [*(REPO / "schedules" / "schedules_in_paper").glob("flux_256*/*.json"),
              *(REPO / "schedules" / "flux_cache_schedules").glob("*/*.json")]
)


@pytest.mark.parametrize("name", SCHEDULE_FILES)
def test_generator_resolves_schedules_like_reference(name):
    """Height, width, guidance, steps and pipeline from each of the repo's
    FLUX schedules, as the JAX generator takes them; the full-width model
    is not built here."""
    from ecad_tpu.image_generators import flux as jgen
    from ecad_tpu_torch.image_generators import flux as tgen

    path = REPO / "schedules" / name
    j = jgen.FluxImageGenerator(schedule_path=path, random_weights=True)
    t = tgen.FluxImageGenerator(schedule_path=path, random_weights=True, device="cpu")
    fields = ("height", "width", "guidance_scale", "num_inference_steps", "pipeline_name",
              "num_blocks", "num_single_blocks", "text_len", "joint_dim", "pooled_dim")
    assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}
    tc, jc = t.model_config(), j.model_config()
    # the port always embeds guidance: FLUX.1-dev is the only FLUX it serves
    assert (tc.num_blocks, tc.num_single_blocks, tc.dim, tc.num_heads, tc.head_dim,
            tc.text_len, True, tc.dtype, tc.cache_dtype) == (
        jc.num_blocks, jc.num_single_blocks, jc.dim, jc.num_heads, jc.head_dim,
        jc.text_len, jc.guidance_embeds, torch.bfloat16, None)
    assert t.cache_schedule.to_dict() == j.cache_schedule.to_dict()


def test_generator_options():
    """cache_dtype and quant reach the model config and the description;
    checkpoint loading reads the weights_root tree, and a tree without the
    transformer's files says where it looked; the registry serves both
    names."""
    from ecad_tpu_torch.image_generators import get_image_generator_type
    from ecad_tpu_torch.image_generators import flux as tgen
    from ecad_tpu_torch.pipelines.registry import pipeline_from_config

    gen = tgen.FluxImageGenerator(random_weights=True, device="cpu",
                                  cache_dtype="float8_e4m3fn")
    assert gen.model_config().cache_dtype == torch.float8_e4m3fn
    assert gen.describe()["cache_dtype"] == "float8_e4m3fn"
    assert get_image_generator_type("FluxImageGenerator") is tgen.FluxImageGenerator
    assert get_image_generator_type("TinyFluxImageGenerator") is tgen.TinyFluxImageGenerator
    assert pipeline_from_config("flux")[0] is tfp.FluxPipeline
    quant = tgen.FluxImageGenerator(random_weights=True, device="cpu", quant="int8_w")
    assert quant.model_config().quant == "int8_w" and quant.describe()["quant"] == "int8_w"
    with pytest.raises(ValueError, match="unknown quant mode"):
        tfx.FluxTransformer(tfx.FluxConfig.tiny(quant="int4"))
    loader = tgen.FluxImageGenerator(weights_root="/nonexistent", device="cpu")
    with pytest.raises(FileNotFoundError, match="FLUX.1-dev/transformer"):
        loader.create_diffusion_pipeline()


def _files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("extra", [[], ["--cache-dtype", "float8_e4m3fn"]])
def test_tiny_flux_cli_same_outputs_as_reference(tmp_path, extra):
    """The tiny FLUX generator through both CLIs on a prompt file, two seeds
    and a guidance override: the same files, and identical embeddings from
    the hash encoder. --cache-dtype is accepted for FLUX generators."""
    from ecad_tpu.inference import cli as jcli
    from ecad_tpu_torch.inference import cli as tcli
    from ecad_tpu_torch.utils.io import load_embedding_dir

    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a small house\na tree by a lake\n")
    args = ["TinyFluxImageGenerator", "--prompt-file", str(prompts),
            "--num-inference-steps", "2", "--images-per-prompt", "2",
            "--seed-step", "4", "--guidance-scale", "3.5", *extra]
    jcli.main([*args, "--output-dir", str(tmp_path / "jax")])
    tcli.main([*args, "--output-dir", str(tmp_path / "torch"), "--device", "cpu"])
    files = _files(tmp_path / "torch")
    assert files == _files(tmp_path / "jax")
    assert [f for f in files if f.startswith("images/")] == [
        f"images/{i:03d}__prompt_seed:000__image_seed:{s:03d}.png"
        for i in range(2) for s in (0, 4)
    ]
    for a, b in zip(load_embedding_dir(tmp_path / "jax" / "embeddings"),
                    load_embedding_dir(tmp_path / "torch" / "embeddings")):
        assert a.keys() == b.keys() and {"prompt_embeds", "pooled_prompt_embeds"} <= a.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])


def test_flux_vae_config_and_random_decoder():
    """VAEConfig.flux is the reference's (16 channels, scaling 0.3611,
    shift 0.1159); the random decoder builds it for 16 channels and
    decodes to uint8 pixels at 8× the latent size."""
    from ecad_tpu.models import vae as jvae
    from ecad_tpu_torch.models import vae as tvae

    j, t = jvae.VAEConfig.flux(), tvae.VAEConfig.flux()
    for f in ("latent_channels", "scaling_factor", "shift_factor", "block_out_channels",
              "layers_per_block", "norm_num_groups"):
        assert getattr(t, f) == getattr(j, f), f
    pipe = tvae.random_decoder_pipeline(16, device="cpu")
    assert pipe.model.config.latent_channels == 16
    z = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 2, 2, 16),
                                                                   dtype=np.float32))
    img = pipe.decode(z)
    assert img.shape == (1, 16, 16, 3) and img.dtype == np.uint8
    with pytest.raises(ValueError):
        tvae.random_decoder_pipeline(8, device="cpu")
