"""The port's denoise pipeline, sampler, schedules and VAE decoder against
the reference on the CPU (tiny configurations, fp32, bridged weights).

Noise and text come from numpy with a fixed seed and go to both sides
(jax.random and torch.Generator give different numbers from one seed)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from ecad_tpu.models import pixart as jpx
from ecad_tpu.models import vae as jvae
from ecad_tpu.pipelines import pixart_pipeline as jpp
from ecad_tpu.pipelines import samplers as jsamp
from ecad_tpu.schedules.pixart import PixArtCacheSchedule as JSched
from ecad_tpu_torch.models import pixart as tpx
from ecad_tpu_torch.models import vae as tvae
from ecad_tpu_torch.models.bridge import pixart_state_dict, vae_state_dict
from ecad_tpu_torch.pipelines import pixart_pipeline as tpp
from ecad_tpu_torch.pipelines import samplers as tsamp
from ecad_tpu_torch.schedules.pixart import PixArtCacheSchedule as TSched

REPO = Path(__file__).resolve().parent.parent
SCHEDULES = REPO / "schedules" / "schedules_in_paper" / "pixart_alpha_256"
STEPS = 20


def test_dpm_schedule_and_coeffs_equal():
    for steps in (4, 20):
        j, t = jsamp.make_dpm_schedule(steps), tsamp.make_dpm_schedule(steps)
        for field in ("timesteps", "alpha_t", "sigma_t", "lambda_t"):
            np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
        np.testing.assert_array_equal(
            tsamp.dpm_scan_coeffs(t), jsamp.dpm_scan_coeffs(j)
        )


@pytest.mark.parametrize("name", ["ours_fast", "ours_faster", "ours_fastest"])
def test_schedule_json_same_genome(name):
    path = SCHEDULES / f"{name}.json"
    j, t = JSched.from_json(path), TSched.from_json(path)
    np.testing.assert_array_equal(t.to_numpy(), j.to_numpy())
    assert t.to_dict() == j.to_dict()
    assert (t.name, t.num_blocks, t.num_inference_steps) == (
        j.name, j.num_blocks, j.num_inference_steps,
    )


@pytest.fixture(scope="module")
def tiny():
    jcfg = jpx.PixArtConfig.tiny(dtype=jnp.float32)
    _, params = jpx.init_params(jcfg, 0)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    tcfg = tpx.PixArtConfig.tiny(dtype=torch.float32)
    model = tpx.PixArtTransformer(tcfg).eval().requires_grad_(False)
    model.load_state_dict(pixart_state_dict(params), strict=True)
    return jcfg, params, tcfg, model


def _mixed_genome(num_blocks):
    rng = np.random.default_rng(7)
    return rng.random((STEPS, num_blocks, 3)) < 0.6


@pytest.mark.parametrize("schedule", ["default", "mixed"])
def test_trajectory_matches_build_denoise_fn(tiny, schedule):
    """20 DPM-Solver++ steps with CFG and text masks, same noise on both
    sides; fp32 throughout, so the final latents agree within 1e-4."""
    jcfg, params, tcfg, model = tiny
    if schedule == "default":
        jsched = JSched.default(STEPS, jcfg.num_blocks)
        tsched = TSched.default(STEPS, tcfg.num_blocks)
    else:
        g = _mixed_genome(jcfg.num_blocks).reshape(STEPS, -1)
        jsched = JSched.from_numpy(g, STEPS, jcfg.num_blocks)
        tsched = TSched.from_numpy(g, STEPS, tcfg.num_blocks)
    rng = np.random.default_rng(11)
    b = 2
    noise = rng.standard_normal((b, 8, 8, 4), dtype=np.float32)
    text = rng.standard_normal((b, 8, 32), dtype=np.float32)
    neg = rng.standard_normal((b, 8, 32), dtype=np.float32)
    tm = (np.arange(8)[None] < np.array([[3], [8]])).astype(np.int32)
    nm = (np.arange(8)[None] < 1).repeat(b, 0).astype(np.int32)

    jpipe = jpp.PixArtPipeline(jpp.PixArtPipelineConfig(jcfg, STEPS), params, jsched)
    want = jpipe.build_denoise_fn(donate=False)(params, noise, text, neg, tm, nm)
    tpipe = tpp.PixArtPipeline(tpp.PixArtPipelineConfig(tcfg, STEPS), model, tsched)
    t = torch.from_numpy
    got = tpipe.build_denoise_fn()(t(noise), t(text), t(neg), t(tm), t(nm))
    assert tpipe.masks == jpipe.masks
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_generate_latents_modes_agree(tiny):
    """Both of the reference's mode names run the same loop; the noise comes
    from a seeded torch.Generator, so one seed gives one trajectory."""
    _, _, tcfg, model = tiny
    pipe = tpp.PixArtPipeline(tpp.PixArtPipelineConfig(tcfg, 4), model)
    text = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(0))
    outs = [pipe.generate_latents(text, text, seed=3, mode=m) for m in tpp.MODES]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with pytest.raises(ValueError):
        pipe.generate_latents(text, text, mode="population")


def test_vae_decode_matches_reference():
    """The tiny VAE decoder with bridged weights, fp32: the decoded pixels
    agree within 1e-4 before quantization and within one uint8 level after
    (a value on a rounding edge may land on either side)."""
    jcfg = jvae.VAEConfig.tiny()
    z = np.random.default_rng(13).standard_normal((2, 4, 4, 4), dtype=np.float32)
    jmodel = jvae.VAEDecoder(jcfg)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(1), z))()["params"]
    params = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    # perturb the norm affines away from 1/0 so the weight mapping is tested
    rng = np.random.default_rng(14)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if p[-1].key in ("scale", "bias") else a,
        params,
    )
    want = jmodel.apply({"params": params}, z)
    want_u8 = jvae.VAEDecoderPipeline(jcfg, params).decode(z)

    tmodel = tvae.VAEDecoder(tvae.VAEConfig.tiny()).eval().requires_grad_(False)
    tmodel.load_state_dict(vae_state_dict(params), strict=True)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(z))
    got_u8 = tvae.VAEDecoderPipeline(tmodel).decode(torch.from_numpy(z))
    assert got.shape == (2, 8, 8, 3) and got_u8.dtype == np.uint8
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert np.abs(got_u8.astype(int) - want_u8.astype(int)).max() <= 1
