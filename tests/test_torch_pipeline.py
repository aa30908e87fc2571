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


# ---------------------------------------------------------------------------
# the PixArt variants: size conditions at 1024 tokens, TGATE, pass-through,
# DiT plans, the pipeline registry
# ---------------------------------------------------------------------------

from ecad_tpu.pipelines import registry as jreg  # noqa: E402
from ecad_tpu.pipelines import tgate as jtg  # noqa: E402
from ecad_tpu_torch.pipelines import registry as treg  # noqa: E402
from ecad_tpu_torch.pipelines import tgate as ttg  # noqa: E402

VARIANT_STEPS = 4
# a 1024-style tiny model: the size conditions (dim a multiple of 3) and a
# 64×64 latent, i.e. 1024 image tokens, so that self-attention takes the
# clamp-softmax route (a 4 MiB score tile, head dim 16)
SIZED_KW = dict(dim=96, sample_size=64, use_additional_conditions=True)


@pytest.fixture(scope="module")
def tiny_sized():
    jcfg = jpx.PixArtConfig.tiny(dtype=jnp.float32, **SIZED_KW)
    _, params = jpx.init_params(jcfg, 0)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    tcfg = tpx.PixArtConfig.tiny(dtype=torch.float32, **SIZED_KW)
    model = tpx.PixArtTransformer(tcfg).eval().requires_grad_(False)
    model.load_state_dict(pixart_state_dict(params), strict=True)
    return jcfg, params, tcfg, model


def _variant_inputs(side):
    rng = np.random.default_rng(17)
    b = 2
    return dict(
        noise=rng.standard_normal((b, side, side, 4), dtype=np.float32),
        text=rng.standard_normal((b, 8, 32), dtype=np.float32),
        neg=rng.standard_normal((b, 8, 32), dtype=np.float32),
        tm=(np.arange(8)[None] < np.array([[3], [8]])).astype(np.int32),
        nm=(np.arange(8)[None] < 1).repeat(b, 0).astype(np.int32),
    )


def _assert_latents_close(got, want):
    """fp32 on both sides, sums in other orders. Random-weight latents grow
    to O(700) over a few DPM steps (x0 = x/α with α ≈ 0.07 at the first
    step), so the bound is relative to the largest latent: 2e-6 of it, a
    few fp32 roundings of that magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=1e-5, atol=2e-6 * float(np.abs(want).max())
    )


PIPELINES = {
    "pixart_alpha": (jpp.PixArtPipeline, tpp.PixArtPipeline, {}),
    "tgate": (jtg.TGATEPixArtPipeline, ttg.TGATEPixArtPipeline, {"gate_step": 2}),
    "pass_through": (jtg.PassThroughPixArtPipeline, ttg.PassThroughPixArtPipeline, {}),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_sized_trajectory_matches_reference(tiny_sized, name):
    """Four DPM steps with the size conditions, CFG, text masks and a
    schedule that caches cross-attention and FF at step 1; TGATE gates at
    step 2 of 4 (its second phase runs at batch B without guidance)."""
    jcfg, params, tcfg, model = tiny_sized
    jcls, tcls, kwargs = PIPELINES[name]
    g = np.ones((VARIANT_STEPS, jcfg.num_blocks, 3), bool)
    g[1, :, 1:] = False
    g = g.reshape(VARIANT_STEPS, -1)
    jsched = JSched.from_numpy(g, VARIANT_STEPS, jcfg.num_blocks)
    tsched = TSched.from_numpy(g, VARIANT_STEPS, tcfg.num_blocks)
    x = _variant_inputs(jcfg.sample_size)
    args = [x[k] for k in ("noise", "text", "neg", "tm", "nm")]
    jpipe = jcls(jpp.PixArtPipelineConfig(jcfg, VARIANT_STEPS), params, jsched, **kwargs)
    want = jpipe.build_denoise_fn(donate=False)(params, *args)
    tpipe = tcls(tpp.PixArtPipelineConfig(tcfg, VARIANT_STEPS), model, tsched, **kwargs)
    got = tpipe.denoise(*(torch.from_numpy(a) for a in args))
    assert tpipe.masks == jpipe.masks
    _assert_latents_close(got, want)


@pytest.mark.parametrize(
    "gate_step,cache_attn1_at",
    [(0, None), (5, None), (2, 3)],
)
def test_tgate_rejects_what_the_reference_rejects(tiny, gate_step, cache_attn1_at):
    """gate_step out of range, or a schedule that reuses self-attention
    after the gate (the CFG-batch caches are dropped there)."""
    jcfg, params, tcfg, model = tiny
    g = np.ones((VARIANT_STEPS, jcfg.num_blocks, 3), bool)
    if cache_attn1_at is not None:
        g[cache_attn1_at, 0, 0] = False
    g = g.reshape(VARIANT_STEPS, -1)
    with pytest.raises(ValueError):
        jtg.TGATEPixArtPipeline(
            jpp.PixArtPipelineConfig(jcfg, VARIANT_STEPS), params,
            JSched.from_numpy(g, VARIANT_STEPS, jcfg.num_blocks), gate_step=gate_step,
        )
    with pytest.raises(ValueError):
        ttg.TGATEPixArtPipeline(
            tpp.PixArtPipelineConfig(tcfg, VARIANT_STEPS), model,
            TSched.from_numpy(g, VARIANT_STEPS, tcfg.num_blocks), gate_step=gate_step,
        )


def test_trajectory_under_dit_plan_matches_reference(tiny):
    """A DiT topology schedule (default topology for two steps, then the two
    blocks in reverse, then block 1 skipped) through both pipelines."""
    from ecad_tpu import graph as jg
    from ecad_tpu_torch import graph as tg

    jcfg, params, tcfg, model = tiny

    def dit(g):
        n = jcfg.num_blocks
        steps = {0: g.default_config(n), 1: g.default_config(n),
                 2: g.reverse(n, 0, 1), 3: g.skip_blocks(n, [1])}
        return g.DiTSchedule(n, VARIANT_STEPS, "mixed_topology", steps)

    x = _variant_inputs(8)
    args = [x[k] for k in ("noise", "text", "neg", "tm", "nm")]
    jpipe = jpp.PixArtPipeline(
        jpp.PixArtPipelineConfig(jcfg, VARIANT_STEPS), params, None, dit_schedule=dit(jg)
    )
    want = jpipe.build_denoise_fn(donate=False)(params, *args)
    tpipe = tpp.PixArtPipeline(
        tpp.PixArtPipelineConfig(tcfg, VARIANT_STEPS), model, None, dit_schedule=dit(tg)
    )
    got = tpipe.denoise(*(torch.from_numpy(a) for a in args))
    assert [tg.plan_block_sequence(plan) for plan in tpipe.plans] == [
        [0, 1], [0, 1], [1, 0], [0]
    ]
    _assert_latents_close(got, want)


def test_pipeline_registry_names_match_reference():
    assert treg.PipelineRegistry.names() == jreg.PipelineRegistry.names()
    for name in ("pixart_alpha", "pixart_sigma", "tgate", "pass_through"):
        jcls, jkw = jreg.pipeline_from_config(name, {"gate_step": 3})
        tcls, tkw = treg.pipeline_from_config(name, {"gate_step": 3})
        assert tcls.__name__ == jcls.__name__ and tkw == jkw == {"gate_step": 3}
    assert treg.pipeline_from_config(None)[0] is tpp.PixArtPipeline
    flux, kw = treg.pipeline_from_config("flux")
    assert flux.__name__ == jreg.pipeline_from_config("flux")[0].__name__ == "FluxPipeline"
    assert flux.__module__ == "ecad_tpu_torch.pipelines.flux_pipeline" and kw == {}
