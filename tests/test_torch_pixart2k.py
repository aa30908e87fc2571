"""PixArt-Σ at 2048² in the port, against the reference on the CPU: the
streaming-route (K6) trajectory, the 2048² generator configuration and the
VAE's mid-attention taken in query blocks. All at tiny sizes (fp32,
bridged weights); the full 2048² model is never built here.

Noise and text come from numpy with a fixed seed and go to both sides."""

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
from ecad_tpu.schedules.pixart import PixArtCacheSchedule as JSched
from ecad_tpu_torch.models import pixart as tpx
from ecad_tpu_torch.models import vae as tvae
from ecad_tpu_torch.models.bridge import pixart_state_dict, vae_state_dict
from ecad_tpu_torch.ops import attention as port_attention
from ecad_tpu_torch.pipelines import pixart_pipeline as tpp
from ecad_tpu_torch.schedules.pixart import PixArtCacheSchedule as TSched

REPO = Path(__file__).resolve().parent.parent
SIGMA_SCHEDULES = {
    "ours_fast": REPO / "schedules/schedules_in_paper/pixart_sigma_256/ours_fast.json",
    "default": REPO / "schedules/sigma_cache_schedules/gen_default/default.json",
}
STEPS = 20


@pytest.fixture(scope="module")
def tiny():
    jcfg = jpx.PixArtConfig.tiny(dtype=jnp.float32)
    _, params = jpx.init_params(jcfg, 0)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    tcfg = tpx.PixArtConfig.tiny(dtype=torch.float32)
    model = tpx.PixArtTransformer(tcfg).eval().requires_grad_(False)
    model.load_state_dict(pixart_state_dict(params), strict=True)
    return jcfg, params, tcfg, model


def test_trajectory_through_flash_route_matches_reference(tiny, monkeypatch):
    """20 DPM-Solver++ steps with CFG, text masks and a mixed schedule,
    every attention of the port sent down the streaming route (its routing
    thresholds lowered to 0, so the tiny shapes take it as 16384 tokens
    do): self-attention through the no-bias variant, cross-attention
    through the key-padding one. The reference's default XLA attention
    computes the same exact softmax; fp32 throughout, so the latents agree
    within 1e-4."""
    jcfg, params, tcfg, model = tiny
    monkeypatch.setattr(port_attention, "_SINGLE_TILE_SCORE_BYTES", 0)
    monkeypatch.setattr(port_attention, "_ROWBLOCK_MAX_KV_ELEMS", 0)
    calls = {"self": 0, "cross": 0}
    plain = port_attention.flash_attention_reference

    def counted(q, k, v, bias=None):
        calls["self" if bias is None else "cross"] += 1
        return plain(q, k, v, bias)

    monkeypatch.setattr(port_attention, "flash_attention_reference", counted)
    g = np.random.default_rng(21).random((STEPS, jcfg.num_blocks, 3)) < 0.6
    g = g.reshape(STEPS, -1)
    jsched = JSched.from_numpy(g, STEPS, jcfg.num_blocks)
    tsched = TSched.from_numpy(g, STEPS, tcfg.num_blocks)
    rng = np.random.default_rng(22)
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
    got = tpipe.denoise(t(noise), t(text), t(neg), t(tm), t(nm))
    assert tpipe.masks == jpipe.masks
    arr = np.array(tpipe.masks, dtype=bool)
    assert calls == {"self": int(arr[..., 0].sum()), "cross": int(arr[..., 1].sum())}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(SIGMA_SCHEDULES))
def test_sigma_2048_config_resolves_like_reference(name):
    """PixArtSigmaImageGenerator with a Σ schedule and the CLI's --height /
    --width 2048 gives the reference generator's configuration: a 256×256
    latent (16384 tokens), no size conditions, PixArt-XL-2 widths, the
    schedule's steps and pipeline. Only the configuration is built."""
    from ecad_tpu.image_generators import pixart as jgen
    from ecad_tpu.pipelines.registry import pipeline_from_config as jpick
    from ecad_tpu_torch.image_generators import pixart as tgen
    from ecad_tpu_torch.pipelines.registry import pipeline_from_config as tpick

    path = SIGMA_SCHEDULES[name]
    j = jgen.PixArtSigmaImageGenerator(schedule_path=path, random_weights=True)
    t = tgen.PixArtSigmaImageGenerator(schedule_path=path, random_weights=True,
                                       batch_size=1, device="cpu")
    for gen in (j, t):  # what the CLI does with --height 2048 --width 2048
        gen.height = gen.width = 2048
    jc, tc = j.model_config(), t.model_config()
    fields = ("sample_size", "use_additional_conditions", "tokens", "dim",
              "num_heads", "head_dim", "num_blocks", "text_len", "caption_dim")
    assert {f: getattr(tc, f) for f in fields} == {f: getattr(jc, f) for f in fields}
    assert (tc.sample_size, tc.use_additional_conditions, tc.tokens) == (256, False, 16384)
    assert (t.num_inference_steps, t.pipeline_name, t.transformer_weights) == (
        j.num_inference_steps, j.pipeline_name, j.transformer_weights)
    jcls, jkw = jpick(j.pipeline_name or "pixart_alpha", j.pipeline_kwargs)
    tcls, tkw = tpick(t.pipeline_name or "pixart_alpha", t.pipeline_kwargs)
    assert tcls.__name__ == jcls.__name__ == "PixArtPipeline" and tkw == jkw


def test_pos_embed_at_2048_interpolates_like_reference():
    """At sample_size 256 both packages interpolate the sincos position
    embedding by 256 // 64 = 4 over a 128×128 grid (checked at a tiny
    width: the grid and the interpolation are what the size decides)."""
    from ecad_tpu.models.common import sincos_2d_pos_embed as jax_pos

    cfg = tpx.PixArtConfig.tiny(sample_size=256, dtype=torch.float32)
    with torch.device("meta"):
        model = tpx.PixArtTransformer(cfg)
    got = model._pos_embed(128, 128, torch.empty((), dtype=torch.float32))[0]
    want = np.asarray(jax_pos(cfg.dim, 128, 128, base_size=128, interpolation_scale=4))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    uninterpolated = jax_pos(cfg.dim, 128, 128, base_size=128, interpolation_scale=1)
    assert np.abs(np.asarray(uninterpolated) - want).max() > 0.1


def test_chunked_mid_attention_matches_reference(monkeypatch):
    """The tiny VAE decoder with its mid-attention taken in blocks of 5
    query rows (16 tokens at batch 2: blocks of 5, 5, 5 and 1) against the
    reference's one-call XLA attention, bridged weights, fp32: within 1e-4
    as the unblocked decoder is, and within fp32 rounding of the unblocked
    port."""
    jcfg = jvae.VAEConfig.tiny()
    z = np.random.default_rng(23).standard_normal((2, 4, 4, 4), dtype=np.float32)
    jmodel = jvae.VAEDecoder(jcfg)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(2), z))()["params"]
    params = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    want = jmodel.apply({"params": params}, z)
    tmodel = tvae.VAEDecoder(tvae.VAEConfig.tiny()).eval().requires_grad_(False)
    tmodel.load_state_dict(vae_state_dict(params), strict=True)
    blocks = []
    softmax = torch.softmax
    monkeypatch.setattr(torch, "softmax", lambda x, dim: blocks.append(x.shape) or softmax(x, dim))
    with torch.inference_mode():
        whole = tmodel(torch.from_numpy(z))
        assert blocks == [(2, 16, 16)]
        blocks.clear()
        monkeypatch.setattr(tvae, "_MID_ATTENTION_LOGITS", 2 * 16 * 5)
        got = tmodel(torch.from_numpy(z))
    assert blocks == [(2, 5, 16)] * 3 + [(2, 1, 16)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)
