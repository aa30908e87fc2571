"""The port's PixArt transformer against the reference, with the reference's
parameters carried across by models/bridge.py (PixArtConfig.tiny, fp32).

Inputs come from numpy with a fixed seed. Both sides run fp32 on the CPU
with the same weights, so they agree to fp32 rounding; through two blocks
of attention, FF and the final projection that is within 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from ecad_tpu.models import pixart as jpx
from ecad_tpu_torch.models import pixart as tpx
from ecad_tpu_torch.models.bridge import pixart_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)
B = 2


@pytest.fixture(scope="module")
def models():
    jcfg = jpx.PixArtConfig.tiny(dtype=jnp.float32)
    _, params = jpx.init_params(jcfg, 0)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    tcfg = tpx.PixArtConfig.tiny(dtype=torch.float32)
    model = tpx.PixArtTransformer(tcfg).eval().requires_grad_(False)
    model.load_state_dict(pixart_state_dict(params), strict=True)
    return jcfg, params, model


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens, dim = cfg.tokens, cfg.dim
    return dict(
        latents=rng.standard_normal(
            (B, cfg.sample_size, cfg.sample_size, cfg.in_channels), dtype=np.float32
        ),
        text=rng.standard_normal((B, cfg.text_len, cfg.caption_dim), dtype=np.float32),
        t=np.array([999.0, 501.0], np.float32),
        text_mask=(np.arange(cfg.text_len)[None] < np.array([[3], [8]])).astype(np.int32),
        h=rng.standard_normal((B, tokens, dim), dtype=np.float32),
        enc=rng.standard_normal((B, cfg.text_len, dim), dtype=np.float32),
        t6=rng.standard_normal((B, 6 * dim), dtype=np.float32) * 0.1,
        cache={
            k: [rng.standard_normal((B, tokens, dim), dtype=np.float32)
                for _ in range(cfg.num_blocks)]
            for k in jpx.COMPONENTS
        },
    )


MASKS = {
    "all_true": lambda n: tuple((True, True, True) for _ in range(n)),
    "mixed": lambda n: tuple(
        ((True, False, True), (False, True, False))[i % 2] for i in range(n)
    ),
    "all_false": lambda n: tuple((False, False, False) for _ in range(n)),
}


@pytest.mark.parametrize("with_text_mask", [False, True])
@pytest.mark.parametrize("mask", [(True, True, True), (True, False, True),
                                  (False, True, False), (False, False, False)])
def test_block_matches_reference(models, mask, with_text_mask):
    cfg, params, model = models
    x = _inputs(cfg)
    bias = None
    if with_text_mask:
        bias = ((1.0 - x["text_mask"]) * -10000.0)[:, None, None, :].astype(np.float32)
    cache = {k: v[0] for k, v in x["cache"].items()}
    block = jpx.PixArtBlock(cfg)
    want_h, want_cache = jax.jit(
        lambda p, h, enc, t6, b, c: block.apply({"params": p}, h, enc, t6, b, c, mask)
    )(params["block_0"], x["h"], x["enc"], x["t6"], bias, cache)
    t = torch.from_numpy
    got_h, got_cache = model.blocks[0](
        t(x["h"]), t(x["enc"]), t(x["t6"]), None if bias is None else t(bias),
        {k: t(v) for k, v in cache.items()}, mask,
    )
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    for k in jpx.COMPONENTS:
        np.testing.assert_allclose(
            got_cache[k].numpy(), np.asarray(want_cache[k]), **TOL
        )


@pytest.mark.parametrize("with_text_mask", [False, True])
@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_forward_matches_reference(models, mask_name, with_text_mask):
    cfg, params, model = models
    x = _inputs(cfg, seed=1)
    mask = MASKS[mask_name](cfg.num_blocks)
    tm = x["text_mask"] if with_text_mask else None
    jmodel = jpx.PixArtTransformer(cfg)
    cache = {k: tuple(v) for k, v in x["cache"].items()}
    want, want_cache = jax.jit(
        lambda p, lat, txt, t, c, m: jmodel.apply(
            {"params": p}, lat, txt, t, c, mask, text_mask=m
        )
    )(params, x["latents"], x["text"], x["t"], cache, tm)
    t = torch.from_numpy
    with torch.inference_mode():
        got, got_cache = model(
            t(x["latents"]), t(x["text"]), t(x["t"]),
            {k: [t(a) for a in v] for k, v in x["cache"].items()}, mask,
            text_mask=None if tm is None else t(tm),
        )
    assert got.shape == (B, cfg.sample_size, cfg.sample_size, cfg.out_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in jpx.COMPONENTS:
        for i in range(cfg.num_blocks):
            np.testing.assert_allclose(
                got_cache[k][i].numpy(), np.asarray(want_cache[k][i]), **TOL
            )


def test_encode_text_hoist_matches_reference(models):
    """The trajectory-constant caption projection and per-block K/V."""
    cfg, params, model = models
    text = _inputs(cfg, seed=2)["text"]
    enc, kv = jpx.PixArtTransformer(cfg).apply(
        {"params": params}, jnp.asarray(text),
        method=jpx.PixArtTransformer.encode_text,
    )
    with torch.inference_mode():
        got_enc, got_kv = model.encode_text(torch.from_numpy(text))
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(enc), **TOL)
    for (gk, gv), (wk, wv) in zip(got_kv, kv):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)


def test_cached_components_are_not_computed(models, monkeypatch):
    """A cached component is skipped, not computed and masked: with every
    component cached, no attention or feed-forward runs, and the block
    returns the caches it was given, re-gated."""
    _, _, model = models
    cfg = model.config
    calls = []
    for name in ("attn1", "attn2", "ff"):
        mod = getattr(model.blocks[0], name)
        monkeypatch.setattr(mod, "forward", lambda *a, _n=name, **k: calls.append(_n))
    x = _inputs(cfg, seed=3)
    cache = {k: torch.from_numpy(v[0]) for k, v in x["cache"].items()}
    _, new = model.blocks[0](
        torch.from_numpy(x["h"]), torch.from_numpy(x["enc"]),
        torch.from_numpy(x["t6"]), None, cache, (False, False, False),
    )
    assert calls == []
    assert all(new[k] is cache[k] for k in jpx.COMPONENTS)


def test_schedule_step_masks_force_step_zero():
    from ecad_tpu.schedules.pixart import PixArtCacheSchedule as JSched
    from ecad_tpu_torch.schedules.pixart import PixArtCacheSchedule as TSched

    arr = np.random.default_rng(5).random((20, 2, 3)) < 0.5
    jm = jpx.schedule_step_masks(
        JSched.from_numpy(arr.reshape(20, -1), 20, 2), jpx.PixArtConfig.tiny()
    )
    tm = tpx.schedule_step_masks(
        TSched.from_numpy(arr.reshape(20, -1), 20, 2), tpx.PixArtConfig.tiny()
    )
    assert tm == jm
    assert all(all(row) for row in tm[0])


# ---------------------------------------------------------------------------
# the 1024² configuration's size conditions, and DiT topology plans
# ---------------------------------------------------------------------------

# dim must be a multiple of 3: the two size embedders are dim // 3 wide and
# their concatenation is added to the dim-wide timestep embedding
SIZE_KW = dict(dim=96, sample_size=16, use_additional_conditions=True)


@pytest.fixture(scope="module")
def sized():
    jcfg = jpx.PixArtConfig.tiny(dtype=jnp.float32, **SIZE_KW)
    _, params = jpx.init_params(jcfg, 1)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    tcfg = tpx.PixArtConfig.tiny(dtype=torch.float32, **SIZE_KW)
    model = tpx.PixArtTransformer(tcfg).eval().requires_grad_(False)
    model.load_state_dict(pixart_state_dict(params), strict=True)
    return jcfg, params, model


SIZES = {
    "square_1024": ([[1024.0, 1024.0], [1024.0, 1024.0]], [1.0, 1.0]),
    "mixed": ([[1024.0, 768.0], [512.0, 2048.0]], [0.75, 4.0]),
}


@pytest.mark.parametrize("sizes", sorted(SIZES))
def test_adaln_single_size_conditions_match_reference(sized, sizes):
    cfg, params, model = sized
    res, ar = (np.asarray(a, np.float32) for a in SIZES[sizes])
    t = np.array([999.0, 3.0], np.float32)
    want_t6, want_emb = jax.jit(
        lambda p: jpx.AdaLayerNormSingle(cfg).apply({"params": p}, t, res, ar)
    )(params["adaln_single"])
    with torch.inference_mode():
        got_t6, got_emb = model.adaln_single(
            torch.from_numpy(t), torch.from_numpy(res), torch.from_numpy(ar)
        )
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb), **TOL)
    np.testing.assert_allclose(got_t6.numpy(), np.asarray(want_t6), **TOL)
    with pytest.raises(ValueError, match="size conditions"):
        model.adaln_single(torch.from_numpy(t))


def _plans():
    from ecad_tpu import graph as jg
    from ecad_tpu_torch import graph as tg

    configs = {
        "default": lambda g: g.default_config(2),
        "reverse": lambda g: g.reverse(2, 0, 1),
        "skip_1": lambda g: g.skip_blocks(2, [1]),
        "parallel_avg_looped": lambda g: g.parallel(2, 0, 1, 1, "avg"),
        "parallel_add": lambda g: g.parallel(2, 0, 1, 0, "add"),
        "repeat_0": lambda g: g.middle_repeat(2, 0, 1),
    }
    return {k: (jg.build_plan(f(jg)), tg.build_plan(f(tg))) for k, f in configs.items()}


@pytest.mark.parametrize("name", ["default", "reverse", "skip_1",
                                  "parallel_avg_looped", "parallel_add", "repeat_0"])
def test_forward_with_plan_and_size_conditions_matches_reference(sized, name):
    """A forward pass under a DiT topology plan, with the size conditions:
    the two graph packages build the same plan and the two models run it
    to the same output and cache."""
    cfg, params, model = sized
    jplan, tplan = _plans()[name]
    assert [tuple(vars(op).values()) for op in tplan] == [
        tuple(vars(op).values()) for op in jplan
    ]
    x = _inputs(cfg, seed=4)
    res = np.full((B, 2), 1024.0, np.float32)
    ar = np.ones((B,), np.float32)
    mask = MASKS["mixed"](cfg.num_blocks)
    cache = {k: tuple(v) for k, v in x["cache"].items()}
    want, want_cache = jax.jit(
        lambda p, lat, txt, tt, c, m: jpx.PixArtTransformer(cfg).apply(
            {"params": p}, lat, txt, tt, c, mask, text_mask=m,
            resolution=res, aspect_ratio=ar, plan=jplan,
        )
    )(params, x["latents"], x["text"], x["t"], cache, x["text_mask"])
    t = torch.from_numpy
    with torch.inference_mode():
        got, got_cache = model(
            t(x["latents"]), t(x["text"]), t(x["t"]),
            {k: [t(a) for a in v] for k, v in x["cache"].items()}, mask,
            text_mask=t(x["text_mask"]), resolution=t(res), aspect_ratio=t(ar),
            plan=tplan,
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in jpx.COMPONENTS:
        for i in range(cfg.num_blocks):
            np.testing.assert_allclose(
                got_cache[k][i].numpy(), np.asarray(want_cache[k][i]), **TOL
            )
