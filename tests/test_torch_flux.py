"""The port's FLUX transformer, schedule and encoder against the reference,
with the reference's parameters carried across by models/bridge.py
(FluxConfig.tiny, fp32).

Inputs come from numpy with a fixed seed and go to both sides. Both sides
run fp32 on the CPU with the same weights, so they agree to fp32 rounding:
within 1e-4 through the blocks and the whole tiny transformer."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from ecad_tpu.models import flux as jfx
from ecad_tpu.pipelines import flux_pipeline as jfp
from ecad_tpu.schedules import FluxCacheSchedule as JSched
from ecad_tpu_torch.models import flux as tfx
from ecad_tpu_torch.models.bridge import flux_state_dict
from ecad_tpu_torch.ops import attention as port_attention
from ecad_tpu_torch.pipelines import flux_pipeline as tfp
from ecad_tpu_torch.schedules import FluxCacheSchedule as TSched

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
B = 2
GRID = (4, 4)  # 16 packed image tokens


def _params(jcfg, seed):
    """The reference's parameters, with every bias and QK-norm scale moved
    off its initial 0 / 1 so that the weight mapping is tested."""
    _, params = jfx.init_flux_params(jcfg, seed)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if p[-1].key in ("bias", "q_scale", "k_scale") else a,
        params,
    )


def _port(tcfg, params):
    model = tfx.FluxTransformer(tcfg).eval().requires_grad_(False)
    model.load_state_dict(flux_state_dict(params), strict=True)
    return model


@pytest.fixture(scope="module")
def models():
    jcfg = jfx.FluxConfig.tiny(dtype=jnp.float32)
    params = _params(jcfg, 0)
    return jcfg, params, _port(tfx.FluxConfig.tiny(dtype=torch.float32), params)


def _rope(cfg, text_len=None, grid=GRID):
    ids = np.concatenate(
        [np.zeros((text_len or cfg.text_len, 3)), jfx.make_image_ids(*grid)]
    )
    return jfx.rope_freqs(ids, cfg.axes_dims, cfg.rope_theta)


def _block_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    ti, tt, d = GRID[0] * GRID[1], cfg.text_len, cfg.dim

    def n(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    return dict(
        img=n(B, ti, d), txt=n(B, tt, d), temb=n(B, d),
        full_cache={"full_attn": (n(B, ti, d), n(B, tt, d)), "full_ff": n(B, ti, d),
                    "full_ff_context": n(B, tt, d)},
        single_cache={"single_attn": n(B, tt + ti, d),
                      "single_proj_mlp": n(B, tt + ti, cfg.mlp_ratio * d),
                      "single_proj_out": n(B, tt + ti, d)},
    )


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _close(got, want, **tol):
    """Two trees of the same structure agree (tuples, dicts, arrays)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k], **tol)
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, **tol)
    else:
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), **(tol or TOL)
        )


MASKS3 = [(True, True, True), (False, True, True), (True, False, True),
          (True, True, False), (False, False, True), (False, False, False)]


@pytest.mark.parametrize("mask", MASKS3)
def test_dual_block_matches_reference(models, mask):
    """All-recompute, mixed and all-cached masks. A cached full_attn reads
    the (image, text) pair as one; every component stores the value it
    used."""
    cfg, params, model = models
    x = _block_inputs(cfg, 1)
    cos, sin = _rope(cfg)
    want = jax.jit(
        lambda p, img, txt, temb, c: jfx.FluxDualBlock(cfg).apply(
            {"params": p}, img, txt, temb, cos, sin, c, mask)
    )(params["block_0"], x["img"], x["txt"], x["temb"], x["full_cache"])
    with torch.inference_mode():
        got = model.blocks[0](
            *_t((x["img"], x["txt"], x["temb"], cos, sin, x["full_cache"])), mask
        )
    _close(got, tuple(want))
    assert isinstance(got[2]["full_attn"], tuple)


@pytest.mark.parametrize("mask", MASKS3)
def test_single_block_matches_reference(models, mask):
    """Includes (True, False, True): the cached single_proj_mlp is the
    pre-activation projection, and the GELU runs after the cache read."""
    cfg, params, model = models
    x = _block_inputs(cfg, 2)
    joint = np.concatenate([x["txt"], x["img"]], axis=1)
    cos, sin = _rope(cfg)
    want = jax.jit(
        lambda p, xx, temb, c: jfx.FluxSingleBlock(cfg).apply(
            {"params": p}, xx, temb, cos, sin, c, mask)
    )(params["single_block_0"], joint, x["temb"], x["single_cache"])
    with torch.inference_mode():
        got = model.single_blocks[0](
            *_t((joint, x["temb"], cos, sin, x["single_cache"])), mask
        )
    _close(got, tuple(want))


def _forward_inputs(cfg, seed, grid=GRID):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, grid[0] * grid[1], cfg.in_channels), dtype=np.float32),
        rng.standard_normal((B, cfg.text_len, cfg.joint_dim), dtype=np.float32),
        rng.standard_normal((B, cfg.pooled_dim), dtype=np.float32),
        np.array([0.93, 0.41], np.float32),  # σ
        np.array([5.0, 3.5], np.float32),  # guidance
    )


def _mixed_mask(cfg, seed, p=0.32):
    """An ours_fast-like step mask: about a third of the slots recomputed."""
    rng = np.random.default_rng(seed)
    n = cfg.num_blocks + cfg.num_single_blocks
    return tuple(tuple(bool(v) for v in r) for r in rng.random((n, 3)) < p)


def _jax_forward(cfg, params, inputs, cache, mask, grid=GRID):
    model = jfx.FluxTransformer(cfg)
    return jax.jit(
        lambda p, lat, txt, pooled, t, g, c: model.apply(
            {"params": p}, lat, txt, pooled, t, g, c, mask, grid)
    )(params, *inputs, cache)


def test_forward_matches_reference(models):
    """Step 0 (empty cache, every slot recomputed), then an ours_fast-like
    mask that reads the step-0 caches; the second step gets the
    reference's caches on both sides, so each step is compared alone."""
    cfg, params, model = models
    inputs = _forward_inputs(cfg, 3)
    want, want_cache = _jax_forward(cfg, params, inputs, {}, jfx.full_flux_mask(cfg))
    with torch.inference_mode():
        got, got_cache = model(*_t(inputs), {}, tfx.full_flux_mask(tfx.FluxConfig.tiny()),
                               GRID)
    assert got.shape == (B, GRID[0] * GRID[1], cfg.in_channels)
    _close(got, want)
    _close(got_cache, dict(want_cache))

    mask = _mixed_mask(cfg, 4)
    cache = jax.tree.map(np.array, dict(want_cache))
    inputs2 = (*inputs[:3], np.array([0.52, 0.2], np.float32), inputs[4])
    want2, want_cache2 = _jax_forward(cfg, params, inputs2, cache, mask)
    with torch.inference_mode():
        got2, got_cache2 = model(*_t(inputs2), _t(cache), mask, GRID)
    _close(got2, want2)
    _close(got_cache2, dict(want_cache2))


def test_forward_on_the_rowblock_route_matches_reference(monkeypatch):
    """Head dim 128 and 512 + 1024 joint tokens: a 9 MiB fp32 score tile,
    so the port's joint attention takes the row-block clamp softmax (its
    plain version here), while the reference on the CPU runs XLA's exact
    softmax. With logits inside the clamp window the two are one function,
    so they agree to fp32 rounding."""
    from ecad_tpu_torch.ops import attention as port_attention

    kw = dict(num_heads=2, head_dim=128, axes_dims=(16, 56, 56), text_len=512)
    jcfg = jfx.FluxConfig.tiny(dtype=jnp.float32, **kw)
    params = _params(jcfg, 5)
    model = _port(tfx.FluxConfig.tiny(dtype=torch.float32, **kw), params)
    routes = []
    real = port_attention.rowblock_attention_reference
    monkeypatch.setattr(port_attention, "rowblock_attention_reference",
                        lambda *a: routes.append(a[0].shape) or real(*a))
    grid = (32, 32)
    inputs = tuple(a[:1] for a in _forward_inputs(jcfg, 6, grid))
    want, _ = _jax_forward(jcfg, params, inputs, {}, jfx.full_flux_mask(jcfg), grid)
    with torch.inference_mode():
        got, _ = model(*_t(inputs), {}, tfx.full_flux_mask(model.config), grid)
    assert routes == [(1, 1536, 2, 128)] * (jcfg.num_blocks + jcfg.num_single_blocks)
    _close(got, want)


def test_trajectory_on_the_streaming_route_matches_reference(monkeypatch):
    """Four flow-match Euler steps at guidance 5 under a mixed schedule at
    head dim 128, with the port's routing thresholds lowered to 0 so that
    every joint attention takes the streaming route (K6), as FLUX.1-dev's
    9728 joint tokens do at 1536²; its plain version here. The reference
    on the CPU runs XLA's exact softmax, the same function; fp32
    throughout, so the final latents agree within 1e-4."""
    steps, side = 4, 64  # 4×4 packed image tokens
    kw = dict(num_heads=2, head_dim=128, axes_dims=(16, 56, 56))
    jcfg = jfx.FluxConfig.tiny(dtype=jnp.float32, **kw)
    params = _params(jcfg, 7)
    model = _port(tfx.FluxConfig.tiny(dtype=torch.float32, **kw), params)
    monkeypatch.setattr(port_attention, "_SINGLE_TILE_SCORE_BYTES", 0)
    monkeypatch.setattr(port_attention, "_ROWBLOCK_MAX_KV_ELEMS", 0)
    shapes = []
    plain = port_attention.flash_attention_reference

    def counted(q, k, v, bias=None):
        shapes.append(tuple(q.shape))
        return plain(q, k, v, bias)

    monkeypatch.setattr(port_attention, "flash_attention_reference", counted)
    n = (jcfg.num_blocks + jcfg.num_single_blocks) * 3
    genome = np.random.default_rng(8).random(steps * n) < 0.5
    jsched, tsched = (
        S.from_numpy(genome, steps, jcfg.num_blocks, num_single_blocks=jcfg.num_single_blocks)
        for S in (JSched, TSched)
    )
    jpipe = jfp.FluxPipeline(
        jfp.FluxPipelineConfig(jcfg, steps, height=side, width=side), params, jsched)
    tpipe = tfp.FluxPipeline(
        tfp.FluxPipelineConfig(model.config, steps, height=side, width=side), model, tsched)
    rng = np.random.default_rng(9)
    noise = rng.standard_normal((B, (side // 16) ** 2, jcfg.in_channels), dtype=np.float32)
    txt = rng.standard_normal((B, jcfg.text_len, jcfg.joint_dim), dtype=np.float32)
    pooled = rng.standard_normal((B, jcfg.pooled_dim), dtype=np.float32)
    want = jpipe.build_denoise_fn(donate=False)(params, noise, txt, pooled)
    got = tpipe.build_denoise_fn()(*(torch.from_numpy(a) for a in (noise, txt, pooled)))
    recomputed = sum(row[0] for step in tpipe.masks for row in step)
    assert shapes == [(B, jcfg.text_len + 16, 2, 128)] * recomputed and recomputed > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_cache_dtype_float8_storage(models):
    """cache_dtype=float8_e4m3fn: the caches are stored in fp8 and read back
    in the compute dtype, as the reference's _to_cache/_from_cache do. The
    recompute-everything output is unchanged; each stored value is the
    reference's to one fp8 ulp (2^-3 relative; fp32 values a rounding apart
    may land on either side of an fp8 rounding edge); an all-cached replay
    from the reference's fp8 caches agrees to fp32 rounding."""
    import dataclasses

    cfg, params, _ = models
    jcfg8 = dataclasses.replace(cfg, cache_dtype=jnp.float8_e4m3fn)
    model8 = _port(tfx.FluxConfig.tiny(dtype=torch.float32,
                                       cache_dtype=torch.float8_e4m3fn), params)
    inputs = _forward_inputs(cfg, 7)
    want, want_cache = _jax_forward(jcfg8, params, inputs, {}, jfx.full_flux_mask(cfg))
    with torch.inference_mode():
        got, got_cache = model8(*_t(inputs), {}, tfx.full_flux_mask(model8.config), GRID)
    _close(got, want)
    assert got_cache["single_proj_mlp_0"].dtype == torch.float8_e4m3fn
    assert all(t.dtype == torch.float8_e4m3fn for t in got_cache["full_attn_0"])
    _close(got_cache, dict(want_cache), rtol=2**-3, atol=2**-9)

    # the reference's fp8 caches, carried across exactly (fp8 values are
    # exact in fp32)
    cache8 = jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.float8_e4m3fn),
        dict(want_cache),
    )
    none = jfx.full_flux_mask(cfg, False)
    want2, want_cache2 = _jax_forward(jcfg8, params, inputs, dict(want_cache), none)
    with torch.inference_mode():
        got2, got_cache2 = model8(*_t(inputs), cache8, none, GRID)
    _close(got2, want2)
    assert all(got_cache2[k] is cache8[k] for k in cache8)


def test_cached_components_do_no_work(models, monkeypatch):
    """A cached component is skipped, not computed and discarded: with
    every component of a block cached, no attention, projection or
    modulated norm runs in it; the single block's one norm runs when its
    attention or MLP projection is recomputed, and only then."""
    _, _, model = models
    cfg = model.config
    calls = []
    monkeypatch.setattr(tfx, "modulated_layer_norm",
                        lambda x, s, h: calls.append("norm") or x)
    monkeypatch.setattr(tfx, "modulated_layer_norm_pair",
                        lambda a, b: calls.append("norm") or (a[0], b[0]))
    for mod in (model.blocks[0].attn, model.single_blocks[0].attn,
                model.single_blocks[0].proj_mlp, model.single_blocks[0].proj_out):
        monkeypatch.setattr(mod, "forward", lambda *a, **k: calls.append("work"))
    x = _t(_block_inputs(cfg, 8))
    cos, sin = (torch.from_numpy(a) for a in _rope(cfg))
    joint = torch.cat([x["txt"], x["img"]], dim=1)
    with torch.inference_mode():
        _, _, new = model.blocks[0](x["img"], x["txt"], x["temb"], cos, sin,
                                    x["full_cache"], (False, False, False))
        assert calls == [] and all(new[k] is x["full_cache"][k] for k in new)
        model.single_blocks[0](joint, x["temb"], cos, sin, x["single_cache"],
                               (False, False, False))
        assert calls == []
        model.single_blocks[0](joint, x["temb"], cos, sin, x["single_cache"],
                               (False, True, False))
    assert calls == ["norm", "work"]


def test_rope_pack_unpack_and_qk_norm_match_reference():
    rng = np.random.default_rng(9)
    # rope tables: float64 angles, float32 results, on both sides
    ids = np.concatenate([np.zeros((7, 3)), jfx.make_image_ids(3, 5)])
    np.testing.assert_array_equal(tfx.make_image_ids(3, 5), jfx.make_image_ids(3, 5))
    for axes in ((4, 6, 6), (16, 56, 56)):
        for a, b in zip(tfx.rope_freqs(ids, axes, 10000), jfx.rope_freqs(ids, axes, 10000)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    cos, sin = jfx.rope_freqs(ids, (4, 6, 6), 10000)
    # interleaved (even, odd) pairs, rotated in fp32: fp32 agrees to
    # rounding, bf16 to the one rounding of the cast back (one bf16 ulp)
    x = rng.standard_normal((2, 22, 3, 16), dtype=np.float32)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, dict(rtol=1e-6, atol=1e-6)),
                          (jnp.bfloat16, torch.bfloat16, dict(rtol=2**-7, atol=2**-7))):
        want = jfx.apply_rope(jnp.asarray(x, jdt), jnp.asarray(cos), jnp.asarray(sin))
        got = tfx.apply_rope(torch.from_numpy(x).to(tdt), torch.from_numpy(cos),
                             torch.from_numpy(sin))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    # packing: feature order (c, p_h, p_w) within a token, exact
    lat = rng.standard_normal((2, 8, 6, 16), dtype=np.float32)
    packed = tfx.pack_latents(torch.from_numpy(lat))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jfx.pack_latents(jnp.asarray(lat))))
    np.testing.assert_array_equal(tfx.unpack_latents(packed, 4, 3).numpy(), lat)
    # QK norm: fp32 RMS with eps 1e-6 and fp32 scales
    q, k = (rng.standard_normal((2, 5, 3, 16), dtype=np.float32) * 3 for _ in range(2))
    scales = {"q_scale": 1 + 0.1 * rng.standard_normal(16).astype(np.float32),
              "k_scale": 1 + 0.1 * rng.standard_normal(16).astype(np.float32)}
    want = jfx.QKNorm(16, jnp.float32).apply({"params": scales}, q, k)
    norm = tfx.QKNorm(16, torch.float32)
    norm.load_state_dict({n: torch.from_numpy(v) for n, v in scales.items()})
    with torch.inference_mode():
        got = norm(torch.from_numpy(q), torch.from_numpy(k))
    _close(tuple(got), tuple(want), rtol=1e-6, atol=1e-6)


SCHEDULE_FILES = sorted(
    str(p.relative_to(REPO / "schedules"))
    for p in [*(REPO / "schedules" / "schedules_in_paper").glob("flux_256*/*.json"),
              *(REPO / "schedules" / "flux_cache_schedules" / "gen_default").glob("*.json")]
)


@pytest.mark.parametrize("name", SCHEDULE_FILES)
def test_schedule_json_loads_like_reference(name, tmp_path):
    """Mask, header and step masks as the reference's FluxCacheSchedule
    gives them, and the JSON round trip."""
    path = REPO / "schedules" / name
    j, t = JSched.from_json(path), TSched.from_json(path)
    np.testing.assert_array_equal(t.mask, j.mask)
    np.testing.assert_array_equal(t.to_numpy(), j.to_numpy())
    assert t.to_dict() == j.to_dict()
    assert (t.name, t.num_blocks, t.num_single_blocks, t.num_inference_steps) == (
        j.name, j.num_blocks, j.num_single_blocks, j.num_inference_steps)
    assert t.components == j.components == (
        "single_attn", "single_proj_mlp", "single_proj_out",
        "full_attn", "full_ff", "full_ff_context")
    assert tfx.flux_step_masks(t, tfx.FluxConfig()) == jfx.flux_step_masks(j, jfx.FluxConfig())
    t.to_json(tmp_path / "s.json")
    back = TSched.from_json(tmp_path / "s.json")
    assert back.to_dict() == t.to_dict()


def test_schedule_genome_order_matches_reference():
    """Per step, the full blocks' components first, then the single
    blocks'; step 0 of the step masks is forced to recompute."""
    genome = np.random.default_rng(10).random(4 * 15) < 0.5
    j = JSched.from_numpy(genome, 4, 2, num_single_blocks=3)
    t = TSched.from_numpy(genome, 4, 2, num_single_blocks=3)
    assert t.slot_names() == j.slot_names()
    np.testing.assert_array_equal(t.to_numpy(), genome)
    masks = tfx.flux_step_masks(t, tfx.FluxConfig.tiny())
    assert masks == jfx.flux_step_masks(j, jfx.FluxConfig.tiny())
    assert masks[0] == tfx.full_flux_mask(tfx.FluxConfig.tiny())
    with pytest.raises(ValueError, match="num_single_blocks"):
        TSched(2, 4)


@pytest.mark.parametrize("shape", [(8, 32, 24), (512, 4096, 768)])
def test_hash_encoder_identical_to_reference(shape):
    from ecad_tpu.image_generators.flux import _FluxHashEncoder as JEnc
    from ecad_tpu_torch.image_generators.flux import _FluxHashEncoder as TEnc

    for prompt in ("a dog", "", "a lighthouse in a storm"):
        for a, b in zip(TEnc(*shape).encode(prompt), JEnc(*shape).encode(prompt)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_init_model_seeded_on_the_device():
    """Built on `meta` and filled on the target device from a seeded
    generator: Linear weights N(0, 0.02) in the model dtype, biases 0,
    QK-norm scales 1 in fp32; the same seed gives the same model."""
    cfg = tfx.FluxConfig.tiny()
    a = tfx.init_model(cfg, 1, "cpu")
    b = tfx.init_model(cfg, 1, "cpu")
    c = tfx.init_model(cfg, 2, "cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["blocks.0.attn.to_q.weight"], sc["blocks.0.attn.to_q.weight"])
    for name, p in a.named_parameters():
        assert not p.requires_grad
        if name.endswith(("q_scale", "k_scale")):
            assert p.dtype == torch.float32 and bool((p == 1).all()), name
        elif name.endswith("bias"):
            assert p.dtype == torch.bfloat16 and bool((p == 0).all()), name
        else:
            assert p.dtype == torch.bfloat16, name
    w = torch.cat([p.float().flatten() for n, p in a.named_parameters()
                   if n.endswith("weight")])
    assert abs(float(w.std()) - 0.02) < 0.002 and abs(float(w.mean())) < 0.002


def test_full_width_parameter_tree_matches_reference():
    """FLUX.1-dev at full width, shapes only (nothing is allocated): the
    port's state_dict names and shapes are the bridged reference tree's,
    11.9 B parameters."""
    jcfg = jfx.FluxConfig()
    model = jfx.FluxTransformer(jcfg)
    lat = jnp.zeros((1, 16, jcfg.in_channels), jcfg.dtype)
    txt = jnp.zeros((1, jcfg.text_len, jcfg.joint_dim), jcfg.dtype)
    pooled = jnp.zeros((1, jcfg.pooled_dim), jcfg.dtype)
    t = jnp.zeros((1,), jnp.float32)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), lat, txt, pooled, t, t + 3.5, {},
                           jfx.full_flux_mask(jcfg), (4, 4))
    )["params"]
    shapes = fnn.meta.unbox(shapes)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [p.key for p in path]
        if keys[-1] == "kernel":  # Dense (in, out) → Linear (out, in)
            keys[-1], shape = "weight", tuple(reversed(leaf.shape))
        else:
            shape = tuple(leaf.shape)
        for prefix, modules in (("block_", "blocks"), ("single_block_", "single_blocks")):
            if keys[0].startswith(prefix):
                keys = [modules, keys[0][len(prefix):], *keys[1:]]
        want[".".join(keys)] = shape
    with torch.device("meta"):
        port = tfx.FluxTransformer(tfx.FluxConfig())
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    n = sum(int(np.prod(s)) for s in got.values())
    assert 11.8e9 < n < 12.0e9, n
