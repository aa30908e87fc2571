"""The port's kernels, through their CPU path (the plain PyTorch versions),
against the reference's Pallas kernels run in interpret mode on the CPU.

Inputs come from numpy with a fixed seed and go to both sides. On the CPU
each wrapper runs its plain version; the CUDA kernels themselves are held
against the same plain versions on the card by chip_smoke.py."""

from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecad_tpu.models.common import layer_norm as jax_layer_norm
from ecad_tpu.ops import attention as jax_attention
from ecad_tpu.ops import fused_attention as jax_fused_attention
from ecad_tpu.ops import modulated_layer_norm as jax_modulated_layer_norm
from ecad_tpu_torch.models.common import layer_norm
from ecad_tpu_torch.ops import (
    attention_route,
    clamp_fd_attention,
    flash_attention,
    flash_attention_reference,
    fused_attention,
    fused_attention_reference,
    launch_counts,
    matmul_only_attention,
    max_exp2_attention,
    modulated_layer_norm,
    modulated_layer_norm_pair,
    modulated_layer_norm_reference,
    nomax_attention,
    rowblock_attention,
    rowblock_attention_reference,
    transposed_attention,
    transposed_attention_reference,
)
from ecad_tpu_torch.ops import _build
from ecad_tpu_torch.ops import attention as port_attention
from ecad_tpu_torch.ops.fused import GROUPS, LANES, MAX_NV, launch_plan
from ecad_tpu_torch.scripts import probe_attention_body

# fp32 on both sides, only the summation order differs
TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(rng, b, tq, tk, h, d):
    return tuple(
        rng.standard_normal(shape, dtype=np.float32)
        for shape in ((b, tq, h, d), (b, tk, h, d), (b, tk, h, d))
    )


def _both(q, k, v, bias=None):
    want = jax_fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if bias is None else jnp.asarray(bias), interpret=True,
    )
    got = fused_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias),
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("tq,tk,d", [(16, 16, 72), (16, 24, 16), (8, 128, 64)])
def test_attention_matches_pallas_no_bias(tq, tk, d):
    rng = np.random.default_rng(0)
    got, want = _both(*_qkv(rng, 2, tq, tk, 3, d))
    np.testing.assert_allclose(got, want, **TOL)


def _key_padding(lengths, tk):
    lens = np.asarray(lengths)[:, None, None, None]
    return np.where(np.arange(tk)[None, None, None, :] < lens, 0.0, -1e9).astype(
        np.float32
    )


@pytest.mark.parametrize(
    "name", ["key_padding", "per_batch_key_padding", "batch_broadcast", "dense"]
)
def test_attention_matches_pallas_with_bias(name):
    rng = np.random.default_rng(1)
    if name == "key_padding":  # tests/test_ops.py test_fused_attention_with_bias
        q, k, v = _qkv(rng, 2, 8, 12, 2, 16)
        bias = _key_padding([7, 7], 12)
    elif name == "per_batch_key_padding":
        q, k, v = _qkv(rng, 3, 16, 256, 2, 72)
        bias = _key_padding([100, 200, 256], 256)
    elif name == "batch_broadcast":  # (1, 1, 1, Tk) over b=3
        q, k, v = _qkv(rng, 3, 16, 256, 2, 64)
        bias = _key_padding([100], 256)
    else:
        q, k, v = _qkv(rng, 2, 8, 12, 3, 16)
        bias = rng.standard_normal((2, 3, 8, 12), dtype=np.float32)
    got, want = _both(q, k, v, bias)
    np.testing.assert_allclose(got, want, **TOL)


def test_attention_text_bias_in_bf16_matches_pallas():
    """The main path's text bias, (1 − mask)·−10000 cast to bf16 (−9984),
    is widened to fp32 on both sides; bf16 inputs, fp32 softmax, one cast.
    Both sides round the same fp32 result once: agreement to one bf16 ulp."""
    rng = np.random.default_rng(2)
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(rng, 2, 16, 12, 2, 72))
    mask = (np.arange(12)[None, :] < np.array([[5], [12]])).astype(np.float32)
    bias16 = ((1.0 - mask) * -10000.0)[:, None, None, :].astype(jnp.bfloat16)
    want = jax_fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias16),
        interpret=True,
    )
    as_t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)  # noqa: E731
    got = fused_attention(as_t(q), as_t(k), as_t(v), as_t(bias16))
    assert float(as_t(bias16).float().min()) == -9984.0
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=2**-7, atol=2**-7
    )


@pytest.mark.parametrize("bias", [None, "key_padding"])
def test_attention_bf16_d64_matches_pallas(bias):
    """K1 and K2 in bf16 at head dim 64, the width the Hopper body now takes
    on the exact single-tile route: the plain version against the Pallas
    kernels in interpret mode at the reference's odd shape (tq 30, tk 300,
    pad keys to 384; key padding per batch at [100, 200, 256]). Both sides
    take bf16 operands into an fp32 softmax and round the fp32 result once:
    agreement to one bf16 ulp (2^-7 of an O(1) output)."""
    rng = np.random.default_rng(4)
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(rng, 3, 30, 300, 2, 64))
    b = None if bias is None else _key_padding([100, 200, 256], 300)
    want = jax_fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if b is None else jnp.asarray(b), interpret=True,
    )
    as_t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)  # noqa: E731
    got = fused_attention(as_t(q), as_t(k), as_t(v), None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=2**-7, atol=2**-7
    )


@pytest.mark.parametrize("d", [64, 72, 128])
def test_attention_bf16_dense_bias_matches_pallas(d):
    """K2 with a dense bias in bf16, which the Hopper body now takes on the
    exact single-tile route at head dims 64, 72 and 128: the plain version
    against ``_attn_kernel_bias`` in interpret mode at the reference's odd
    shape (tq 30, tk 300: 84 pad keys) with a bf16 (B, H, Tq, Tk) bias,
    which both sides widen to fp32 exactly. Both take bf16 operands into an
    fp32 softmax and round the fp32 result once: agreement to one bf16 ulp
    (2^-7 of an O(1) output)."""
    rng = np.random.default_rng(47)
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(rng, 2, 30, 300, 2, d))
    bias = rng.standard_normal((2, 2, 30, 300), dtype=np.float32).astype(jnp.bfloat16)
    want = jax_fused_attention(*(jnp.asarray(x) for x in (q, k, v)), bias=jnp.asarray(bias),
                               interpret=True)
    as_t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)  # noqa: E731
    args = [as_t(x) for x in (q, k, v, bias)]
    assert attention_route(tuple(args[0].shape), 300, args[3]) == "exact"
    got = fused_attention(*args)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=2**-7, atol=2**-7
    )


@pytest.mark.parametrize("bias", [None, "key_padding"])
@pytest.mark.parametrize("route", ["transposed", "flash"])
def test_clamp_and_streaming_bf16_d64_match_pallas(route, bias, monkeypatch):
    """K4 and K6 in bf16 at head dim 64, the width the Hopper body now takes
    on the clamp transposed and streaming routes: each plain version,
    through its wrapper on the CPU, against the Pallas kernels in interpret
    mode (`_transposed_attention`; `_flash_attention` with
    _ROWBLOCK_MAX_KV_ELEMS = 0, so that the streaming kernel runs) at the
    reference's odd shape (tq 30, tk 300: pad keys to 384 on both routes;
    key padding per batch at [100, 200, 256]). Both sides round q·scale (the
    clamp) and p to bf16 the same way and round the fp32 result once:
    agreement to one bf16 ulp (2^-7 of an O(1) output)."""
    monkeypatch.setattr(jax_attention, "_ROWBLOCK_MAX_KV_ELEMS", 0)
    rng = np.random.default_rng(45)
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(rng, 3, 30, 300, 2, 64))
    b = None if bias is None else _key_padding([100, 200, 256], 300)
    ref, port = {"transposed": (jax_attention._transposed_attention, transposed_attention),
                 "flash": (jax_attention._flash_attention, flash_attention)}[route]
    want = ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               None if b is None else jnp.asarray(b), interpret=True)
    as_t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)  # noqa: E731
    got = port(as_t(q), as_t(k), as_t(v), None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=2**-7, atol=2**-7
    )


def test_modulated_layer_norm_matches_pallas():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 16, 128), dtype=np.float32)
    scale = rng.standard_normal((3, 1, 128), dtype=np.float32) * 0.1
    shift = rng.standard_normal((3, 1, 128), dtype=np.float32) * 0.1
    want = jax_modulated_layer_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift), interpret=True
    )
    got = modulated_layer_norm(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(shift)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # (B, d) modulation is accepted too, as in the reference
    got2 = modulated_layer_norm(
        torch.from_numpy(x), torch.from_numpy(scale[:, 0]),
        torch.from_numpy(shift[:, 0]),
    )
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


def test_modulated_layer_norm_pair_matches_pallas():
    """The pair's plain version (FLUX's image and text streams of one site)
    against two calls of the reference kernel in interpret mode, fp32, with
    the scale and shift of each segment strided views of a (1, 6, d)
    modulation, as the dual block takes them: TOL, since only the
    summation order differs."""
    rng = np.random.default_rng(13)
    segs = []
    for t in (40, 8):
        x = rng.standard_normal((1, t, 128), dtype=np.float32)
        mods = rng.standard_normal((1, 6, 128), dtype=np.float32) * 0.1
        segs.append((x, mods[:, 1:2], mods[:, 0:1]))
    got = modulated_layer_norm_pair(*(tuple(torch.from_numpy(a) for a in s) for s in segs))
    assert len(got) == 2
    for g, (x, scale, shift) in zip(got, segs):
        want = jax_modulated_layer_norm(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift), interpret=True)
        assert g.shape == x.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL)


def test_modulated_layer_norm_pair_refuses_segments_it_cannot_join():
    """One launch takes one d, one dtype and one device: the pair raises
    on segments whose d differs, that lie on different devices, or whose
    dtypes differ."""
    def seg(t, d, **kw):
        return (torch.zeros(1, t, d, **kw), torch.zeros(1, 1, d, **kw),
                torch.zeros(1, 1, d, **kw))

    with pytest.raises(ValueError, match="differ in d"):
        modulated_layer_norm_pair(seg(4, 128), seg(2, 64))
    with pytest.raises(ValueError, match="different devices"):
        modulated_layer_norm_pair(seg(4, 128), seg(2, 128, device="meta"))
    with pytest.raises(ValueError, match="differ in dtype"):
        modulated_layer_norm_pair(seg(4, 128), seg(2, 128, dtype=torch.bfloat16))


@pytest.mark.parametrize("segments", [((2, 5),), ((1, 7), (3, 2))], ids=["one", "two"])
@pytest.mark.parametrize("d", [1152, 3072, 72, 64, 96])
def test_modlnorm_launch_plan_covers_each_vector_once(d, segments):
    """The kernel's indexing, walked on the CPU: row group g of n (a group
    is the plan's warps a row) takes rows g, g + n, ... numbered across the
    segments, lane l of the group's 32·G vectors l, l + 32·G, ... of its
    row. Every (segment, sample, token, vector) of a launch is covered
    exactly once, for any number of groups, and the vectors tile a row
    exactly (16 bytes each where the addresses allow it, 8 or one element
    where they do not; a row too wide for the kernel raises)."""
    for elem, offsets in ((2, ()), (4, ()), (2, (8,)), (4, (4,)), (2, (2,))):
        vec = next(w for w in (16, 8, elem)
                   if all(o % w == 0 for o in offsets) and d * elem % w == 0)
        if d * elem // vec > MAX_NV * LANES * GROUPS[-1]:  # too wide
            with pytest.raises(ValueError, match="more than the kernel"):
                launch_plan(d, elem, segments, offsets)
            continue
        plan = launch_plan(d, elem, segments, offsets)
        assert plan.vec_bytes == vec
        assert plan.n_vec * plan.vec_bytes == d * elem
        lanes = LANES * plan.group
        assert plan.group in GROUPS
        assert plan.nv <= MAX_NV and (plan.nv - 1) * lanes < plan.n_vec <= plan.nv * lanes
        want = {(s, b, t, v) for s, (bs, ts) in enumerate(segments)
                for b in range(bs) for t in range(ts) for v in range(plan.n_vec)}
        for n_groups in (1, 3, 4, 8, 1000):
            seen = Counter()
            for group in range(n_groups):
                for row in plan.group_rows(group, n_groups):
                    seg, b, t = plan.locate(row)
                    for lane in range(lanes):
                        seen.update((seg, b, t, v) for v in plan.lane_vectors(lane))
            assert set(seen) == want and set(seen.values()) == {1}


def test_modlnorm_probe_variants_edit_the_current_source():
    """Every edit of `probe_modlnorm.VARIANTS` matches the kernel's source
    as it stands (the probe runs only on the card)."""
    from ecad_tpu_torch.scripts import probe_modlnorm

    src = (_build.CSRC_DIR / "modlnorm_sm90.cu").read_text()
    for name, edits in probe_modlnorm.VARIANTS.items():
        assert probe_modlnorm.variant_source(src, edits) != src, name
    assert set(probe_modlnorm.EXACT) <= set(probe_modlnorm.VARIANTS)


def test_modlnorm_launch_plan_refuses_rows_past_its_registers():
    """A row the kernel's longest register array cannot hold raises (the
    wrapper never falls back): five vectors a lane of eight warps, 10240
    bf16 elements in 16-byte vectors, 1280 in single elements."""
    most = MAX_NV * LANES * GROUPS[-1]
    plan = launch_plan(most * 8, 2, [(1, 1)])
    assert (plan.nv, plan.group) == (MAX_NV, GROUPS[-1]) and most * 8 == 10240
    with pytest.raises(ValueError, match="more than the kernel"):
        launch_plan(most * 8 + 8, 2, [(1, 1)])
    with pytest.raises(ValueError, match="more than the kernel"):
        launch_plan(most + 1, 2, [(1, 1)])


def test_modulated_layer_norm_vs_model_form():
    """The reference *model* computes layer_norm(h)·(1+scale)+shift with the
    norm cast to the hidden dtype first (models/common.py:153); the kernel
    modulates in fp32 and casts once. In fp32 the two agree to rounding. In
    bf16 the model form rounds four times (the normed value, 1+scale, the
    product, the sum) where the kernel rounds once; with intermediates of
    magnitude below 8 here each extra rounding is at most 2^-6 absolute,
    so the two agree within 2^-5 absolute plus 2^-6 relative (about two
    bf16 ulps of the output)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 96), dtype=np.float32)
    scale = rng.standard_normal((2, 1, 96), dtype=np.float32) * 0.5
    shift = rng.standard_normal((2, 1, 96), dtype=np.float32) * 0.5
    for dtype, jdt, tol in (
        (torch.float32, jnp.float32, TOL),
        (torch.bfloat16, jnp.bfloat16, dict(rtol=2**-6, atol=2**-5)),
    ):
        jx, js, jh = (jnp.asarray(a).astype(jdt) for a in (x, scale, shift))
        want = jax_layer_norm(jx) * (1 + js) + jh
        t = [torch.from_numpy(a).to(dtype) for a in (x, scale, shift)]
        got = modulated_layer_norm(*t)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), **tol
        )
        # the port's own model-form helper agrees with the reference's
        np.testing.assert_allclose(
            layer_norm(t[0]).float().numpy(),
            np.asarray(jax_layer_norm(jx), np.float32), **tol,
        )


def test_cpu_path_counts_no_launches():
    """On CPU tensors the wrappers run the plain versions: no kernel launch
    is counted, on any softmax route."""
    before = launch_counts()
    assert set(before) == {
        "attention", "attention_bias", "attention_long", "attention_long_bias",
        "attention_rowblock", "attention_rowblock_bias", "attention_flash",
        "attention_flash_bias", "xattn_matmul_only", "xattn_nomax", "xattn_max",
        "xattn_fd", "modlnorm", "int8_matmul",
    }
    x = torch.randn(2, 4, 8)
    s = torch.zeros(2, 1, 8)
    fused_attention(torch.randn(1, 4, 2, 8), torch.randn(1, 4, 2, 8),
                    torch.randn(1, 4, 2, 8))
    q = torch.randn(1, 1024, 1, 72)  # a clamp-route shape
    fused_attention(q, q, q)
    transposed_attention(q[:, :8], q, q, torch.zeros(1, 1, 1, 1024))
    q = torch.randn(1, 1536, 1, 128)  # a row-block-route shape
    fused_attention(q, q, q)
    rowblock_attention(q[:, :8], q, q, torch.zeros(1, 1, 1, 1536))
    q = torch.randn(1, 1024, 1, 16)
    k = torch.randn(1, 8200, 1, 16)  # past 8192 keys and 8 MiB: the streaming route
    assert attention_route(tuple(q.shape), 8200) == "flash"
    fused_attention(q, k, k)
    flash_attention(q[:, :8], k, k, torch.zeros(1, 1, 1, 8200))
    q = torch.randn(1, 1536, 1, 128, dtype=torch.bfloat16)  # the Hopper body's calls
    rowblock_attention(q, q, q)
    flash_attention(q, q, q)
    fused_attention(q[:, :256], q[:, :256], q[:, :256])
    q = torch.randn(1, 1024, 1, 72, dtype=torch.bfloat16)
    fused_attention(q, q, q)
    fused_attention(q[:, :256], q[:, :256], q[:, :256])
    q = torch.randn(1, 128, 1, 72)  # the attention-variant harness's kernels
    for fn in (matmul_only_attention, nomax_attention, max_exp2_attention,
               clamp_fd_attention):
        fn(q, q, q)
    out = modulated_layer_norm(x, s, s)
    assert launch_counts() == before
    torch.testing.assert_close(out, modulated_layer_norm_reference(x, s, s))


# ---------------------------------------------------------------------------
# the clamp softmax (K4, _transposed_kernel / _transposed_kernel_nobias)
# ---------------------------------------------------------------------------

# fp32: the same function on both sides, only the summation order differs.
# bf16: both sides round q·scale and p to bf16 identically and cast the
# same fp32 result once; the fp32 sums differ in order, so the outputs
# agree within one bf16 ulp.
CLAMP_TOL = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2**-7, atol=2**-7)}


def _key_padding_bias_np(lengths, tk):
    lens = np.asarray(lengths)[:, None, None, None]
    return np.where(np.arange(tk)[None, None, None, :] < lens, 0.0, -1e9).astype(
        np.float32
    )


# the reference's TestTransposedAttention cases (tests/test_ops.py:289-328):
# (b, h, tq, tk, d, bias lengths or None, q scale, monkeypatched constants)
CLAMP_CASES = {
    "multiblock_q_d72": (2, 2, 256, 384, 72, None, 1.0, {"_TRANSPOSED_BLOCK_Q": 128}),
    "multichunk_kv": (2, 2, 128, 512, 72, None, 1.0, {"_TRANSPOSED_MAX_CHUNK": 128}),
    "unaligned_130_300_36": (2, 2, 130, 300, 36, None, 1.0, {}),
    "batch_broadcast_bias": (3, 2, 128, 256, 72, [100], 1.0, {}),
    "per_batch_key_padding": (3, 2, 128, 256, 72, [100, 200, 256], 1.0, {}),
    "q_times_1e4": (1, 1, 128, 256, 72, None, 1e4, {}),
}


def _tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 mantissa bits, to nearest, ties
    away from zero (adding half of the 13 dropped bits to the magnitude)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(np.float32(x) - big)


def _mm_3xtf32(a, b, passes=3):
    """a @ b as the fp32 body takes it on the tensor cores: each operand
    split into big = tf32(x) and small = tf32(x − big), the small products
    summed before the big one, in fp32 (every product of two tf32 values is
    exact in fp32); ``passes=1`` is one plain TF32 product."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    if passes == 1:
        return np.matmul(ab, bb)
    acc = np.matmul(as_, bb)
    acc = acc + np.matmul(ab, bs)
    return acc + np.matmul(ab, bb)


def _emulated_f32_body(q, k, v, bias, route, passes=3, scores=None):
    """The fp32 body's arithmetic in numpy on (B, T, H, D) inputs: q scaled
    in fp32 (1/√D on the exact route, clamp_scale(D, float32) on the clamp
    one), s = q·kᵀ and o = p·v through `_mm_3xtf32` (s through `scores`
    where given), the exact softmax with the route's pad keys of score −1e9
    or the clamp's exp2(clip(s, −100, 80)) with n_pad·2^-100 in Σp."""
    d, tk = q.shape[-1], k.shape[1]
    qh, kh, vh = (np.transpose(a, (0, 2, 1, 3)) for a in (q, k, v))
    n_pad = port_attention.pad_keys(route, tk)
    if scores is None:
        scores = lambda a, b: _mm_3xtf32(a, b, passes)  # noqa: E731
    if route == "exact":
        s = scores(qh * np.float32(1.0 / np.sqrt(d)), np.swapaxes(kh, -1, -2))
        if bias is not None:
            s = s + bias
        m = np.maximum(s.max(-1, keepdims=True), np.float32(-1e9) if n_pad else -np.inf)
        p = np.exp(s - m)
        denom = p.sum(-1, keepdims=True) + np.float32(n_pad) * np.exp(np.float32(-1e9) - m)
    else:
        scale = np.float32(port_attention.clamp_scale(d, torch.float32))
        s = scores(qh * scale, np.swapaxes(kh, -1, -2))
        if bias is not None:
            s = s + bias * np.float32(1.4426950408889634)
        p = np.exp2(np.clip(s, -100, 80))
        denom = p.sum(-1, keepdims=True) + np.float32(n_pad * 2.0 ** -100)
    out = _mm_3xtf32(p.astype(np.float32), vh, passes) / denom
    return np.transpose(out, (0, 2, 1, 3)).astype(np.float32)


# chip_smoke.py's fp32 attention cases: (route, b, tq, tk, h, d, q scale,
# key-padding lengths or None)
TF32X3_CASES = {
    "logits_near_40_d64": ("exact", 1, 16, 256, 1, 64, 6.0, None),
    "logits_near_40_d72": ("exact", 1, 16, 256, 1, 72, 6.0, None),
    "key_padding_100_200_256_tk300_d72": ("exact", 3, 30, 300, 2, 72, 1.0, (100, 200, 256)),
    "key_padding_100_200_256_tk300_d128": ("exact", 3, 30, 300, 2, 128, 1.0, (100, 200, 256)),
    "clamp_key_padding_100_200_256_tk300_d72": ("clamp", 3, 30, 300, 2, 72, 1.0,
                                                (100, 200, 256)),
    "clamp_logits_times_6_d128": ("clamp", 1, 16, 256, 1, 128, 6.0, None),
}


def _emulated_f32_wide_scores(qh, kt, passes=3, chunk=64):
    """q·kᵀ as the fp32 body takes it where it sums partial scores: the head
    dim in `chunk`-column parts (64 in the streamed form past head dim 512,
    128 in the clusters of two, three and four blocks at widths 256, 384 and
    512), each part's three TF32 products (`_mm_3xtf32`) from zero, the
    parts' scores added in fp32 in order (((s0 + s1) + s2) + s3: the
    clusters' rank order, the same in every block)."""
    s = None
    for c in range(0, qh.shape[-1], chunk):
        part = _mm_3xtf32(qh[..., c:c + chunk], kt[..., c:c + chunk, :], passes)
        s = part if s is None else (s + part).astype(np.float32)
    return s


# (route, b, tq, tk, d, q scale, key-padding lengths or None, the columns a
# part of the scores): the streamed form past head dim 512 (64) and the
# clusters at widths 256, 384 and 512 (128: two, three and four blocks, the
# last block's columns past d zeros), at chip_smoke.py's fp32 shapes
TF32X3_WIDE_CASES = {
    "exact_key_padding_d320": ("exact", 3, 30, 300, 320, 1.0, (100, 200, 256), 64),
    "exact_logits_times_6_d512": ("exact", 1, 16, 256, 512, 6.0, None, 64),
    "clamp_key_padding_d320": ("clamp", 3, 30, 300, 320, 1.0, (100, 200, 256), 64),
    "clamp_logits_times_6_d512": ("clamp", 1, 16, 256, 512, 6.0, None, 64),
    "exact_key_padding_d256_halves": ("exact", 3, 30, 300, 256, 1.0, (100, 200, 256), 128),
    "clamp_logits_times_6_d256_halves": ("clamp", 1, 16, 256, 256, 6.0, None, 128),
    "exact_key_padding_d320_three_blocks": ("exact", 3, 30, 300, 320, 1.0, (100, 200, 256), 128),
    "clamp_logits_times_6_d320_three_blocks": ("clamp", 1, 16, 256, 320, 6.0, None, 128),
    "exact_logits_times_6_d512_four_blocks": ("exact", 1, 16, 256, 512, 6.0, None, 128),
    "clamp_key_padding_d512_four_blocks": ("clamp", 3, 30, 300, 512, 1.0, (100, 200, 256), 128),
}


@pytest.mark.parametrize("case", sorted(TF32X3_WIDE_CASES))
def test_3xtf32_streamed_emulation_meets_fp32_tol(case):
    """Two forms of the fp32 body change the order of the scores' fp32 sums
    and not p·v's (o's columns are apart): the streamed form past head dim
    512 (each 64-column chunk of q·kᵀ from zero in accumulators of its own,
    the chunks added in IEEE fp32) and the clusters of two, three and four
    blocks at widths 256, 384 and 512 (each block's 128 columns, the partial
    scores added in fp32 in rank order — the same sum in every block).
    `_emulated_f32_body` with those scores (`_emulated_f32_wide_scores`)
    against the Pallas kernels in interpret mode at head dims 256, 320 and
    512: within chip_smoke.py's FP32_TOL (atol 1e-5, rtol 1e-5); one plain
    TF32 pass misses it."""
    route, b, tq, tk, d, qscale, lengths, chunk = TF32X3_WIDE_CASES[case]
    rng = np.random.default_rng(24)
    q, k, v = _qkv(rng, b, tq, tk, 1, d)
    q = q * np.float32(qscale)
    bias = None if lengths is None else _key_padding_bias_np(lengths, tk)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jbias = None if bias is None else jnp.asarray(bias)
    want = np.asarray(jax_fused_attention(*args, bias=jbias, interpret=True) if route == "exact"
                      else jax_attention._transposed_attention(*args, jbias, interpret=True))
    atol, rtol = _chip_smoke_module().FP32_TOL
    got = _emulated_f32_body(q, k, v, bias, route,
                             scores=lambda a, b_: _emulated_f32_wide_scores(a, b_, 3, chunk))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    one_pass = _emulated_f32_body(q, k, v, bias, route, passes=1,
                                  scores=lambda a, b_: _emulated_f32_wide_scores(a, b_, 1, chunk))
    assert (np.abs(one_pass - want) > atol + rtol * np.abs(want)).any()


@pytest.mark.parametrize("case", sorted(TF32X3_CASES))
def test_3xtf32_emulation_meets_fp32_tol(case):
    """The fp32 body's 3×TF32 products (`_emulated_f32_body`: the rna split,
    three products, fp32 sums) against the Pallas kernels in interpret mode
    on fp32 inputs — `fused_attention` (the exact single-tile route, its
    pad keys to 384) and `_transposed_attention` (the clamp) — at
    chip_smoke.py's fp32 shapes: logits near ±40, key padding [100, 200,
    256] at Tk 300, and the clamp route. Within chip_smoke.py's FP32_TOL
    (atol 1e-5, rtol 1e-5) before the card runs it; one plain TF32 product
    in its place misses that tolerance."""
    route, b, tq, tk, h, d, qscale, lengths = TF32X3_CASES[case]
    rng = np.random.default_rng(23)
    q, k, v = _qkv(rng, b, tq, tk, h, d)
    q = q * np.float32(qscale)
    bias = None if lengths is None else _key_padding_bias_np(lengths, tk)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jbias = None if bias is None else jnp.asarray(bias)
    want = np.asarray(jax_fused_attention(*args, bias=jbias, interpret=True) if route == "exact"
                      else jax_attention._transposed_attention(*args, jbias, interpret=True))
    atol, rtol = _chip_smoke_module().FP32_TOL
    got = _emulated_f32_body(q, k, v, bias, route)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    one_pass = _emulated_f32_body(q, k, v, bias, route, passes=1)
    assert (np.abs(one_pass - want) > atol + rtol * np.abs(want)).any()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CLAMP_CASES))
def test_transposed_reference_matches_pallas(case, dtype, monkeypatch):
    """transposed_attention_reference against _transposed_attention in
    interpret mode, compared by value — also at q×1e4, where every logit
    sits outside the clamp window and the row is near-uniform over the
    keys clamped at 2^80."""
    b, h, tq, tk, d, lengths, qscale, patch = CLAMP_CASES[case]
    for name, value in patch.items():
        monkeypatch.setattr(jax_attention, name, value)
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, b, tq, tk, h, d)
    q = q * np.float32(qscale)
    bias = None if lengths is None else _key_padding_bias_np(lengths, tk)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (
        jnp.bfloat16, torch.bfloat16)
    want = jax_attention._transposed_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)),
        None if bias is None else jnp.asarray(bias), interpret=True,
    )
    got = transposed_attention_reference(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        None if bias is None else torch.from_numpy(bias),
    )
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), **CLAMP_TOL[dtype]
    )
    assert torch.isfinite(got.float()).all()


# ---------------------------------------------------------------------------
# the row-block clamp softmax (K5, _rowblock_kernel / _rowblock_kernel_nobias)
# ---------------------------------------------------------------------------

# the reference's TestRowBlockAttention cases (tests/test_ops.py:125-188),
# with _ROWBLOCK_BLOCK_Q = 16 for several q blocks per (batch, head), and
# the same at the head dim the route serves (128) and at 72: (b, h, tq, tk,
# d, bias lengths or None, q scale)
ROWBLOCK_CASES = {
    "multiblock_q_48_384_d64": (2, 2, 48, 384, 64, None, 1.0),
    "unaligned_30_300_d72": (2, 2, 30, 300, 72, None, 1.0),
    "batch_broadcast_bias_b3": (3, 2, 32, 256, 64, [100], 1.0),
    "logits_times_6": (1, 1, 16, 256, 64, None, 6.0),
    "q_times_1e4": (1, 1, 16, 256, 64, None, 1e4),
    "multiblock_q_48_384_d128": (2, 2, 48, 384, 128, None, 1.0),
    "ragged_tk300_key_padding_d128": (2, 2, 30, 300, 128, [250, 300], 1.0),
    "per_batch_key_padding_d128": (3, 2, 32, 256, 128, [100, 200, 256], 1.0),
    # the reference's padded-head-dim branch (:475-479), which its kernel
    # shoot-out reaches at 72
    "per_batch_key_padding_d72": (3, 2, 30, 300, 72, [100, 200, 256], 1.0),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(ROWBLOCK_CASES))
def test_rowblock_reference_matches_pallas(case, dtype, monkeypatch):
    """rowblock_attention_reference, and the rowblock_attention wrapper on
    the CPU, against _rowblock_attention in interpret mode, compared by
    value — also at logits ×6 and at q×1e4, where every logit sits outside
    the clamp window. Tolerances as for the transposed kernel: the same
    function, sums in another order (the reference's two kv chunks)."""
    b, h, tq, tk, d, lengths, qscale = ROWBLOCK_CASES[case]
    monkeypatch.setattr(jax_attention, "_ROWBLOCK_BLOCK_Q", 16)
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, b, tq, tk, h, d)
    q = q * np.float32(qscale)
    bias = None if lengths is None else _key_padding_bias_np(lengths, tk)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (
        jnp.bfloat16, torch.bfloat16)
    want = jax_attention._rowblock_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)),
        None if bias is None else jnp.asarray(bias), interpret=True,
    )
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    args.append(None if bias is None else torch.from_numpy(bias))
    got = rowblock_attention_reference(*args)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), **CLAMP_TOL[dtype]
    )
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(rowblock_attention(*args), got, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the streaming exact softmax (K6, _flash_kernel)
# ---------------------------------------------------------------------------

# fp32: the same function on both sides, only the summation order differs
# (the reference's online softmax over 128-key blocks here). bf16: both
# sides round p to bf16, the reference against each block's running max,
# the port against the row's max (a different rounding of the same p, of
# relative size 2^-9, averaged over the keys), and cast the fp32 result
# once: at most one flip of the output's last bit, 2^-9 at outputs in
# [0.25, 0.5) (atol = rtol = 1.6e-3 passes every case). The limit, 2e-3,
# stays below what a plain version that keeps p in fp32 (the single-tile
# route's) needs at the key-padding and broadcast-bias cases, 2.4e-3 to
# 2.6e-3: so it pins p's rounding to v's dtype.
FLASH_TOL = {"fp32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-3, atol=2e-3)}

# the reference's TestFlashAttention cases (tests/test_ops.py:58-122), at
# their head dims and again at PixArt's 72 and FLUX's 128, plus q×1e4:
# (b, h, tq, tk, d, bias lengths or None, q scale)
_FLASH_SHAPES = {
    "multiblock_kv_48_384": (2, 2, 48, 384, 64, None),
    "unaligned_tk300": (2, 2, 24, 300, 32, None),
    "key_padding_120_of_256": (2, 2, 32, 256, 64, [120, 120]),
    "batch_broadcast_bias_b3": (3, 2, 32, 256, 64, [100]),
}
FLASH_CASES = {
    f"{name}_d{d}": (b, h, tq, tk, d, lengths, 1.0)
    for name, (b, h, tq, tk, ref_d, lengths) in _FLASH_SHAPES.items()
    for d in (ref_d, 72, 128)
}
FLASH_CASES["q_times_1e4_d72"] = (1, 1, 32, 256, 72, None, 1e4)


def _flash_case(case, dtype, monkeypatch):
    """The case's torch (q, k, v, bias) in `dtype` and _flash_attention's
    output on them in interpret mode, as fp32 numpy, with tiny blocks
    (several q and kv blocks per (batch, head)) and _ROWBLOCK_MAX_KV_ELEMS
    = 0 so that the streaming kernel runs."""
    b, h, tq, tk, d, lengths, qscale = FLASH_CASES[case]
    monkeypatch.setattr(jax_attention, "_ROWBLOCK_MAX_KV_ELEMS", 0)
    monkeypatch.setattr(jax_attention, "_FLASH_BLOCK_Q", 16)
    monkeypatch.setattr(jax_attention, "_FLASH_BLOCK_K", 128)
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, b, tq, tk, h, d)
    q = q * np.float32(qscale)
    bias = None if lengths is None else _key_padding_bias_np(lengths, tk)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (
        jnp.bfloat16, torch.bfloat16)
    want = jax_attention._flash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)),
        None if bias is None else jnp.asarray(bias), interpret=True,
    )
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    args.append(None if bias is None else torch.from_numpy(bias))
    return args, np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_reference_matches_pallas(case, dtype, monkeypatch):
    """flash_attention_reference, and the flash_attention and
    fused_attention wrappers on the CPU, against _flash_attention in
    interpret mode (see _flash_case), compared by value — also at q×1e4,
    where each row is one-hot."""
    args, want = _flash_case(case, dtype, monkeypatch)
    tk = args[1].shape[1]
    got = flash_attention_reference(*args)
    np.testing.assert_allclose(got.float().numpy(), want, **FLASH_TOL[dtype])
    assert torch.isfinite(got.float()).all()
    before = launch_counts()
    torch.testing.assert_close(flash_attention(*args), got, rtol=0, atol=0)
    # the port's router sends the same shape to the streaming route once
    # its thresholds are lowered as the reference's are here
    monkeypatch.setattr(port_attention, "_SINGLE_TILE_SCORE_BYTES", 0)
    monkeypatch.setattr(port_attention, "_ROWBLOCK_MAX_KV_ELEMS", 0)
    assert attention_route(tuple(args[0].shape), tk, args[3]) == "flash"
    torch.testing.assert_close(fused_attention(*args), got, rtol=0, atol=0)
    assert launch_counts() == before


@pytest.mark.parametrize("case", [
    "key_padding_120_of_256_d64", "key_padding_120_of_256_d128",
    "batch_broadcast_bias_b3_d64", "batch_broadcast_bias_b3_d72",
    "batch_broadcast_bias_b3_d128",
])
def test_flash_bf16_tolerance_pins_p_rounding(case, monkeypatch):
    """FLASH_TOL's bf16 limit rejects a plain version that keeps p in fp32
    for p·v (the single-tile route's, fused_attention_reference): the
    streaming route must round p to v's dtype as _flash_kernel does."""
    args, want = _flash_case(case, "bf16", monkeypatch)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(
            fused_attention_reference(*args).float().numpy(), want, **FLASH_TOL["bf16"]
        )


def test_rowblock_attention_rejects_dense_bias():
    q = torch.zeros(2, 4, 2, 128)
    with pytest.raises(ValueError, match="key-padding"):
        rowblock_attention(q, q, q, torch.zeros(2, 2, 4, 4))


@pytest.mark.parametrize("d", [16, 36, 64, 72, 80])
def test_clamp_scale_rounds_like_reference(d):
    """q is pre-scaled by scale·log2e rounded to q's dtype, as the reference
    rounds ``jnp.asarray(scale, q.dtype)``."""
    scale = jax_attention._LOG2E / float(np.sqrt(d))
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        want = float(np.asarray(jnp.asarray(scale, jdt), np.float32))
        assert port_attention.clamp_scale(d, tdt) == want


@pytest.mark.parametrize("case", ["self_q_times_1e4", "cross_key_padding"])
def test_fused_attention_routes_like_reference(case):
    """The port's fused_attention picks the reference's function: at the
    PixArt-512 self-attention class (1, 1024, 1, 72) with q×1e4 the clamp
    softmax is near-uniform over the clamped keys, the max-subtract one
    one-hot (they differ by ≈4 there); and a 2048-query cross-attention to
    120 keys with a key-padding bias takes the clamp route too."""
    rng = np.random.default_rng(6)
    if case == "self_q_times_1e4":
        q, k, v = _qkv(rng, 1, 1024, 1024, 1, 72)
        q = q * np.float32(1e4)
        bias = None
    else:
        q, k, v = _qkv(rng, 2, 2048, 120, 2, 72)
        bias = _key_padding_bias_np([7, 120], 120)
    got, want = _both(q, k, v, bias)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if case == "self_q_times_1e4":
        exact = fused_attention_reference_np(q, k, v)
        assert np.abs(exact - want).max() > 1.0  # the routes compute different functions


def fused_attention_reference_np(q, k, v):
    t = torch.from_numpy
    return fused_attention_reference(t(q), t(k), t(v)).numpy()


def test_routing_constants_match_reference():
    for name in ("_SINGLE_TILE_SCORE_BYTES", "_ROWBLOCK_MAX_KV_ELEMS",
                 "_TRANSPOSED_MIN_SCORE_BYTES", "_LOG2E", "_CLAMP_LO", "_CLAMP_HI"):
        assert getattr(port_attention, name) == getattr(jax_attention, name), name


# (q shape, tk, bias kind) → the reference's route
ROUTES = {
    "pixart256_self": ((16, 256, 16, 72), 256, None, "exact"),
    "pixart256_cross": ((16, 256, 16, 72), 120, "padding", "exact"),
    "pixart512_self": ((16, 1024, 16, 72), 1024, None, "clamp"),
    "pixart512_cross": ((16, 1024, 16, 72), 120, "padding", "exact"),
    "pixart1024_self": ((4, 4096, 16, 72), 4096, None, "clamp"),
    "pixart1024_cross": ((4, 4096, 16, 72), 120, "padding", "clamp"),
    "pixart1024_cross_batch_broadcast": ((4, 4096, 16, 72), 120, "broadcast", "clamp"),
    "pixart1024_dense_bias": ((4, 4096, 16, 72), 4096, "dense", "exact_xla"),
    "pixart2048_self": ((2, 16384, 16, 72), 16384, None, "flash"),
    "flux1024_joint": ((2, 4608, 24, 128), 4608, None, "rowblock"),
    "flux256_joint": ((2, 768, 24, 128), 768, None, "exact"),
    "d128_past_rowblock": ((1, 9000, 1, 128), 9000, None, "flash"),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_attention_route(name):
    shape, tk, kind, want = ROUTES[name]
    b, tq, h, _ = shape
    bias = {
        None: None,
        "padding": torch.zeros(b, 1, 1, tk, device="meta"),
        "broadcast": torch.zeros(1, 1, 1, tk, device="meta"),
        "dense": torch.zeros(b, h, tq, tk, device="meta"),
    }[kind]
    assert attention_route(shape, tk, bias) == want


@pytest.mark.parametrize(
    "shape,tk,error,match",
    [
        ((2, 4608, 2, 128), 4608, ValueError, "unsupported device"),
        ((1, 9000, 1, 128), 9000, ValueError, "unsupported device"),
        ((1, 1024, 1, 72), 1024, ValueError, "unsupported device"),
    ],
)
def test_non_cpu_tensors_never_fall_back(shape, tk, error, match):
    """Off the CPU the router launches a kernel or raises: a tensor on a
    device without a kernel (here FLUX-1024's row-block shape, a
    streaming-route shape past 8192 keys, and a clamp-route shape) raises
    instead of running a plain version."""
    b, tq, h, d = shape
    q = torch.empty(shape, device="meta")
    kv = torch.empty((b, tk, h, d), device="meta")
    with pytest.raises(error, match=match):
        fused_attention(q, kv, kv)


def test_transposed_attention_rejects_dense_bias():
    q = torch.zeros(2, 4, 2, 8)
    with pytest.raises(ValueError, match="key-padding"):
        transposed_attention(q, q, q, torch.zeros(2, 2, 4, 4))


def test_flash_attention_rejects_dense_bias():
    q = torch.zeros(2, 4, 2, 8)
    with pytest.raises(ValueError, match="key-padding"):
        flash_attention(q, q, q, torch.zeros(2, 2, 4, 4))


@pytest.mark.parametrize(
    "shapes",
    [
        ((1, 4, 2, 8), (1, 5, 2, 8), (1, 6, 2, 8)),  # k/v mismatch
        ((1, 4, 2, 8), (2, 4, 2, 8), (2, 4, 2, 8)),  # batch mismatch
        ((1, 4, 2, 136), (1, 4, 2, 128), (1, 4, 2, 128)),  # head dim mismatch
    ],
)
def test_attention_rejects_bad_shapes(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        fused_attention(q, k, v)


# ---------------------------------------------------------------------------
# head dims past 128 and odd head dims: the reference pads D to round_up(D,
# 128) (or 16 on the clamp transposed route) and computes; so do the plain
# versions, on every route, as the card's kernels do up to 256
# ---------------------------------------------------------------------------

# name → (route, q shape, tk, bias kind): each route at a shape that
# reaches it (the exact one at the reference's odd tq 30, tk 300, with no
# bias, a key-padding bias per batch at [100, 200, 256] of 300 keys (a
# third batch entry broadcasts it) and a dense one)
WIDE_CASES = {
    **{f"exact{tag}_d{d}": ("exact", (3, 30, 2, d), 300, bias)
       for d in (160, 256)
       for tag, bias in (("", None), ("_key_padding", "padding"), ("_dense", "dense"))},
    "clamp_d160": ("clamp", (1, 512, 1, 160), 512, None),
    "rowblock_d256": ("rowblock", (1, 1536, 1, 256), 1536, None),
    **{f"flash_d{d}": ("flash", (1, 512, 1, d), 4224, None) for d in (160, 256)},
}
# bf16 on each route as its own parity tests hold it: one bf16 ulp (the
# exact and clamp routes), and p's other rounding on the streaming one
WIDE_TOL = {"fp32": dict(rtol=2e-5, atol=2e-5),
            "bf16": {"exact": dict(rtol=2**-7, atol=2**-7), "clamp": CLAMP_TOL["bf16"],
                     "rowblock": CLAMP_TOL["bf16"], "flash": dict(rtol=2e-3, atol=2e-3)}}


def _wide_inputs(rng, shape, tk, bias_kind):
    b, tq, h, d = shape
    q, k, v = _qkv(rng, b, tq, tk, h, d)
    bias = {None: None, "padding": _key_padding([100, 200, 256], tk),
            "dense": rng.standard_normal((b, h, tq, tk), dtype=np.float32)}[bias_kind]
    return q, k, v, bias


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_attention_past_head_dim_128_matches_pallas(case, dtype):
    """Head dims 160 and 256, which the port's wrappers refused before and
    the reference computes (padding D to 256): `fused_attention` on the CPU
    against the JAX package's in interpret mode on each route a shape
    reaches — exact (no bias, key padding, dense bias), clamp at 160,
    row-block at 256, streaming past 8192×128 key elements — in fp32 and
    bf16."""
    route, shape, tk, bias_kind = WIDE_CASES[case]
    rng = np.random.default_rng(60)
    q, k, v, bias = _wide_inputs(rng, shape, tk, bias_kind)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    want = jax_fused_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                               bias=None if bias is None else jnp.asarray(bias), interpret=True)
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    tbias = None if bias is None else torch.from_numpy(bias)
    assert attention_route(tuple(args[0].shape), tk, tbias) == route
    got = fused_attention(*args, tbias)
    assert got.dtype == tdt and got.shape == shape
    tol = WIDE_TOL["fp32"] if dtype == "fp32" else WIDE_TOL["bf16"][route]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# name → (route, q shape, tk, bias kind) past head dim 256, where the
# card runs the streamed forms: each route at a shape that reaches it — the
# exact one (no bias, key padding, dense) at every head dim, the clamp one
# at 264 and 320 (a 1 MiB score tile, D % 128 ≠ 0), the row-block one at
# 384 and 512 (past the 8 MiB tile, D % 128 = 0), the streaming one at 320
# and 512 (past 8192×128 key elements)
WIDER_CASES = {
    **{f"exact{tag}_d{d}": ("exact", (3, 30, 2, d), 300, bias)
       for d in (264, 320, 384, 512)
       for tag, bias in (("", None), ("_key_padding", "padding"), ("_dense", "dense"))},
    **{f"clamp_d{d}": ("clamp", (1, 512, 1, d), 512, None) for d in (264, 320)},
    **{f"rowblock_d{d}": ("rowblock", (1, 1536, 1, d), 1536, None) for d in (384, 512)},
    **{f"flash_d{d}": ("flash", (1, 512, 1, d), 4224, None) for d in (320, 512)},
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(WIDER_CASES))
def test_attention_past_head_dim_256_matches_pallas(case, dtype):
    """Head dims 264, 320, 384 and 512, which the port's kernels refused
    before and the reference computes (padding D to a multiple of 128):
    `fused_attention` on the CPU against the JAX package's in interpret mode
    on each route a shape reaches — exact (no bias, key padding, dense
    bias), clamp, row-block, streaming — in fp32 and bf16, within
    `WIDE_TOL`."""
    route, shape, tk, bias_kind = WIDER_CASES[case]
    rng = np.random.default_rng(62)
    q, k, v, bias = _wide_inputs(rng, shape, tk, bias_kind)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    want = jax_fused_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                               bias=None if bias is None else jnp.asarray(bias), interpret=True)
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    tbias = None if bias is None else torch.from_numpy(bias)
    assert attention_route(tuple(args[0].shape), tk, tbias) == route
    got = fused_attention(*args, tbias)
    assert got.dtype == tdt and got.shape == shape
    tol = WIDE_TOL["fp32"] if dtype == "fp32" else WIDE_TOL["bf16"][route]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("route", ["exact", "clamp"])
@pytest.mark.parametrize("d", [8, 20, 36, 48, 80, 100])
def test_attention_at_odd_head_dims_matches_pallas(d, route, dtype):
    """Head dims the Hopper bodies run at a wider built width (columns past
    D zero), in bf16 at 20, 36 and 100 through a padded copy of the
    operands (rows not a multiple of 16 bytes): the plain versions the
    wrappers run on the CPU against the JAX package in interpret mode at
    the reference's odd shape (tq 30, tk 300) with a key-padding bias —
    `fused_attention` on the exact single-tile route, `transposed_attention`
    against `_transposed_attention` on the clamp one."""
    rng = np.random.default_rng(61 + d)
    q, k, v, bias = _wide_inputs(rng, (3, 30, 2, d), 300, "padding")
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)]
    if route == "exact":
        want = jax_fused_attention(*jargs, bias=jnp.asarray(bias), interpret=True)
        port = fused_attention
    else:
        want = jax_attention._transposed_attention(*jargs, jnp.asarray(bias), interpret=True)
        port = transposed_attention
    got = port(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), torch.from_numpy(bias))
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == "fp32" else dict(rtol=2**-7, atol=2**-7))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_attention_rejects_bias_that_does_not_broadcast():
    q = torch.zeros(2, 4, 2, 8)
    with pytest.raises(ValueError):
        fused_attention(q, q, q, torch.zeros(2, 1, 1, 5))
    # an additive bias, not a boolean keep-mask
    with pytest.raises(TypeError):
        fused_attention(q, q, q, torch.ones(2, 1, 1, 4, dtype=torch.bool))


# ---------------------------------------------------------------------------
# fully clamped rows: the reference's pad keys on the clamp routes (K4, K5)
# ---------------------------------------------------------------------------


def _text_bias_np(lengths, tk):
    """The models' text bias, (1 − mask)·−10000 (models/pixart.py:305-306),
    as a (B, 1, 1, Tk) key-padding bias; a length of 0 masks every key."""
    lens = np.asarray(lengths)[:, None, None, None]
    return np.where(np.arange(tk)[None, None, None, :] < lens, 0.0, -10000.0).astype(
        np.float32
    )


def _clamp_without_pad_keys(q, k, v, bias):
    """The clamp plain version as it was before the repair: Σp over the Tk
    real keys only."""
    qs = q * torch.tensor(port_attention.clamp_scale(q.shape[-1], q.dtype), dtype=q.dtype)
    s = qs.float().permute(0, 2, 1, 3) @ k.float().permute(0, 2, 3, 1)
    s = s + bias.float() * port_attention._LOG2E
    p = torch.exp2(s.clamp(port_attention._CLAMP_LO, port_attention._CLAMP_HI))
    out = (p.to(v.dtype).float() @ v.float().permute(0, 2, 1, 3)) / p.sum(-1, keepdim=True)
    return out.to(q.dtype).permute(0, 2, 1, 3)


# route → (the reference's wrapper, the port's plain version, b, h, tq, tk,
# d, text lengths): batch 0's text mask keeps no key, so every logit of
# its rows clamps at −100 and each of the Tk real keys and the reference's
# Tk_pad − Tk pad keys weighs 2^-100
CLAMPED_ROWS = {
    "transposed_k4_tk120_d72": ("_transposed_attention", transposed_attention_reference,
                                2, 2, 16, 120, 72, [0, 60]),
    "rowblock_k5_tk300_d128": ("_rowblock_attention", rowblock_attention_reference,
                               2, 2, 16, 300, 128, [0, 250]),
}


def _clamped_case(case, dtype):
    ref_name, plain, b, h, tq, tk, d, lengths = CLAMPED_ROWS[case]
    rng = np.random.default_rng(31)
    q, k, v = _qkv(rng, b, tq, tk, h, d)
    bias = _text_bias_np(lengths, tk)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (
        jnp.bfloat16, torch.bfloat16)
    want = getattr(jax_attention, ref_name)(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(bias), interpret=True)
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)] + [torch.from_numpy(bias)]
    return plain, args, np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CLAMPED_ROWS))
def test_clamp_routes_match_reference_in_fully_clamped_rows(case, dtype):
    """An all-masked text row on the clamp routes: the reference divides
    by Tk_pad = round_up(Tk, 128) keys of 2^-100 (its pad keys' v rows are
    0), so its output is Σv/Tk_pad; the plain version, which adds the pad
    keys' (Tk_pad − Tk)·2^-100 to Σp, matches it there and in the
    partly masked batch row."""
    plain, args, want = _clamped_case(case, dtype)
    got = plain(*args)
    np.testing.assert_allclose(got.float().numpy(), want, **CLAMP_TOL[dtype])
    tk = args[1].shape[1]
    mean_v = args[2].float().sum(1, keepdim=True) / port_attention._round_up(tk, 128)
    np.testing.assert_allclose(want[0], mean_v[0].expand_as(got[0]).numpy(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CLAMPED_ROWS))
def test_clamp_plain_version_without_pad_keys_fails_fully_clamped_rows(case, dtype):
    """The plain version before the repair divided by Tk: in the all-masked
    row it is the reference times Tk_pad/Tk (128/120 at Tk=120, 384/300 at
    Tk=300), which the tolerance rejects; in the partly masked row it
    agrees."""
    _, args, want = _clamped_case(case, dtype)
    old = _clamp_without_pad_keys(*args).float().numpy()
    tk = args[1].shape[1]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(old, want, **CLAMP_TOL[dtype])
    np.testing.assert_allclose(old[1], want[1], **CLAMP_TOL[dtype])
    ratio = port_attention._round_up(tk, 128) / tk
    np.testing.assert_allclose(old[0], want[0] * ratio, rtol=1e-2, atol=1e-2)


# case → (route, Tk, the caller bias on batch 0's keys — on all of them at
# −1e9 and below, on the last 50 above it — and the reference's pad keys
# n_pad there): batch 1 keeps a ragged key-padding bias (its last 20 keys
# at −10000), where the pad keys weigh 0
EXACT_PAD_CASES = {
    "single_tile_k2": ("single", 300, -1e9, 84),
    "flash_k6": ("flash", 300, -1e9, 84),
    "single_tile_minus_2e9": ("single", 300, -2e9, 84),
    "flash_minus_2e9": ("flash", 300, -2e9, 84),
    "single_tile_ragged_above_minus_1e9": ("single", 300, -1e4, 84),
    "flash_ragged_above_minus_1e9": ("flash", 300, -1e4, 84),
    # two 1536-key blocks: the streaming route pads 1600 keys to 3072
    "flash_two_key_blocks": ("flash", 1600, -1e9, 1472),
}


@pytest.mark.parametrize("case", sorted(EXACT_PAD_CASES))
def test_exact_routes_pad_keys_under_a_minus_1e9_bias(case, monkeypatch):
    """The exact routes pad Tk with keys of score −1e9 whose rows of v are
    0: round_up(Tk, 128) on the single-tile route, a multiple of min(1536,
    round_up(Tk, 128)) on the streaming one. Where a caller's bias puts
    every real key of a row at −1e9 too, every score rounds to −1e9 and the
    reference's output is Σv/Tk_pad; below −1e9 the pad keys win and it is
    0; a bias above −1e9 leaves them at weight 0. The plain versions add
    the same pad keys and agree with the reference's kernels (interpret
    mode) in every row."""
    route, tk, fill, n_pad = EXACT_PAD_CASES[case]
    rng = np.random.default_rng(32)
    q, k, v = _qkv(rng, 2, 8, tk, 1, 64)
    bias = np.zeros((2, 1, 1, tk), np.float32)
    bias[0, ..., 0 if fill <= -1e9 else tk - 50:] = fill
    bias[1, ..., tk - 20:] = -10000.0
    if route == "flash":
        monkeypatch.setattr(jax_attention, "_ROWBLOCK_MAX_KV_ELEMS", 0)
        want = jax_attention._flash_attention(
            *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(bias), interpret=True)
        got = flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    else:
        want = jax_fused_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   bias=jnp.asarray(bias), interpret=True)
        got = fused_attention_reference(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # what the reference gives in batch 0's rows
    if fill == -1e9:
        row0 = np.broadcast_to(v[:1].sum(axis=1, keepdims=True) / (tk + n_pad), want[:1].shape)
    elif fill == -2e9:
        row0 = np.zeros_like(want[:1])
    else:  # the softmax over the real keys alone, in float64
        sc = np.einsum("qd,kd->qk", q[0, :, 0], k[0, :, 0]).astype(np.float64) / 8.0
        w = np.exp(sc + bias[0, 0] - (sc + bias[0, 0]).max(-1, keepdims=True))
        row0 = ((w / w.sum(-1, keepdims=True)) @ v[0, :, 0])[None, :, None]
    np.testing.assert_allclose(want[:1], row0, rtol=1e-5, atol=1e-5)


def _exact_without_pad_keys(q, k, v, bias):
    """The single-tile plain version as it was before the repair: the
    softmax over the Tk real keys only."""
    s = (q.permute(0, 2, 1, 3) / q.shape[-1] ** 0.5) @ k.permute(0, 2, 3, 1) + bias
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return ((p @ v.permute(0, 2, 1, 3)) / p.sum(-1, keepdim=True)).permute(0, 2, 1, 3)


@pytest.mark.parametrize("fill", [-1e9, -2e9])
def test_exact_plain_version_without_pad_keys_fails_minus_1e9_rows(fill):
    """Before the repair the plain version gave Σv/Tk in a row whose every
    key has a caller bias of −1e9 (the reference: Σv/Tk_pad, 300 against
    384 keys) or −2e9 (the reference: 0): the test's tolerance rejects it
    there and passes it in the ragged row."""
    rng = np.random.default_rng(33)
    q, k, v = _qkv(rng, 2, 8, 300, 1, 64)
    bias = np.zeros((2, 1, 1, 300), np.float32)
    bias[0] = fill
    bias[1, ..., 280:] = -10000.0
    want = np.asarray(jax_fused_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                          bias=jnp.asarray(bias), interpret=True))
    old = _exact_without_pad_keys(*(torch.from_numpy(a) for a in (q, k, v, bias))).numpy()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(old[:1], want[:1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(old[1:], want[1:], rtol=1e-5, atol=1e-5)


def _dense_past_the_tile(dtype):
    """(1, 2048, 2, 72) queries to 1100 keys with a dense (1, 2, 2048, 1100)
    fp32 bias: a 9.4 MB score tile, past the reference's 8 MiB single tile,
    so the reference calls XLA (ecad_tpu/ops/attention.py:701-707), which
    adds no pad keys. Rows 0-7 of each head have a bias of −1e9 at every
    key, rows 8-15 one of −2e9. Returns the torch (q, k, v, bias) and the
    reference's output."""
    rng = np.random.default_rng(51)
    q, k, v = _qkv(rng, 1, 2048, 1100, 2, 72)
    bias = rng.standard_normal((1, 2, 2048, 1100), dtype=np.float32)
    bias[:, :, :8] = -1e9
    bias[:, :, 8:16] = -2e9
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (
        jnp.bfloat16, torch.bfloat16)
    want = jax_fused_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                               bias=jnp.asarray(bias), interpret=True)
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)] + [torch.from_numpy(bias)]
    return args, np.asarray(want, np.float32)


# fp32: only the order of the fp32 sums differs (≤ 1.1e-6 measured). bf16:
# XLA normalises p in fp32 and rounds it to v's dtype before p·v
# (jax._src.nn.functions._dot_product_attention_core), where the port keeps
# p in fp32 and divides at the end, as its kernel does: each weight differs
# by up to 2^-9 relative, which moves an output by up to 2^-9 of Σ p|v|
# beside its own rounding — measured ≤ 6.6e-4 beyond 2^-7 relative, at an
# output std of 0.08
DENSE_XLA_TOL = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2**-7, atol=2e-3)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dense_bias_past_the_tile_adds_no_pad_keys(dtype):
    """A dense bias past the single tile takes the reference's XLA route
    ("exact_xla"): no pad keys, so a row whose every key has a bias of −1e9
    or −2e9 is uniform over its Tk keys, Σv/Tk, on both sides (the
    single-tile route's 52 pad keys would give Σv/1152 and 0); the port's
    fused_attention matches the reference within DENSE_XLA_TOL."""
    args, want = _dense_past_the_tile(dtype)
    assert attention_route(tuple(args[0].shape), 1100, args[3]) == "exact_xla"
    assert port_attention.pad_keys("exact_xla", 1100) == 0
    got = fused_attention(*args).float().numpy()
    np.testing.assert_allclose(got, want, **DENSE_XLA_TOL[dtype])
    mean_v = args[2].float().mean(1, keepdim=True).expand(1, 16, 2, 72).numpy()
    for side in (got, want):
        np.testing.assert_allclose(side[:, :16], mean_v, rtol=2**-7, atol=1e-6)


def test_exact_plain_version_with_pad_keys_fails_dense_rows_past_the_tile():
    """Before the repair the plain version (and the kernel) added the
    single-tile route's round_up(Tk, 128) − Tk = 52 pad keys on the XLA
    route too: it gives Σv/1152 in the −1e9 rows and 0 in the −2e9 ones,
    which the test's tolerance rejects; in the other rows it agrees."""
    args, want = _dense_past_the_tile("fp32")
    old = fused_attention_reference(*args).numpy()
    assert port_attention.pad_keys("exact", 1100) == 52
    for rows in (slice(0, 8), slice(8, 16)):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(old[:, rows], want[:, rows], **DENSE_XLA_TOL["fp32"])
    assert float(np.abs(old[:, 8:16]).max()) == 0.0
    np.testing.assert_allclose(old[:, 16:], want[:, 16:], **DENSE_XLA_TOL["fp32"])


# ---------------------------------------------------------------------------
# the Hopper body (csrc/attention_sm90.cu): routing and TMA arguments
# ---------------------------------------------------------------------------

# (wrapper, q shape, tk, dtype, bias) → the launch it takes: ("sm90",
# counter; ``_bias`` where it takes a bias) or ("mma", variant of
# csrc/attention.cu). A bias is "padding" (B, 1, 1, Tk), "broadcast" (1, 1,
# 1, Tk) or "dense" (B, H, Tq, Tk).
HOPPER_ROUTES = {
    "flux1024_rowblock": ("fused", (1, 4608, 24, 128), 4608, "bf16", None,
                          ("sm90", "attention_rowblock")),
    "flux1536_flash": ("fused", (1, 9728, 24, 128), 9728, "bf16", None,
                       ("sm90", "attention_flash")),
    "flux256_exact_k1": ("fused", (4, 768, 24, 128), 768, "bf16", None,
                         ("sm90", "attention")),
    "pixart256_exact_k1_d72": ("fused", (16, 256, 16, 72), 256, "bf16", None,
                               ("sm90", "attention")),
    "pixart1024_clamp_k4_d72": ("fused", (4, 4096, 16, 72), 4096, "bf16", None,
                                ("sm90", "attention_long")),
    "exact_ragged_d72": ("fused", (2, 30, 2, 72), 300, "bf16", None, ("sm90", "attention")),
    "exact_key_padding_k2": ("fused", (16, 256, 16, 72), 120, "bf16", "padding",
                             ("sm90", "attention_bias")),
    "exact_key_padding_d128": ("fused", (2, 30, 2, 128), 300, "bf16", "padding",
                               ("sm90", "attention_bias")),
    "exact_batch_broadcast_bias_d72": ("fused", (3, 30, 2, 72), 300, "bf16", "broadcast",
                                       ("sm90", "attention_bias")),
    "pixart512_cross_k2": ("fused", (16, 1024, 16, 72), 120, "bf16", "padding",
                           ("sm90", "attention_bias")),
    "exact_dense_bias_d72": ("fused", (2, 30, 2, 72), 300, "bf16", "dense",
                             ("sm90", "attention_bias")),
    # any bias that is not a key-padding one, on the single-tile route, at
    # each head dim the Hopper body is built for: a dense (B, H, Tq, Tk), a
    # per-head (1, H, 1, Tk) and a per-query-row (B, 1, Tq, Tk) bias
    **{f"single_tile_{kind}_bias_d{d}": ("fused", (2, 30, 2, d), 300, "bf16", kind,
                                   ("sm90", "attention_bias"))
       for d in (64, 72, 128) for kind in ("dense", "per_head", "per_query")},
    # the XLA route of a dense bias past the single tile takes the same kernel
    "exact_xla_dense_bias_d64": ("fused", (2, 4096, 2, 64), 4096, "bf16", "dense",
                                 ("sm90", "attention_bias")),
    # a head dim between the built widths runs at the next one up
    "exact_dense_bias_d36": ("fused", (2, 30, 2, 36), 300, "bf16", "dense",
                             ("sm90", "attention_bias")),
    # the narrow widths, a head dim whose rows TMA cannot map (a copy), and
    # past 128
    "exact_d16": ("fused", (2, 30, 2, 16), 300, "bf16", None, ("sm90", "attention")),
    "pixart256_shape_exact_d32": ("fused", (16, 256, 16, 32), 256, "bf16", None,
                                  ("sm90", "attention")),
    "exact_d36_rows_72_bytes": ("fused", (16, 256, 16, 36), 256, "bf16", None,
                                ("sm90", "attention")),
    "exact_key_padding_d256": ("fused", (2, 30, 2, 256), 300, "bf16", "padding",
                               ("sm90", "attention_bias")),
    "rowblock_d256": ("fused", (1, 1536, 1, 256), 1536, "bf16", None,
                      ("sm90", "attention_rowblock")),
    "clamp_d160": ("fused", (4, 4096, 8, 160), 4096, "bf16", None, ("sm90", "attention_long")),
    "flash_d256": ("fused", (1, 4608, 12, 256), 4608, "bf16", None,
                   ("sm90", "attention_flash")),
    "exact_fp32_d160": ("fused", (2, 30, 2, 160), 300, "fp32", "dense",
                        ("f32", "attention_bias")),
    "flash_fp32_d256": ("fused", (1, 512, 1, 256), 4224, "fp32", None,
                        ("f32", "attention_flash")),
    "transposed_fp32_d256": ("transposed", (2, 30, 2, 256), 300, "fp32", "padding",
                             ("f32", "attention_long_bias")),
    "exact_key_padding_fp32": ("fused", (2, 30, 2, 72), 300, "fp32", "padding",
                               ("f32", "attention_bias")),
    "exact_key_padding_d64": ("fused", (2, 30, 2, 64), 300, "bf16", "padding",
                              ("sm90", "attention_bias")),
    "exact_fp32_d72": ("fused", (2, 30, 2, 72), 300, "fp32", None, ("f32", "attention")),
    "exact_d64": ("fused", (2, 30, 2, 64), 300, "bf16", None, ("sm90", "attention")),
    "exact_fp32_d64": ("fused", (2, 30, 2, 64), 300, "fp32", None, ("f32", "attention")),
    # fp32 on the fp32 body at the tiny test doubles' head dims, with a dense
    # bias (the single-tile route takes any bias there), at a head dim
    # between its widths and on rows TMA cannot map (a copy)
    "exact_fp32_d16": ("fused", (2, 30, 2, 16), 300, "fp32", None, ("f32", "attention")),
    "exact_fp32_d32": ("fused", (2, 30, 2, 32), 300, "fp32", None, ("f32", "attention")),
    "flash_fp32_d32": ("flash", (1, 8464, 2, 32), 8464, "fp32", None,
                       ("f32", "attention_flash")),
    "exact_dense_bias_fp32_d72": ("fused", (2, 30, 2, 72), 300, "fp32", "dense",
                                  ("f32", "attention_bias")),
    "exact_fp32_misaligned_rows_d72": ("fused", (2, 30, 2, 72), 300, "fp32_rows_292_bytes",
                                       None, ("f32", "attention")),
    "transposed_fp32_misaligned_rows_d72": ("transposed", (2, 30, 2, 72), 300,
                                            "fp32_rows_292_bytes", None,
                                            ("f32", "attention_long")),
    "exact_fp32_d36": ("fused", (2, 130, 2, 36), 300, "fp32", None, ("f32", "attention")),
    "transposed_fp32_d36": ("transposed", (2, 130, 2, 36), 300, "fp32", None,
                            ("f32", "attention_long")),
    # the reference's width-reduced FLUX (dim 1536, head dim 64) at 256²:
    # forced onto the single-tile route (K1, K2 with a bias) on the Hopper
    # body; the router sends the same shape to the clamp (K4), on the Hopper
    # body too
    "single_tile_flux256_dim1536_d64": ("single", (8, 768, 24, 64), 768, "bf16", None,
                                        ("sm90", "attention")),
    "single_tile_key_padding_flux256_dim1536_d64": ("single", (8, 768, 24, 64), 768, "bf16",
                                                    "padding", ("sm90", "attention_bias")),
    "flux256_dim1536_clamp_d64": ("fused", (8, 768, 24, 64), 768, "bf16", None,
                                  ("sm90", "attention_long")),
    "transposed_d64": ("transposed", (2, 30, 2, 64), 300, "bf16", None,
                       ("sm90", "attention_long")),
    "transposed_key_padding_d64": ("transposed", (2, 30, 2, 64), 300, "bf16", "padding",
                                   ("sm90", "attention_long_bias")),
    "flash_d64_through_the_router": ("fused", (1, 9728, 24, 64), 9728, "bf16", None,
                                     ("sm90", "attention_flash")),
    "transposed_key_padding": ("transposed", (4, 4096, 16, 72), 120, "bf16", "padding",
                               ("sm90", "attention_long_bias")),
    "pixart1024_cross_k4_bias": ("fused", (4, 4096, 16, 72), 120, "bf16", "padding",
                                 ("sm90", "attention_long_bias")),
    "pixart2048_cross_k4_bias": ("fused", (2, 16384, 16, 72), 120, "bf16", "padding",
                                 ("sm90", "attention_long_bias")),
    "transposed_batch_broadcast_bias_d128": ("transposed", (3, 30, 2, 128), 300, "bf16",
                                             "broadcast", ("sm90", "attention_long_bias")),
    "transposed_key_padding_fp32": ("transposed", (2, 30, 2, 72), 300, "fp32", "padding",
                                    ("f32", "attention_long_bias")),
    "transposed_key_padding_d36": ("transposed", (2, 30, 2, 36), 300, "bf16", "padding",
                                   ("sm90", "attention_long_bias")),
    "transposed_fp32": ("transposed", (2, 30, 2, 72), 300, "fp32", None,
                        ("f32", "attention_long")),
    "transposed_d36": ("transposed", (2, 30, 2, 36), 300, "bf16", None,
                       ("sm90", "attention_long")),
    "rowblock_key_padding": ("rowblock", (2, 30, 2, 128), 300, "bf16", "padding",
                             ("sm90", "attention_rowblock_bias")),
    "rowblock_key_padding_d64": ("rowblock", (2, 30, 2, 64), 300, "bf16", "padding",
                                 ("sm90", "attention_rowblock_bias")),
    "rowblock_key_padding_d72": ("rowblock", (2, 30, 2, 72), 300, "bf16", "padding",
                                 ("sm90", "attention_rowblock_bias")),
    "rowblock_batch_broadcast_bias_d72": ("rowblock", (3, 30, 2, 72), 300, "bf16",
                                          "broadcast", ("sm90", "attention_rowblock_bias")),
    "rowblock_key_padding_fp32": ("rowblock", (2, 30, 2, 128), 300, "fp32", "padding",
                                  ("f32", "attention_rowblock_bias")),
    "flash_key_padding": ("flash", (2, 30, 2, 128), 300, "bf16", "padding",
                          ("sm90", "attention_flash_bias")),
    "flash_key_padding_d72": ("flash", (2, 30, 2, 72), 300, "bf16", "padding",
                              ("sm90", "attention_flash_bias")),
    "flash_batch_broadcast_bias_d72": ("flash", (3, 30, 2, 72), 300, "bf16", "broadcast",
                                       ("sm90", "attention_flash_bias")),
    "flash_key_padding_fp32_d72": ("flash", (2, 30, 2, 72), 300, "fp32", "padding",
                                   ("f32", "attention_flash_bias")),
    "flash_key_padding_d64": ("flash", (2, 30, 2, 64), 300, "bf16", "padding",
                              ("sm90", "attention_flash_bias")),
    "pixart2048_flash_key_padding": ("fused", (2, 16384, 16, 72), 16384, "bf16", "padding",
                                     ("sm90", "attention_flash_bias")),
    "flux1536_flash_key_padding_d128": ("fused", (1, 9728, 24, 128), 9728, "bf16", "padding",
                                        ("sm90", "attention_flash_bias")),
    "rowblock_fp32": ("rowblock", (2, 30, 2, 128), 300, "fp32", None,
                      ("f32", "attention_rowblock")),
    "flash_fp32": ("flash", (2, 30, 2, 128), 300, "fp32", None, ("f32", "attention_flash")),
    "flash_fp32_d72": ("flash", (2, 30, 2, 72), 300, "fp32", None, ("f32", "attention_flash")),
    "flash_d72": ("flash", (2, 30, 2, 72), 300, "bf16", None, ("sm90", "attention_flash")),
    "flash_d64": ("flash", (2, 30, 2, 64), 300, "bf16", None, ("sm90", "attention_flash")),
    "rowblock_d64": ("rowblock", (2, 30, 2, 64), 300, "bf16", None,
                     ("sm90", "attention_rowblock")),
    # the kernel shoot-out's row-block row at PixArt-1024's width
    # (scripts/bench_attention_kernels.py `pixart1024`)
    "rowblock_d72": ("rowblock", (8, 4096, 16, 72), 4096, "bf16", None,
                     ("sm90", "attention_rowblock")),
    "rowblock_d36": ("rowblock", (2, 30, 2, 36), 300, "bf16", None,
                     ("sm90", "attention_rowblock")),
    "rowblock_fp32_d72": ("rowblock", (2, 30, 2, 72), 300, "fp32", None,
                          ("f32", "attention_rowblock")),
    "rowblock_key_padding_d128": ("fused", (1, 4608, 24, 128), 4608, "bf16", "padding",
                                  ("sm90", "attention_rowblock_bias")),
    # past head dim 256: the streamed forms, any bias a route takes
    "exact_dense_d320": ("fused", (2, 30, 2, 320), 300, "bf16", "dense",
                         ("sm90", "attention_bias")),
    "flash_key_padding_fp32_d512": ("flash", (2, 30, 2, 512), 300, "fp32", "padding",
                                    ("f32", "attention_flash_bias")),
    "rowblock_d384": ("fused", (1, 1536, 1, 384), 1536, "bf16", None,
                      ("sm90", "attention_rowblock")),
    "transposed_d72": ("transposed", (2, 30, 2, 72), 300, "bf16", None,
                       ("sm90", "attention_long")),
    "pixart2048_flash_d72": ("fused", (2, 16384, 16, 72), 16384, "bf16", None,
                             ("sm90", "attention_flash")),
}


@pytest.mark.parametrize("name", sorted(HOPPER_ROUTES))
def test_hopper_body_routing(name, monkeypatch):
    """bf16 calls without a bias at any head dim up to 256 on the
    single-tile exact (K1), transposed clamp (K4), row-block clamp (K5) and
    streaming (K6) routes launch the Hopper body, and so do bf16 calls with
    a key-padding bias on each of them (K2, and K4, K5 and K6 with a bias),
    the bias passed on, and bf16 calls with any other bias (dense, per head,
    per query row) on the single-tile route and on the XLA route of a dense
    bias past the tile; fp32 calls at any head dim up to 256, in any strides
    (fp32 rows 292 bytes apart too), launch the fp32 body on every route,
    with any bias the route takes (a dense one on the single-tile route); no
    call keeps a csrc/attention.cu variant. Tensors on the meta device reach
    the launch decision without a card; the launchers are replaced by
    recorders."""
    wrapper, shape, tk, dtype, bias_kind, want = HOPPER_ROUTES[name]
    calls = []

    def sm90(q, k, v, counter, bias=None, n_pad=0):
        calls.append(("sm90", counter if bias is None else counter + "_bias"))

    monkeypatch.setattr(port_attention, "_launch_sm90", sm90)
    monkeypatch.setattr(port_attention, "_launch_f32",
                        lambda q, k, v, counter, bias, n_pad: calls.append(
                            ("f32", counter if bias is None else counter + "_bias")))
    monkeypatch.setattr(port_attention, "_launch",
                        lambda q, k, v, bias, variant, n_pad: calls.append(("mma", variant)))
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    b, tq, h, d = shape
    # rows 292 bytes apart: a head dim of 72 floats cut from rows of 73
    width = d + 1 if dtype == "fp32_rows_292_bytes" else d
    q = torch.empty((b, tq, h, width), dtype=tdt, device="meta")[..., :d]
    kv = torch.empty((b, tk, h, width), dtype=tdt, device="meta")[..., :d]
    bias = {None: None, "padding": (b, 1, 1, tk), "broadcast": (1, 1, 1, tk),
            "dense": (b, h, tq, tk), "per_head": (1, h, 1, tk),
            "per_query": (b, 1, tq, tk)}[bias_kind]
    bias = bias and torch.zeros(bias, dtype=tdt, device="meta")
    fn = {"fused": fused_attention, "rowblock": rowblock_attention,
          "flash": flash_attention, "transposed": transposed_attention,
          "single": port_attention.single_tile_attention}[wrapper]
    fn(q, kv, kv, bias)
    assert calls == [want]


# (wrapper, q shape, tk, dtype, bias kind) → the pad keys the launch gets
# (the Hopper body's in bf16, the fp32 body's or csrc/attention.cu's): none
# on the reference's XLA route (a dense bias past the single tile),
# round_up(Tk, 128) − Tk on the single-tile and clamp routes,
# round_up(Tk, min(1536, round_up(Tk, 128))) − Tk on the streaming one
PAD_KEY_LAUNCHES = {
    "dense_bias_past_the_tile_bf16": ("fused", (1, 2048, 2, 72), 1100, "bf16", "dense", 0),
    "dense_bias_past_the_tile_fp32": ("fused", (1, 2048, 2, 72), 1100, "fp32", "dense", 0),
    "dense_bias_past_the_tile_d64": ("fused", (2, 4096, 2, 64), 4096, "bf16", "dense", 0),
    "dense_bias_single_tile": ("fused", (2, 30, 2, 72), 300, "bf16", "dense", 84),
    "key_padding_single_tile_fp32": ("fused", (2, 30, 2, 72), 300, "fp32", "padding", 84),
    "clamp_key_padding_fp32": ("transposed", (2, 30, 2, 72), 300, "fp32", "padding", 84),
    "flash_key_padding_fp32": ("flash", (2, 30, 2, 72), 1600, "fp32", "padding", 1472),
    "flash_key_padding_d64": ("flash", (2, 30, 2, 64), 300, "fp32", "padding", 84),
    "dense_bias_single_tile_d128": ("fused", (2, 30, 2, 128), 300, "bf16", "dense", 84),
    "dense_bias_single_tile_d36": ("fused", (2, 30, 2, 36), 300, "bf16", "dense", 84),
    "key_padding_single_tile_bf16": ("fused", (2, 30, 2, 72), 300, "bf16", "padding", 84),
    "clamp_key_padding_bf16": ("transposed", (2, 30, 2, 72), 300, "bf16", "padding", 84),
    "rowblock_key_padding_bf16": ("rowblock", (2, 30, 2, 128), 300, "bf16", "padding", 84),
    "flash_key_padding_bf16": ("flash", (2, 30, 2, 72), 1600, "bf16", "padding", 1472),
}


@pytest.mark.parametrize("name", sorted(PAD_KEY_LAUNCHES))
def test_mma_launches_get_the_routes_pad_keys(name, monkeypatch):
    """Every C entry — the Hopper body's (bf16 at head dim 64, 72 or 128,
    a dense bias too), csrc/attention.cu's and the fp32 body's — takes the
    pad keys from the wrapper: the route's count (`pad_keys`), 0 on the XLA
    route of a dense bias past the single tile, which the reference computes
    without pad keys. Meta tensors reach the launch; the launchers are
    replaced by recorders."""
    wrapper, shape, tk, dtype, bias_kind, n_pad = PAD_KEY_LAUNCHES[name]
    calls = []
    monkeypatch.setattr(port_attention, "_launch_sm90",
                        lambda q, k, v, counter, bias=None, n_pad=0: calls.append(n_pad))
    monkeypatch.setattr(port_attention, "_launch",
                        lambda q, k, v, bias, variant, n: calls.append(n))
    monkeypatch.setattr(port_attention, "_launch_f32",
                        lambda q, k, v, counter, bias, n: calls.append(n))
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    b, tq, h, d = shape
    q = torch.empty(shape, dtype=tdt, device="meta")
    kv = torch.empty((b, tk, h, d), dtype=tdt, device="meta")
    bias = torch.zeros((b, h, tq, tk) if bias_kind == "dense" else (b, 1, 1, tk),
                       dtype=tdt, device="meta")
    fn = {"fused": fused_attention, "flash": flash_attention,
          "transposed": transposed_attention, "rowblock": rowblock_attention}[wrapper]
    fn(q, kv, kv, bias)
    assert calls == [n_pad]


@pytest.mark.parametrize("edited", ["source", "header"])
def test_library_path_hashes_the_source_and_the_headers(tmp_path, monkeypatch, edited):
    """A library's name changes when its source or a csrc/ header changes,
    so an edited shared header rebuilds every source that includes it."""
    (tmp_path / "body.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// helpers\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build.library_path("body")
    assert _build.library_path("body") == before
    (tmp_path / ("body.cu" if edited == "source" else "common.cuh")).write_text("// edited\n")
    assert _build.library_path("body") != before


@pytest.mark.parametrize("source", ["attention_sm90", "attention_f32_sm90"])
def test_hopper_bodies_share_the_common_header(source):
    """Both Hopper bodies take their mbarrier, TMA and wgmma helpers from
    csrc/sm90_common.cuh rather than from a copy of their own."""
    src = (_build.CSRC_DIR / f"{source}.cu").read_text()
    assert '#include "sm90_common.cuh"' in src
    for helper in ("void mbar_wait(", "void tma_load(", "EncodeTiled encode_tiled("):
        assert helper not in src
        assert helper in (_build.CSRC_DIR / "sm90_common.cuh").read_text()


def test_f32_tma_operand_arguments():
    """The fp32 body's tensor map of a (B, T, H, D) operand: dims {D, H, T,
    B} and the byte strides of H, T, B (a dimension of one takes the packed
    stride), at any head dim (past 256 the streamed form maps the same
    operand in 8-column boxes and v in slices of its columns); rows of 257
    floats (1028 bytes apart), a base off 16 bytes and rows 292 bytes apart
    raise, and the launch maps a copy of each (`tma_copy`)."""
    x = torch.zeros(2, 300, 3, 72)
    assert port_attention.f32_tma_operand(x, "q") == [72, 3, 300, 2, 288, 864, 259200]
    one = torch.zeros(1, 300, 1, 16)
    assert port_attention.f32_tma_operand(one, "k") == [16, 1, 300, 1, 64, 64, 19200]
    wide = torch.zeros(2, 30, 2, 320)
    assert port_attention.f32_tma_operand(wide, "k") == [320, 2, 30, 2, 1280, 2560, 76800]
    for bad, match in ((torch.zeros(2, 30, 2, 257), "multiples of 16"),
                       (torch.zeros(2 * 30 * 2 * 72 + 1)[1:].view(2, 30, 2, 72), "16-byte"),
                       (torch.zeros(2, 30, 2, 73)[..., :72], "multiples of 16")):
        with pytest.raises(ValueError, match=match):
            port_attention.f32_tma_operand(bad, "v")
        copy = port_attention.tma_copy(bad)
        assert port_attention.f32_tma_operand(copy, "v")[:4] == [bad.shape[-1], 2, 30, 2]
        torch.testing.assert_close(copy, bad, rtol=0, atol=0)


# (dtype, q shape) → the TMA arguments of q at the width the call runs at
# (`sm90_width`, `f32_width`), and that width: the narrow bf16 widths' box
# is the whole row (32 or 16 columns under the 64- or 32-byte swizzle), past
# 128 the box is 64 columns by 64 keys; fp32 rows of 36 floats (144 bytes)
# map as they are, and run at width 40
TMA_WIDTH_CASES = {
    "bf16_d32": (torch.bfloat16, (16, 256, 16, 32),
                 [32, 16, 256, 16, 64, 1024, 256 * 1024, 32, 1, 128, 1], 32),
    "bf16_d16": (torch.bfloat16, (2, 30, 2, 16), [16, 2, 30, 2, 32, 64, 30 * 64, 16, 1, 128, 1],
                 16),
    "bf16_d40": (torch.bfloat16, (2, 30, 2, 40), [40, 2, 30, 2, 80, 160, 30 * 160, 64, 1, 128, 1],
                 64),
    "bf16_d160": (torch.bfloat16, (4, 4096, 8, 160),
                  [160, 8, 4096, 4, 320, 2560, 4096 * 2560, 64, 1, 64, 1], 192),
    "bf16_d256": (torch.bfloat16, (1, 4608, 12, 256),
                  [256, 12, 4608, 1, 512, 6144, 4608 * 6144, 64, 1, 64, 1], 256),
    "fp32_d36": (torch.float32, (16, 256, 16, 36), [36, 16, 256, 16, 144, 2304, 256 * 2304],
                 40),
    "fp32_d256": (torch.float32, (1, 512, 1, 256), [256, 1, 512, 1, 1024, 1024, 512 * 1024],
                  256),
    "fp32_d80": (torch.float32, (2, 30, 2, 80), [80, 2, 30, 2, 320, 640, 30 * 640], 96),
    # past 256: the streamed forms at round_up(d, 64)
    "bf16_d320": (torch.bfloat16, (1, 64, 2, 320),
                  [320, 2, 64, 1, 640, 1280, 64 * 1280, 64, 1, 64, 1], 320),
    "fp32_d512": (torch.float32, (1, 64, 2, 512), [512, 2, 64, 1, 2048, 4096, 64 * 4096], 512),
    # fp32 past 256: the clusters at 384 and 512, the streamed form past 512
    "fp32_d320": (torch.float32, (1, 64, 2, 320), [320, 2, 64, 1, 1280, 2560, 64 * 2560], 384),
    "fp32_d640": (torch.float32, (1, 64, 2, 640), [640, 2, 64, 1, 2560, 5120, 64 * 5120], 640),
}


@pytest.mark.parametrize("case", sorted(TMA_WIDTH_CASES))
def test_tma_operand_arguments_at_the_new_widths(case):
    dtype, shape, want, width = TMA_WIDTH_CASES[case]
    x = torch.empty(shape, dtype=dtype, device="meta")
    if dtype == torch.bfloat16:
        assert port_attention.sm90_width(shape[-1]) == width
        assert port_attention.tma_operand(x, "q") == want
    else:
        assert port_attention.f32_width(shape[-1]) == width
        assert port_attention.f32_tma_operand(x, "q") == want


@pytest.mark.parametrize("shape,want", [
    ((2, 30, 2, 36), [36, 2, 30, 2, 80, 160, 30 * 160, 64, 1, 128, 1]),
    # one head and one batch entry: their strides, never stepped along, are
    # the padded row's 80 bytes and 16 rows of it, not the packed 72
    ((1, 16, 1, 36), [36, 1, 16, 1, 80, 80, 16 * 80, 64, 1, 128, 1]),
])
def test_tma_copy_maps_bf16_rows_of_72_bytes(shape, want):
    """bf16 at D=36 (72-byte rows: TMA cannot step them) goes to the
    Hopper body as a packed copy whose rows are 80 bytes apart, the map's
    inner dim staying 36; an operand TMA can map is passed as it is."""
    x = torch.randn(shape).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        port_attention.tma_operand(x, "q")
    copy = port_attention.tma_copy(x)
    b, t, h, _ = shape
    assert copy.stride() == (t * h * 40, h * 40, 40, 1)
    assert port_attention.tma_operand(copy, "q") == want
    torch.testing.assert_close(copy, x, rtol=0, atol=0)
    y = torch.zeros(2, 30, 2, 40, dtype=torch.bfloat16)
    assert port_attention.tma_copy(y) is y


def test_tma_operand_arguments():
    """The tensor map of a (B, T, H, 128) bf16 operand: dims {D, H, T, B},
    byte strides of H, T, B, box {64, 1, 128, 1}; a dimension of one takes
    the packed stride; a strided view (a slice of heads) keeps its own."""
    x = torch.zeros(2, 300, 3, 128, dtype=torch.bfloat16)
    assert port_attention.tma_operand(x, "q") == [
        128, 3, 300, 2, 256, 768, 300 * 768, 64, 1, 128, 1]
    one = torch.zeros(1, 4608, 24, 128, dtype=torch.bfloat16)
    assert port_attention.tma_operand(one, "k") == [
        128, 24, 4608, 1, 256, 24 * 256, 4608 * 24 * 256, 64, 1, 128, 1]
    heads = torch.zeros(2, 64, 6, 128, dtype=torch.bfloat16)[:, :, 1:4]
    assert port_attention.tma_operand(heads, "v")[:7] == [128, 3, 64, 2, 256, 1536, 64 * 1536]


def test_tma_operand_arguments_at_d72():
    """At D=72 the map's dims are {72, H, T, B} with 144-byte rows and the
    same box {64, 1, 128, 1}: a tile is two 64-column boxes, the second
    zero-filled past column 72. A slice of two heads keeps its strides."""
    x = torch.zeros(4, 4096, 16, 72, dtype=torch.bfloat16)
    assert port_attention.tma_operand(x, "q") == [
        72, 16, 4096, 4, 144, 16 * 144, 4096 * 16 * 144, 64, 1, 128, 1]
    one = torch.zeros(1, 256, 1, 72, dtype=torch.bfloat16)
    assert port_attention.tma_operand(one, "k") == [
        72, 1, 256, 1, 144, 144, 256 * 144, 64, 1, 128, 1]
    pair = x[:, :, 2:4]
    assert pair.data_ptr() % 16 == 0
    assert port_attention.tma_operand(pair, "v")[:7] == [72, 2, 4096, 4, 144, 16 * 144,
                                                         4096 * 16 * 144]


def test_tma_operand_arguments_at_d64():
    """At D=64 the map's dims are {64, H, T, B} with 128-byte rows and the
    same box {64, 1, 128, 1}: one 64-column box under the 128-byte swizzle
    is the whole row (no tail map). A slice of heads keeps its strides."""
    x = torch.zeros(8, 768, 24, 64, dtype=torch.bfloat16)
    assert port_attention.tma_operand(x, "q") == [
        64, 24, 768, 8, 128, 24 * 128, 768 * 24 * 128, 64, 1, 128, 1]
    one = torch.zeros(1, 300, 1, 64, dtype=torch.bfloat16)
    assert port_attention.tma_operand(one, "k") == [
        64, 1, 300, 1, 128, 128, 300 * 128, 64, 1, 128, 1]
    pair = x[:, :, 2:4]
    assert port_attention.tma_operand(pair, "v")[:7] == [64, 2, 768, 8, 128, 24 * 128,
                                                         768 * 24 * 128]


@pytest.mark.parametrize("d", [257, 320])
def test_tma_operand_refuses_other_head_dims(d):
    """Past head dim 256 the Hopper body's streamed form maps a bf16 operand
    as the widths past 128 do — 64-column boxes of 64 keys, which q·kᵀ
    walks along the row — at the width round_up(d, 64); rows TMA cannot
    step (257 bf16, 514 bytes) are refused and their packed copy maps
    (`tma_copy`); another dtype is refused."""
    x = torch.zeros(1, 8, 1, d, dtype=torch.bfloat16)
    assert port_attention.sm90_width(d) == -(-d // 64) * 64
    if d % 8:
        with pytest.raises(ValueError, match="multiples of 16"):
            port_attention.tma_operand(x, "q")
        x = port_attention.tma_copy(x)
    row = 2 * (-(-d // 8) * 8)  # bytes a row, padded to 16
    assert port_attention.tma_operand(x, "q") == [d, 1, 8, 1, row, row, 8 * row, 64, 1, 64, 1]
    with pytest.raises(ValueError, match="takes bf16"):
        port_attention.tma_operand(torch.zeros(1, 8, 1, d), "q")


def test_pixart_attention_operands_map_at_d72():
    """PixArt's Attention views its separate q, k, v projections as (B, T,
    H, 72) (models/common.py): each maps, and the self-attention call it
    makes on the 256² shape takes the Hopper body's exact kernel."""
    from ecad_tpu_torch.models.common import Attention

    attn = Attention(1152, 16, 72, torch.bfloat16)
    x = torch.randn(2, 256, 1152, dtype=torch.bfloat16)
    q = attn.to_q(x).view(2, 256, 16, 72)
    k, v = attn.kv(x)
    maps = [port_attention.tma_operand(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    assert all(m == [72, 16, 256, 2, 144, 2304, 256 * 2304, 64, 1, 128, 1] for m in maps)
    assert port_attention._takes_sm90("attention", q, None)


def test_pixart_cross_attention_operands_map_at_d72():
    """PixArt's cross-attention operands as the model makes them — q from
    the block's Attention (models/common.py), k and v from encode_text's
    trajectory-constant enc_kv views (models/pixart.py), the text bias
    from process_input, (2B, 1, 1, 120) in bf16 — map onto the Hopper
    body's K2: each tensor map and the bias's arguments, and the call
    takes the single-tile route with its bias to the Hopper kernel."""
    from ecad_tpu_torch.models.pixart import PixArtConfig, init_model

    cfg = PixArtConfig.tiny(num_heads=2, head_dim=72, dim=144, text_len=120,
                            dtype=torch.bfloat16)
    model = init_model(cfg, 0, "cpu")
    text = torch.randn(4, 120, cfg.caption_dim, dtype=torch.bfloat16)
    mask = (torch.arange(120)[None] < torch.tensor([7, 60, 120, 1])[:, None]).int()
    latents = torch.zeros(4, 16, 16, cfg.in_channels, dtype=torch.bfloat16)
    enc, enc_kv = model.encode_text(text)
    h, _, _, _, _, enc_bias = model.process_input(
        latents, text, torch.zeros(4), mask, text_precomputed=(enc, enc_kv))
    attn = model.blocks[0].attn2
    q = attn.to_q(h).view(4, h.shape[1], 2, 72)
    k, v = enc_kv[0]
    assert [port_attention.tma_operand(t, n) for t, n in ((k, "k"), (v, "v"))] == [
        [72, 2, 120, 4, 144, 288, 120 * 288, 64, 1, 128, 1]] * 2
    assert port_attention.tma_operand(q, "q")[:7] == [72, 2, 64, 4, 144, 288, 64 * 288]
    assert enc_bias.shape == (4, 1, 1, 120) and enc_bias.dtype == torch.bfloat16
    assert port_attention.bias_operand(enc_bias, 4) == ([120, 1], 1)
    assert attention_route(tuple(q.shape), 120, enc_bias) == "exact"
    assert port_attention._takes_sm90("attention", q, enc_bias)


# bias → its launch arguments on the Hopper body: ([batch stride, key
# stride] in elements, 0 where it broadcasts; dtype code, 1 bf16, 0 fp32)
BIAS_OPERANDS = {
    "per_batch_bf16": (lambda: torch.zeros(4, 1, 1, 120, dtype=torch.bfloat16), ([120, 1], 1)),
    "per_batch_fp32": (lambda: torch.zeros(4, 1, 1, 120), ([120, 1], 0)),
    "batch_broadcast": (lambda: torch.zeros(1, 1, 1, 300), ([0, 1], 0)),
    "odd_tk_per_batch": (lambda: torch.zeros(4, 1, 1, 121, dtype=torch.bfloat16),
                         ([121, 1], 1)),
    "strided_view": (lambda: torch.zeros(4, 1, 1, 256)[..., :121:2], ([256, 2], 0)),
    "key_broadcast": (lambda: torch.zeros(4, 1, 1, 1).expand(4, 1, 1, 120), ([1, 0], 0)),
    "offset_base": (lambda: torch.zeros(4 * 121 + 1, dtype=torch.bfloat16)[1:].view(4, 1, 1, 121),
                    ([121, 1], 1)),
}


@pytest.mark.parametrize("name", sorted(BIAS_OPERANDS))
def test_bias_operand_arguments(name):
    """A key-padding bias reaches the Hopper body as a pointer, its batch
    and key strides (0 where it broadcasts) and its dtype; the body reads
    it with plain loads, so an odd Tk, a strided view or a base off 16
    bytes takes the same body."""
    make, want = BIAS_OPERANDS[name]
    assert port_attention.bias_operand(make(), 4) == want


@pytest.mark.parametrize("bias,match", [
    ((4, 2, 1, 120), "key-padding"),  # per head
    ((4, 1, 8, 120), "key-padding"),  # per query row
    ((2, 1, 1, 120), "key-padding"),  # another batch
    (torch.float16, "bf16 or fp32"),
    (torch.float64, "bf16 or fp32"),
])
def test_bias_operand_refusals(bias, match, monkeypatch):
    """What the key-padding kernels do not read raises, through bias_operand
    and through the single-tile, clamp and streaming wrappers: a bias that
    is not (B|1, 1, 1, Tk), or one in another dtype than bf16 or fp32; any
    other bias takes the dense kernel on the single-tile route
    (`dense_bias_operand`) and so never reaches bias_operand there."""
    shape, dtype = (bias, torch.float32) if isinstance(bias, tuple) else ((4, 1, 1, 120), bias)
    b = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        port_attention.bias_operand(b, 4)
    if dtype != torch.float32:
        monkeypatch.setattr(port_attention, "_launch",
                            lambda *a, **kw: pytest.fail("fell back to attention.cu"))
        q = torch.empty(4, 64, 2, 72, dtype=torch.bfloat16, device="meta")
        kv = torch.empty(4, 120, 2, 72, dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match=match):
            fused_attention(q, kv, kv, torch.empty(shape, dtype=dtype, device="meta"))
        q128, kv128 = (torch.empty(4, t, 2, 128, dtype=torch.bfloat16, device="meta")
                       for t in (64, 120))
        for fn, args in ((transposed_attention, (q, kv, kv)),
                         (flash_attention, (q, kv, kv)),
                         (rowblock_attention, (q128, kv128, kv128))):
            with pytest.raises(ValueError, match="bf16 or fp32"):
                fn(*args, torch.empty(4, 1, 1, 120, dtype=dtype, device="meta"))


# dense bias → its launch arguments on the Hopper body: ([batch, head, query
# row, key strides] in elements, 0 where it broadcasts; dtype code, 1 bf16,
# 0 fp32; 4-byte key pairs, 1 where a bf16 bias has them), at Tk = 300
_bf16 = torch.bfloat16
DENSE_BIAS_OPERANDS = {
    "dense_bf16": (lambda: torch.zeros(2, 3, 30, 300, dtype=_bf16),
                   ([27000, 9000, 300, 1], 1, 1)),
    "dense_fp32": (lambda: torch.zeros(2, 3, 30, 300), ([27000, 9000, 300, 1], 0, 0)),
    "per_head": (lambda: torch.zeros(1, 3, 1, 300, dtype=_bf16), ([0, 300, 0, 1], 1, 1)),
    "per_query": (lambda: torch.zeros(2, 1, 30, 300, dtype=_bf16), ([9000, 0, 300, 1], 1, 1)),
    "batch_broadcast": (lambda: torch.zeros(1, 3, 30, 300, dtype=_bf16),
                        ([0, 9000, 300, 1], 1, 1)),
    "key_broadcast": (lambda: torch.zeros(2, 3, 30, 1, dtype=_bf16).expand(2, 3, 30, 300),
                      ([90, 30, 1, 0], 1, 0)),
    "transposed_view": (lambda: torch.zeros(2, 3, 300, 30, dtype=_bf16).transpose(2, 3),
                        ([27000, 9000, 1, 30], 1, 0)),
    "rows_301_apart": (lambda: torch.zeros(2, 3, 30, 301, dtype=_bf16)[..., :300],
                       ([27090, 9030, 301, 1], 1, 0)),
    "offset_base": (lambda: torch.zeros(2 * 3 * 30 * 300 + 1, dtype=_bf16)[1:].view(
        2, 3, 30, 300), ([27000, 9000, 300, 1], 1, 0)),
    "every_other_key": (lambda: torch.zeros(2, 3, 30, 600, dtype=_bf16)[..., ::2],
                        ([54000, 18000, 600, 2], 1, 0)),
}


@pytest.mark.parametrize("name", sorted(DENSE_BIAS_OPERANDS))
def test_dense_bias_operand_arguments(name):
    """A dense bias reaches the Hopper body as a pointer, its four strides
    (0 on each broadcast dimension) and its dtype; its consumers load bf16
    key pairs 4 bytes at a time where the base, the strides and Tk allow it
    (not at rows 301 keys apart, a base off 4 bytes, a transposed or
    key-strided view, or fp32), else each value where it is used."""
    make, want = DENSE_BIAS_OPERANDS[name]
    assert port_attention.dense_bias_operand(make(), 300) == want
    assert port_attention.dense_bias_operand(make(), 301)[2] == 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_dense_bias_operand_refusals(dtype, monkeypatch):
    """A dense bias in a dtype the Hopper body does not read raises, through
    dense_bias_operand and through the router on the single-tile route and
    the XLA route past it; it is not sent to csrc/attention.cu instead."""
    with pytest.raises(ValueError, match="bf16 or fp32"):
        port_attention.dense_bias_operand(torch.zeros(2, 2, 30, 300, dtype=dtype), 300)
    monkeypatch.setattr(port_attention, "_launch",
                        lambda *a, **kw: pytest.fail("fell back to attention.cu"))
    for tq, tk in ((30, 300), (2048, 1100)):
        q = torch.empty(1, tq, 2, 72, dtype=torch.bfloat16, device="meta")
        kv = torch.empty(1, tk, 2, 72, dtype=torch.bfloat16, device="meta")
        bias = torch.empty(1, 2, tq, tk, dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="bf16 or fp32"):
            fused_attention(q, kv, kv, bias)


@pytest.mark.parametrize("d", [128, 72])
@pytest.mark.parametrize("fault", ["base_off_16_bytes", "row_stride_264_bytes",
                                   "head_dim_not_contiguous"])
def test_hopper_body_refuses_what_tma_cannot_map(fault, d, monkeypatch):
    """A bf16 operand whose base or strides TMA cannot take has no tensor
    map (`tma_operand` raises); a call with one goes to the Hopper body all
    the same — through the single-tile, transposed, streaming and row-block
    wrappers, with or without a key-padding bias — as a packed copy that
    maps (`tma_copy`, equal to the operand), and is not sent to the
    csrc/attention.cu body. Meta tensors reach the launcher's last check
    (the device) with every argument made."""
    if fault == "base_off_16_bytes":
        bad = torch.zeros(2 * 64 * 2 * d + 1, dtype=torch.bfloat16)[1:].view(2, 64, 2, d)
    elif fault == "row_stride_264_bytes":  # 132 elements per head row
        bad = torch.zeros(2, 64, 2, 132, dtype=torch.bfloat16)[..., :d]
    else:
        bad = torch.zeros(2, 64, d, 2, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="TMA|contiguous"):
        port_attention.tma_operand(bad, "q")
    copy = port_attention.tma_copy(bad)
    assert port_attention.tma_operand(copy, "q")[:4] == [d, 2, 64, 2]
    torch.testing.assert_close(copy, bad, rtol=0, atol=0)
    monkeypatch.setattr(port_attention, "_launch",
                        lambda *a, **kw: pytest.fail("fell back to attention.cu"))
    good = torch.empty(2, 64, 2, d, dtype=torch.bfloat16, device="meta")
    meta_bad = torch.empty_strided(bad.shape, bad.stride(), dtype=torch.bfloat16,
                                   device="meta")
    if fault == "base_off_16_bytes":  # a meta view keeps the 2-byte offset
        meta_bad = torch.empty(bad.numel() + 1, dtype=torch.bfloat16,
                               device="meta")[1:].view(bad.shape)
    wrappers = [fused_attention, transposed_attention, flash_attention, rowblock_attention]
    bias = torch.empty(2, 1, 1, 64, dtype=torch.bfloat16, device="meta")
    for fn in wrappers:
        for b in (None, bias):
            with pytest.raises(ValueError, match="unsupported device meta"):
                fn(good, meta_bad, good, b)


# layouts of a (B, T, H, D) operand: packed, rows cut from wider ones (not a
# multiple of 16 bytes apart), a base off 16 bytes, the last two dims swapped
NO_ATTENTION_CU_LAYOUTS = ("packed", "rows_cut", "base_off_16_bytes", "d_not_contiguous")


def _meta_operand(shape, dtype, layout):
    b, t, h, d = shape
    if layout == "packed":
        return torch.empty(shape, dtype=dtype, device="meta")
    if layout == "rows_cut":
        return torch.empty((b, t, h, d + 3), dtype=dtype, device="meta")[..., 1:d + 1]
    if layout == "base_off_16_bytes":
        return torch.empty(b * t * h * d + 1, dtype=dtype, device="meta")[1:].view(shape)
    return torch.empty((b, t, d, h), dtype=dtype, device="meta").transpose(2, 3)


@pytest.mark.parametrize("bh", [(2, 2), (1, 1)])
@pytest.mark.parametrize("layout", NO_ATTENTION_CU_LAYOUTS)
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("d", [1, 8, 15, 16, 17, 32, 36, 40, 63, 64, 65, 72, 80, 100, 127,
                               128, 129, 160, 192, 200, 255, 256])
def test_no_wrapper_reaches_attention_cu(d, dtype, layout, bh, monkeypatch):
    """Every CUDA call at a head dim up to 256, in bf16 or fp32, in any
    layout (with one batch entry and one head too), with each bias its
    wrapper accepts (none, a key-padding one, a dense one on the single-tile
    route), reaches the Hopper bodies' launchers (`_launch_sm90`,
    `_launch_f32`) with tensor maps made — meta tensors stop at their
    device check — and never csrc/attention.cu's `_launch`; and so does
    every route past 256 in both dtypes (bf16's streamed form; fp32's
    clusters at 257, 320, 384, 385 and 512 and its streamed form at 513 and
    640), reaching no plain version either."""
    monkeypatch.setattr(port_attention, "_launch",
                        lambda *a, **kw: pytest.fail("reached attention.cu"))
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    b, h = bh
    q = _meta_operand((b, 30, h, d), tdt, layout)
    k = _meta_operand((b, 300, h, d), tdt, layout)
    v = torch.empty((b, 300, h, d), dtype=tdt, device="meta")
    padding = torch.empty(b, 1, 1, 300, dtype=tdt, device="meta")
    dense = torch.empty(b, h, 30, 300, dtype=tdt, device="meta")
    calls = [(fn, bias) for fn in (transposed_attention, rowblock_attention, flash_attention)
             for bias in (None, padding)]
    calls += [(fn, bias) for fn in (fused_attention, port_attention.single_tile_attention)
              for bias in (None, padding, dense)]
    for fn, bias in calls:
        with pytest.raises(ValueError, match="unsupported device meta"):
            fn(q, k, v, bias)
    for name in ("fused_attention_reference", "transposed_attention_reference",
                 "rowblock_attention_reference", "flash_attention_reference"):
        monkeypatch.setattr(port_attention, name,
                            lambda *a, name=name, **kw: pytest.fail(f"reached {name}"))
    for wide_d in (257, 320, 384, 385, 512, 513, 640):
        qw = _meta_operand((b, 30, h, wide_d), tdt, layout)
        kw = _meta_operand((b, 300, h, wide_d), tdt, layout)
        vw = torch.empty((b, 300, h, wide_d), dtype=tdt, device="meta")
        dense_w = torch.empty(b, h, 30, 300, dtype=tdt, device="meta")
        for fn, bias in calls:
            if bias is dense:
                bias = dense_w
            with pytest.raises(ValueError, match="unsupported device meta"):
                fn(qw, kw, vw, bias)


# ---------------------------------------------------------------------------
# the Hopper body's exact-mode arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------


def _chip_smoke_module():
    """chip_smoke.py, loaded from its file, for the tolerances its checks
    hold the kernels to on the card (it imports nothing CUDA-only)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hopper_exact_body(q, k, v, bias, n_pad):
    """csrc/attention_sm90.cu's exact mode in its own order, on bf16 (B, T,
    H, D) q, k, v: per 128-key tile, s = q·kᵀ in fp32, c = fp32(1/√D)·log2e
    in fp32; with a key-padding bias s₂ = fp32(s·c + fp32(bias·log2e)) (one
    FFMA), the running max m on s₂ and p = exp2(s₂ − m); without one the
    max on the raw s and p = exp2(fp32(s·c + fp32(−m·c))); keys past Tk at
    −∞; p rounded to bf16 for p·v against the running max of its tile, Σp
    in fp32 over the unrounded p, both rescaled by exp2 of the change of
    the max; then the n_pad pad keys of score −1e9: m′ = max(m₂, fp32(−1e9·
    log2e)), f = exp2(m₂ − m′), Σp·f + n_pad·exp2(−1e9·log2e − m′), and one
    factor f/Σp, one cast."""
    f32 = torch.float32
    log2e = torch.tensor(port_attention._LOG2E, dtype=f32)
    c = torch.tensor(1.0 / np.sqrt(q.shape[-1]), dtype=f32) * log2e
    pad = torch.tensor(port_attention._PAD_SCORE, dtype=f32) * log2e
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    b, h, tq, _ = qf.shape
    tk = kf.shape[2]
    b2 = None if bias is None else bias.float() * log2e  # (B|1, 1, 1, Tk)
    m = torch.full((b, h, tq, 1), -torch.inf, dtype=f32)
    l = torch.zeros((b, h, tq, 1), dtype=f32)
    o = torch.zeros_like(qf)
    for k0 in range(0, tk, 128):
        s = qf @ kf[:, :, k0:k0 + 128].transpose(-1, -2)
        if b2 is not None:
            s = (s.double() * c.double() + b2[..., k0:k0 + 128].double()).float()
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        if b2 is not None:
            alpha, p = torch.exp2(m - mx), torch.exp2(s - mx)
        else:
            shift = -mx * c
            alpha = torch.exp2((m - mx) * c)
            p = torch.exp2((s.double() * c.double() + shift.double()).float())
        m, l = mx, l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + 128]
    m2 = m if b2 is not None else m * c
    f = torch.ones_like(l)
    if n_pad:
        mp = torch.maximum(m2, pad)
        f = torch.exp2(m2 - mp)
        l = l * f + n_pad * torch.exp2(pad - mp)
    return (o * (f / l)).to(torch.bfloat16).permute(0, 2, 1, 3)


# fp32 head dim → the kernel chip_smoke.py's profiles must name on the
# clamp route: the two-block cluster at 256, three blocks to 384, four to
# 512, the streamed form past it (its slice of o's columns in the name)
F32_WIDE_KERNELS = {256: "attn_clamp_f32_sm90_kernel<256, false>",
                    257: "attn_clamp_f32_sm90_kernel<384, false>",
                    384: "attn_clamp_f32_sm90_kernel<384, false>",
                    385: "attn_clamp_f32_sm90_kernel<512, false>",
                    512: "attn_clamp_f32_sm90_kernel<512, false>",
                    513: "attn_clamp_f32_wide_sm90_kernel<128, false>",
                    640: "attn_clamp_f32_wide_sm90_kernel<128, false>"}


@pytest.mark.parametrize("kernel,names,want", [
    ("attn_exact_dense_sm90_kernel<72>",
     ["void (anonymous namespace)::attn_exact_dense_sm90_kernel<72>((anonymous namespace)::Maps, "
      "(anonymous namespace)::Params)"], True),
    ("attn_exact_dense_sm90_kernel<72>",
     ["_ZN50_GLOBAL__N__c1e0a0bd_17_attention_sm90_cu_e66bb11028attn_exact_dense_sm90_kernel"
      "ILi72EEEvNS_4MapsENS_6ParamsE"], True),
    ("attn_exact_dense_sm90_kernel<72>",
     ["void (anonymous namespace)::attn_exact_sm90_kernel<72, true>(Maps, Params)"], False),
    ("attn_exact_dense_sm90_kernel<128>",
     ["void (anonymous namespace)::attn_exact_dense_sm90_kernel<72>(Maps, Params)"], False),
    ("attn_exact_sm90_kernel<72, true>",
     ["_ZN50_GLOBAL__N__c1e0a0bd_17_attention_sm90_cu_e66bb11022attn_exact_sm90_kernel"
      "ILi72ELb1EEEvNS_4MapsENS_6ParamsE"], True),
    ("attn_exact_sm90_kernel<72, true>",
     ["void (anonymous namespace)::attn_exact_dense_sm90_kernel<72>(Maps, Params)"], False),
    ("attn_exact_dense_sm90_kernel<72>",
     ["void (anonymous namespace)::attn_exact_dense_sm90_kernel<72>(Maps, Params)",
      "void attn_bf16_kernel<72, true>(Params)"], False),
    # fp32 at 256, 257, 384, 385, 512, 513 and 640: the clusters' kernels
    # and the streamed form's, each named in a demangled profile
    *[(k, [f"void (anonymous namespace)::{k}((anonymous namespace)::Maps, "
           "(anonymous namespace)::Params)"], True) for k in F32_WIDE_KERNELS.values()],
    ("attn_clamp_f32_sm90_kernel<512, false>",
     ["void (anonymous namespace)::attn_clamp_f32_sm90_kernel<384, false>(Maps, Params)"], False),
])
def test_chip_smoke_names_the_hopper_kernel(kernel, names, want):
    """chip_smoke.py's profile check: a Hopper kernel named with its head
    dim alone (the dense K2) or with its BIAS flag too, demangled or
    mangled, and nothing of csrc/attention.cu beside it."""
    assert _chip_smoke_module().ran_hopper_kernel(names, kernel) is want


@pytest.mark.parametrize("d", sorted(F32_WIDE_KERNELS))
def test_chip_smoke_names_the_f32_kernel_past_256(d):
    """`hopper_kernel` names the fp32 cluster kernels at 256, 384 and 512 and
    the streamed form past 512, and the profile check takes that name from a
    demangled profile and not the other form's."""
    smoke = _chip_smoke_module()
    kernel = smoke.hopper_kernel("clamp", torch.float32, d)
    assert kernel == F32_WIDE_KERNELS[d]
    width = kernel.split("<")[1].split(",")[0]
    ran = [f"void (anonymous namespace)::{kernel.split('<')[0]}<{width}, false>("
           "(anonymous namespace)::Maps, (anonymous namespace)::Params)"]
    assert smoke.ran_hopper_kernel(ran, kernel)
    other = ("attn_clamp_f32_wide_sm90_kernel<128, false>" if "wide" not in kernel
             else "attn_clamp_f32_sm90_kernel<512, false>")
    assert not smoke.ran_hopper_kernel(ran, other)


def _least_atol_per_std(got, want, rtol):
    """The least atol that passes `got` beside `rtol`, per the std of
    `want` (chip_smoke.py's `least_atol_per_std`)."""
    err = (got - want).abs() - rtol * want.abs()
    return float(err.max().clamp(min=0)) / float(want.std())


# case → (the text lengths of batch rows 0 and 1, or a fill for every key of
# row 0 beside a row of 60 keys): PixArt-256's cross-attention class, 256
# queries to 120 keys, whose bias the model makes in bf16 (−10000 → −9984)
K2_BODY_CASES = {
    "text_lengths_7_60": ([7, 60], None),
    "text_lengths_120_7": ([120, 7], None),
    "every_key_minus_1e9": ([0, 60], -1e9),
    "every_key_minus_2e9": ([0, 60], -2e9),
}
# the emulated body against _attn_kernel_bias: one bf16 ulp of the output
# relative, 2^-7 (both sides round their fp32 result once), and 0.01 of the
# output's std for p rounded to bf16 where the reference keeps it in fp32
K2_BODY_TOL = dict(share=0.01, rtol=2.0 ** -7)


@pytest.mark.parametrize("case", sorted(K2_BODY_CASES))
def test_hopper_k2_arithmetic_matches_attn_kernel_bias(case):
    """The Hopper body's K2 arithmetic (`_hopper_exact_body`: the bias
    folded into the log2-domain FFMA, the max on the biased score, p
    rounded to bf16 against its tile's running max, the route's 8 pad keys)
    against `_attn_kernel_bias` in interpret mode at (2, 256, 2, 72) → 120
    keys, bf16: within K2_BODY_TOL, which lies inside chip_smoke.py's
    BF16_TOL; in a row whose every key has a bias of −1e9 both give
    Σv/128, below it 0."""
    lengths, fill = K2_BODY_CASES[case]
    rng = np.random.default_rng(41)
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(rng, 2, 256, 120, 2, 72))
    if fill is None:
        bias = _text_bias_np(lengths, 120).astype(jnp.bfloat16)
    else:
        bias = _text_bias_np(lengths, 120)
        bias[0] = fill
    want = np.asarray(jax_fused_attention(
        *(jnp.asarray(x) for x in (q, k, v)), bias=jnp.asarray(bias), interpret=True),
        np.float32)
    as_t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(  # noqa: E731
        torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
    got = _hopper_exact_body(*(as_t(x) for x in (q, k, v, bias)), n_pad=8).float()
    want = torch.from_numpy(want)
    atol = K2_BODY_TOL["share"] * float(want.std())
    torch.testing.assert_close(got, want, atol=atol, rtol=K2_BODY_TOL["rtol"])
    if fill == -1e9:
        mean_v = as_t(v).float()[:1].sum(1, keepdim=True) / 128
        torch.testing.assert_close(got[:1], mean_v.expand_as(got[:1]), atol=2**-7, rtol=2**-7)
    elif fill == -2e9:
        assert float(got[:1].abs().max()) == 0.0
    bf16_atol, bf16_rtol = _chip_smoke_module().BF16_TOL
    assert atol <= bf16_atol and K2_BODY_TOL["rtol"] <= bf16_rtol


# case → (the dense bias's shape, its dtype, a fill for rows 0-7 of batch
# row 0 or None): queries to 120 keys at (2, 256, 2, 72), as K2's cases
K2_DENSE_BODY_CASES = {
    "dense_bf16": ((2, 2, 256, 120), "bf16", None),
    "per_head_fp32": ((1, 2, 1, 120), "fp32", None),
    "per_query_bf16": ((2, 1, 256, 120), "bf16", None),
    "dense_rows_minus_1e9": ((2, 2, 256, 120), "fp32", -1e9),
    "dense_rows_minus_2e9": ((2, 2, 256, 120), "fp32", -2e9),
}


@pytest.mark.parametrize("case", sorted(K2_DENSE_BODY_CASES))
def test_hopper_dense_k2_arithmetic_matches_attn_kernel_bias(case):
    """The arithmetic of the Hopper body's K2 with a dense bias
    (``attn_exact_dense_sm90_kernel``: the same as with a key-padding bias —
    fp32(bias·log2e) folded into the log2-domain FFMA, the max on the
    biased score, p rounded to bf16 against its tile's running max, the
    route's 8 pad keys — with a bias value per score, `_hopper_exact_body`)
    against `_attn_kernel_bias` in interpret mode at (2, 256, 2, 72) → 120
    keys, bf16, with dense, per-head and per-query biases: within
    K2_BODY_TOL; in rows whose every key has a bias of −1e9 both give
    Σv/128, below it 0."""
    shape, dtype, fill = K2_DENSE_BODY_CASES[case]
    rng = np.random.default_rng(48)
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(rng, 2, 256, 120, 2, 72))
    bias = rng.standard_normal(shape, dtype=np.float32) * 3
    if fill is not None:
        bias[0, :, :8] = fill
    if dtype == "bf16":
        bias = bias.astype(jnp.bfloat16)
    want = torch.from_numpy(np.asarray(jax_fused_attention(
        *(jnp.asarray(x) for x in (q, k, v)), bias=jnp.asarray(bias), interpret=True),
        np.float32))
    as_t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(  # noqa: E731
        torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
    got = _hopper_exact_body(*(as_t(x) for x in (q, k, v, bias)), n_pad=8).float()
    atol = K2_BODY_TOL["share"] * float(want.std())
    torch.testing.assert_close(got, want, atol=atol, rtol=K2_BODY_TOL["rtol"])
    if fill == -1e9:
        mean_v = as_t(v).float()[:1].sum(1, keepdim=True) / 128
        for side in (got, want):
            torch.testing.assert_close(side[:1, :8], mean_v.expand_as(side[:1, :8]),
                                       atol=2**-7, rtol=2**-7)
    elif fill == -2e9:
        assert float(got[:1, :8].abs().max()) == 0.0 == float(want[:1, :8].abs().max())


def test_hopper_k6_arithmetic_matches_flash_kernel_at_d72(monkeypatch):
    """The Hopper body's K6 arithmetic without a bias (the max on the raw
    scores, p = exp2(s·c − m·c) in one FFMA, rounded to bf16 against the
    running max of each 128-key tile, the route's pad keys: 3200 keys pad
    to 4608, n_pad 1408) against `_flash_kernel` in interpret mode at
    (1, 64, 2, 72) → 3200 keys, bf16, where the reference rounds p against
    the running max of each 1536-key block instead: the least atol per std
    that passes beside 2^-7 relative stays below half of chip_smoke.py's
    flash_bf16_tol share (0.025), and the emulation passes that tolerance."""
    monkeypatch.setattr(jax_attention, "_ROWBLOCK_MAX_KV_ELEMS", 0)
    rng = np.random.default_rng(42)
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(rng, 1, 64, 3200, 2, 72))
    want = torch.from_numpy(np.asarray(jax_attention._flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), None, interpret=True), np.float32))
    as_t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)  # noqa: E731
    got = _hopper_exact_body(*(as_t(x) for x in (q, k, v)), None, n_pad=1408).float()
    least = _least_atol_per_std(got, want, 2.0 ** -7)
    assert least <= 0.0125, least
    atol, rtol = _chip_smoke_module().flash_bf16_tol(want)
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    assert rtol == 2.0 ** -7


@pytest.mark.parametrize("bias", [None, "key_padding"])
def test_hopper_k6_arithmetic_matches_flash_kernel_at_d64(bias, monkeypatch):
    """The Hopper body's K6 arithmetic at head dim 64 (`_hopper_exact_body`:
    p rounded to bf16 against the running max of each 128-key tile; with a
    key-padding bias folded into the log2-domain FFMA), the route's pad
    keys (1600 keys pad to 3072, n_pad 1472), against `_flash_kernel` in
    interpret mode (its 1536-key blocks) at (2, 64, 2, 64) → 1600 keys,
    bf16, without a bias and with an fp32 bias of −1e9 past lengths [1600,
    700]: the least atol per std that passes beside 2^-7 relative stays
    below half of chip_smoke.py's flash_bf16_tol share (0.025), and the
    emulation passes that tolerance."""
    monkeypatch.setattr(jax_attention, "_ROWBLOCK_MAX_KV_ELEMS", 0)
    rng = np.random.default_rng(46)
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(rng, 2, 64, 1600, 2, 64))
    b = None if bias is None else _key_padding_bias_np([1600, 700], 1600)
    assert port_attention.pad_keys("flash", 1600) == 1472
    want = torch.from_numpy(np.asarray(jax_attention._flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), None if b is None else jnp.asarray(b),
        interpret=True), np.float32))
    as_t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)  # noqa: E731
    got = _hopper_exact_body(*(as_t(x) for x in (q, k, v)),
                             None if b is None else torch.from_numpy(b), n_pad=1472).float()
    least = _least_atol_per_std(got, want, 2.0 ** -7)
    assert least <= 0.0125, least
    atol, rtol = _chip_smoke_module().flash_bf16_tol(want)
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


# case → (the key-padding lengths of batch rows 0 and 1, or a fill for every
# key of row 0 beside a row of 700 keys)
K6_BIAS_BODY_CASES = {
    "lengths_1900_700": ([1900, 700], None),
    "every_key_minus_1e9": ([0, 700], -1e9),
    "every_key_minus_2e9": ([0, 700], -2e9),
}


@pytest.mark.parametrize("case", sorted(K6_BIAS_BODY_CASES))
def test_hopper_k6_bias_arithmetic_matches_flash_kernel(case, monkeypatch):
    """The Hopper body's K6 arithmetic with a key-padding bias (the bias
    folded into the log2-domain FFMA, the max on the biased score, p
    rounded to bf16 against the running max of each 128-key tile, the
    streaming route's pad keys: 2000 keys pad to 3072, n_pad 1072) against
    `_flash_kernel` in interpret mode (its 1536-key blocks) at (2, 512, 2,
    72) → 2000 keys, bf16, with an fp32 bias of −1e9 past each row's
    length: the least atol per std that passes beside 2^-7 relative stays
    below half of chip_smoke.py's flash_bf16_tol share (0.025), and the
    emulation passes that tolerance; in a row whose every key has a bias of
    −1e9 both give Σv/3072, below it 0."""
    monkeypatch.setattr(jax_attention, "_ROWBLOCK_MAX_KV_ELEMS", 0)
    lengths, fill = K6_BIAS_BODY_CASES[case]
    rng = np.random.default_rng(44)
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(rng, 2, 512, 2000, 2, 72))
    bias = _key_padding_bias_np(lengths, 2000)
    if fill is not None:
        bias[0] = fill
    assert port_attention.pad_keys("flash", 2000) == 1072
    want = torch.from_numpy(np.asarray(jax_attention._flash_attention(
        *(jnp.asarray(x) for x in (q, k, v, bias)), interpret=True), np.float32))
    as_t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)  # noqa: E731
    got = _hopper_exact_body(*(as_t(x) for x in (q, k, v)), torch.from_numpy(bias),
                             n_pad=1072).float()
    least = _least_atol_per_std(got, want, 2.0 ** -7)
    assert least <= 0.0125, least
    atol, rtol = _chip_smoke_module().flash_bf16_tol(want)
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    if fill == -1e9:
        mean_v = as_t(v).float()[:1].sum(1, keepdim=True) / 3072
        for side in (got, want):
            torch.testing.assert_close(side[:1], mean_v.expand_as(got[:1]), atol=2**-7,
                                       rtol=2**-7)
    elif fill == -2e9:
        assert float(got[:1].abs().max()) == 0.0 == float(want[:1].abs().max())


# ---------------------------------------------------------------------------
# the Hopper body's clamp-mode arithmetic with a key-padding bias, emulated
# ---------------------------------------------------------------------------


def _hopper_clamp_body(q, k, v, bias, n_pad, clip_past_tk=False):
    """csrc/attention_sm90.cu's clamp mode in its own order, on bf16 (B, T,
    H, D) q, k, v: q × bf16(scale·log2e), rounded to bf16; per 128-key
    tile, s = q·kᵀ in fp32 plus fp32(bias·log2e) in a plain fp32 add (−∞
    past Tk), p = exp2(clip(s, −100, 80)), the keys past Tk at 0, Σp in
    fp32 over the unrounded p, p rounded to bf16 for p·v; then the
    reference's n_pad pad keys, n_pad·2^-100 added to Σp, one factor 1/Σp,
    one cast. `clip_past_tk` keeps the clip's 2^-100 for the keys past Tk
    too: the form that counts them twice."""
    f32 = torch.float32
    log2e = torch.tensor(port_attention._LOG2E, dtype=f32)
    scale = torch.tensor(port_attention.clamp_scale(q.shape[-1], q.dtype), dtype=q.dtype)
    qf = (q * scale).float().permute(0, 2, 1, 3)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))
    tk = kf.shape[2]
    tk_pad = port_attention._round_up(tk, 128)
    kf, vf = (torch.nn.functional.pad(t, (0, 0, 0, tk_pad - tk)) for t in (kf, vf))
    b2 = torch.full((*bias.shape[:3], tk_pad), -torch.inf, dtype=f32)
    b2[..., :tk] = bias.float() * log2e
    real = torch.arange(tk_pad) < tk
    l = torch.zeros((*qf.shape[:3], 1), dtype=f32)
    o = torch.zeros_like(qf)
    for k0 in range(0, tk_pad, 128):
        s = qf @ kf[:, :, k0:k0 + 128].transpose(-1, -2) + b2[..., k0:k0 + 128]
        p = torch.exp2(s.clamp(port_attention._CLAMP_LO, port_attention._CLAMP_HI))
        if not clip_past_tk:
            p = torch.where(real[k0:k0 + 128], p, 0.0)
        l = l + p.sum(-1, keepdim=True)
        o = o + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + 128]
    l = l + n_pad * port_attention._PAD_KEY_WEIGHT
    return (o * (1.0 / l)).to(torch.bfloat16).permute(0, 2, 1, 3)


# case → (the reference's wrapper, q shape, Tk, the text lengths of batch
# rows 0 and 1, the fill past them): PixArt-1024's cross-attention class
# (queries to 120 text keys, the transposed route, D=72) and the row-block
# route at D=128 with an unaligned Tk; batch row 0 keeps no key, so every
# logit of its rows clamps at −100
K4_K5_BODY_CASES = {
    "transposed_text_0_60": ("_transposed_attention", (2, 256, 2, 72), 120, [0, 60], -10000.0),
    "transposed_text_0_120": ("_transposed_attention", (2, 256, 2, 72), 120, [0, 120],
                              -10000.0),
    "rowblock_tk300_minus_1e4": ("_rowblock_attention", (2, 64, 2, 128), 300, [0, 250],
                                 -10000.0),
    "rowblock_tk300_minus_1e9": ("_rowblock_attention", (2, 64, 2, 128), 300, [0, 250], -1e9),
}
# the emulated body against the Pallas kernels: one bf16 ulp of the output
# relative, 2^-7 (both sides round their fp32 result once), and 0.01 of the
# output's std for the order of the fp32 sums
CLAMP_BODY_TOL = dict(share=0.01, rtol=2.0 ** -7)


def _k4_k5_body_case(case, bias_dtype):
    ref_name, (b, tq, h, d), tk, lengths, fill = K4_K5_BODY_CASES[case]
    rng = np.random.default_rng(43)
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(rng, b, tq, tk, h, d))
    bias = np.where(np.arange(tk)[None, None, None, :]
                    < np.asarray(lengths)[:, None, None, None], 0.0, fill).astype(np.float32)
    if bias_dtype == "bf16":
        bias = bias.astype(jnp.bfloat16)
    want = torch.from_numpy(np.asarray(getattr(jax_attention, ref_name)(
        *(jnp.asarray(x) for x in (q, k, v, bias)), interpret=True), np.float32))
    as_t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(  # noqa: E731
        torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
    return [as_t(x) for x in (q, k, v, bias)], want


def _mean_v(v, tk_pad):
    """An all-masked row's output on the clamp routes: Σv/Tk_pad."""
    return v.float().sum(1, keepdim=True) / tk_pad


@pytest.mark.parametrize("bias_dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("case", sorted(K4_K5_BODY_CASES))
def test_hopper_clamp_bias_arithmetic_matches_pallas(case, bias_dtype):
    """The Hopper body's clamp mode with a key-padding bias
    (`_hopper_clamp_body`: the bias added to the fp32 scores in a plain
    add, the keys past Tk at weight 0, the route's pad keys in the
    epilogue) against `_transposed_kernel` at (2, 256, 2, 72) → 120 keys
    and `_rowblock_kernel` at (2, 64, 2, 128) → 300 keys, in interpret
    mode, bf16, with the bias in bf16 and fp32: within CLAMP_BODY_TOL,
    which lies inside chip_smoke.py's clamp_bf16_tol; the all-masked batch
    row gives Σv/Tk_pad (Σv/128 at 120 keys, Σv/384 at 300) on both
    sides."""
    (q, k, v, bias), want = _k4_k5_body_case(case, bias_dtype)
    tk = k.shape[1]
    tk_pad = port_attention._round_up(tk, 128)
    got = _hopper_clamp_body(q, k, v, bias, n_pad=tk_pad - tk).float()
    atol = CLAMP_BODY_TOL["share"] * float(want.std())
    torch.testing.assert_close(got, want, atol=atol, rtol=CLAMP_BODY_TOL["rtol"])
    mean_v = _mean_v(v[:1], tk_pad).expand_as(got[:1])
    for side in (got, want):
        torch.testing.assert_close(side[:1], mean_v, atol=1e-6, rtol=2.0 ** -7)
    clamp_atol, clamp_rtol = _chip_smoke_module().clamp_bf16_tol(want)
    assert atol <= clamp_atol and CLAMP_BODY_TOL["rtol"] <= clamp_rtol


@pytest.mark.parametrize("case", ["transposed_text_0_60", "rowblock_tk300_minus_1e9"])
def test_hopper_clamp_bias_counting_pad_keys_twice_fails_masked_rows(case):
    """The form that lets the clip weigh the keys past Tk at 2^-100 (their
    bias is −∞) and also adds the epilogue's n_pad·2^-100 divides an
    all-masked row by Tk_pad + n_pad (136 at 120 keys, 468 at 300): the
    Σv/Tk_pad check rejects it there, though it passes the partly masked
    row; at 120 keys (8 pad keys, 6 % off) it also passes the std-scaled
    tolerance the whole output is held to, so that check alone would not
    catch it."""
    (q, k, v, bias), want = _k4_k5_body_case(case, "bf16")
    tk = k.shape[1]
    tk_pad = port_attention._round_up(tk, 128)
    bad = _hopper_clamp_body(q, k, v, bias, n_pad=tk_pad - tk, clip_past_tk=True).float()
    mean_v = _mean_v(v[:1], tk_pad).expand_as(bad[:1])
    with pytest.raises(AssertionError):
        torch.testing.assert_close(bad[:1], mean_v, atol=1e-6, rtol=2.0 ** -7)
    torch.testing.assert_close(bad[:1], mean_v * tk_pad / (2 * tk_pad - tk),
                               atol=1e-6, rtol=2.0 ** -7)
    atol = CLAMP_BODY_TOL["share"] * float(want.std())
    torch.testing.assert_close(bad[1:], want[1:], atol=atol, rtol=CLAMP_BODY_TOL["rtol"])
    if tk == 120:
        clamp_atol, clamp_rtol = _chip_smoke_module().clamp_bf16_tol(want)
        torch.testing.assert_close(bad, want, atol=clamp_atol, rtol=clamp_rtol)


# ---------------------------------------------------------------------------
# scripts/probe_attention_body.py: its variant builds of the Hopper body
# ---------------------------------------------------------------------------


PROBE_VARIANTS = {name: edits for row in probe_attention_body.ROWS.values()
                  for name, edits in row[4].items()}


@pytest.mark.parametrize("variant", sorted(PROBE_VARIANTS))
def test_probe_variants_edit_the_current_source(variant):
    """Each probe variant's text edits still match csrc/attention_sm90.cu
    and change it (a probe that no longer applies raises on the card)."""
    src = (_build.CSRC_DIR / "attention_sm90.cu").read_text()
    edits = PROBE_VARIANTS[variant]
    assert probe_attention_body.variant_source(src, edits) != src
    with pytest.raises(ValueError, match="does not match"):
        probe_attention_body.variant_source(src.replace(edits[0][0], ""), edits)


F32_PROBE_VARIANTS = {name: edits for row in probe_attention_body.F32_ROWS.values()
                      for name, edits in row[4].items()}


@pytest.mark.parametrize("variant", sorted(F32_PROBE_VARIANTS))
def test_f32_probe_variants_edit_the_current_source(variant):
    """Each fp32-body probe variant's text edits still match
    csrc/attention_f32_sm90.cu and change it."""
    src = (_build.CSRC_DIR / "attention_f32_sm90.cu").read_text()
    edits = F32_PROBE_VARIANTS[variant]
    assert probe_attention_body.variant_source(src, edits) != src
    with pytest.raises(ValueError, match="does not match"):
        probe_attention_body.variant_source(src.replace(edits[0][0], ""), edits)


@pytest.mark.parametrize("new,want", [
    # UR4 and UR5 swapped: the same instructions, another allocation
    (["USHF.R.U32.HI UR8, URZ, 0x1, UR4", "UIADD3 UR5, UR5, UR7, URZ",
      "UIADD3 UR4, UR4, 0x1, URZ"], 3),
    (["USHF.R.U32.HI UR8, URZ, 0x1, UR5", "UIADD3 UR4, UR4, UR7, URZ",
      "UIADD3 UR4, UR4, 0x1, URZ"], 1),
    # another constant, another opcode, one instruction fewer
    (["USHF.R.U32.HI UR8, URZ, 0x1, UR5", "UIADD3 UR4, UR4, UR7, URZ",
      "UIADD3 UR5, UR5, 0x2, URZ"], None),
    (["USHF.R.U32.HI UR8, URZ, 0x1, UR5", "UIMAD UR4, UR4, UR7, URZ",
      "UIADD3 UR5, UR5, 0x1, URZ"], None),
    (["USHF.R.U32.HI UR8, URZ, 0x1, UR5", "UIADD3 UR4, UR4, UR7, URZ"], None),
])
def test_compare_sass_tells_another_register_allocation_from_other_code(new, want):
    """scripts/compare_sass.py counts the instructions that name other
    registers where two builds are otherwise the same instructions in the
    same order, and tells any other difference apart."""
    from ecad_tpu_torch.scripts.compare_sass import registers_only

    old = ["USHF.R.U32.HI UR8, URZ, 0x1, UR5", "UIADD3 UR4, UR4, UR7, URZ",
           "UIADD3 UR5, UR5, 0x1, URZ"]
    assert registers_only(old, new) == want


def test_probe_script_needs_a_card():
    with pytest.raises(SystemExit, match="CUDA"):
        probe_attention_body.main([])
