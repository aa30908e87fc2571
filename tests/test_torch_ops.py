"""The port's kernels, through their CPU path (the plain PyTorch versions),
against the reference's Pallas kernels run in interpret mode on the CPU.

Inputs come from numpy with a fixed seed and go to both sides. On the CPU
each wrapper runs its plain version; the CUDA kernels themselves are held
against the same plain versions on the card by chip_smoke.py."""

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
    modulated_layer_norm_reference,
    nomax_attention,
    rowblock_attention,
    rowblock_attention_reference,
    transposed_attention,
    transposed_attention_reference,
)
from ecad_tpu_torch.ops import _build
from ecad_tpu_torch.ops import attention as port_attention
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
        "xattn_fd", "modlnorm",
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
# the same at the head dim the route serves (128): (b, h, tq, tk, d, bias
# lengths or None, q scale)
ROWBLOCK_CASES = {
    "multiblock_q_48_384_d64": (2, 2, 48, 384, 64, None, 1.0),
    "unaligned_30_300_d72": (2, 2, 30, 300, 72, None, 1.0),
    "batch_broadcast_bias_b3": (3, 2, 32, 256, 64, [100], 1.0),
    "logits_times_6": (1, 1, 16, 256, 64, None, 6.0),
    "q_times_1e4": (1, 1, 16, 256, 64, None, 1e4),
    "multiblock_q_48_384_d128": (2, 2, 48, 384, 128, None, 1.0),
    "ragged_tk300_key_padding_d128": (2, 2, 30, 300, 128, [250, 300], 1.0),
    "per_batch_key_padding_d128": (3, 2, 32, 256, 128, [100, 200, 256], 1.0),
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
        ((1, 4, 2, 136), (1, 4, 2, 136), (1, 4, 2, 136)),  # head dim > 128
    ],
)
def test_attention_rejects_bad_shapes(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        fused_attention(q, k, v)


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
    "exact_dense_bias_d72": ("fused", (2, 30, 2, 72), 300, "bf16", "dense", ("mma", 0)),
    "exact_key_padding_fp32": ("fused", (2, 30, 2, 72), 300, "fp32", "padding", ("mma", 0)),
    "exact_key_padding_d64": ("fused", (2, 30, 2, 64), 300, "bf16", "padding", ("mma", 0)),
    "exact_fp32_d72": ("fused", (2, 30, 2, 72), 300, "fp32", None, ("mma", 0)),
    "exact_d64": ("fused", (2, 30, 2, 64), 300, "bf16", None, ("mma", 0)),
    "transposed_key_padding": ("transposed", (4, 4096, 16, 72), 120, "bf16", "padding",
                               ("sm90", "attention_long_bias")),
    "pixart1024_cross_k4_bias": ("fused", (4, 4096, 16, 72), 120, "bf16", "padding",
                                 ("sm90", "attention_long_bias")),
    "pixart2048_cross_k4_bias": ("fused", (2, 16384, 16, 72), 120, "bf16", "padding",
                                 ("sm90", "attention_long_bias")),
    "transposed_batch_broadcast_bias_d128": ("transposed", (3, 30, 2, 128), 300, "bf16",
                                             "broadcast", ("sm90", "attention_long_bias")),
    "transposed_key_padding_fp32": ("transposed", (2, 30, 2, 72), 300, "fp32", "padding",
                                    ("mma", 1)),
    "transposed_key_padding_d36": ("transposed", (2, 30, 2, 36), 300, "bf16", "padding",
                                   ("mma", 1)),
    "transposed_fp32": ("transposed", (2, 30, 2, 72), 300, "fp32", None, ("mma", 1)),
    "transposed_d36": ("transposed", (2, 30, 2, 36), 300, "bf16", None, ("mma", 1)),
    "rowblock_key_padding": ("rowblock", (2, 30, 2, 128), 300, "bf16", "padding",
                             ("sm90", "attention_rowblock_bias")),
    "rowblock_key_padding_d64": ("rowblock", (2, 30, 2, 64), 300, "bf16", "padding", ("mma", 2)),
    "rowblock_key_padding_fp32": ("rowblock", (2, 30, 2, 128), 300, "fp32", "padding",
                                  ("mma", 2)),
    "flash_key_padding": ("flash", (2, 30, 2, 128), 300, "bf16", "padding",
                          ("sm90", "attention_flash_bias")),
    "flash_key_padding_d72": ("flash", (2, 30, 2, 72), 300, "bf16", "padding",
                              ("sm90", "attention_flash_bias")),
    "flash_batch_broadcast_bias_d72": ("flash", (3, 30, 2, 72), 300, "bf16", "broadcast",
                                       ("sm90", "attention_flash_bias")),
    "flash_key_padding_fp32_d72": ("flash", (2, 30, 2, 72), 300, "fp32", "padding", ("mma", 3)),
    "flash_key_padding_d64": ("flash", (2, 30, 2, 64), 300, "bf16", "padding", ("mma", 3)),
    "pixart2048_flash_key_padding": ("fused", (2, 16384, 16, 72), 16384, "bf16", "padding",
                                     ("sm90", "attention_flash_bias")),
    "flux1536_flash_key_padding_d128": ("fused", (1, 9728, 24, 128), 9728, "bf16", "padding",
                                        ("sm90", "attention_flash_bias")),
    "rowblock_fp32": ("rowblock", (2, 30, 2, 128), 300, "fp32", None, ("mma", 2)),
    "flash_fp32": ("flash", (2, 30, 2, 128), 300, "fp32", None, ("mma", 3)),
    "flash_fp32_d72": ("flash", (2, 30, 2, 72), 300, "fp32", None, ("mma", 3)),
    "flash_d72": ("flash", (2, 30, 2, 72), 300, "bf16", None, ("sm90", "attention_flash")),
    "flash_d64": ("flash", (2, 30, 2, 64), 300, "bf16", None, ("mma", 3)),
    "rowblock_d64": ("rowblock", (2, 30, 2, 64), 300, "bf16", None, ("mma", 2)),
    "rowblock_key_padding_d128": ("fused", (1, 4608, 24, 128), 4608, "bf16", "padding",
                                  ("sm90", "attention_rowblock_bias")),
    "transposed_d72": ("transposed", (2, 30, 2, 72), 300, "bf16", None,
                       ("sm90", "attention_long")),
    "pixart2048_flash_d72": ("fused", (2, 16384, 16, 72), 16384, "bf16", None,
                             ("sm90", "attention_flash")),
}


@pytest.mark.parametrize("name", sorted(HOPPER_ROUTES))
def test_hopper_body_routing(name, monkeypatch):
    """bf16 calls without a bias at head dim 72 or 128 on the single-tile
    exact (K1), transposed clamp (K4) and streaming (K6) routes, and at 128
    on the row-block route (K5), launch the Hopper body, and so do bf16
    calls with a key-padding bias on each of them (K2, and K4, K5 and K6
    with a bias, at the same head dims), the bias passed on; every other
    call — a dense bias, fp32, another head dim — keeps its
    csrc/attention.cu variant.
    Tensors on the meta device reach the launch decision without a card;
    the launchers are replaced by recorders."""
    wrapper, shape, tk, dtype, bias_kind, want = HOPPER_ROUTES[name]
    calls = []

    def sm90(q, k, v, counter, bias=None):
        calls.append(("sm90", counter if bias is None else counter + "_bias"))

    monkeypatch.setattr(port_attention, "_launch_sm90", sm90)
    monkeypatch.setattr(port_attention, "_launch",
                        lambda q, k, v, bias, variant, n_pad: calls.append(("mma", variant)))
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    b, tq, h, d = shape
    q = torch.empty(shape, dtype=tdt, device="meta")
    kv = torch.empty((b, tk, h, d), dtype=tdt, device="meta")
    bias = {None: None, "padding": (b, 1, 1, tk), "broadcast": (1, 1, 1, tk),
            "dense": (b, h, tq, tk)}[bias_kind]
    bias = bias and torch.zeros(bias, dtype=tdt, device="meta")
    fn = {"fused": fused_attention, "rowblock": rowblock_attention,
          "flash": flash_attention, "transposed": transposed_attention}[wrapper]
    fn(q, kv, kv, bias)
    assert calls == [want]


# (wrapper, q shape, tk, dtype, bias kind) → the pad keys the csrc/attention.cu
# launch gets: none on the reference's XLA route (a dense bias past the
# single tile), round_up(Tk, 128) − Tk on the single-tile and clamp routes,
# round_up(Tk, min(1536, round_up(Tk, 128))) − Tk on the streaming one
PAD_KEY_LAUNCHES = {
    "dense_bias_past_the_tile_bf16": ("fused", (1, 2048, 2, 72), 1100, "bf16", "dense", 0),
    "dense_bias_past_the_tile_fp32": ("fused", (1, 2048, 2, 72), 1100, "fp32", "dense", 0),
    "dense_bias_past_the_tile_d64": ("fused", (2, 4096, 2, 64), 4096, "bf16", "dense", 0),
    "dense_bias_single_tile": ("fused", (2, 30, 2, 72), 300, "bf16", "dense", 84),
    "key_padding_single_tile_fp32": ("fused", (2, 30, 2, 72), 300, "fp32", "padding", 84),
    "clamp_key_padding_fp32": ("transposed", (2, 30, 2, 72), 300, "fp32", "padding", 84),
    "flash_key_padding_fp32": ("flash", (2, 30, 2, 72), 1600, "fp32", "padding", 1472),
    "flash_key_padding_d64": ("flash", (2, 30, 2, 64), 300, "bf16", "padding", 84),
}


@pytest.mark.parametrize("name", sorted(PAD_KEY_LAUNCHES))
def test_mma_launches_get_the_routes_pad_keys(name, monkeypatch):
    """csrc/attention.cu's C entry takes the pad keys from the wrapper: the
    route's count (`pad_keys`), 0 on the XLA route of a dense bias past the
    single tile, which the reference computes without pad keys. Meta
    tensors reach the launch; the launcher is replaced by a recorder."""
    wrapper, shape, tk, dtype, bias_kind, n_pad = PAD_KEY_LAUNCHES[name]
    calls = []
    monkeypatch.setattr(port_attention, "_launch_sm90",
                        lambda *a, **kw: pytest.fail("took the Hopper body"))
    monkeypatch.setattr(port_attention, "_launch",
                        lambda q, k, v, bias, variant, n: calls.append(n))
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    b, tq, h, d = shape
    q = torch.empty(shape, dtype=tdt, device="meta")
    kv = torch.empty((b, tk, h, d), dtype=tdt, device="meta")
    bias = torch.zeros((b, h, tq, tk) if bias_kind == "dense" else (b, 1, 1, tk),
                       dtype=tdt, device="meta")
    fn = {"fused": fused_attention, "flash": flash_attention,
          "transposed": transposed_attention}[wrapper]
    fn(q, kv, kv, bias)
    assert calls == [n_pad]


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


@pytest.mark.parametrize("d", [64, 80, 96])
def test_tma_operand_refuses_other_head_dims(d):
    with pytest.raises(ValueError, match="head dim 72 or 128"):
        port_attention.tma_operand(torch.zeros(1, 8, 1, d, dtype=torch.bfloat16), "q")


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
    """What the Hopper body does not read raises, through bias_operand and
    through the single-tile, clamp and streaming wrappers: a bias that is not (B|1, 1,
    1, Tk), or one in another dtype than bf16 or fp32; a dense bias is sent
    to csrc/attention.cu by the router (test_hopper_body_routing) and so
    never reaches bias_operand there."""
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


@pytest.mark.parametrize("d", [128, 72])
@pytest.mark.parametrize("fault", ["base_off_16_bytes", "row_stride_264_bytes",
                                   "head_dim_not_contiguous"])
def test_hopper_body_refuses_what_tma_cannot_map(fault, d, monkeypatch):
    """A bf16 call for the Hopper body whose base or strides TMA cannot
    take raises — through the single-tile, transposed and streaming
    wrappers, and at D=128 the row-block one — with or without a
    key-padding bias; it is not sent to the csrc/attention.cu body
    instead."""
    if fault == "base_off_16_bytes":
        bad = torch.zeros(2 * 64 * 2 * d + 1, dtype=torch.bfloat16)[1:].view(2, 64, 2, d)
    elif fault == "row_stride_264_bytes":  # 132 elements per head row
        bad = torch.zeros(2, 64, 2, 132, dtype=torch.bfloat16)[..., :d]
    else:
        bad = torch.zeros(2, 64, d, 2, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="TMA|contiguous"):
        port_attention.tma_operand(bad, "q")
    monkeypatch.setattr(port_attention, "_launch",
                        lambda *a, **kw: pytest.fail("fell back to attention.cu"))
    good = torch.empty(2, 64, 2, d, dtype=torch.bfloat16, device="meta")
    meta_bad = torch.empty_strided(bad.shape, bad.stride(), dtype=torch.bfloat16,
                                   device="meta")
    if fault == "base_off_16_bytes":  # a meta view keeps the 2-byte offset
        meta_bad = torch.empty(bad.numel() + 1, dtype=torch.bfloat16,
                               device="meta")[1:].view(bad.shape)
    wrappers = [fused_attention, transposed_attention, flash_attention]
    if d == 128:
        wrappers.append(rowblock_attention)
    for fn in wrappers:
        with pytest.raises(ValueError, match="TMA|contiguous"):
            fn(good, meta_bad, good)
    bias = torch.empty(2, 1, 1, 64, dtype=torch.bfloat16, device="meta")
    for fn in wrappers:
        with pytest.raises(ValueError, match="TMA|contiguous"):
            fn(good, meta_bad, good, bias)


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


def test_probe_script_needs_a_card():
    with pytest.raises(SystemExit, match="CUDA"):
        probe_attention_body.main([])
