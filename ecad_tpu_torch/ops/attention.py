"""Fused attention: the hand-written CUDA kernels, their plain versions and
the routing between the two softmax variants.

`fused_attention(q, k, v, bias=None)` takes ``(B, T, H, D)`` tensors, as
``ecad_tpu.ops.fused_attention`` does, and picks the function to compute
the way that one does (`attention_route`):

* **exact** — softmax(q·kᵀ/√D + bias)·v with an fp32 softmax and the row
  max subtracted. Replaces the Pallas kernels ``_attn_kernel`` (no bias,
  ecad_tpu/ops/attention.py:58) and ``_attn_kernel_bias`` (fp32 additive
  bias, :75). Plain version: `fused_attention_reference`.
* **exact_xla** — the same function for a dense bias past the single tile,
  where the reference calls XLA's ``jax.nn.dot_product_attention``
  (:701-707) and so adds no pad keys (below); the same kernel and plain
  version with n_pad = 0.
* **clamp** — the function of ``_transposed_kernel`` (:285) and
  ``_transposed_kernel_nobias`` (:344), which the reference takes for
  lane-padded head dims (PixArt's 72) from a 1 MiB score tile up:
  ``p = exp2(clip(s, −100, 80))`` with no row max, q pre-scaled by
  scale·log2e in its own dtype. `transposed_attention` launches it;
  plain version: `transposed_attention_reference`.
* **rowblock** — the same clamp function as the reference's row-block
  kernels ``_rowblock_kernel`` (:255) and ``_rowblock_kernel_nobias``
  (:274) compute it, for head dims that are a multiple of 128 past an
  8 MiB score tile (FLUX-1024's joint attention); called directly, at any
  head dim (the reference's kernel shoot-out takes it at 72).
  `rowblock_attention` launches it under its own kernel name and counters;
  plain version: `rowblock_attention_reference`.

* **flash** — the exact softmax of the reference's streaming kernel
  ``_flash_kernel`` (:151), which ``_flash_attention`` (:573-673) takes
  past 8192×128 key elements (PixArt-2048's 16384-token self-attention):
  q·kᵀ in fp32, then ×1/√D, plus the key-padding bias, p rounded to v's
  dtype for p·v. `flash_attention` launches it under its own kernel name
  and counters; plain version: `flash_attention_reference`.

Every route runs on one of two hand-written CUDA C++ sources (each says
what bounds its kernels on the H100). bf16 calls at any head dim up to
256 take the Hopper body of ``csrc/attention_sm90.cu`` (wgmma fed by TMA;
`_takes_sm90`), built at widths 16, 32, 64, 72, 128, 192 and 256 (a call
runs at the smallest at or above its head dim, `sm90_width`), without a
bias or with a key-padding bias (B|1, 1, 1, Tk):
the exact single-tile route (K1; K2 with a bias) — PixArt's 256²
self-attention and its text cross-attention at 256² and 512², FLUX.1-dev's
joint attention at 256², and the reference's width-reduced FLUX (head dim
64) in its routing experiment (scripts/exp_attn_pixart256.py) — and, on
that route and on the XLA route of a dense bias past the tile, with any
other bias that broadcasts (dense, per head, per query row, strided:
``attn_exact_dense_sm90_kernel``, read by the consumers in its own dtype;
`dense_bias_operand`), which no served path sends; the
transposed clamp route (K4, with a bias too) — PixArt's 1024²
self-attention and its text cross-attention at 1024² and PixArt-Σ's at
2048², and the width-reduced FLUX at 256² as the router sends it; the
streaming route (K6, with a bias too) — PixArt-Σ's 2048² self-attention,
FLUX.1-dev's at 1536² and the width-reduced FLUX's; and the row-block
route (K5, with a bias too) — FLUX.1-dev at 1024², and at other head dims
what `rowblock_attention` called directly reaches (the router takes that
route at multiples of 128 alone; the kernel shoot-out,
scripts/bench_attention_kernels.py, calls it at 72). Served paths run
head dims 72 and 128 only. The attention-variant harness's X1, X2 and X3
take the same body in bf16 at 72 and 128, and X4 at 72 (`attn_variants`).
fp32 calls at any head dim up to 512 take the fp32 body of
``csrc/attention_f32_sm90.cu`` (the products on the tensor cores through a
3×TF32 split), built at widths 16, 32, 40, 64, 72, 96, 128,
192, 256, 384 and 512 (`f32_width`; from 256 on clusters of two, three and
four blocks of 128 columns), on every route — K1, K2 (with any bias that
broadcasts, dense ones too), K4, K5 and K6 — under the same counters.
Operands TMA cannot map (a base off 16 bytes, strides that are not
multiples of 16 bytes: bf16 at a head dim that is not a multiple of 8, fp32
at one that is not a multiple of 4) reach either body as a packed copy
(`tma_copy`). Past its widest width (`MAX_HEAD_DIM`: 256 in bf16, 512 in
fp32) either body runs a streamed form of each
route (`WIDE_SLICE`): q·kᵀ over all of the head dim in column boxes that
stream through shared memory beside k's, p·v over one slice of o's columns
a work item; there is no upper limit on the head dim, on the card or in
the plain versions. A bf16 call whose bias the body does
not read (`bias_operand`, `dense_bias_operand`: bf16 or fp32) raises. The
old ``csrc/attention.cu`` body (`_launch`) is reached by no wrapper: the
kernel checks and scripts/compare_attention_bodies.py time it beside the
Hopper bodies.

The exact routes' pad keys. The reference pads the keys of the exact
routes with keys of score −1e9 whose rows of v are 0: to round_up(Tk, 128)
on the single-tile route, to a multiple of min(1536, round_up(Tk, 128)) on
the streaming one; none on the XLA route of a dense bias past the single
tile (`pad_keys`). They weigh exactly 0 unless every real score of a row
is within 104 of −1e9 or below it (a caller bias of −1e9 or less); then
they take their share. The plain versions and the kernels add them the
same way (`_exact_weights`, and each kernel's epilogue).

On a CPU tensor every wrapper runs its plain version. On a CUDA tensor it
launches the kernel or raises: there is no fallback. Each launch adds one
to ``LAUNCHES``: ``attention`` / ``attention_bias`` (exact, without / with
a bias), ``attention_long`` / ``attention_long_bias`` (clamp, transposed
route), ``attention_rowblock`` / ``attention_rowblock_bias`` (clamp,
row-block route) and ``attention_flash`` / ``attention_flash_bias``
(exact, streaming route). The attention-variant harness's kernels (X2,
X3, X4 and X1: modes 4, 5, 6 and 7 of the Hopper body) are wrapped in
`attn_variants` and count under ``xattn_*``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

LAUNCHES = {
    "attention": 0,
    "attention_bias": 0,
    "attention_long": 0,
    "attention_long_bias": 0,
    "attention_rowblock": 0,
    "attention_rowblock_bias": 0,
    "attention_flash": 0,
    "attention_flash_bias": 0,
    # the attention-variant harness's kernels (X1-X4, ops/attn_variants.py)
    "xattn_matmul_only": 0,
    "xattn_nomax": 0,
    "xattn_max": 0,
    "xattn_fd": 0,
}
# kernel variant of the C entry point → counter name (without "_bias")
_VARIANTS = {0: "attention", 1: "attention_long", 2: "attention_rowblock", 3: "attention_flash"}

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# the widest head dim the built widths take, by dtype; past it each body's
# streamed form runs (`sm90_width`, `f32_width`), o in slices of
# `WIDE_SLICE` columns
MAX_HEAD_DIM = {torch.bfloat16: 256, torch.float32: 512}
# o's columns a work item of the streamed forms past `MAX_HEAD_DIM`, by dtype
WIDE_SLICE = {torch.bfloat16: 256, torch.float32: 128}
_FN = None
_SM90_FN = None
_F32_FN = None
# the widths the Hopper body (csrc/attention_sm90.cu) is built at: a head
# dim d runs at the smallest at or above it, its columns past d zero-filled
SM90_WIDTHS = (16, 32, 64, 72, 128, 192, 256)
# the Hopper body's kernels, by counter name: the C entry's mode and the
# widths it is built for; the last four are the attention-variant harness's
# X2, X3, X4 and X1 (`attn_variants`), built at 72 and 128 (X4 at 72) and
# taken only at those head dims
_SM90_MODES = {"attention_flash": (0, SM90_WIDTHS), "attention_rowblock": (1, SM90_WIDTHS),
               "attention": (2, SM90_WIDTHS), "attention_long": (3, SM90_WIDTHS),
               "xattn_nomax": (4, (72, 128)), "xattn_max": (5, (72, 128)),
               "xattn_fd": (6, (72,)), "xattn_matmul_only": (7, (72, 128))}
_SM90_HARNESS = ("xattn_nomax", "xattn_max", "xattn_fd", "xattn_matmul_only")
# the routes whose Hopper kernel also takes a key-padding bias: K2, K4, K5, K6
_SM90_BIAS = ("attention", "attention_long", "attention_rowblock", "attention_flash")
# the bias dtypes the Hopper body reads, with the C entry's code for each
_SM90_BIAS_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the fp32 Hopper body's kernels (csrc/attention_f32_sm90.cu), by counter
# name: the C entry's route; and the widths it is built at (multiples of 8,
# TF32's k-step), each head dim at the smallest at or above it: 256, 384
# and 512 on clusters of 2, 3 and 4 blocks of 128 columns
_F32_ROUTES = {"attention_flash": 0, "attention_rowblock": 1, "attention": 2, "attention_long": 3}
F32_WIDTHS = (16, 32, 40, 64, 72, 96, 128, 192, 256, 384, 512)

# The reference's routing constants (ecad_tpu/ops/attention.py :95, :134,
# :148). They decide WHICH function a shape gets — the clamp softmax or the
# max-subtract one — so they are kept as the reference has them; they are
# not tuned for the H100.
_SINGLE_TILE_SCORE_BYTES = 8 * 1024 * 1024
_ROWBLOCK_MAX_KV_ELEMS = 8192 * 128
_TRANSPOSED_MIN_SCORE_BYTES = 1024 * 1024
_LOG2E = 1.4426950408889634
_CLAMP_LO, _CLAMP_HI = -100.0, 80.0  # log2 domain (:200-201)
_PAD_KEY_WEIGHT = 2.0 ** _CLAMP_LO  # a −1e9-biased pad key of the clamp routes
_PAD_SCORE = -1e9  # a pad key's score on the exact routes (:103, :755-772)
_FLASH_BLOCK_K = 1536  # the streaming route's key block (:102)


def _kernel():
    global _FN
    if _FN is None:
        from ._build import load_library

        fn = load_library("attention").ecad_attention_fwd
        fn.argtypes = [
            ctypes.c_int,  # dtype
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
            ctypes.c_void_p,  # o
            ctypes.c_void_p,  # bias (fp32) or NULL
            ctypes.POINTER(ctypes.c_longlong),  # 16 strides
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H Tq Tk
            ctypes.c_int,  # D
            ctypes.c_float,  # scale: 1/√D (the exact variants)
            ctypes.c_float,  # q_scale: bf16(scale·log2e) in q's dtype (the others)
            ctypes.c_int,  # vec_ok
            ctypes.c_int,  # variant: 0 exact, 1 clamp (K4), 2 row-block (K5), 3 flash (K6)
            ctypes.c_int,  # n_pad: the route's pad keys (`pad_keys`)
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _sm90_kernel():
    global _SM90_FN
    if _SM90_FN is None:
        from ._build import load_library

        fn = load_library("attention_sm90").ecad_attention_sm90_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
            ctypes.c_void_p,  # o
            ctypes.POINTER(ctypes.c_ulonglong),  # 3 × 11 tensor-map arguments
            ctypes.POINTER(ctypes.c_longlong),  # o's strides (b, t, h)
            ctypes.c_void_p,  # key-padding bias (modes 0-3), dense bias (mode 2) or NULL
            ctypes.POINTER(ctypes.c_longlong),  # its strides (batch, head, query row, key)
            ctypes.c_int,  # the bias is bf16 (1) or fp32 (0)
            ctypes.c_int,  # the bias is dense (1) or a key-padding one (0)
            ctypes.c_int,  # a dense bf16 bias has 4-byte-aligned key pairs (1)
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H Tq Tk
            ctypes.c_float,  # scale: 1/√D (the exact modes)
            ctypes.c_float,  # q_scale: bf16(scale·log2e) (the modes with a pre-scaled q)
            ctypes.c_int,  # mode: 0 exact streaming (K6), 1 clamp row-block (K5),
            # 2 exact single-tile (K1; K2 with a bias), 3 clamp transposed (K4),
            # 4 the harness's no max (X2), 5 its max on a pre-scaled q (X3),
            # 6 its clamp with the denominator from the p·v products (X4),
            # 7 its bf16(q·kᵀ)·v with no softmax (X1)
            ctypes.c_int,  # n_pad: the route's pad keys (`pad_keys`; 0 in modes 4-7)
            ctypes.c_int,  # the width the call runs at (`sm90_width`)
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _SM90_FN = fn
    return _SM90_FN


def _f32_kernel():
    global _F32_FN
    if _F32_FN is None:
        from ._build import load_library

        fn = load_library("attention_f32_sm90").ecad_attention_f32_sm90_fwd
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
            ctypes.c_void_p,  # o
            ctypes.POINTER(ctypes.c_ulonglong),  # 3 × 7 tensor-map arguments (q, k, v)
            ctypes.POINTER(ctypes.c_longlong),  # 7 strides: o (b, t, h), bias (b, h, q, k)
            ctypes.c_void_p,  # fp32 bias or NULL
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H Tq Tk
            ctypes.c_float,  # 1/√D (exact routes) or clamp_scale(D, float32) (clamp routes)
            ctypes.c_int,  # route: 0 streaming (K6), 1 row-block (K5), 2 single-tile (K1,
            # K2), 3 transposed (K4)
            ctypes.c_int,  # n_pad: the route's pad keys (`pad_keys`)
            ctypes.c_int,  # the width the call runs at (`f32_width`)
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _F32_FN = fn
    return _F32_FN


def _exact_weights(s: torch.Tensor, n_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """exp(s − m) and the row sums of the exact softmax over fp32 scores
    `s`, with the reference's `n_pad` pad keys of score −1e9 (rows of v 0):
    they raise the max to at least −1e9 and add n_pad·exp(−1e9 − m) to the
    sum, which is exactly 0 unless every score of the row is near −1e9 or
    below it."""
    m = s.amax(dim=-1, keepdim=True)
    if n_pad:
        m = m.clamp(min=_PAD_SCORE)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    if n_pad:
        denom = denom + n_pad * torch.exp(_PAD_SCORE - m)
    return p, denom


def fused_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    n_pad: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (and of ``_attn_kernel`` /
    ``_attn_kernel_bias``): fp32 upcast, q scaled by 1/√D, fp32 bias added,
    row-max subtracted, exp, p·v, one divide by the row sum, one cast; with
    `n_pad` pad keys of score −1e9 (`_exact_weights`), by default the
    single-tile route's round_up(Tk, 128) − Tk (`pad_keys`; 0 on the XLA
    route of a dense bias past the tile, which normalises p in fp32 and
    rounds it to v's dtype before p·v where this divides at the end: in
    bf16 the two differ by p's rounding)."""
    d, tk = q.shape[-1], k.shape[1]
    qf = q.float().permute(0, 2, 1, 3) * (1.0 / math.sqrt(d))
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    s = qf @ kf.transpose(-1, -2)
    if bias is not None:
        s = s + bias.float()
    p, denom = _exact_weights(s, pad_keys("exact", tk) if n_pad is None else n_pad)
    out = (p @ vf) / denom
    return out.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def _check(q, k, v, bias) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("fused_attention takes (B, T, H, D) tensors")
    b, tq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"q, k, v must share one of {list(_DTYPES)}; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if bias is not None:
        target = (b, h, tq, k.shape[1])
        if bias.dim() != 4 or any(
            s not in (1, t) for s, t in zip(bias.shape, target)
        ):
            raise ValueError(
                f"bias {tuple(bias.shape)} does not broadcast to {target}"
            )
        if bias.device != q.device:
            raise ValueError("bias must be on the device of q")
        if not bias.is_floating_point():
            raise TypeError(f"bias is added to the scores; got {bias.dtype}")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _key_padding_bias_ok(bias: Optional[torch.Tensor], batch: int) -> bool:
    """The reference's ``_flash_bias_ok`` (:43-55): None, or a key-padding
    bias (B, 1, 1, Tk) / batch-broadcast (1, 1, 1, Tk)."""
    return bias is None or (
        bias.dim() == 4
        and bias.shape[1] == 1
        and bias.shape[2] == 1
        and bias.shape[0] in (1, batch)
    )


def attention_route(
    q_shape: tuple, tk: int, bias: Optional[torch.Tensor] = None
) -> str:
    """Which function the reference's ``fused_attention`` (:677-720, with
    ``_flash_attention`` :591-597) computes for these shapes: "exact" (the
    single-tile kernels), "exact_xla" (XLA, for a dense bias past the
    tile), "clamp" (the transposed kernel K4), "rowblock" (K5) or "flash"
    (K6)."""
    b, tq, _, d = q_shape
    score_bytes = _round_up(tq, 8) * _round_up(tk, 128) * 4
    padding_ok = _key_padding_bias_ok(bias, b)
    if score_bytes > _SINGLE_TILE_SCORE_BYTES:
        if not padding_ok:
            return "exact_xla"
        if _round_up(tk, 128) * _round_up(d, 128) <= _ROWBLOCK_MAX_KV_ELEMS:
            return "clamp" if d % 128 else "rowblock"
        return "flash"
    if d % 128 and score_bytes >= _TRANSPOSED_MIN_SCORE_BYTES and padding_ok:
        return "clamp"
    return "exact"


def pad_keys(route: str, tk: int) -> int:
    """The reference's pad keys on `route` for `tk` keys: up to a multiple
    of 128 on the single-tile and clamp routes (score −1e9 on the exact
    one, 2^-100 each in Σp on the clamp ones), of the key block min(1536,
    round_up(Tk, 128)) on the streaming route, none on the XLA route."""
    if route == "exact_xla":
        return 0
    block = min(_FLASH_BLOCK_K, _round_up(tk, 128)) if route == "flash" else 128
    return _round_up(tk, block) - tk


@functools.lru_cache(maxsize=None)
def clamp_scale(d: int, dtype: torch.dtype) -> float:
    """scale·log2e = log2(e)/√D rounded to `dtype`, as the reference's
    ``jnp.asarray(scale, q.dtype)`` (:378-383) rounds it (kept per (D,
    dtype): every launch passes it, and making it takes a tensor)."""
    return float(torch.tensor(_LOG2E / math.sqrt(d)).to(dtype))


def transposed_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the clamp kernel (and of
    ``_transposed_kernel`` / ``_transposed_kernel_nobias``): q times
    scale·log2e rounded to q's dtype, s = q·kᵀ in fp32 plus the
    key-padding bias times log2e, p = exp2(clip(s, −100, 80)), Σp in fp32,
    p rounded to v's dtype for p·v, one divide, one cast. The reference
    pads the keys to Tk_pad = round_up(Tk, 128) with a −1e9 bias, which
    clamps to 2^-100 each, and their rows of v are 0: so Σp here gains
    (Tk_pad − Tk)·2^-100 for them. That is nothing beside a logit above the
    clamp's floor, but in a row whose every logit is clamped at −100 (an
    all-masked text row) it makes the weights 1/Tk_pad, as the
    reference's."""
    tk = k.shape[1]
    qs = q * torch.tensor(clamp_scale(q.shape[-1], q.dtype), dtype=q.dtype)
    qf = qs.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    s = qf @ kf.transpose(-1, -2)
    if bias is not None:
        s = s + bias.float() * _LOG2E
    p = torch.exp2(s.clamp(_CLAMP_LO, _CLAMP_HI))
    denom = p.sum(dim=-1, keepdim=True) + pad_keys("clamp", tk) * _PAD_KEY_WEIGHT
    out = (p.to(v.dtype).float() @ vf) / denom
    return out.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def rowblock_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the row-block kernel (and of
    ``_rowblock_kernel`` / ``_rowblock_kernel_nobias``). The function is
    the transposed kernel's — q × bf16(scale·log2e) in q's dtype
    (:491-492), exp2(clip(s, −100, 80)), Σp in fp32, bf16 p into p·v — only
    the TPU layout differs, and its two kv chunks (:496-501) change only the
    order of the fp32 sums; so the body is shared."""
    return transposed_attention_reference(q, k, v, bias)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the streaming kernel (and of
    ``_flash_kernel``): s = q·kᵀ in fp32 from operands in their own dtype,
    times 1/√D on the fp32 scores (q is not pre-scaled, :172-178), plus the
    fp32 key-padding bias, the row max subtracted, natural exp, Σp in fp32,
    p rounded to v's dtype for p·v (:187-190), one divide, one cast. The
    reference streams keys in blocks of 1536 with an online max; that
    changes only which running max each p is rounded against before the
    cast, and the order of the fp32 sums. The reference pads the keys to a
    multiple of bk = min(1536, round_up(Tk, 128)) with −1e9-biased keys
    whose rows of v are 0; they are added as `_exact_weights` says."""
    d, tk = q.shape[-1], k.shape[1]
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if bias is not None:
        s = s + bias.float()
    p, denom = _exact_weights(s, pad_keys("flash", tk))
    out = (p.to(v.dtype).float() @ vf) / denom
    return out.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def _launch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    variant: int,
    n_pad: int,
) -> torch.Tensor:
    """One launch of csrc/attention.cu's kernel on q's device (its mma.sync
    body in bf16, its SIMT kernel in fp32, at head dims up to 128): the old
    body, which no wrapper reaches; chip_smoke.py's kernel checks and
    scripts/compare_attention_bodies.py time it beside the Hopper bodies.
    `variant` 0 is the exact softmax, 1 the clamp softmax of the transposed route (K4), 2 that of the
    row-block route (K5), 3 the exact softmax of the streaming route (K6),
    with the route's `n_pad` pad keys (`pad_keys`). Counts it."""
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    tensors = (q, k, v, out)
    strides = [s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))]
    if bias is not None:
        bias = bias.float()
        strides += [
            0 if bias.shape[i] == 1 else bias.stride(i) for i in range(4)
        ]
    else:
        strides += [0, 0, 0, 0]
    elem = q.element_size()
    vec_ok = int(
        d % 8 == 0
        and all(t.data_ptr() % 16 == 0 for t in tensors)
        and all((s * elem) % 16 == 0 for s in strides[:12])
    )
    with torch.cuda.device(q.device):
        status = _kernel()(
            _DTYPES[q.dtype],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if bias is None else bias.data_ptr(),
            (ctypes.c_longlong * 16)(*strides),
            b, h, tq, tk, d,
            1.0 / math.sqrt(d), clamp_scale(d, q.dtype),
            vec_ok,
            variant,
            n_pad,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"attention kernel launch failed: cudaError_t {status} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}, variant={variant})"
        )
    name = _VARIANTS[variant]
    LAUNCHES[name if bias is None else name + "_bias"] += 1
    return out


def _smallest_width(widths: tuple, d: int) -> int:
    """The smallest of `widths` at or above head dim `d`; past the widest
    (`MAX_HEAD_DIM`), round_up(d, 64): the streamed form, whose q·kᵀ walks
    the head dim in 64-column chunks."""
    for w in widths:
        if d <= w:
            return w
    return _round_up(d, 64)


def sm90_width(d: int, counter: str = "attention") -> int:
    """The width of the Hopper body a bf16 call at head dim `d` on the route
    of `counter` runs at: the smallest built width at or above `d` on the
    four routes, round_up(d, 64) past 256 (the streamed form), `d` itself
    for the harness's X1-X4 (their widths only; ValueError at another)."""
    widths = _SM90_MODES[counter][1]
    if counter in _SM90_HARNESS:
        if d not in widths:
            raise ValueError(f"the attention-variant harness's {counter} takes head dims "
                             f"{widths}; got {d}")
        return d
    return _smallest_width(widths, d)


def f32_width(d: int) -> int:
    """The width of the fp32 Hopper body an fp32 call at head dim `d` runs
    at: the smallest of `F32_WIDTHS` at or above `d` (384 for d 257-384,
    512 for 385-512: clusters of three and four blocks), round_up(d, 64)
    past 512 (the streamed form)."""
    return _smallest_width(F32_WIDTHS, d)


def f32_resident_clusters(width: int, counter: str, bias: bool = False) -> int:
    """The clusters of the fp32 body's kernel of `counter`'s route at the
    built `width` (with or without a bias) that the card holds at once
    (`cudaOccupancyMaxActiveClusters`: its launch's grid; 1 below 256,
    where no cluster launches). Needs a card; raises if the query fails."""
    from ._build import load_library

    fn = load_library("attention_f32_sm90").ecad_attention_f32_sm90_clusters
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(0):
        n = fn(width, _F32_ROUTES[counter], int(bias))
    if n < 0:
        raise RuntimeError(f"cluster query at width {width} failed: cudaError_t {-n}")
    return n


def tma_operand(t: torch.Tensor, name: str, width: Optional[int] = None) -> list[int]:
    """The arguments of the 4-D TMA tensor map of a bf16 (B, T, H, D)
    operand of the Hopper body at `width` (by default `sm90_width(D)`): the
    dims {D, H, T, B} (innermost first), the byte strides of H, T and B, and
    the box {the width's box columns, 1, its tile's keys, 1} — 11 integers.
    The box is 64 columns (128 bytes, the 128-byte swizzle's width: columns
    0-63, the whole row at width 64, and 64-127, … at 128, 192, 256 and past
    256, where q·kᵀ streams the boxes of a row one after the other) or, at
    widths 32 and 16, the whole row under the 64- or 32-byte swizzle; its
    rows are 128 keys, 64 past width 128. At width 72 the C entry adds a map
    with an 8-column box and no swizzle for columns 64-71. Columns from D to
    the width are TMA's zero fill. TMA needs a 16-byte-aligned base and
    strides that are multiples of 16 bytes (below 2^40); a dimension of size
    1 is never stepped along, so it takes the packed stride. Raises
    ValueError for another dtype or where the operand does not meet them
    (`tma_copy` makes a copy that does)."""
    b, tt, h, d = t.shape
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the Hopper body takes bf16; got {t.dtype}")
    width = sm90_width(d) if width is None else width
    strides, problem = _tma_strides(t)
    if problem:
        raise ValueError(name + problem)
    return [d, h, tt, b, *strides, *_sm90_box(width)]


def _sm90_box(width: int) -> list[int]:
    """The Hopper body's box at `width`: {64 columns (the whole row at 32
    and 16), 1 head, 128 keys (64 past 128), 1 batch entry}."""
    return [min(width, 64), 1, 64 if width > 128 else 128, 1]


def _tma_strides(t: torch.Tensor) -> tuple[list[int], str]:
    """The byte strides of H, T and B of a (B, T, H, D) operand for a TMA
    tensor map, and "" — or no strides and what TMA cannot take: a last
    dim that is not contiguous, a base off 16 bytes, a stride that is not a
    multiple of 16 bytes (below 2^40). A dimension of size 1 is never
    stepped along, so it takes the packed stride, rounded up to 16 bytes
    (a head of 36 bf16 in rows padded to 40: 80 bytes)."""
    b, tt, h, d = t.shape
    sb_, st_, sh_, sd_ = t.stride()
    if sd_ != 1:
        return [], " must be contiguous in its last dim"
    if t.data_ptr() % 16:
        return [], f": TMA needs a 16-byte-aligned base; got {t.data_ptr():#x}"
    elem = t.element_size()
    strides, packed = [], d * elem
    for size, stride in ((h, sh_), (tt, st_), (b, sb_)):
        sb = stride * elem if size > 1 else _round_up(packed, 16)
        if sb % 16 or not 0 < sb < 2**40:
            return [], (f": TMA needs strides that are multiples of 16 bytes; "
                        f"got strides {t.stride()} of {t.dtype}")
        strides.append(sb)
        packed = sb * size
    return strides, ""


def _padded(shape: tuple, dtype: torch.dtype, device, cols: int) -> torch.Tensor:
    """An empty (B, T, H, D) tensor whose rows are `cols` ≥ D elements
    apart: a view of the first D columns of a packed (B, T, H, cols) one."""
    b, tt, h, d = shape
    out = torch.empty((b, tt, h, cols), dtype=dtype, device=device)
    return out if cols == d else out[..., :d]


def tma_copy(t: torch.Tensor) -> torch.Tensor:
    """`t` where TMA can map it (`_tma_strides`), else a copy that it can:
    packed, each row padded to a multiple of 16 bytes (the padding is never
    read: the map's inner dim stays D). What a base off 16 bytes, strides
    TMA cannot step (bf16 at D % 8 ≠ 0, fp32 at D % 4 ≠ 0) or a last dim
    that is not contiguous costs on the card: one copy of the operand."""
    if not _tma_strides(t)[1]:
        return t
    out = _padded(tuple(t.shape), t.dtype, t.device, _round_up(t.shape[-1], 16 // t.element_size()))
    return out.copy_(t)


def _tma_ready(t: torch.Tensor) -> tuple[torch.Tensor, list[int]]:
    """`t` and its tensor map's dims {D, H, T, B} and byte strides of H, T
    and B (`_tma_strides`), or a copy TMA can map (`tma_copy`) and its
    own: each operand's strides found once a launch."""
    strides, problem = _tma_strides(t)
    if problem:
        t = tma_copy(t)
        strides = _tma_strides(t)[0]
    b, tt, h, d = t.shape
    return t, [d, h, tt, b, *strides]


def f32_tma_operand(t: torch.Tensor, name: str) -> list[int]:
    """The arguments of the TMA tensor map of an fp32 (B, T, H, D) operand
    of the fp32 Hopper body: the dims {D, H, T, B} and the byte strides of
    H, T and B — 7 integers; the C entry loads q and k in 8-column boxes
    under the 32-byte swizzle and v in rows of the call's width
    (`f32_width`; past 512 in slices of `WIDE_SLICE` columns), columns from
    D on TMA's zero fill. Raises ValueError for another dtype or where TMA
    cannot map the operand (`_tma_strides`; `tma_copy` makes a copy that it
    can)."""
    b, tt, h, d = t.shape
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: the fp32 Hopper body takes fp32; got {t.dtype}")
    strides, problem = _tma_strides(t)
    if problem:
        raise ValueError(name + problem)
    return [d, h, tt, b, *strides]


def bias_operand(bias: torch.Tensor, batch: int) -> tuple[list[int], int]:
    """The launch arguments of the Hopper body's key-padding bias (B|1, 1,
    1, Tk): its element strides over the batch and the keys, each 0 where
    the bias broadcasts, and its dtype's code (1 bf16, 0 fp32). The body
    reads it with plain loads in its own dtype, so any strides and any
    element-aligned base will do. Raises ValueError for a bias of another
    shape or dtype."""
    if not _key_padding_bias_ok(bias, batch):
        raise ValueError("the Hopper body takes only key-padding biases (B|1, 1, 1, Tk); "
                         f"got {tuple(bias.shape)}")
    if bias.dtype not in _SM90_BIAS_DTYPES:
        raise ValueError(f"the Hopper body reads a bf16 or fp32 bias; got {bias.dtype}")
    strides = [0 if bias.shape[i] == 1 else bias.stride(i) for i in (0, 3)]
    return strides, _SM90_BIAS_DTYPES[bias.dtype]


def dense_bias_operand(bias: torch.Tensor, tk: int) -> tuple[list[int], int, int]:
    """The launch arguments of the Hopper body's dense bias (B|1, H|1,
    Tq|1, Tk|1) on the exact single-tile and XLA routes
    (``attn_exact_dense_sm90_kernel``): its element strides over the batch,
    the heads, the query rows and the keys, each 0 where the bias
    broadcasts; its dtype's code (1 bf16, 0 fp32); and whether its
    consumers may load it as 4-byte pairs of neighbouring keys (1: bf16
    with an even element offset of the base, key stride 1, even strides and
    an even `tk`), else they load each value where it is used. Any strides
    and any element-aligned base will do. Raises ValueError for a bias in
    another dtype."""
    if bias.dtype not in _SM90_BIAS_DTYPES:
        raise ValueError(f"the Hopper body reads a bf16 or fp32 bias; got {bias.dtype}")
    strides = [0 if bias.shape[i] == 1 else bias.stride(i) for i in range(4)]
    pairs = (bias.dtype == torch.bfloat16 and bias.data_ptr() % 4 == 0 and strides[3] == 1
             and tk % 2 == 0 and all(s % 2 == 0 for s in strides[:3]))
    return strides, _SM90_BIAS_DTYPES[bias.dtype], int(pairs)


def _takes_sm90(counter: str, q: torch.Tensor, bias: Optional[torch.Tensor]) -> bool:
    """Whether a call of the route that counts under `counter` goes to the
    Hopper body (csrc/attention_sm90.cu): bf16 at any head dim (the
    harness's X1-X4 at their own widths only), without a
    bias or, on a route whose kernel takes one (`_SM90_BIAS`), with a
    key-padding bias; on the exact single-tile route (``attention``: the XLA
    route of a dense bias past the tile too) with any bias. A function of
    route, dtype, head dim and bias only."""
    d = q.shape[-1]
    fits = d in _SM90_MODES[counter][1] if counter in _SM90_HARNESS else True
    return (q.dtype == torch.bfloat16 and fits
            and (bias is None or counter == "attention" or (
                counter in _SM90_BIAS and _key_padding_bias_ok(bias, q.shape[0]))))


def _launch_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str,
                 bias: Optional[torch.Tensor] = None, n_pad: int = 0) -> torch.Tensor:
    """One launch of the Hopper body in the mode of counter `name`
    (``attention``: exact single-tile, K1, or K2 with a key-padding `bias`
    or, under its own kernel name, any other `bias` that broadcasts from
    (B|1, H|1, Tq|1, Tk|1); ``attention_long``: clamp transposed, K4;
    ``attention_rowblock``: clamp row-block, K5, each also with a
    key-padding `bias`; ``attention_flash``: exact streaming, K6, also with
    a key-padding `bias`; ``xattn_nomax`` and ``xattn_max``: the
    attention-variant harness's exp2 softmax without and with the max on a
    pre-scaled q, X2 and X3, no bias, Tk % 128 == 0; ``xattn_fd``: its
    clamp softmax with the denominator from the p·v products, X4, D=72, no
    bias, any Tk; ``xattn_matmul_only``: its bf16(q·kᵀ)·v with no softmax,
    X1, no bias, Tk % 128 == 0), with the route's `n_pad` pad keys
    (`pad_keys`; the harness's modes take none), at the width `sm90_width`
    gives (past 256 the streamed form of the route, any bias read value by
    value). Operands TMA cannot map go to the kernel as copies (`tma_copy`),
    and at a head dim that is not a multiple of 8 o comes back through one
    (its rows' padding). Raises where no width takes the head dim (X1-X4)
    or the body does not read the bias (`bias_operand`, `dense_bias_operand`).
    Counts it under `name`, or ``name_bias``."""
    b, tq, h, d = q.shape
    width = sm90_width(d, name)
    (q, qm), (k, km), (v, vm) = (_tma_ready(t) for t in (q, k, v))
    box = _sm90_box(width)
    maps = [*qm, *box, *km, *box, *vm, *box]
    tk = k.shape[1]
    dense = bias is not None and not _key_padding_bias_ok(bias, b)
    if bias is None:
        bias_strides, bias_bf16, pairs = [0, 0, 0, 0], 0, 0
    elif dense:
        bias_strides, bias_bf16, pairs = dense_bias_operand(bias, tk)
    else:
        (sb, sk), bias_bf16 = bias_operand(bias, b)
        bias_strides, pairs = [sb, 0, 0, sk], 0
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    mode = _SM90_MODES[name][0]
    # o's rows a multiple of 16 bytes apart, as its TMA store needs
    out = _padded((b, tq, h, d), q.dtype, q.device, _round_up(d, 8))
    with torch.cuda.device(q.device):
        status = _sm90_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            (ctypes.c_ulonglong * len(maps))(*maps),
            (ctypes.c_longlong * 3)(out.stride(0), out.stride(1), out.stride(2)),
            None if bias is None else bias.data_ptr(),
            (ctypes.c_longlong * 4)(*bias_strides), bias_bf16, int(dense), pairs,
            b, h, tq, tk, 1.0 / math.sqrt(d), clamp_scale(d, q.dtype), mode, n_pad, width,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"Hopper attention launch failed: status {status} (cudaError_t, or 100000 + "
            f"the CUresult of a refused tensor map; q {tuple(q.shape)}, k {tuple(k.shape)})"
        )
    LAUNCHES[name if bias is None else name + "_bias"] += 1
    return out.contiguous()


def _launch_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str,
                bias: Optional[torch.Tensor], n_pad: int) -> torch.Tensor:
    """One launch of the fp32 Hopper body on the route of counter `name`
    (``attention``: exact single-tile, K1, or K2 with a `bias` that
    broadcasts from (B|1, H|1, Tq|1, Tk|1), dense too; ``attention_flash``:
    exact streaming, K6; ``attention_long`` and ``attention_rowblock``:
    clamp transposed, K4, and row-block, K5; these three with no bias or a
    key-padding one), with the route's `n_pad` pad keys (`pad_keys`), at the
    width `f32_width` gives (past 512 the streamed form). Operands TMA
    cannot map go to the kernel as copies (`tma_copy`); the kernel writes
    all of the width's columns of o (the streamed form its first D), so
    below the width o comes back through a copy of its first D. Counts it
    under `name`, or ``name_bias``."""
    b, tq, h, d = q.shape
    width = f32_width(d)
    (q, qm), (k, km), (v, vm) = (_tma_ready(t) for t in (q, k, v))
    maps = [*qm, *km, *vm]
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    out = _padded((b, tq, h, d), q.dtype, q.device, width)
    strides = [out.stride(0), out.stride(1), out.stride(2)]
    if bias is not None:
        bias = bias.float()
        strides += [0 if bias.shape[i] == 1 else bias.stride(i) for i in range(4)]
    else:
        strides += [0, 0, 0, 0]
    route = _F32_ROUTES[name]
    scale = 1.0 / math.sqrt(d) if route in (0, 2) else clamp_scale(d, torch.float32)
    with torch.cuda.device(q.device):
        status = _f32_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            (ctypes.c_ulonglong * len(maps))(*maps), (ctypes.c_longlong * 7)(*strides),
            None if bias is None else bias.data_ptr(),
            b, h, tq, k.shape[1], scale, route, n_pad, width,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"fp32 Hopper attention launch failed: status {status} (cudaError_t, or 100000 + "
            f"the CUresult of a refused tensor map; q {tuple(q.shape)}, k {tuple(k.shape)})"
        )
    LAUNCHES[name if bias is None else name + "_bias"] += 1
    return out.contiguous()


def _launch_card(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str,
                 bias: Optional[torch.Tensor], n_pad: int) -> torch.Tensor:
    """The route of counter `name` on q's device: bf16 on the Hopper body
    (`_launch_sm90`), fp32 on the fp32 one (`_launch_f32`), at any head dim
    and in any layout. csrc/attention.cu's `_launch` is not reached."""
    if q.dtype == torch.bfloat16:
        return _launch_sm90(q, k, v, name, bias, n_pad)
    return _launch_f32(q, k, v, name, bias, n_pad)


def transposed_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The clamp softmax (the reference's ``_transposed_attention``) at any
    shape: (B, Tq, H, D) × (B, Tk, H, D) → (B, Tq, H, D), with no bias or a
    key-padding bias (B|1, 1, 1, Tk), added in fp32 in the log2 domain."""
    _check_key_padding(q, k, v, bias)
    if q.device.type == "cpu":
        return transposed_attention_reference(q, k, v, bias)
    return _launch_card(q, k, v, "attention_long", bias, pad_keys("clamp", k.shape[1]))


def rowblock_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The clamp softmax of the reference's ``_rowblock_attention`` at any
    shape: (B, Tq, H, D) × (B, Tk, H, D) → (B, Tq, H, D), with no bias or a
    key-padding bias (B|1, 1, 1, Tk), added in fp32 in the log2 domain."""
    _check_key_padding(q, k, v, bias)
    if q.device.type == "cpu":
        return rowblock_attention_reference(q, k, v, bias)
    return _launch_card(q, k, v, "attention_rowblock", bias, pad_keys("rowblock", k.shape[1]))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The exact softmax of the reference's streaming kernel
    (``_flash_attention``) at any shape: (B, Tq, H, D) × (B, Tk, H, D) →
    (B, Tq, H, D), with no bias or a key-padding bias (B|1, 1, 1, Tk),
    added in fp32 to the scaled scores."""
    _check_key_padding(q, k, v, bias)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias)
    return _launch_card(q, k, v, "attention_flash", bias, pad_keys("flash", k.shape[1]))


def single_tile_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The exact softmax of the single-tile route (K1; K2 with a bias) at
    any shape, whatever `attention_route` would pick there: what the
    reference's routing experiments call through ``fused_attention.
    __wrapped__`` (scripts/exp_attn_pixart256.py), with that route's pad
    keys (`pad_keys`)."""
    _check(q, k, v, bias)
    n_pad = pad_keys("exact", k.shape[1])
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, bias, n_pad)
    return _launch_card(q, k, v, "attention", bias, n_pad)


def _check_key_padding(q, k, v, bias) -> None:
    _check(q, k, v, bias)
    if not _key_padding_bias_ok(bias, q.shape[0]):
        raise ValueError(
            "the clamp and streaming kernels take only key-padding biases "
            f"(B|1, 1, 1, Tk); got {tuple(bias.shape)}"
        )


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, Tq, H, D) × (B, Tk, H, D) → (B, Tq, H, D). `bias` broadcasts
    from (B|1, H|1, Tq|1, Tk|1), e.g. a (B, 1, 1, Tk) key-padding bias; it
    is added in fp32. The shapes pick the softmax (`attention_route`)."""
    _check(q, k, v, bias)
    route = attention_route(tuple(q.shape), k.shape[1], bias)
    if route == "clamp":
        return transposed_attention(q, k, v, bias)
    if route == "rowblock":
        return rowblock_attention(q, k, v, bias)
    if route == "flash":
        return flash_attention(q, k, v, bias)
    n_pad = pad_keys(route, k.shape[1])
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, bias, n_pad)
    return _launch_card(q, k, v, "attention", bias, n_pad)
