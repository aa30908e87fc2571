"""Fused attention: the hand-written CUDA kernel, its plain versions and
the routing between its two softmax variants.

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
  8 MiB score tile (FLUX-1024's joint attention). `rowblock_attention`
  launches it under its own kernel name and counters; plain version:
  `rowblock_attention_reference`.

* **flash** — the exact softmax of the reference's streaming kernel
  ``_flash_kernel`` (:151), which ``_flash_attention`` (:573-673) takes
  past 8192×128 key elements (PixArt-2048's 16384-token self-attention):
  q·kᵀ in fp32, then ×1/√D, plus the key-padding bias, p rounded to v's
  dtype for p·v. `flash_attention` launches it under its own kernel name
  and counters; plain version: `flash_attention_reference`.

Every route runs on one of two hand-written CUDA C++ sources (each says
what bounds its kernels on the H100). bf16 calls at head dim 72 or 128 take
the Hopper body of ``csrc/attention_sm90.cu`` (wgmma fed by TMA;
`_takes_sm90`), without a bias or with a key-padding bias (B|1, 1, 1, Tk):
the exact single-tile route (K1; K2 with a bias) — PixArt's 256²
self-attention and its text cross-attention at 256² and 512², FLUX.1-dev's
joint attention at 256²; the transposed clamp route (K4, with a bias too)
— PixArt's 1024² self-attention and its text cross-attention at 1024² and
PixArt-Σ's at 2048²; the streaming route (K6, with a bias too) —
PixArt-Σ's 2048² self-attention, FLUX.1-dev's at 1536²; and at 128 the
row-block route (K5, with a bias too) — FLUX.1-dev at 1024². The
attention-variant harness's X2 and X3 take the same body in bf16 at 72 and
128, and X4 at 72 (`attn_variants`). The mma.sync body of
``csrc/attention.cu`` (a compile-time variant per route) takes the rest:
fp32, other head dims, dense biases, and the harness's X1. The choice
depends on route, dtype, head dim and bias only. A call for the Hopper
body whose operands TMA cannot map (`tma_operand`: a 16-byte-aligned base
and strides), or whose bias the body does not read (`bias_operand`: bf16
or fp32), raises; it never drops back to the other body.

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
(exact, streaming route). The attention-variant harness's kernels (X1:
variant 4 of csrc/attention.cu; X2, X3 and X4: modes 4, 5 and 6 of the
Hopper body) are wrapped in `attn_variants` and count under ``xattn_*``.
"""

from __future__ import annotations

import ctypes
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
_VARIANTS = {
    0: "attention", 1: "attention_long", 2: "attention_rowblock", 3: "attention_flash",
    4: "xattn_matmul_only",
}

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
MAX_HEAD_DIM = 128
_FN = None
_SM90_FN = None
# the Hopper body's kernels (csrc/attention_sm90.cu), by counter name: the
# C entry's mode and the head dims it is built for; the last three are the
# attention-variant harness's X2, X3 and X4 (`attn_variants`)
_SM90_MODES = {"attention_flash": (0, (72, 128)), "attention_rowblock": (1, (128,)),
               "attention": (2, (72, 128)), "attention_long": (3, (72, 128)),
               "xattn_nomax": (4, (72, 128)), "xattn_max": (5, (72, 128)),
               "xattn_fd": (6, (72,))}
# the routes whose Hopper kernel also takes a key-padding bias: K2, K4, K5, K6
_SM90_BIAS = ("attention", "attention_long", "attention_rowblock", "attention_flash")
# the bias dtypes the Hopper body reads, with the C entry's code for each
_SM90_BIAS_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SM90_BOX = (64, 1, 128, 1)  # 64 columns (128 bytes: the swizzle's width), 1 head, 128 rows

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
            ctypes.c_int,  # variant: 0 exact, 1 clamp (K4), 2 row-block (K5), 3 flash (K6),
            # 4 the harness's X1
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
            ctypes.c_void_p,  # key-padding bias (modes 0-3) or NULL
            ctypes.POINTER(ctypes.c_longlong),  # its strides (batch, key)
            ctypes.c_int,  # the bias is bf16 (1) or fp32 (0)
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H Tq Tk
            ctypes.c_float,  # scale: 1/√D (the exact modes)
            ctypes.c_float,  # q_scale: bf16(scale·log2e) (the modes with a pre-scaled q)
            ctypes.c_int,  # mode: 0 exact streaming (K6), 1 clamp row-block (K5),
            # 2 exact single-tile (K1; K2 with a bias), 3 clamp transposed (K4),
            # 4 the harness's no max (X2), 5 its max on a pre-scaled q (X3),
            # 6 its clamp with the denominator from the p·v products (X4)
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _SM90_FN = fn
    return _SM90_FN


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
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
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


def clamp_scale(d: int, dtype: torch.dtype) -> float:
    """scale·log2e = log2(e)/√D rounded to `dtype`, as the reference's
    ``jnp.asarray(scale, q.dtype)`` (:378-383) rounds it."""
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
    """One launch of the CUDA kernel on q's device: `variant` 0 is the
    exact softmax, 1 the clamp softmax of the transposed route (K4), 2 that
    of the row-block route (K5), 3 the exact softmax of the streaming route
    (K6), 4 the attention-variant harness's X1 (`attn_variants`), with the
    route's `n_pad` pad keys (`pad_keys`). Counts it."""
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


def tma_operand(t: torch.Tensor, name: str) -> list[int]:
    """The arguments of the 4-D TMA tensor map of a bf16 (B, T, H, D)
    operand of the Hopper body, D = 72 or 128: the dims {D, H, T, B}
    (innermost first), the byte strides of H, T and B, and the box {64, 1,
    128, 1} — 11 integers. The C entry builds from them a map under the
    128-byte swizzle (columns 0-63, and 64-127 at D=128) and, at D=72, one
    with an 8-column box and no swizzle for columns 64-71. TMA needs a
    16-byte-aligned base and strides that are multiples of 16 bytes (below
    2^40); a dimension of size 1 is never stepped along, so it takes the
    packed stride. Raises ValueError where the operand does not meet
    them."""
    b, tt, h, d = t.shape
    if t.dtype != torch.bfloat16 or d not in (72, 128):
        raise ValueError(f"{name}: the Hopper body takes bf16 at head dim 72 or 128; got "
                         f"{t.dtype}, {d}")
    if t.stride(3) != 1:
        raise ValueError(f"{name} must be contiguous in its last dim")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: TMA needs a 16-byte-aligned base; got {t.data_ptr():#x}")
    elem = t.element_size()
    strides, packed = [], d * elem
    for size, stride in ((h, t.stride(2)), (tt, t.stride(1)), (b, t.stride(0))):
        sb = stride * elem if size > 1 else packed
        if sb % 16 or not 0 < sb < 2**40:
            raise ValueError(f"{name}: TMA needs strides that are multiples of 16 bytes; "
                             f"got strides {t.stride()} of {t.dtype}")
        strides.append(sb)
        packed = sb * size
    return [d, h, tt, b, *strides, *_SM90_BOX]


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


def _takes_sm90(counter: str, q: torch.Tensor, bias: Optional[torch.Tensor]) -> bool:
    """Whether a call of the route that counts under `counter` goes to the
    Hopper body (csrc/attention_sm90.cu): bf16 at a head dim the body is
    built for on that route (`_SM90_MODES`), without a bias or, on a route
    whose kernel takes one (`_SM90_BIAS`), with a key-padding bias. A
    function of route, dtype, head dim and bias only."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] in _SM90_MODES[counter][1]
            and (bias is None or (counter in _SM90_BIAS
                                  and _key_padding_bias_ok(bias, q.shape[0]))))


def _launch_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the Hopper body in the mode of counter `name`
    (``attention``: exact single-tile, K1, or K2 with a key-padding `bias`;
    ``attention_long``: clamp transposed, K4; ``attention_rowblock``: clamp
    row-block, K5, each also with a key-padding `bias`;
    ``attention_flash``: exact streaming, K6, also with a key-padding
    `bias`; ``xattn_nomax`` and ``xattn_max``: the attention-variant
    harness's exp2 softmax without and with the max on a pre-scaled q, X2
    and X3, no bias, Tk % 128 == 0; ``xattn_fd``: its clamp softmax with
    the denominator from the p·v products, X4, D=72, no bias, any Tk).
    Raises where TMA cannot map an operand (`tma_operand`) or the body does
    not read the bias (`bias_operand`). Counts it under `name`, or
    ``name_bias``."""
    maps = [a for t, n in ((q, "q"), (k, "k"), (v, "v")) for a in tma_operand(t, n)]
    b, tq, h, d = q.shape
    bias_strides, bias_bf16 = ([0, 0], 0) if bias is None else bias_operand(bias, b)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    mode = _SM90_MODES[name][0]
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        status = _sm90_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            (ctypes.c_ulonglong * len(maps))(*maps),
            (ctypes.c_longlong * 3)(out.stride(0), out.stride(1), out.stride(2)),
            None if bias is None else bias.data_ptr(),
            (ctypes.c_longlong * 2)(*bias_strides), bias_bf16,
            b, h, tq, k.shape[1], 1.0 / math.sqrt(d), clamp_scale(d, q.dtype), mode,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"Hopper attention launch failed: status {status} (cudaError_t, or 100000 + "
            f"the CUresult of a refused tensor map; q {tuple(q.shape)}, k {tuple(k.shape)})"
        )
    LAUNCHES[name if bias is None else name + "_bias"] += 1
    return out


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
    if _takes_sm90("attention_long", q, bias):
        return _launch_sm90(q, k, v, "attention_long", bias)
    return _launch(q, k, v, bias, 1, pad_keys("clamp", k.shape[1]))


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
    if _takes_sm90("attention_rowblock", q, bias):
        return _launch_sm90(q, k, v, "attention_rowblock", bias)
    return _launch(q, k, v, bias, 2, pad_keys("rowblock", k.shape[1]))


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
    if _takes_sm90("attention_flash", q, bias):
        return _launch_sm90(q, k, v, "attention_flash", bias)
    return _launch(q, k, v, bias, 3, pad_keys("flash", k.shape[1]))


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
    if _takes_sm90("attention", q, bias):
        return _launch_sm90(q, k, v, "attention", bias)
    return _launch(q, k, v, bias, 0, n_pad)
