"""The attention-variant harness's kernels (X1-X4) and their plain versions.

The JAX package's research harness ``scripts/exp_attn_variants.py`` times
the TPU's attention body at its headline shapes with parts of the work
taken out, through eight Pallas bodies. Each function has a counterpart
here. X2, X3 and X4 run on the Hopper body, ``csrc/attention_sm90.cu``
(modes 4, 5 and 6 of its C entry, wgmma fed by TMA, keys in 128-key
tiles), so that they take apart the body that serves K1-K6; X1 on the
``mma.sync`` body of ``csrc/attention.cu`` (variant 4 of its C entry,
64-key tiles). Each source says what bounds each kernel.

* ``k_matmul_only`` (:103) — o = bf16(q·kᵀ)·v with unscaled scores, no
  softmax: `matmul_only_attention` (X1, ``attn_xmatmul_bf16_kernel``);
* ``k_nomax`` (:115) — q pre-scaled by bf16(log2e/√D), p = exp2(s) with no
  max and no clamp, Σp in fp32: `nomax_attention` (X2,
  ``attn_xnomax_sm90_kernel<D>``);
* ``k_rowblock`` (:129) and ``k_chunk2`` (:144) — q pre-scaled, p =
  exp2(s − max), Σp in fp32: `max_exp2_attention` (X3,
  ``attn_xmax_sm90_kernel<D>``);
* ``k_transposed_fd`` (:288) and ``k_transposed_subk_fd`` (:349) — the
  clamp numerator, denominator Σ bf16(p) taken by the tensor cores through
  a ones column of v: `clamp_fd_attention` (X4, ``attn_xfd_sm90_kernel<72>``);
* ``k_transposed`` (:190) and ``k_transposed_subk`` (:317) compute K4's
  no-bias function: `transposed_attention` in ``attention.py``.

All take (B, T, H, D) tensors and no bias. In every one, s = q·kᵀ is
accumulated in fp32, p is rounded to v's dtype for p·v, and the output is
cast once. On a CPU tensor each wrapper runs its plain version; on a CUDA
tensor it launches its kernel (bf16 only, at the head dims the kernels are
built for) or raises, and counts the launch in ``attention.LAUNCHES``
(``xattn_matmul_only``, ``xattn_nomax``, ``xattn_max``, ``xattn_fd``).

Key counts. The Pallas wrappers ``_prep`` and ``_call_transposed*`` pad the
keys with zeros to a multiple of 128 and mask them only in the ``*_fd``
bodies (through the ones row, :416-418); elsewhere each pad key has s = 0
and weighs exp2(0) (or exp2(−max)), which moves a row by ≈ 0.1 at Tk = 200.
A kernel here must neither copy that nor quietly differ from it, so every
wrapper but `clamp_fd_attention` raises unless Tk % 128 == 0.
"""

from __future__ import annotations

import torch

from . import attention as _attention
from .attention import _CLAMP_HI, _CLAMP_LO, _round_up, clamp_scale

# X1 on csrc/attention.cu: the C entry's variant and the padded head dims
# (DP) it is built at, those of D = 72 and 128 (the harness's). X2-X4 run
# on the Hopper body, at the head dims `attention._SM90_MODES` gives.
_X1_VARIANT, _X1_PADDED_DIMS = 4, (80, 128)


def _scores(q: torch.Tensor, k: torch.Tensor, scaled: bool) -> torch.Tensor:
    """fp32 scores (B, H, Tq, Tk); with `scaled` q is first multiplied by
    bf16(log2e/√D) in its own dtype, as ``_prep`` (:67-68) and
    ``_call_transposed*`` (:245-249, :393-397) do."""
    if scaled:
        q = q * torch.tensor(clamp_scale(q.shape[-1], q.dtype), dtype=q.dtype)
    return q.float().permute(0, 2, 1, 3) @ k.float().permute(0, 2, 3, 1)


def _pv(p: torch.Tensor, v: torch.Tensor, dtype: torch.dtype, denom=None) -> torch.Tensor:
    """p rounded to v's dtype, times v in fp32, over `denom`, cast once."""
    out = p.to(v.dtype).float() @ v.float().permute(0, 2, 1, 3)
    if denom is not None:
        out = out / denom
    return out.to(dtype).permute(0, 2, 1, 3).contiguous()


def matmul_only_attention_reference(q, k, v) -> torch.Tensor:
    """Plain version of X1 (and of ``k_matmul_only``): s = q·kᵀ in fp32
    with q unscaled, s rounded to v's dtype, times v in fp32, cast once. The
    output is not normalised: at D=128 |s| is ≈ 11 and outputs reach ≈ 10³,
    so a flip of one bf16 rounding of s (ulp 0.0625 at |s| ≈ 11) between
    two fp32 sum orders moves an output by up to that ulp times |v|."""
    return _pv(_scores(q, k, scaled=False), v, q.dtype)


def nomax_attention_reference(q, k, v) -> torch.Tensor:
    """Plain version of X2 (and of ``k_nomax``): q pre-scaled, p = exp2(s)
    with no max and no clamp — +inf past s = 128 in fp32, as on the TPU, so
    such a row comes out NaN — Σp in fp32, p rounded to v's dtype for p·v,
    one divide. Only the order of the fp32 sums differs from the kernel."""
    p = torch.exp2(_scores(q, k, scaled=True))
    return _pv(p, v, q.dtype, p.sum(dim=-1, keepdim=True))


def max_exp2_attention_reference(q, k, v) -> torch.Tensor:
    """Plain version of X3 (and of ``k_rowblock`` / ``k_chunk2``): q
    pre-scaled, p = exp2(s − rowmax), Σp in fp32, p rounded to v's dtype for
    p·v, one divide. The kernel keeps a running max over 128-key tiles, so
    each p is rounded to bf16 against the max of the tiles seen so far and
    rescaled in fp32 afterwards (``k_chunk2`` rounds against each half's
    max); that changes the bf16 rounding of p (relative 2^-9 either way)
    and the order of the fp32 sums, as K6's docstring states for its own
    online max."""
    s = _scores(q, k, scaled=True)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    return _pv(p, v, q.dtype, p.sum(dim=-1, keepdim=True))


def clamp_fd_attention_reference(q, k, v) -> torch.Tensor:
    """Plain version of X4 (and of ``k_transposed_fd`` /
    ``k_transposed_subk_fd``): q pre-scaled, p = exp2(clip(s, −100, 80)),
    numerator bf16(p)·v and denominator Σ bf16(p), both accumulated in
    fp32, one divide. The denominator is a sum of the rounded p (the ones
    row of vᵀ meets the same bf16 p as v), where K4's sums p in fp32: the
    two differ by up to 2^-9 relative. Keys past Tk do not exist here; the
    Pallas wrapper pads them and its ones row gives them weight 0."""
    p = torch.exp2(_scores(q, k, scaled=True).clamp(_CLAMP_LO, _CLAMP_HI)).to(v.dtype)
    return _pv(p, v, q.dtype, p.float().sum(dim=-1, keepdim=True))


def _run(q, k, v, counter: str, plain, aligned: bool) -> torch.Tensor:
    _attention._check(q, k, v, None)
    tk, d = k.shape[1], q.shape[-1]
    if aligned and tk % 128:
        raise ValueError(
            f"Tk={tk} is not a multiple of 128: the reference's Pallas body "
            "counts the zero pad keys there, and this kernel would not"
        )
    if q.device.type == "cpu":
        return plain(q, k, v)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the harness's kernels take bfloat16; got {q.dtype}")
    if counter in _attention._SM90_MODES:
        if not _attention._takes_sm90(counter, q, None):
            raise ValueError(f"head dim {d}: {counter} runs on the Hopper body, built for "
                             f"head dims {_attention._SM90_MODES[counter][1]}")
        return _attention._launch_sm90(q, k, v, counter)
    if _round_up(d, 16) not in _X1_PADDED_DIMS:
        raise ValueError(f"head dim {d}: kernel variant {_X1_VARIANT} is built for padded "
                         f"head dims {_X1_PADDED_DIMS}")
    return _attention._launch(q, k, v, None, _X1_VARIANT, 0)


def matmul_only_attention(q, k, v) -> torch.Tensor:
    """X1: bf16(q·kᵀ)·v, unnormalised. Tk % 128 == 0."""
    return _run(q, k, v, "xattn_matmul_only", matmul_only_attention_reference, aligned=True)


def nomax_attention(q, k, v) -> torch.Tensor:
    """X2: exp2 softmax without a max (overflows past s = 128). Tk % 128 == 0."""
    return _run(q, k, v, "xattn_nomax", nomax_attention_reference, aligned=True)


def max_exp2_attention(q, k, v) -> torch.Tensor:
    """X3: exp2 softmax with the max, on a pre-scaled q. Tk % 128 == 0."""
    return _run(q, k, v, "xattn_max", max_exp2_attention_reference, aligned=True)


def clamp_fd_attention(q, k, v) -> torch.Tensor:
    """X4: the clamp softmax with the denominator from the p·v product. Any
    Tk: the reference body masks its pad keys. On the card D = 72."""
    return _run(q, k, v, "xattn_fd", clamp_fd_attention_reference, aligned=False)
