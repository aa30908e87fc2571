"""Modulated LayerNorm, LN(x)·(1+scale)+shift: a Triton kernel and its
plain version.

Replaces the Pallas kernel ``_modlnorm_kernel``
(ecad_tpu/ops/fused.py:20, launched at :46): per row of (B, T, d), an
affine-free LayerNorm with fp32 mean and variance and eps 1e-6, then
·(1+scale)+shift with a per-sample (B, 1, d) scale and shift, and one cast
at the end. The port calls it at the PixArt block's two modulated norms
and at the final-layer norm (ecad_tpu/models/pixart.py:255, :276, :401).

What bounds it on the H100: one read of x and one write of the output
(the per-sample scale and shift are d-vectors), a handful of flops per
byte, so device-memory bytes. The design is one program per row: the row
(d=1152 at full width) sits in registers as one masked block of 2048
lanes, both reductions and the epilogue run there, and x is read once.
It is a row reduction with an elementwise epilogue, no tensor cores and
no shared-memory staging, which is why Triton serves it as well as CUDA.

``triton`` is imported only when the kernel is first launched. On a CPU
tensor the wrapper runs `modulated_layer_norm_reference`; on a CUDA tensor
it launches the kernel or raises. Each launch adds one to
``LAUNCHES["modlnorm"]``.
"""

from __future__ import annotations

import torch

LAUNCHES = {"modlnorm": 0}

_KERNEL = None
tl = None  # triton.language, bound by _triton_kernel at the first launch


def _modlnorm_body(
    x_ptr, scale_ptr, shift_ptr, o_ptr,
    T, D, stride_xb, stride_xt, stride_sb, stride_hb, eps,
    BLOCK_D: tl.constexpr,
):
    row = tl.program_id(0)
    bi = row // T
    ti = row % T
    cols = tl.arange(0, BLOCK_D)
    mask = cols < D
    x = tl.load(
        x_ptr + bi * stride_xb + ti * stride_xt + cols, mask=mask, other=0.0
    ).to(tl.float32)
    mean = tl.sum(x, axis=0) / D
    xc = tl.where(mask, x - mean, 0.0)
    var = tl.sum(xc * xc, axis=0) / D
    normed = xc * tl.rsqrt(var + eps)
    sc = tl.load(scale_ptr + bi * stride_sb + cols, mask=mask, other=0.0)
    sh = tl.load(shift_ptr + bi * stride_hb + cols, mask=mask, other=0.0)
    y = normed * (1.0 + sc.to(tl.float32)) + sh.to(tl.float32)
    tl.store(o_ptr + row * D + cols, y.to(o_ptr.dtype.element_ty), mask=mask)


def _triton_kernel():
    """Import triton and JIT the kernel body, once."""
    global _KERNEL, tl
    if _KERNEL is None:
        import triton
        import triton.language as tl  # binds the module global the body reads

        _KERNEL = triton.jit(_modlnorm_body)
    return _KERNEL


def modulated_layer_norm_reference(
    x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: fp32 statistics, fp32
    modulation, one cast to x's dtype."""
    b, _, d = x.shape
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    normed = xc * torch.rsqrt(var + eps)
    scale = scale.reshape(b, 1, d).float()
    shift = shift.reshape(b, 1, d).float()
    return (normed * (1.0 + scale) + shift).to(x.dtype)


def modulated_layer_norm(
    x: torch.Tensor,  # (B, T, d)
    scale: torch.Tensor,  # (B, 1, d) or (B, d)
    shift: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """LN(x)·(1+scale)+shift in one pass (affine-free LN, fp32 stats)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, d); got {tuple(x.shape)}")
    b, t, d = x.shape
    for name, m in (("scale", scale), ("shift", shift)):
        if m.numel() != b * d or m.shape[0] != b or m.shape[-1] != d:
            raise ValueError(f"{name} {tuple(m.shape)} is not (B, 1, d)")
        if m.device != x.device:
            raise ValueError(f"{name} must be on the device of x")
    if x.device.type == "cpu":
        return modulated_layer_norm_reference(x, scale, shift, eps)
    if x.device.type != "cuda":
        raise ValueError(f"modulated_layer_norm: unsupported device {x.device}")
    scale = scale.reshape(b, d)
    shift = shift.reshape(b, d)
    if x.stride(2) != 1 or scale.stride(1) != 1 or shift.stride(1) != 1:
        raise ValueError("x, scale and shift must be contiguous in d")
    out = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
    block = 1 << (d - 1).bit_length()
    kernel = _triton_kernel()
    with torch.cuda.device(x.device):
        kernel[(b * t,)](
            x, scale, shift, out,
            t, d, x.stride(0), x.stride(1), scale.stride(0), shift.stride(0),
            eps,
            BLOCK_D=block,
            num_warps=4 if block <= 1024 else 8,
        )
    LAUNCHES["modlnorm"] += 1
    return out
