"""Fused attention: the hand-written CUDA kernel and its plain version.

`fused_attention(q, k, v, bias=None)` takes ``(B, T, H, D)`` tensors, as
``ecad_tpu.ops.fused_attention`` does, and computes
softmax(q·kᵀ/√D + bias)·v with an fp32 softmax. It replaces the Pallas
kernels ``_attn_kernel`` (no bias, ecad_tpu/ops/attention.py:58) and
``_attn_kernel_bias`` (fp32 additive bias, :75) with one CUDA C++ kernel,
``csrc/attention.cu`` (the source says what bounds it on the H100 and what
its design does about that).

On a CPU tensor the wrapper runs `fused_attention_reference`, the plain
PyTorch version of the same arithmetic. On a CUDA tensor it launches the
kernel or raises: there is no fallback. Each launch adds one to
``LAUNCHES["attention"]`` (no bias) or ``LAUNCHES["attention_bias"]``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

LAUNCHES = {"attention": 0, "attention_bias": 0}

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
MAX_HEAD_DIM = 128
_FN = None


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
            ctypes.c_float,  # scale
            ctypes.c_int,  # vec_ok
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def fused_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (and of ``_attn_kernel`` /
    ``_attn_kernel_bias``): fp32 upcast, q scaled by 1/√D, fp32 bias added,
    row-max subtracted, exp, p·v, one divide by the row sum, one cast."""
    d = q.shape[-1]
    qf = q.float().permute(0, 2, 1, 3) * (1.0 / math.sqrt(d))
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    s = qf @ kf.transpose(-1, -2)
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = (p @ vf) / p.sum(dim=-1, keepdim=True)
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


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, Tq, H, D) × (B, Tk, H, D) → (B, Tq, H, D). `bias` broadcasts
    from (B|1, H|1, Tq|1, Tk|1), e.g. a (B, 1, 1, Tk) key-padding bias; it
    is added in fp32."""
    _check(q, k, v, bias)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, bias)
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
            1.0 / math.sqrt(d),
            vec_ok,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"attention kernel launch failed: cudaError_t {status} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})"
        )
    LAUNCHES["attention" if bias is None else "attention_bias"] += 1
    return out
