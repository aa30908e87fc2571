"""Modulated LayerNorm, LN(x)·(1+scale)+shift: a CUDA kernel for Hopper
and its plain version.

Replaces the Pallas kernel ``_modlnorm_kernel``
(ecad_tpu/ops/fused.py:20, launched at :46): per row of (B, T, d), an
affine-free LayerNorm with fp32 mean and variance and eps 1e-6, then
·(1+scale)+shift with a per-sample (B, 1, d) scale and shift, and one cast
at the end. The port calls it at the PixArt block's two modulated norms
and final-layer norm (ecad_tpu/models/pixart.py:255, :276, :401), and at
FLUX's norms, where `modulated_layer_norm_pair` takes a dual block's image-
and text-stream norms of one site in one launch.

The kernel is ``csrc/modlnorm_sm90.cu`` (`modlnorm_sm90_kernel`), built
with ``nvcc`` at first use and bound with ctypes: a warp a row with the row
in registers as 16-byte vectors, shuffle reductions, a persistent grid
that loads the next row before reducing the current one, and a table of
one or two segments (what bounds it and why is in the source).
`launch_plan` is the part of its indexing decided here: the vector width,
the vectors a lane and the segments' first rows.

On a CPU tensor the wrappers run `modulated_layer_norm_reference`; on a
CUDA tensor they launch the kernel or raise. Each launch adds one to
``LAUNCHES["modlnorm"]``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

LAUNCHES = {"modlnorm": 0}

# the kernels the C entry offers (`kernel_of` in csrc/modlnorm_sm90.cu):
# vectors a lane (the length of the register array) up to MAX_NV, and
# warps a row
MAX_NV = 5
GROUPS = (1, 2, 4, 8)
LANES = 32
MIN_WARPS = 2048
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        from ._build import load_library

        fn = load_library("modlnorm_sm90").ecad_modlnorm_sm90_fwd
        fn.argtypes = [
            ctypes.c_int,  # dtype: 1 bf16, 0 fp32
            ctypes.c_int,  # vector bytes
            ctypes.c_int,  # vectors a lane (1 to MAX_NV)
            ctypes.c_int,  # warps a row (one of GROUPS)
            ctypes.c_int,  # segments (1 or 2)
            ctypes.POINTER(ctypes.c_void_p),  # per segment: x, scale, shift, out
            ctypes.POINTER(ctypes.c_longlong),  # per segment: B, T, x_sb, x_st, scale_sb, shift_sb
            ctypes.c_int,  # d
            ctypes.c_float,  # eps
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


@dataclass(frozen=True)
class LaunchPlan:
    """How the kernel covers one launch: vectors of `vec_bytes` (`n_vec` to
    a row), `group` warps a row, lane l of the row's 32·group holding
    vectors l, l + 32·group, ... (`nv` at most); the segments' (B, T) and
    their first rows in the launch's numbering (`row0`)."""

    vec_bytes: int
    n_vec: int
    nv: int
    group: int
    shapes: tuple[tuple[int, int], ...]
    row0: tuple[int, ...]

    @property
    def n_rows(self) -> int:
        return self.row0[-1] + self.shapes[-1][0] * self.shapes[-1][1]

    def locate(self, row: int) -> tuple[int, int, int]:
        """(segment, sample, token) of a row, as the kernel's `row_ptrs`."""
        seg = 1 if len(self.row0) > 1 and row >= self.row0[1] else 0
        r = row - self.row0[seg]
        t_len = self.shapes[seg][1]
        return seg, r // t_len, r % t_len

    def group_rows(self, group: int, n_groups: int) -> range:
        """The rows that row group `group` (`self.group` warps) of
        `n_groups` takes, in the kernel's order."""
        return range(group, self.n_rows, n_groups)

    def lane_vectors(self, lane: int) -> list[int]:
        """The vectors of its row that lane `lane` of a row group holds."""
        lanes = LANES * self.group
        return [i * lanes + lane for i in range(self.nv) if i * lanes + lane < self.n_vec]


def warps_a_row(n_vec: int, n_rows: int) -> int:
    """Warps a row: enough that each lane holds at most `MAX_NV` vectors
    (d = 1152 in bf16, 144 vectors: one warp of five; 3072, 384 vectors:
    four warps of three), and that the launch has `MIN_WARPS` warps at
    least, so that a row's registers leave room for warps enough, and the
    launch has warps enough, to keep the card's memory busy (the choice is
    measured by `scripts/probe_modlnorm.py`)."""
    fits = next((g for g in GROUPS if n_vec <= MAX_NV * LANES * g), GROUPS[-1])
    fills = next((g for g in GROUPS if n_rows * g >= MIN_WARPS), GROUPS[-1])
    return max(fits, fills)


def launch_plan(d: int, elem_size: int, shapes, byte_offsets=()) -> LaunchPlan:
    """The widest vector (16 bytes, 8, or one element) that tiles a row of
    `d` elements of `elem_size` bytes and divides every address and stride
    in `byte_offsets`, `warps_a_row` for it, and the fewest vectors a lane
    that hold a row's vectors in their lanes; `shapes` is each segment's
    (B, T). Raises where `MAX_NV` a lane of the most warps do not hold the
    row."""
    widths = (16, 8, elem_size)
    vec = next(w for w in widths
               if (d * elem_size) % w == 0 and all(o % w == 0 for o in byte_offsets))
    n_vec = d * elem_size // vec
    row0, rows = [], 0
    for b, t in shapes:
        row0.append(rows)
        rows += b * t
    group = warps_a_row(n_vec, rows)
    nv = -(-n_vec // (LANES * group))
    if nv > MAX_NV:
        raise ValueError(
            f"modulated_layer_norm: d={d} needs {n_vec} vectors of {vec} bytes a row, "
            f"more than the kernel's {MAX_NV * LANES * group}")
    return LaunchPlan(vec, n_vec, nv, group, tuple(shapes), tuple(row0))


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


def _check(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, d); got {tuple(x.shape)}")
    b, _, d = x.shape
    for name, m in (("scale", scale), ("shift", shift)):
        if m.numel() != b * d or m.shape[0] != b or m.shape[-1] != d:
            raise ValueError(f"{name} {tuple(m.shape)} is not (B, 1, d)")
        if m.device != x.device:
            raise ValueError(f"{name} must be on the device of x")


def _launch(segments, eps: float) -> list[torch.Tensor]:
    """One kernel launch over one or two (x, scale, shift) segments, which
    `_check` passed and which share d, dtype and device; raises unless
    that device is a CUDA card."""
    x0 = segments[0][0]
    if x0.device.type != "cuda":
        raise ValueError(f"modulated_layer_norm: unsupported device {x0.device}")
    if x0.dtype not in _DTYPES:
        raise ValueError(f"modulated_layer_norm: unsupported dtype {x0.dtype}")
    size = x0.element_size()
    ptrs, ints, shapes, offsets, outs = [], [], [], [], []
    for x, scale, shift in segments:
        b, t, d = x.shape
        scale, shift = scale.reshape(b, d), shift.reshape(b, d)
        if scale.dtype != x.dtype or shift.dtype != x.dtype:
            raise ValueError("scale and shift must have the dtype of x")
        if x.stride(2) != 1 or scale.stride(1) != 1 or shift.stride(1) != 1:
            raise ValueError("x, scale and shift must be contiguous in d")
        out = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
        # a stride of a length-1 dimension is never stepped
        strides = (x.stride(0) if b > 1 else 0, x.stride(1) if t > 1 else 0,
                   scale.stride(0) if b > 1 else 0, shift.stride(0) if b > 1 else 0)
        ptrs += [x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr()]
        ints += [b, t, *strides]
        shapes.append((b, t))
        offsets += [s * size for s in strides]
        outs.append(out)
    plan = launch_plan(x0.shape[2], size, shapes, (*ptrs, *offsets))
    fn = _kernel()
    with torch.cuda.device(x0.device):
        err = fn(
            _DTYPES[x0.dtype], plan.vec_bytes, plan.nv, plan.group, len(segments),
            (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_longlong * len(ints))(*ints),
            x0.shape[2], eps, torch.cuda.current_stream(x0.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"modlnorm_sm90 launch failed: error {err} (segments {shapes}, d {x0.shape[2]}, "
            f"{x0.dtype}, {plan.vec_bytes}-byte vectors, {plan.nv} a lane, "
            f"{plan.group} warps a row)")
    LAUNCHES["modlnorm"] += 1
    return outs


def modulated_layer_norm(
    x: torch.Tensor,  # (B, T, d)
    scale: torch.Tensor,  # (B, 1, d) or (B, d)
    shift: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """LN(x)·(1+scale)+shift in one pass (affine-free LN, fp32 stats)."""
    _check(x, scale, shift)
    if x.device.type == "cpu":
        return modulated_layer_norm_reference(x, scale, shift, eps)
    return _launch([(x, scale, shift)], eps)[0]


def modulated_layer_norm_pair(
    first: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    second: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`modulated_layer_norm` of two (x, scale, shift) segments that share
    d, dtype and device — FLUX's image and text streams at one site of a
    dual block — in one launch on the card; each segment keeps its own B,
    T, strides and modulation."""
    for seg in (first, second):
        _check(*seg)
    x0, x1 = first[0], second[0]
    if x0.shape[2] != x1.shape[2]:
        raise ValueError(f"segments differ in d: {x0.shape[2]} and {x1.shape[2]}")
    if x0.device != x1.device:
        raise ValueError(f"segments lie on different devices: {x0.device} and {x1.device}")
    if x0.dtype != x1.dtype:
        raise ValueError(f"segments differ in dtype: {x0.dtype} and {x1.dtype}")
    if x0.device.type == "cpu":
        return (modulated_layer_norm_reference(*first, eps),
                modulated_layer_norm_reference(*second, eps))
    out0, out1 = _launch([first, second], eps)
    return out0, out1
