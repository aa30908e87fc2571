"""Int8 (W8A8) serving quantization of the block projections, in PyTorch.

Counterpart of ``ecad_tpu/ops/quant.py``. The scheme is the reference's:
symmetric and zero-point-free, activations with a per-token scale (max-abs
over the contraction axis, computed at each call) or, in the static modes,
one calibrated per-tensor scale per site; weights with a per-output-channel
scale. The product is int8 × int8 → int32 (`int8_matmul`: one
``torch._int_mm`` call, cuBLASLt's int8 GEMM on the card), dequantized in
fp32 as (acc · token scale) · channel scale, cast to the model dtype, and
the bias added in that dtype. The arithmetic is the reference's, in its
order, so at the same inputs the int8 values, scales, int32 sums and the
outputs equal the JAX package's bit for bit.

Modes (the configs' ``quant``):

* ``int8``: bf16 weights stay resident; each site's weight is quantized
  once per weight value (`QuantLinear`), since it is a pure function of
  the weight (the reference requantizes inside its jitted program, where
  XLA computes it once);
* ``int8_static``: ``int8`` with per-site activation scales from a
  calibration table (`calibrate_dense_amax`, keyed by the reference's
  module path, e.g. ``block_3/attn1/to_q``); a site missing from the table
  keeps per-token scales;
* ``int8_w`` / ``int8_w_static``: int8 weight storage (`Int8Dense`: 1 byte
  a weight plus an fp32 scale per output channel), without or with the
  calibrated activation scales.

The quantize and dequant passes are plain PyTorch on both devices. Under
``torch.profiler`` the quantize pass, the product and the dequant pass run
inside the ranges ``int8_quantize``, ``int8_gemm`` and ``int8_dequant``
(opened only while a profiler records).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as F

_EPS = 1e-8
MODES = ("int8", "int8_static", "int8_w", "int8_w_static")
STATIC_MODES = ("int8_static", "int8_w_static")
WEIGHT_MODES = ("int8_w", "int8_w_static")
# torch._int_mm on the card takes more than 16 rows; fewer are padded with
# zero rows, which add nothing to any int32 sum
MIN_ROWS = 17
LAUNCHES = {"int8_matmul": 0}


def _span(name: str):
    """A profiler range around a pass, only while a profiler records."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def quantize_int8(x: torch.Tensor, dim: int, reduce=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along `dim`: (q, scale) with q int8 in
    [-127, 127] and scale fp32 shaped like `x` with `dim` kept as 1, so
    that q · scale ≈ x (ref :45). Where `x` is one rank's slice of `dim`
    (a row-parallel site under tp), `reduce(t, "max")` takes the max-abs
    over every rank's slice, so the scale is the whole row's."""
    x32 = x.float()
    amax = x32.abs().amax(dim=dim, keepdim=True)
    if reduce is not None:
        amax = reduce(amax, "max")
    scale = amax.clamp_min(_EPS) * (1.0 / 127.0)
    q = torch.round(x32 / scale).clamp_(-127.0, 127.0).to(torch.int8)
    return q, scale


def quantize_weight(weight: torch.Tensor, reduce=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A Linear weight (out, in) → its int8 (out, in) and its fp32 scale per
    output channel (out,); `reduce` as in `quantize_int8`, for a slice of
    the input features."""
    q, scale = quantize_int8(weight, dim=1, reduce=reduce)
    return q, scale.reshape(-1)


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 (m, k) × int8 weight (n, k) → int32 (m, n): one ``torch._int_mm``
    with the weight as its ``.t()`` view, so that k is the contiguous axis
    of both operands (cuBLASLt's int8 "TN" layout). Rows fewer than
    `MIN_ROWS` are padded with zeros and sliced off; k and n must be
    multiples of 8 on either device, as the card requires."""
    m, k = a.shape
    if k % 8 or w.shape[0] % 8 or w.shape[1] != k:
        raise ValueError(
            f"int8_matmul takes k and n multiples of 8: a {tuple(a.shape)}, "
            f"weight {tuple(w.shape)}"
        )
    if m < MIN_ROWS:
        a = F.pad(a, (0, 0, 0, MIN_ROWS - m))
    LAUNCHES["int8_matmul"] += 1
    with _span("int8_gemm"):
        return torch._int_mm(a.contiguous(), w.t())[:m]


def int8_linear(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor] = None,
    *,
    act_amax: Optional[float] = None,
    weight_q: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    dtype: Optional[torch.dtype] = None,
    reduce=None,
) -> torch.Tensor:
    """The W8A8 Linear: ``x @ weight.T + bias`` through the int8 product.

    The activation is quantized per token (`act_amax` None, ref
    `int8_dot_general` :58) or against one calibrated max-abs (ref
    `static_int8_dot_general` :110, with ``inv = 127 / amax`` and
    ``scale = 1 / inv`` in Python floats). `weight_q` is the weight's
    (int8, scale) pair when it is held already; else `weight` is quantized
    here. The output is in `dtype` (default x's).

    At a row-parallel site under tp, `x` and the weight hold one rank's
    slice of the input features and `reduce(t, op)` all-reduces over the
    tp ranks: the token scales take the whole row's max-abs and the int32
    sums are added across ranks before the dequant, so the output equals
    the one-rank product bit for bit (integer sums in any order)."""
    dtype = x.dtype if dtype is None else dtype
    lead, k = x.shape[:-1], x.shape[-1]
    with _span("int8_quantize"):
        wq, ws = quantize_weight(weight, reduce) if weight_q is None else weight_q
        x2 = x.reshape(-1, k)
        if act_amax is None:
            xq, xs = quantize_int8(x2, dim=-1, reduce=reduce)
        else:
            inv = 127.0 / max(float(act_amax), _EPS)
            xq = torch.round(x2.float() * inv).clamp_(-127.0, 127.0).to(torch.int8)
            xs = 1.0 / inv
    acc = int8_matmul(xq, wq)
    if reduce is not None:
        acc = reduce(acc, "sum")
    with _span("int8_dequant"):
        y = (acc.float() * xs * ws).to(dtype)
        if bias is not None:
            y = y + bias.to(dtype)
    return y.reshape(*lead, -1)


def maybe_quant(
    quant: Optional[str],
    site_key: Optional[str] = None,
    act_scales=None,
) -> Optional[Callable]:
    """The product of one site for a quant mode (ref `maybe_quant_dot_general`
    :168): None (the exact Linear) for bf16 serving and for the storage
    modes, whose sites are `Int8Dense`s; `int8_linear` for ``int8``; for
    ``int8_static`` the static form with the site's amax from `act_scales`
    (a mapping, or pairs, from the reference's module path), or the
    dynamic one where the table lacks the site."""
    if quant is None or quant == "none" or quant in WEIGHT_MODES:
        return None
    if quant == "int8":
        return int8_linear
    if quant == "int8_static":
        amax = dict(act_scales or ()).get(site_key)
        if amax is None:
            return int8_linear
        return functools.partial(int8_linear, act_amax=float(amax))
    raise ValueError(
        f"unknown quant mode {quant!r} "
        "(expected None|'int8'|'int8_static'|'int8_w'|'int8_w_static')"
    )


class QuantLinear(nn.Linear):
    """An ``nn.Linear`` (same parameters, same state_dict) whose product is
    `fn` (`int8_linear` or its static form, from `maybe_quant`). The int8
    weight is computed at the first call and again only when the weight
    changes (its version counter, storage or device)."""

    def __init__(self, in_features: int, out_features: int, fn: Callable,
                 bias: bool = True, dtype: Optional[torch.dtype] = None) -> None:
        super().__init__(in_features, out_features, bias=bias, dtype=dtype)
        self.fn = fn
        self._wq = None
        self._wq_key = None

    def weight_q(self, reduce=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The int8 weight and its channel scales; `reduce` as in
        `quantize_int8` where the weight is a slice of the input features
        (a row-parallel site under tp)."""
        w = self.weight
        # an inference tensor has no version counter and cannot change
        key = (None if w.is_inference() else w._version, w.data_ptr(), w.device)
        if key != self._wq_key:
            self._wq, self._wq_key = quantize_weight(w.detach(), reduce), key
        return self._wq

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x, self.weight, self.bias, weight_q=self.weight_q())


class Int8Dense(nn.Module):
    """Weight-storage int8 Linear (ref :284): ``weight`` int8 (out, in), 1
    byte a weight; ``scale`` fp32 (out,), the per-output-channel dequant
    scale; ``bias`` in the model dtype. The activation is quantized per
    token, or against the calibrated `act_amax` (``int8_w_static``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 act_amax: Optional[float] = None) -> None:
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.act_amax = act_amax
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, dtype=torch.int8), requires_grad=False
        )
        self.scale = nn.Parameter(
            torch.empty(out_features, dtype=torch.float32), requires_grad=False
        )
        if bias:
            self.bias = nn.Parameter(torch.empty(out_features, dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_linear(x, None, self.bias, act_amax=self.act_amax,
                           weight_q=(self.weight, self.scale), dtype=self.dtype)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"act_amax={self.act_amax}")


def dense(
    in_features: int,
    out_features: int,
    dtype: torch.dtype,
    quant: Optional[str] = None,
    site: Optional[str] = None,
    act_scales=None,
    bias: bool = True,
) -> nn.Module:
    """One projection site for a quant mode: ``nn.Linear`` for None, a
    `QuantLinear` for ``int8`` and ``int8_static``, an `Int8Dense` for
    ``int8_w`` and ``int8_w_static``. `site` is the reference's module path
    of the site, the key of `act_scales` in the static modes."""
    if quant in WEIGHT_MODES:
        amax = None
        if quant == "int8_w_static" and act_scales:
            amax = dict(act_scales).get(site)
        return Int8Dense(in_features, out_features, bias=bias, dtype=dtype,
                         act_amax=None if amax is None else float(amax))
    fn = maybe_quant(quant, site, act_scales)
    if fn is None:
        return nn.Linear(in_features, out_features, bias=bias, dtype=dtype)
    return QuantLinear(in_features, out_features, fn, bias=bias, dtype=dtype)


def quantize_params_tree(state: dict, ref: nn.Module, reduce=None) -> dict:
    """A float model's state_dict → the state_dict of `ref`, the same
    architecture built for ``int8_w`` (ref :380): wherever `ref` has an
    `Int8Dense`, the float weight is quantized per output channel into its
    int8 ``weight`` and fp32 ``scale``; every other entry, an int8 weight
    with its scale among them, passes through. `reduce(name)` gives a
    site's `reduce` for `quantize_weight` (a row-parallel slice under tp)
    or None."""
    out = dict(state)
    for name, module in ref.named_modules():
        weight = state[f"{name}.weight"] if isinstance(module, Int8Dense) else None
        if weight is not None and weight.is_floating_point():
            out[f"{name}.weight"], out[f"{name}.scale"] = quantize_weight(
                weight, None if reduce is None else reduce(name))
    return out


@torch.inference_mode()
def calibrate_dense_amax(model: nn.Module, *args, **kwargs) -> dict[str, float]:
    """Every Linear's and `Int8Dense`'s input max-abs during one forward of
    `model` on `args`, keyed by the reference's module path
    (``block_3/attn1/to_q``; `models.bridge.reference_path`): the
    calibration table of the static modes (ref :201). A site called more
    than once keeps its largest value."""
    from ..models.bridge import reference_path

    amax: dict[str, torch.Tensor] = {}

    def recorder(name):
        def hook(module, inputs):
            a = inputs[0].float().abs().amax()
            amax[name] = a if name not in amax else torch.maximum(amax[name], a)
        return hook

    handles = [
        module.register_forward_pre_hook(recorder(name))
        for name, module in model.named_modules()
        if isinstance(module, (nn.Linear, Int8Dense))
    ]
    try:
        model(*args, **kwargs)
    finally:
        for handle in handles:
            handle.remove()
    return {reference_path(name): float(a) for name, a in amax.items()}


def merge_amax(*tables: dict) -> dict:
    """Fold per-timestep calibration tables with elementwise max (ref :257)."""
    merged: dict = {}
    for t in tables:
        for k, v in t.items():
            merged[k] = max(merged.get(k, 0.0), float(v))
    return merged
