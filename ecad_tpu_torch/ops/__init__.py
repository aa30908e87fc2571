"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper runs its plain version for CPU tensors and launches its kernel
(or raises) for CUDA tensors, counting launches in its module's
``LAUNCHES`` (the harness's kernels, ``attn_variants``, count in
``attention.LAUNCHES``). ``quant.LAUNCHES["int8_matmul"]`` counts the int8
products of the serving quantization (a library call, ``torch._int_mm``,
on either device). `launch_counts` / `reset_launch_counts` read and clear them
all, so a run can show that it went through the kernels.
"""

from . import attention as _attention
from . import fused as _fused
from . import quant as _quant
from .attention import (
    attention_route,
    flash_attention,
    flash_attention_reference,
    fused_attention,
    fused_attention_reference,
    rowblock_attention,
    rowblock_attention_reference,
    single_tile_attention,
    transposed_attention,
    transposed_attention_reference,
)
from .attn_variants import (
    clamp_fd_attention,
    clamp_fd_attention_reference,
    matmul_only_attention,
    matmul_only_attention_reference,
    max_exp2_attention,
    max_exp2_attention_reference,
    nomax_attention,
    nomax_attention_reference,
)
from .fused import (
    modulated_layer_norm,
    modulated_layer_norm_pair,
    modulated_layer_norm_reference,
)

_COUNTERS = (_attention.LAUNCHES, _fused.LAUNCHES, _quant.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    out: dict[str, int] = {}
    for counter in _COUNTERS:
        out.update(counter)
    return out


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for name in counter:
            counter[name] = 0


__all__ = [
    "attention_route",
    "flash_attention",
    "flash_attention_reference",
    "fused_attention",
    "fused_attention_reference",
    "rowblock_attention",
    "rowblock_attention_reference",
    "single_tile_attention",
    "transposed_attention",
    "transposed_attention_reference",
    "matmul_only_attention",
    "matmul_only_attention_reference",
    "nomax_attention",
    "nomax_attention_reference",
    "max_exp2_attention",
    "max_exp2_attention_reference",
    "clamp_fd_attention",
    "clamp_fd_attention_reference",
    "modulated_layer_norm",
    "modulated_layer_norm_pair",
    "modulated_layer_norm_reference",
    "launch_counts",
    "reset_launch_counts",
]
