"""ecad_tpu_torch — the PyTorch/CUDA port of ecad_tpu for NVIDIA Hopper.

Same module names as ``ecad_tpu`` (the JAX reference), PyTorch inside.
Every entry point runs on ``cuda`` unless the caller asks for ``cpu``;
without a GPU and without that request it raises instead of quietly
running on the CPU. The hand-written kernels live in ``ops/`` (CUDA C++
sources under ``csrc/``, built with ``nvcc`` at first use into
``build/ecad_tpu_torch/``; Triton kernels compiled at first launch).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` (the default) must exist:
    there is no silent fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ecad_tpu_torch: a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "(--device cpu) to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["resolve_device", "__version__"]
