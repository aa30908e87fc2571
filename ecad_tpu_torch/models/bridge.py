"""Carry weights across from the JAX reference's param trees.

`pixart_state_dict`, `flux_state_dict`, `vae_state_dict`, `t5_state_dict`
and `clip_state_dict` take the Flax param tree of ``ecad_tpu``'s
PixArtTransformer, FluxTransformer, VAEDecoder, T5Encoder or
CLIPTextEncoder as nested dicts of numpy arrays (unbox any partitioning
metadata first), or the same tree of torch tensors that the checkpoint
converters of `models.weights` build, and return the ``state_dict`` of the
port's module of the same configuration (numpy leaves as fp32 tensors,
torch leaves as views in their own dtype):

* a Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in);
* a Conv ``kernel`` HWIO becomes a Conv2d ``weight`` OIHW;
* a GroupNorm ``scale`` becomes ``weight``;
* ``scale_shift_table`` and every ``bias`` are copied as they are;
* an int8 ``kernel`` with a sibling ``scale`` (an ``int8_w`` site, ref
  ``ops/quant.py`` ``Int8Dense``) becomes the `Int8Dense`'s int8
  ``weight`` (out, in), and its ``scale`` stays the fp32 dequant
  ``scale``, as the reference reads a ``scale`` beside an int8 kernel
  (``models/common.py:281-295``);
* ``block_<i>`` becomes ``blocks.<i>`` and FLUX's ``single_block_<i>``
  ``single_blocks.<i>`` (the encoders' ``layer_<i>`` keep their names).

`reference_path` maps a port module name back to the reference's module
path, the key of the static quant modes' calibration tables.

Module names are the reference's, so every other path carries over as it
is — among them the 1024² checkpoint's size-condition embedders,
``adaln_single/{resolution,aspect_ratio}_embedder/linear_{1,2}``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> dict[tuple, Any]:
    out: dict[tuple, Any] = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value if isinstance(value, torch.Tensor) else np.asarray(value)
    return out


def _is_int8(arr) -> bool:
    return arr.dtype in (np.int8, torch.int8)


_BLOCK_LISTS = (("block_", "blocks"), ("single_block_", "single_blocks"))


def reference_path(name: str) -> str:
    """A port module name → the reference's module path:
    ``blocks.3.attn1.to_q`` → ``block_3/attn1/to_q``,
    ``single_blocks.2.proj_mlp`` → ``single_block_2/proj_mlp``."""
    parts = name.split(".")
    for prefix, modules in _BLOCK_LISTS:
        if len(parts) > 1 and parts[0] == modules:
            parts = [prefix + parts[1], *parts[2:]]
    return "/".join(parts)


def _convert(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    state: dict[str, torch.Tensor] = {}
    flat = _flatten(params)
    for path, arr in flat.items():
        *parents, name = path
        if name == "kernel":
            # a Dense kernel (in, out) → (out, in), an int8 one included; a
            # Conv kernel HWIO → OIHW
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = (arr.permute if isinstance(arr, torch.Tensor) else arr.transpose)(
                    3, 2, 0, 1)
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
            name = "weight"
        elif name == "scale" and not _is_int8(flat.get((*parents, "kernel"), arr)):
            # a norm's affine scale; beside an int8 kernel it is the
            # fp32 dequant scale and keeps its name
            name = "weight"
        for prefix, modules in _BLOCK_LISTS:
            if parents and parents[0].startswith(prefix):
                parents = [modules, parents[0][len(prefix):], *parents[1:]]
        if not isinstance(arr, torch.Tensor):
            dtype = np.int8 if _is_int8(arr) else np.float32
            arr = torch.from_numpy(np.array(arr, dtype=dtype, order="C"))
        state[".".join([*parents, name])] = arr
    return state


def pixart_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX PixArtTransformer params → port PixArtTransformer state_dict."""
    return _convert(params)


def flux_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX FluxTransformer params → port FluxTransformer state_dict. The
    QK-norm ``q_scale``/``k_scale`` keep their names."""
    return _convert(params)


def vae_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX VAEDecoder params → port VAEDecoder state_dict."""
    return _convert(params)


def t5_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX T5Encoder params → port T5Encoder state_dict (the RMS norms'
    weights are bare arrays and keep their names)."""
    return _convert(params)


def clip_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX CLIPTextEncoder params → port CLIPTextEncoder state_dict."""
    return _convert(params)
