"""Carry weights across from the JAX reference's param trees.

`pixart_state_dict`, `flux_state_dict` and `vae_state_dict` take the Flax
param tree of ``ecad_tpu``'s PixArtTransformer, FluxTransformer or
VAEDecoder as nested dicts of numpy arrays (unbox any partitioning
metadata first) and return the ``state_dict`` of the port's module of the
same configuration:

* a Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in);
* a Conv ``kernel`` HWIO becomes a Conv2d ``weight`` OIHW;
* a GroupNorm ``scale`` becomes ``weight``;
* ``scale_shift_table`` and every ``bias`` are copied as they are;
* ``block_<i>`` becomes ``blocks.<i>`` and FLUX's ``single_block_<i>``
  ``single_blocks.<i>``.

Module names are the reference's, so every other path carries over as it
is — among them the 1024² checkpoint's size-condition embedders,
``adaln_single/{resolution,aspect_ratio}_embedder/linear_{1,2}``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out: dict[tuple, np.ndarray] = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _convert(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    state: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params).items():
        *parents, name = path
        if name == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
            name = "weight"
        elif name == "scale":
            name = "weight"
        for prefix, modules in (("block_", "blocks"), ("single_block_", "single_blocks")):
            if parents and parents[0].startswith(prefix):
                parents = [modules, parents[0][len(prefix):], *parents[1:]]
        state[".".join([*parents, name])] = torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C")
        )
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
