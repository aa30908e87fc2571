"""Weight loading: local HF-layout checkpoints → the port's modules.

Counterpart of ``ecad_tpu/models/weights.py``. No network access is
assumed anywhere: ``weights_root/<repo-name>/`` holds the HuggingFace repo
layout (transformer/, text_encoder/, vae/, tokenizer/…) with safetensors or
torch ``.bin`` shards. The key mappings cover diffusers'
PixArtTransformer2DModel and FluxTransformer2DModel naming, so public
checkpoints drop in.

`load_state_dict` reads safetensors with the port's own reader (an 8-byte
little-endian header length, a JSON header, then raw little-endian bytes)
and returns torch CPU tensors that share one memory map of each file, in
the file's dtype: a BF16 shard is neither widened nor copied on the host
(the reference's numpy reader widens to fp32 and cannot read BF16 at all).
The converters build the reference's param-tree layout (Dense kernels
(in, out), conv kernels HWIO) as transposed views in the checkpoint's
dtype, and `models.bridge` turns that tree into the port's ``state_dict``;
the module the state is loaded into casts each tensor to its own dtype on
the device (the reference's ``serving_cast``).
"""

from __future__ import annotations

import json
import mmap
import struct
import sys
from pathlib import Path
from typing import Any

import torch

# safetensors dtype names the reader takes (the port's models ship F32,
# F16 and BF16; the rest are the integer and flag tensors checkpoints carry)
_DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: Path | str) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors viewing a
    private memory map of the file (pages are read when first touched)."""
    if sys.byteorder != "little":
        raise RuntimeError("the safetensors reader needs a little-endian host")
    path = Path(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        # ACCESS_COPY: a writable (copy-on-write) map, which torch.frombuffer
        # takes without a warning; nothing is ever written back to the file
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    header.pop("__metadata__", None)
    base = 8 + n
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(
                f"{path.name}: tensor {name!r} has dtype {info['dtype']}, which "
                f"the reader does not take (one of {sorted(_DTYPES)})"
            )
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = (end - begin) // itemsize
        if count != int(torch.Size(shape).numel()):
            raise ValueError(f"{path.name}: {name!r} holds {end - begin} bytes for {shape}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin,
                               offset=base + begin)
        if (base + begin) % itemsize:
            raw = raw.clone()  # an unaligned tensor gets its own aligned bytes
        out[name] = raw.view(dtype).view(shape)
    return out


def load_state_dict(model_dir: Path | str) -> dict[str, torch.Tensor]:
    """Every tensor of a model directory: all ``*.safetensors`` files (the
    shards of an index and single files alike, in name order), else all
    ``*.bin`` files through ``torch.load(weights_only=True)``. CPU tensors
    in the checkpoint's dtype."""
    model_dir = Path(model_dir)
    state: dict[str, torch.Tensor] = {}
    sts = sorted(model_dir.glob("*.safetensors"))
    if sts:
        for f in sts:
            state.update(read_safetensors(f))
        return state
    bins = sorted(model_dir.glob("*.bin"))
    if bins:
        for f in bins:
            state.update(torch.load(f, map_location="cpu", weights_only=True))
        return state
    raise FileNotFoundError(f"no weight files in {model_dir}")


def _lin(state, key) -> dict[str, torch.Tensor]:
    out = {"kernel": state[f"{key}.weight"].T}
    if f"{key}.bias" in state:
        out["bias"] = state[f"{key}.bias"]
    return out


class _TrackedState(dict):
    """State dict that records which keys a converter consumed, so a
    mapping bug at full scale (e.g. a missed embedder) fails loudly
    instead of silently dropping tensors."""

    def __init__(self, state):
        super().__init__(state)
        self.used: set[str] = set()

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)


_IGNORABLE = ("num_batches_tracked", "position_ids")


def _audit_consumed(state: "_TrackedState", what: str) -> None:
    left = [
        k
        for k in state
        if k not in state.used and not any(s in k for s in _IGNORABLE)
    ]
    if left:
        raise ValueError(
            f"{what} conversion left {len(left)} checkpoint tensors "
            f"unconsumed (mapping bug or unexpected architecture): "
            f"{left[:8]}{'…' if len(left) > 8 else ''}"
        )


# ---------------------------------------------------------------------------
# PixArt (diffusers PixArtTransformer2DModel)
# ---------------------------------------------------------------------------


def convert_pixart_state_dict(state: dict, config) -> dict:
    """diffusers keys → the reference's PixArtTransformer param tree (ref
    :88-156). The patchify conv (out, in, kh, kw) becomes a dense kernel
    (kh·kw·in, out): patch tokens are ordered (p_h, p_w, channel)."""
    state = _TrackedState(state)
    p: dict[str, Any] = {}
    w = state["pos_embed.proj.weight"]
    p["patch_proj"] = {
        "kernel": w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]),
        "bias": state["pos_embed.proj.bias"],
    }
    emb = "adaln_single.emb"
    p["adaln_single"] = {
        "timestep_embedder": {
            "linear_1": _lin(state, f"{emb}.timestep_embedder.linear_1"),
            "linear_2": _lin(state, f"{emb}.timestep_embedder.linear_2"),
        },
        "linear": _lin(state, "adaln_single.linear"),
    }
    if f"{emb}.resolution_embedder.linear_1.weight" in state:
        for name in ("resolution_embedder", "aspect_ratio_embedder"):
            p["adaln_single"][name] = {
                "linear_1": _lin(state, f"{emb}.{name}.linear_1"),
                "linear_2": _lin(state, f"{emb}.{name}.linear_2"),
            }
    p["caption_projection"] = {
        "linear_1": _lin(state, "caption_projection.linear_1"),
        "linear_2": _lin(state, "caption_projection.linear_2"),
    }
    for i in range(config.num_blocks):
        b = f"transformer_blocks.{i}"

        def attn(name):
            return {
                "to_q": _lin(state, f"{b}.{name}.to_q"),
                "to_k": _lin(state, f"{b}.{name}.to_k"),
                "to_v": _lin(state, f"{b}.{name}.to_v"),
                "to_out": _lin(state, f"{b}.{name}.to_out.0"),
            }

        p[f"block_{i}"] = {
            "scale_shift_table": state[f"{b}.scale_shift_table"],
            "attn1": attn("attn1"),
            "attn2": attn("attn2"),
            "ff": {
                "proj_in": _lin(state, f"{b}.ff.net.0.proj"),
                "proj_out": _lin(state, f"{b}.ff.net.2"),
            },
        }
    p["scale_shift_table"] = state["scale_shift_table"]
    p["proj_out"] = _lin(state, "proj_out")
    _audit_consumed(state, "PixArt transformer")
    return p


def _storage_quantize(state: dict, config, model_cls) -> dict:
    """For ``int8_w`` and ``int8_w_static`` configs, the float state_dict in
    the int8 weight-storage layout the model expects (ref :159-175): int8
    ``weight`` and fp32 per-channel ``scale`` wherever `model_cls(config)`,
    built on the meta device, has an `Int8Dense`; quantized from the
    checkpoint's own values, as the reference quantizes before its
    serving cast."""
    if getattr(config, "quant", None) not in ("int8_w", "int8_w_static"):
        return state
    from ..ops.quant import quantize_params_tree

    with torch.device("meta"):
        ref = model_cls(config)
    return quantize_params_tree(state, ref)


def load_pixart_params(weights_root: Path | str, repo: str, config) -> dict:
    """``weights_root/repo/transformer`` → the port PixArtTransformer's
    state_dict for `config` (ref :178-184)."""
    from .bridge import pixart_state_dict
    from .pixart import PixArtTransformer

    model_dir = Path(weights_root) / repo / "transformer"
    state = pixart_state_dict(convert_pixart_state_dict(load_state_dict(model_dir), config))
    return _storage_quantize(state, config, PixArtTransformer)


# ---------------------------------------------------------------------------
# FLUX (diffusers FluxTransformer2DModel)
# ---------------------------------------------------------------------------


def convert_flux_state_dict(state: dict, config) -> dict:
    """diffusers keys → the reference's FluxTransformer param tree (ref
    :191-261)."""
    state = _TrackedState(state)
    tte = "time_text_embed"
    p: dict[str, Any] = {
        "x_embedder": _lin(state, "x_embedder"),
        "context_embedder": _lin(state, "context_embedder"),
        "timestep_embedder": {
            "linear_1": _lin(state, f"{tte}.timestep_embedder.linear_1"),
            "linear_2": _lin(state, f"{tte}.timestep_embedder.linear_2"),
        },
        "text_embedder": {
            "linear_1": _lin(state, f"{tte}.text_embedder.linear_1"),
            "linear_2": _lin(state, f"{tte}.text_embedder.linear_2"),
        },
        "norm_out_linear": _lin(state, "norm_out.linear"),
        "proj_out": _lin(state, "proj_out"),
    }
    if f"{tte}.guidance_embedder.linear_1.weight" in state:
        p["guidance_embedder"] = {
            "linear_1": _lin(state, f"{tte}.guidance_embedder.linear_1"),
            "linear_2": _lin(state, f"{tte}.guidance_embedder.linear_2"),
        }

    def qknorm(prefix, q_key, k_key):
        return {
            "q_scale": state[f"{prefix}.{q_key}.weight"],
            "k_scale": state[f"{prefix}.{k_key}.weight"],
        }

    for i in range(config.num_blocks):
        b = f"transformer_blocks.{i}"
        p[f"block_{i}"] = {
            "norm1": {"linear": _lin(state, f"{b}.norm1.linear")},
            "norm1_context": {"linear": _lin(state, f"{b}.norm1_context.linear")},
            "attn": {
                **{n: _lin(state, f"{b}.attn.{n}")
                   for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                             "add_v_proj")},
                "to_out": _lin(state, f"{b}.attn.to_out.0"),
                "to_add_out": _lin(state, f"{b}.attn.to_add_out"),
                "norm_qk": qknorm(f"{b}.attn", "norm_q", "norm_k"),
                "norm_added_qk": qknorm(f"{b}.attn", "norm_added_q", "norm_added_k"),
            },
            "ff_in": _lin(state, f"{b}.ff.net.0.proj"),
            "ff_out": _lin(state, f"{b}.ff.net.2"),
            "ff_context_in": _lin(state, f"{b}.ff_context.net.0.proj"),
            "ff_context_out": _lin(state, f"{b}.ff_context.net.2"),
        }
    for i in range(config.num_single_blocks):
        b = f"single_transformer_blocks.{i}"
        p[f"single_block_{i}"] = {
            "norm": {"linear": _lin(state, f"{b}.norm.linear")},
            "attn": {
                "to_q": _lin(state, f"{b}.attn.to_q"),
                "to_k": _lin(state, f"{b}.attn.to_k"),
                "to_v": _lin(state, f"{b}.attn.to_v"),
                "norm_qk": qknorm(f"{b}.attn", "norm_q", "norm_k"),
            },
            "proj_mlp": _lin(state, f"{b}.proj_mlp"),
            "proj_out": _lin(state, f"{b}.proj_out"),
        }
    _audit_consumed(state, "FLUX transformer")
    return p


def load_flux_params(weights_root: Path | str, repo: str, config) -> dict:
    """``weights_root/repo/transformer`` → the port FluxTransformer's
    state_dict for `config` (ref :264-269)."""
    from .bridge import flux_state_dict
    from .flux import FluxTransformer

    model_dir = Path(weights_root) / repo / "transformer"
    state = flux_state_dict(convert_flux_state_dict(load_state_dict(model_dir), config))
    return _storage_quantize(state, config, FluxTransformer)
