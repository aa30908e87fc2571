"""CLIP score in PyTorch.

Counterpart of ``ecad_tpu/scoring/clip_score.py``. The reference shells out
to `python -m clip_score` and regex-parses the output
(ecad/benchmark/compute_clip.py:180-214). Protocol (torchmetrics /
clip-score package): score = 100 · max(0, cos(image_embed, text_embed))
per pair. This module adds the CLIP vision tower (`CLIPVisionEncoder`:
patch conv without bias, class embedding, learned positions,
``pre_layrnorm``, the text tower's quick-GELU layers from
``models/clip.py``, the pooled CLS token through ``post_layernorm``) and
the two projections; the text tower is ``models/clip.py``'s
`CLIPTextEncoder`.

Precision: fp32, as the reference; the vision tower's forward and the
score's products run under `fid.ieee_fp32` (no TF32 on the card for the
patch convolution or the products). Parameter names follow the reference's tree
(`bridge.clip_vision_state_dict`).

`CLIPScorer.from_weights` reads a local HF-layout CLIP directory. Unlike
the reference's, which builds ViT-B/32's vision tower beside a 768-wide
text tower that no public CLIP pairs with it, it takes both towers' widths
from the directory's ``config.json`` where there is one (the reference's
defaults otherwise; CLIP's end-of-text token is the vocabulary's last id).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..models.clip import CLIPLayer, CLIPTextConfig, CLIPTextEncoder, LayerNorm
from ..models.common import load_module
from . import ScorerRegistry, _aggregate
from .fid import ieee_fp32, ieee_fp32_context, image_batch, resize_images

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

ENV_MODEL_DIR = "ECAD_CLIP_MODEL_DIR"


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls, **kw) -> "CLIPVisionConfig":
        d = dict(image_size=16, patch_size=8, hidden_size=32,
                 intermediate_size=64, num_layers=2, num_heads=4,
                 projection_dim=16)
        d.update(kw)
        return cls(**d)


class CLIPVisionEncoder(nn.Module):
    def __init__(self, config: CLIPVisionConfig) -> None:
        super().__init__()
        c = self.config = config
        d, p = c.hidden_size, c.patch_size
        self.patch_embedding = nn.Conv2d(3, d, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.position_embedding = nn.Parameter(
            torch.empty((c.image_size // p) ** 2 + 1, d))
        self.pre_layrnorm = LayerNorm(d, eps=c.layer_norm_eps)
        # the vision layers are the text tower's without its causal bias
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(c))
        self.post_layernorm = LayerNorm(d, eps=c.layer_norm_eps)

    @ieee_fp32
    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) normalized → pooled (B, hidden)."""
        x = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding[None, None].expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None, : x.shape[1] + 1]
        x = self.pre_layrnorm(x)
        for i in range(self.config.num_layers):
            x = getattr(self, f"layer_{i}")(x, None)
        return self.post_layernorm(x[:, 0])


def convert_clip_vision_state_dict(state: dict, config: CLIPVisionConfig) -> dict:
    """transformers CLIPVisionModel keys → the reference's param tree (ref
    :107-144), as views of the checkpoint's tensors."""

    def lin(k):
        out = {"kernel": state[f"{k}.weight"].T}
        if f"{k}.bias" in state:
            out["bias"] = state[f"{k}.bias"]
        return out

    def ln(k):
        return {"scale": state[f"{k}.weight"], "bias": state[f"{k}.bias"]}

    pre = "vision_model"
    params: dict[str, Any] = {
        "patch_embedding": {
            "kernel": state[f"{pre}.embeddings.patch_embedding.weight"].permute(2, 3, 1, 0)},
        "class_embedding": state[f"{pre}.embeddings.class_embedding"],
        "position_embedding": state[f"{pre}.embeddings.position_embedding.weight"],
        "pre_layrnorm": ln(f"{pre}.pre_layrnorm"),
        "post_layernorm": ln(f"{pre}.post_layernorm"),
    }
    for i in range(config.num_layers):
        b = f"{pre}.encoder.layers.{i}"
        params[f"layer_{i}"] = {
            "layer_norm1": ln(f"{b}.layer_norm1"),
            "layer_norm2": ln(f"{b}.layer_norm2"),
            **{n: lin(f"{b}.self_attn.{n}") for n in ("q_proj", "k_proj", "v_proj",
                                                     "out_proj")},
            "fc1": lin(f"{b}.mlp.fc1"),
            "fc2": lin(f"{b}.mlp.fc2"),
        }
    return params


# config.json keys (transformers' CLIPConfig) → the port's config fields
_VISION_KEYS = {"image_size": "image_size", "patch_size": "patch_size",
                "hidden_size": "hidden_size", "intermediate_size": "intermediate_size",
                "num_layers": "num_hidden_layers", "num_heads": "num_attention_heads",
                "layer_norm_eps": "layer_norm_eps"}
_TEXT_KEYS = {"vocab_size": "vocab_size", "hidden_size": "hidden_size",
              "intermediate_size": "intermediate_size", "num_layers": "num_hidden_layers",
              "num_heads": "num_attention_heads",
              "max_position_embeddings": "max_position_embeddings",
              "layer_norm_eps": "layer_norm_eps"}


def clip_configs(model_dir: Path | str) -> tuple[CLIPVisionConfig, CLIPTextConfig]:
    """Both towers' configs from ``model_dir/config.json`` (its
    ``vision_config``, ``text_config`` and ``projection_dim``) where it
    exists, else the reference's defaults. The text tower's EOS is the
    vocabulary's last id (49407 in CLIP's 49408)."""
    path = Path(model_dir) / "config.json"
    vision, text = CLIPVisionConfig(), CLIPTextConfig()
    if not path.exists():
        return vision, text
    cfg = json.loads(path.read_text())
    v, t = cfg.get("vision_config") or {}, cfg.get("text_config") or {}
    vision = dataclasses.replace(
        vision, **{ours: v[theirs] for ours, theirs in _VISION_KEYS.items() if theirs in v},
        **({"projection_dim": cfg["projection_dim"]} if "projection_dim" in cfg else {}))
    text = dataclasses.replace(
        text, **{ours: t[theirs] for ours, theirs in _TEXT_KEYS.items() if theirs in t})
    return vision, dataclasses.replace(text, eos_token_id=text.vocab_size - 1)


def load_clip_towers(model_dir: Path | str, device: str | torch.device = "cuda") -> tuple:
    """(vision tower, text tower, visual projection, text projection) of a
    local HF-layout CLIP directory on `device`, at the widths of
    `clip_configs`."""
    from ..models.bridge import clip_state_dict, clip_vision_state_dict
    from ..models.clip import convert_clip_state_dict
    from ..models.weights import load_state_dict

    dev = resolve_device(device)
    state = load_state_dict(model_dir)
    vision_config, text_config = clip_configs(model_dir)
    with torch.device("meta"):
        vision, text = CLIPVisionEncoder(vision_config), CLIPTextEncoder(text_config)
    vision = load_module(vision, clip_vision_state_dict(
        convert_clip_vision_state_dict(state, vision_config)), dev)
    text = load_module(text, clip_state_dict(convert_clip_state_dict(state, text_config)), dev)
    return (vision, text, state["visual_projection.weight"].T,
            state["text_projection.weight"].T)


class CLIPScorer:
    """Image–text CLIP score with the clip-score package's protocol. Takes
    uint8 (N, H, W, 3) images — a numpy array, or a tensor already on the
    towers' device, which stays there. `tokenizer` is any object that takes
    a list of prompts and returns numpy ``input_ids``."""

    def __init__(
        self,
        vision: CLIPVisionEncoder,
        text: CLIPTextEncoder,
        visual_projection: torch.Tensor,  # (hidden_v, proj)
        text_projection: torch.Tensor,  # (hidden_t, proj)
        tokenizer,
    ):
        self.vision, self.text, self.tokenizer = vision, text, tokenizer
        self.vision_config, self.text_config = vision.config, text.config
        self.device = vision.class_embedding.device
        self.vproj = visual_projection.to(self.device, torch.float32)
        self.tproj = text_projection.to(self.device, torch.float32)

    @classmethod
    def from_weights(cls, model_dir: Path | str,
                     device: str | torch.device = "cuda") -> "CLIPScorer":
        """The towers of `load_clip_towers` and the directory's tokenizer
        (``transformers``' AutoTokenizer)."""
        from transformers import AutoTokenizer

        return cls(*load_clip_towers(model_dir, device),
                   AutoTokenizer.from_pretrained(str(model_dir)))

    def preprocess(self, images) -> torch.Tensor:
        x = resize_images(image_batch(images, self.device), self.vision_config.image_size,
                          "bicubic")
        mean = torch.tensor(CLIP_IMAGE_MEAN, device=self.device)[:, None, None]
        std = torch.tensor(CLIP_IMAGE_STD, device=self.device)[:, None, None]
        return (x - mean) / std

    @torch.inference_mode()
    def image_features(self, images) -> torch.Tensor:
        """The vision tower's pooled output (before the projection), the
        ``clip_vision`` FID features."""
        return self.vision(self.preprocess(images))

    def tokenize(self, prompts) -> torch.Tensor:
        toks = self.tokenizer(
            list(prompts), padding="max_length", truncation=True,
            max_length=self.text_config.max_position_embeddings, return_tensors="np",
        )
        return torch.from_numpy(np.asarray(toks["input_ids"])).to(self.device)

    def scores(self, images, prompts) -> torch.Tensor:
        """(N,) 100·max(0, cos) on the towers' device."""
        return self.scores_of_ids(images, self.tokenize(prompts))

    @torch.inference_mode()
    def scores_of_ids(self, images, ids: torch.Tensor) -> torch.Tensor:
        with ieee_fp32_context():
            img = self.image_features(images) @ self.vproj
            txt = self.text(ids)[1] @ self.tproj
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
        return 100.0 * torch.clamp((img * txt).sum(-1), min=0.0)

    def __call__(self, images, prompts, prompt_ids=None) -> dict:
        return _aggregate(self.scores(images, prompts).cpu().numpy(), prompts, prompt_ids)


_RESIDENT: Optional[CLIPScorer] = None


def resident_scorer(device=None) -> CLIPScorer:
    """The resident CLIP scorer, built at first use on `device` (``cuda``
    when None) from ``ECAD_CLIP_MODEL_DIR``, and built again when asked for
    another device."""
    global _RESIDENT
    if _RESIDENT is None or (device is not None
                             and _RESIDENT.device.type != torch.device(device).type):
        import os

        model_dir = os.environ.get(ENV_MODEL_DIR)
        if not model_dir:
            raise RuntimeError(
                f"clip scoring needs local weights: set {ENV_MODEL_DIR} to a CLIP "
                "model directory (HF layout), or use --scorer mock"
            )
        _RESIDENT = CLIPScorer.from_weights(model_dir, device or "cuda")
    return _RESIDENT


def _clip_scorer(images, prompts, prompt_ids=None) -> dict:
    """Registry entry: the resident scorer on the images' device (a
    tensor's own, else the resident's or ``cuda``)."""
    device = images.device if isinstance(images, torch.Tensor) else None
    return resident_scorer(device)(images, prompts, prompt_ids)


ScorerRegistry.register(_clip_scorer, name="clip")
