"""ImageReward (BLIP backbone + MLP head) in PyTorch.

Counterpart of ``ecad_tpu/scoring/image_reward.py``. The reference scores
candidates with the torch ImageReward-v1.0 package
(ecad/benchmark/score_images.py:31-40), which wraps a BLIP pretrain model
(ViT-L/16 image encoder + BERT text encoder with per-layer cross-attention)
and a 5-layer MLP head, normalizing the raw reward with fixed mean/std:

* `VisionTransformer` — pre-norm ViT: patch conv, CLS token, learned
  position embeddings, exact-GELU MLP, LayerNorm eps 1e-6;
* `BertCrossEncoder` — post-norm BERT layers: self-attention with a −1e9
  key-padding bias, cross-attention to the image tokens, no token-type
  embeddings, LayerNorm eps 1e-12;
* `ImageRewardModel` — the text encoder's [CLS] feature →
  MLP(768→1024→128→64→16→1), score = (reward − mean)/std with
  ImageReward-v1.0's constants.

Precision: fp32 throughout, as the reference. Each tower's forward runs
under `fid.ieee_fp32`, so on the card the patch convolution and every
product are IEEE fp32 — no TF32 — and the card agrees with the CPU to fp32
round-off. The attention is `models.common.dot_product_attention`, the
plain softmax that ``jax.nn.dot_product_attention`` computes under XLA (no
Pallas kernel there, so none here). Module and parameter names follow the
reference's param tree, so `bridge.image_reward_state_dict` maps one onto
the other.

Weights load from a local ImageReward checkpoint (`load_image_reward`;
keys follow the published ImageReward.pt layout: ``blip.visual_encoder.*``,
``blip.text_encoder.bert.*``, ``mlp.layers.N``). The tokenizer is any
object that takes a list of prompts and returns numpy ``input_ids`` and
``attention_mask``; `ImageRewardScorer.from_weights` loads a BERT one with
``transformers`` (imported there only).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..models.common import dot_product_attention, load_module
from . import ScorerRegistry, _aggregate
from .fid import ieee_fp32, image_batch, resize_images

# ImageReward-v1.0 normalization constants (published with the model)
REWARD_MEAN = 0.16717362830052426
REWARD_STD = 1.0333394966054072

IMAGE_SIZE = 224
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
MAX_LENGTH = 35  # prompt tokens ImageReward scores with

ENV_CHECKPOINT = "ECAD_IMAGE_REWARD_CHECKPOINT"
ENV_TOKENIZER = "ECAD_IMAGE_REWARD_TOKENIZER"


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6

    @classmethod
    def large(cls, **kw) -> "ViTConfig":
        """ViT-L/16 at 224², ImageReward-v1.0's image encoder."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        d = dict(image_size=16, patch_size=8, hidden_size=32, num_layers=2,
                 num_heads=4)
        d.update(kw)
        return cls(**d)


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30524  # BLIP's extended BERT vocab
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    encoder_width: int = 1024  # cross-attention k/v dim (ViT hidden)

    @classmethod
    def base(cls, **kw) -> "BertConfig":
        """BERT-base with cross-attention to ViT-L, ImageReward-v1.0's text
        encoder."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        d = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                 intermediate_size=64, max_position_embeddings=32,
                 encoder_width=32)
        d.update(kw)
        return cls(**d)


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.view(b, s, n, d // n)


class ViTBlock(nn.Module):
    def __init__(self, c: ViTConfig) -> None:
        super().__init__()
        d = c.hidden_size
        self.heads = c.num_heads
        self.norm1 = nn.LayerNorm(d, eps=c.layer_norm_eps)
        self.q, self.k, self.v, self.proj = (nn.Linear(d, d) for _ in range(4))
        self.norm2 = nn.LayerNorm(d, eps=c.layer_norm_eps)
        self.fc1 = nn.Linear(d, d * c.mlp_ratio)
        self.fc2 = nn.Linear(d * c.mlp_ratio, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        q, k, v = (_heads(p(h), self.heads) for p in (self.q, self.k, self.v))
        x = x + self.proj(dot_product_attention(q, k, v).flatten(2))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class VisionTransformer(nn.Module):
    def __init__(self, config: ViTConfig) -> None:
        super().__init__()
        c = self.config = config
        d, p = c.hidden_size, c.patch_size
        self.patch_embed = nn.Conv2d(3, d, p, stride=p)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, (c.image_size // p) ** 2 + 1, d))
        for i in range(c.num_layers):
            self.add_module(f"block_{i}", ViTBlock(c))
        self.norm = nn.LayerNorm(d, eps=c.layer_norm_eps)

    @ieee_fp32
    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) normalized pixels → (B, 1+T, d) tokens."""
        x = self.patch_embed(pixels).flatten(2).transpose(1, 2)  # patches row-major
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
        x = x + self.pos_embed[:, : x.shape[1]]
        for i in range(self.config.num_layers):
            x = getattr(self, f"block_{i}")(x)
        return self.norm(x)


class BertCrossLayer(nn.Module):
    def __init__(self, c: BertConfig) -> None:
        super().__init__()
        d, eps = c.hidden_size, c.layer_norm_eps
        self.heads = c.num_heads
        for name in ("self", "cross"):
            kv_in = d if name == "self" else c.encoder_width
            self.add_module(f"{name}_q", nn.Linear(d, d))
            self.add_module(f"{name}_k", nn.Linear(kv_in, d))
            self.add_module(f"{name}_v", nn.Linear(kv_in, d))
            self.add_module(f"{name}_out", nn.Linear(d, d))
            self.add_module(f"{name}_norm", nn.LayerNorm(d, eps=eps))
        self.fc1 = nn.Linear(d, c.intermediate_size)
        self.fc2 = nn.Linear(c.intermediate_size, d)
        self.out_norm = nn.LayerNorm(d, eps=eps)

    def _mha(self, name: str, queries, keys_values, bias) -> torch.Tensor:
        q = _heads(getattr(self, f"{name}_q")(queries), self.heads)
        k = _heads(getattr(self, f"{name}_k")(keys_values), self.heads)
        v = _heads(getattr(self, f"{name}_v")(keys_values), self.heads)
        return getattr(self, f"{name}_out")(dot_product_attention(q, k, v, bias).flatten(2))

    def forward(self, x, ctx, mask_bias) -> torch.Tensor:
        # post-norm (BERT): residual then LayerNorm
        x = self.self_norm(x + self._mha("self", x, x, mask_bias))
        x = self.cross_norm(x + self._mha("cross", x, ctx, None))
        return self.out_norm(x + self.fc2(F.gelu(self.fc1(x))))


class BertCrossEncoder(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        c = self.config = config
        self.word_embeddings = nn.Parameter(torch.empty(c.vocab_size, c.hidden_size))
        self.position_embeddings = nn.Parameter(
            torch.empty(c.max_position_embeddings, c.hidden_size))
        self.embed_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", BertCrossLayer(c))

    @ieee_fp32
    def forward(self, input_ids, image_tokens, attention_mask=None) -> torch.Tensor:
        """(B, S) ids, (B, T, encoder_width) image tokens, an optional (B, S)
        0/1 mask → (B, S, d). BLIP's med-BERT has no token-type
        embeddings."""
        s = input_ids.shape[1]
        x = F.embedding(input_ids, self.word_embeddings) + self.position_embeddings[None, :s]
        x = self.embed_norm(x)
        mask_bias = None
        if attention_mask is not None:
            mask_bias = ((1.0 - attention_mask.float()) * -1e9)[:, None, None, :]
        for i in range(self.config.num_layers):
            x = getattr(self, f"layer_{i}")(x, image_tokens, mask_bias)
        return x


MLP_DIMS = (1024, 128, 64, 16, 1)


class RewardMLP(nn.Module):
    """ImageReward head: 768 → 1024 → 128 → 64 → 16 → 1, ReLU between."""

    def __init__(self, in_dim: int, dims: tuple[int, ...] = MLP_DIMS) -> None:
        super().__init__()
        self.n = len(dims)
        for i, (a, b) in enumerate(zip((in_dim, *dims[:-1]), dims)):
            self.add_module(f"fc{i}", nn.Linear(a, b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x


class ImageRewardModel(nn.Module):
    def __init__(self, vit: ViTConfig, bert: BertConfig,
                 mlp_dims: tuple[int, ...] = MLP_DIMS) -> None:
        super().__init__()
        self.vit, self.bert = vit, bert
        self.visual_encoder = VisionTransformer(vit)
        self.text_encoder = BertCrossEncoder(bert)
        self.mlp = RewardMLP(bert.hidden_size, mlp_dims)

    @ieee_fp32
    def forward(self, pixels, input_ids, attention_mask=None) -> torch.Tensor:
        """(B, 3, S, S) normalized pixels and (B, L) tokens → (B,) scores."""
        img_tokens = self.visual_encoder(pixels)
        txt = self.text_encoder(input_ids, img_tokens, attention_mask)
        reward = self.mlp(txt[:, 0])
        return (reward[:, 0] - REWARD_MEAN) / REWARD_STD


def convert_image_reward_state_dict(state: dict) -> dict:
    """ImageReward.pt keys → the reference's param tree (ref :282-380), as
    views of the checkpoint's tensors.

    Checkpoint layout (ImageReward-v1.0): `blip.visual_encoder.*` (timm ViT
    naming: patch_embed.proj, cls_token, pos_embed, blocks.N.{norm1,
    attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}, norm), `blip.text_encoder.*`
    (BERT naming with crossattention), `mlp.layers.N`."""

    def t(key):
        return state[key].T

    def ln(key):
        return {"scale": state[f"{key}.weight"], "bias": state[f"{key}.bias"]}

    def lin(key):
        return {"kernel": t(f"{key}.weight"), "bias": state[f"{key}.bias"]}

    p: dict[str, Any] = {}
    # ---- ViT (timm naming; fused qkv split into thirds) ----
    ve = "blip.visual_encoder"
    vit: dict[str, Any] = {
        "patch_embed": {
            "kernel": state[f"{ve}.patch_embed.proj.weight"].permute(2, 3, 1, 0),
            "bias": state[f"{ve}.patch_embed.proj.bias"],
        },
        "cls_token": state[f"{ve}.cls_token"],
        "pos_embed": state[f"{ve}.pos_embed"],
        "norm": ln(f"{ve}.norm"),
    }
    n_layers = max(
        int(k.split(".")[3]) for k in state if k.startswith(f"{ve}.blocks.")
    ) + 1
    for i in range(n_layers):
        b = f"{ve}.blocks.{i}"
        qkv_w = state[f"{b}.attn.qkv.weight"]
        d = qkv_w.shape[0] // 3
        qkv_b = state.get(f"{b}.attn.qkv.bias")
        if qkv_b is None:
            qkv_b = torch.zeros(3 * d, dtype=qkv_w.dtype)
        vit[f"block_{i}"] = {
            "norm1": ln(f"{b}.norm1"),
            **{n: {"kernel": qkv_w[j * d:(j + 1) * d].T, "bias": qkv_b[j * d:(j + 1) * d]}
               for j, n in enumerate("qkv")},
            "proj": lin(f"{b}.attn.proj"),
            "norm2": ln(f"{b}.norm2"),
            "fc1": lin(f"{b}.mlp.fc1"),
            "fc2": lin(f"{b}.mlp.fc2"),
        }
    p["visual_encoder"] = vit

    # ---- BERT text encoder with cross-attention ----
    te = "blip.text_encoder.bert"
    bert: dict[str, Any] = {
        "word_embeddings": state[f"{te}.embeddings.word_embeddings.weight"],
        "position_embeddings": state[f"{te}.embeddings.position_embeddings.weight"],
        "embed_norm": ln(f"{te}.embeddings.LayerNorm"),
    }
    n_layers = max(
        int(k.split(".")[5]) for k in state if k.startswith(f"{te}.encoder.layer.")
    ) + 1
    for i in range(n_layers):
        b = f"{te}.encoder.layer.{i}"
        bert[f"layer_{i}"] = {
            "self_q": lin(f"{b}.attention.self.query"),
            "self_k": lin(f"{b}.attention.self.key"),
            "self_v": lin(f"{b}.attention.self.value"),
            "self_out": lin(f"{b}.attention.output.dense"),
            "self_norm": ln(f"{b}.attention.output.LayerNorm"),
            "cross_q": lin(f"{b}.crossattention.self.query"),
            "cross_k": lin(f"{b}.crossattention.self.key"),
            "cross_v": lin(f"{b}.crossattention.self.value"),
            "cross_out": lin(f"{b}.crossattention.output.dense"),
            "cross_norm": ln(f"{b}.crossattention.output.LayerNorm"),
            "fc1": lin(f"{b}.intermediate.dense"),
            "fc2": lin(f"{b}.output.dense"),
            "out_norm": ln(f"{b}.output.LayerNorm"),
        }
    p["text_encoder"] = bert

    # ---- reward head ----
    mlp_keys = sorted(
        {
            int(k.split(".")[2])
            for k in state
            if k.startswith("mlp.layers.") and k.endswith(".weight")
        }
    )
    p["mlp"] = {f"fc{j}": lin(f"mlp.layers.{idx}") for j, idx in enumerate(mlp_keys)}
    return p


def load_image_reward(checkpoint: Path | str,
                      device: str | torch.device = "cuda") -> ImageRewardModel:
    """The model of a local ImageReward.pt (``torch.load``, memory-mapped)
    on `device`: ViT-L/16 and BERT-base (`ViTConfig.large`,
    `BertConfig.base`, as the reference's scorer builds them), the head's
    widths from the checkpoint."""
    from ..models.bridge import image_reward_state_dict

    state = torch.load(checkpoint, map_location="cpu", weights_only=True, mmap=True)
    params = convert_image_reward_state_dict(state)
    mlp_dims = tuple(int(fc["kernel"].shape[1]) for fc in params["mlp"].values())
    with torch.device("meta"):
        model = ImageRewardModel(ViTConfig.large(), BertConfig.base(), mlp_dims)
    return load_module(model, image_reward_state_dict(params), resolve_device(device))


class ImageRewardScorer:
    """Callable scorer for the registry: uint8 (N, H, W, 3) images — a numpy
    array, or a tensor already on the model's device, which stays there —
    and their prompts → the scores.json payload. Only the scores go to the
    host."""

    def __init__(self, model: ImageRewardModel, tokenizer):
        self.model = model
        self.tokenizer = tokenizer
        self.device = next(model.parameters()).device

    @classmethod
    def from_weights(cls, checkpoint: Path | str, tokenizer_dir: Path | str,
                     device: str | torch.device = "cuda") -> "ImageRewardScorer":
        from transformers import AutoTokenizer

        model = load_image_reward(checkpoint, device)
        return cls(model, AutoTokenizer.from_pretrained(str(tokenizer_dir)))

    def preprocess(self, images) -> torch.Tensor:
        """uint8 (N, H, W, 3) → normalized (N, 3, S, S) at the ViT's input
        resolution (224² for the real model; antialiased bicubic)."""
        x = resize_images(image_batch(images, self.device), self.model.vit.image_size,
                          "bicubic")
        mean = torch.tensor(IMAGE_MEAN, device=self.device)[:, None, None]
        std = torch.tensor(IMAGE_STD, device=self.device)[:, None, None]
        return (x - mean) / std

    def tokenize(self, prompts) -> tuple[torch.Tensor, torch.Tensor]:
        toks = self.tokenizer(list(prompts), padding="max_length", truncation=True,
                              max_length=MAX_LENGTH, return_tensors="np")
        return tuple(torch.from_numpy(np.asarray(toks[k])).to(self.device)
                     for k in ("input_ids", "attention_mask"))

    @torch.inference_mode()
    def rewards(self, images, prompts) -> torch.Tensor:
        """(N,) normalized rewards, on the model's device."""
        ids, mask = self.tokenize(prompts)
        return self.model(self.preprocess(images), ids, mask)

    def __call__(self, images, prompts, prompt_ids=None) -> dict:
        return _aggregate(self.rewards(images, prompts).cpu().numpy(), prompts, prompt_ids)


# ---------------------------------------------------------------------------
# registry hook
# ---------------------------------------------------------------------------

_RESIDENT: Optional[ImageRewardScorer] = None


def _image_reward_scorer(images, prompts, prompt_ids=None) -> dict:
    """Registry entry: the resident scorer, built at first use on the
    images' device (a tensor's own, else ``cuda``) from
    ECAD_IMAGE_REWARD_CHECKPOINT / ECAD_IMAGE_REWARD_TOKENIZER (local
    paths; no downloads), and built again for images on another device."""
    global _RESIDENT
    device = images.device if isinstance(images, torch.Tensor) else None
    if _RESIDENT is None or (device is not None and _RESIDENT.device.type != device.type):
        import os

        ckpt, tok = os.environ.get(ENV_CHECKPOINT), os.environ.get(ENV_TOKENIZER)
        if not ckpt or not tok:
            raise RuntimeError(
                f"image_reward scoring needs local weights: set {ENV_CHECKPOINT} "
                f"(ImageReward.pt) and {ENV_TOKENIZER} (bert tokenizer dir), or "
                "use --scorer mock"
            )
        _RESIDENT = ImageRewardScorer.from_weights(ckpt, tok, device or "cuda")
    return _RESIDENT(images, prompts, prompt_ids)


ScorerRegistry.register(_image_reward_scorer, name="image_reward")
