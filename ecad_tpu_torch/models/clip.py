"""CLIP text encoder in PyTorch (FLUX's pooled-embedding encoder).

Counterpart of ``ecad_tpu/models/clip.py`` (transformers' CLIPTextModel,
openai/clip-vit-large-patch14 as FLUX.1 uses it): learned position
embeddings, causal self-attention (a −inf bias above the diagonal),
quick-GELU MLP, a final layer norm; the pooled output is the hidden state
at the first EOS token (``argmax`` of ids == eos). fp32 throughout, as in
the reference; the layer norms run in fp32 and cast back. Module and
parameter names follow the reference's param tree, so
`bridge.clip_state_dict` maps one onto the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from .common import dot_product_attention, load_module


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    dtype: torch.dtype = torch.float32

    @classmethod
    def large(cls, **kw) -> "CLIPTextConfig":
        """openai/clip-vit-large-patch14's text tower (FLUX.1's)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "CLIPTextConfig":
        d = dict(
            vocab_size=99, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, max_position_embeddings=16,
            eos_token_id=98,
        )
        d.update(kw)
        return cls(**d)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class LayerNorm(nn.LayerNorm):
    """Flax ``nn.LayerNorm(dtype=float32)``: fp32 statistics and affine,
    cast back to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class CLIPLayer(nn.Module):
    def __init__(self, config: CLIPTextConfig) -> None:
        super().__init__()
        c = config
        d, dt = c.hidden_size, c.dtype
        self.heads = c.num_heads
        self.layer_norm1 = LayerNorm(d, eps=c.layer_norm_eps)
        self.q_proj = nn.Linear(d, d, dtype=dt)
        self.k_proj = nn.Linear(d, d, dtype=dt)
        self.v_proj = nn.Linear(d, d, dtype=dt)
        self.out_proj = nn.Linear(d, d, dtype=dt)
        self.layer_norm2 = LayerNorm(d, eps=c.layer_norm_eps)
        self.fc1 = nn.Linear(d, c.intermediate_size, dtype=dt)
        self.fc2 = nn.Linear(c.intermediate_size, d, dtype=dt)

    def forward(self, x: torch.Tensor, causal_bias: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = self.layer_norm1(x)
        q, k, v = (proj(h).view(b, s, self.heads, d // self.heads)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        attn = dot_product_attention(q, k, v, causal_bias)
        x = x + self.out_proj(attn.reshape(b, s, d))
        return x + self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))


class CLIPTextEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig) -> None:
        super().__init__()
        c = self.config = config
        self.token_embedding = nn.Parameter(
            torch.empty(c.vocab_size, c.hidden_size, dtype=torch.float32))
        self.position_embedding = nn.Parameter(
            torch.empty(c.max_position_embeddings, c.hidden_size, dtype=torch.float32))
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(c))
        self.final_layer_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, S) ids → (last_hidden_state (B, S, d), pooled (B, d))."""
        c = self.config
        b, s = input_ids.shape
        x = (F.embedding(input_ids, self.token_embedding)
             + self.position_embedding[None, :s]).to(c.dtype)
        causal = torch.full((s, s), float("-inf"), device=x.device).triu(1)[None, None]
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}")(x, causal)
        x = self.final_layer_norm(x)
        # pooled = the hidden state at the (first) EOS token
        eos_pos = torch.argmax((input_ids == c.eos_token_id).int(), dim=1)
        return x, x[torch.arange(b, device=x.device), eos_pos]


def convert_clip_state_dict(state: dict, config: CLIPTextConfig) -> dict:
    """transformers CLIPTextModel state-dict keys → the reference's param
    tree (ref :136-170): Linear kernels transposed (views)."""

    def lin(key):
        out = {"kernel": state[f"{key}.weight"].T}
        if f"{key}.bias" in state:
            out["bias"] = state[f"{key}.bias"]
        return out

    def ln(key):
        return {"scale": state[f"{key}.weight"], "bias": state[f"{key}.bias"]}

    pre = "text_model"
    params: dict[str, Any] = {
        "token_embedding": state[f"{pre}.embeddings.token_embedding.weight"],
        "position_embedding": state[f"{pre}.embeddings.position_embedding.weight"],
        "final_layer_norm": ln(f"{pre}.final_layer_norm"),
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


def load_clip_weights(
    weights_dir: Path | str, config: CLIPTextConfig, device: str | torch.device = "cuda"
) -> CLIPTextEncoder:
    """The encoder of a local HF-layout CLIP ``text_encoder`` directory,
    built for `config` on `device`."""
    from .bridge import clip_state_dict
    from .weights import load_state_dict

    params = convert_clip_state_dict(load_state_dict(weights_dir), config)
    with torch.device("meta"):
        model = CLIPTextEncoder(config)
    return load_module(model, clip_state_dict(params), resolve_device(device))


class CLIPTextPipeline:
    """Tokenizer + encoder bundle; `tokenizer` as `t5.T5EncoderPipeline`'s."""

    def __init__(self, config: CLIPTextConfig, model: CLIPTextEncoder, tokenizer):
        self.config = config
        self.model = model
        self.tokenizer = tokenizer

    @classmethod
    def from_weights(
        cls, weights_root: Path | str, repo: str, device: str | torch.device = "cuda"
    ) -> "CLIPTextPipeline":
        """CLIP-L from ``weights_root/repo/text_encoder`` and its tokenizer
        from ``tokenizer/`` (ref :184-195)."""
        from transformers import AutoTokenizer

        root = Path(weights_root) / repo
        config = CLIPTextConfig.large()
        model = load_clip_weights(root / "text_encoder", config, device)
        tokenizer = AutoTokenizer.from_pretrained(str(root / "tokenizer"))
        return cls(config, model, tokenizer)

    @torch.inference_mode()
    def encode_pooled(self, prompt: str) -> np.ndarray:
        """One prompt → its pooled (hidden_size,) embedding on the host."""
        toks = self.tokenizer(
            prompt, padding="max_length",
            max_length=self.config.max_position_embeddings,
            truncation=True, return_tensors="np",
        )
        ids = torch.from_numpy(np.asarray(toks["input_ids"]))
        _, pooled = self.model(ids.to(self.model.token_embedding.device))
        return pooled[0].cpu().numpy()
