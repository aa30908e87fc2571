"""T5 v1.1 encoder in PyTorch (PixArt's and FLUX's text encoder).

Counterpart of ``ecad_tpu/models/t5.py``: RMS layer norm (no mean
subtraction, no bias), a relative-position-bucket attention bias computed
on layer 0 and shared by every layer, gated tanh-GELU MLP, no biases
anywhere. The Dense layers hold their weights in `T5Config.dtype` (bf16 at
XXL) and cast their input to it, as Flax's ``nn.Dense(dtype=…)`` does; the
norm weights and the relative-position table stay fp32, so each block's
normalised input and the encoder's output are fp32 (bf16 × fp32 weight, as
in the reference). The token embedding is held in the compute dtype, which
the reference casts it to on every lookup. The reference scales q by √d_kv
to cancel its attention's 1/√d; here the attention runs with scale 1.0,
the same function (exactly at d_kv = 64). The key-padding mask adds −1e9
to the layer-0 position bias.

Weights load from a local HF-layout ``text_encoder`` directory through
`models.weights.load_state_dict`; tokenization uses the tokenizer files
shipped next to the weights (``transformers`` is imported only there).
Module and parameter names follow the reference's param tree, so
`bridge.t5_state_dict` maps one onto the other.
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
from .common import dot_product_attention, load_module


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def xxl(cls, **kw) -> "T5Config":
        """T5-XXL's encoder (google/t5-v1_1-xxl, PixArt's and FLUX.1's)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "T5Config":
        d = dict(
            vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
            num_heads=4, dtype=torch.float32,
        )
        d.update(kw)
        return cls(**d)


def t5_layer_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in fp32, cast back to x's dtype, times `weight` (an fp32
    weight makes the result fp32, as in the reference)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def relative_position_buckets(
    qlen: int, klen: int, num_buckets: int, max_distance: int
) -> np.ndarray:
    """Bidirectional bucket ids (transformers T5Attention._relative_position_bucket)."""
    ctx = np.arange(qlen)[:, None]
    mem = np.arange(klen)[None, :]
    rel = mem - ctx
    num_buckets //= 2
    ret = (rel > 0).astype(np.int64) * num_buckets
    n = np.abs(rel)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return ret + np.where(is_small, n, large)


class T5SelfAttention(nn.Module):
    def __init__(self, config: T5Config) -> None:
        super().__init__()
        c = config
        inner = c.num_heads * c.d_kv
        self.heads, self.d_kv = c.num_heads, c.d_kv
        self.q = nn.Linear(c.d_model, inner, bias=False, dtype=c.dtype)
        self.k = nn.Linear(c.d_model, inner, bias=False, dtype=c.dtype)
        self.v = nn.Linear(c.d_model, inner, bias=False, dtype=c.dtype)
        self.o = nn.Linear(inner, c.d_model, bias=False, dtype=c.dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        x = x.to(self.q.weight.dtype)
        q, k, v = (proj(x).view(b, s, self.heads, self.d_kv)
                   for proj in (self.q, self.k, self.v))
        out = dot_product_attention(q, k, v, bias, scale=1.0)
        return self.o(out.reshape(b, s, self.heads * self.d_kv))


class T5Block(nn.Module):
    def __init__(self, config: T5Config) -> None:
        super().__init__()
        c = config
        self.eps = c.layer_norm_epsilon
        self.attn_layer_norm = nn.Parameter(torch.ones(c.d_model, dtype=torch.float32))
        self.attention = T5SelfAttention(c)
        self.ff_layer_norm = nn.Parameter(torch.ones(c.d_model, dtype=torch.float32))
        self.wi_0 = nn.Linear(c.d_model, c.d_ff, bias=False, dtype=c.dtype)
        self.wi_1 = nn.Linear(c.d_model, c.d_ff, bias=False, dtype=c.dtype)
        self.wo = nn.Linear(c.d_ff, c.d_model, bias=False, dtype=c.dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(t5_layer_norm(x, self.attn_layer_norm, self.eps), bias)
        h = t5_layer_norm(x, self.ff_layer_norm, self.eps).to(self.wi_0.weight.dtype)
        ff = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        return x + self.wo(ff)


class T5Encoder(nn.Module):
    def __init__(self, config: T5Config) -> None:
        super().__init__()
        c = self.config = config
        self.token_embedding = nn.Parameter(torch.empty(c.vocab_size, c.d_model, dtype=c.dtype))
        self.relative_attention_bias = nn.Parameter(
            torch.empty(c.relative_attention_num_buckets, c.num_heads, dtype=torch.float32)
        )
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", T5Block(c))
        self.final_layer_norm = nn.Parameter(torch.ones(c.d_model, dtype=torch.float32))

    def position_bias(self, s: int) -> torch.Tensor:
        """The layer-0 relative-position bias (1, H, s, s), fp32."""
        c = self.config
        buckets = relative_position_buckets(
            s, s, c.relative_attention_num_buckets, c.relative_attention_max_distance
        )
        ids = torch.from_numpy(buckets).to(self.relative_attention_bias.device)
        return self.relative_attention_bias[ids].permute(2, 0, 1)[None]

    def forward(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """(B, S) token ids and 1/0 mask → (B, S, d_model) fp32."""
        c = self.config
        x = F.embedding(input_ids, self.token_embedding).to(c.dtype)
        bias = self.position_bias(input_ids.shape[1])
        if attention_mask is not None:
            bias = bias + ((1.0 - attention_mask.float()) * -1e9)[:, None, None, :]
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}")(x, bias)
        return t5_layer_norm(x, self.final_layer_norm, c.layer_norm_epsilon)


# ---------------------------------------------------------------------------
# weight porting (HF state dict → the reference's param tree → the module)
# ---------------------------------------------------------------------------


def convert_t5_state_dict(state: dict, config: T5Config) -> dict:
    """transformers T5EncoderModel state-dict keys → the reference's param
    tree (ref :205-237): Linear kernels transposed (views)."""

    def t(key):
        return state[key].T

    params: dict[str, Any] = {
        "token_embedding": state["shared.weight"],
        "relative_attention_bias": state[
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
        ],
        "final_layer_norm": state["encoder.final_layer_norm.weight"],
    }
    for i in range(config.num_layers):
        pre = f"encoder.block.{i}.layer"
        attn = f"{pre}.0.SelfAttention"
        mlp = f"{pre}.1.DenseReluDense"
        params[f"layer_{i}"] = {
            "attn_layer_norm": state[f"{pre}.0.layer_norm.weight"],
            "ff_layer_norm": state[f"{pre}.1.layer_norm.weight"],
            "attention": {n: {"kernel": t(f"{attn}.{n}.weight")} for n in "qkvo"},
            **{n: {"kernel": t(f"{mlp}.{n}.weight")} for n in ("wi_0", "wi_1", "wo")},
        }
    return params


def load_t5_weights(
    weights_dir: Path | str, config: T5Config, device: str | torch.device = "cuda"
) -> T5Encoder:
    """The encoder of a local HF-layout ``text_encoder`` directory
    (safetensors shards or pytorch_model.bin), built for `config` on
    `device` (ref :240-246 returns the param tree)."""
    from .bridge import t5_state_dict
    from .weights import load_state_dict

    params = convert_t5_state_dict(load_state_dict(weights_dir), config)
    with torch.device("meta"):
        model = T5Encoder(config)
    return load_module(model, t5_state_dict(params), resolve_device(device))


class T5EncoderPipeline:
    """Tokenizer + encoder bundle exposing the reference's encode surface.
    `tokenizer` is any callable that takes (prompt, padding="max_length",
    max_length=…, truncation=True, return_tensors="np") and returns numpy
    ``input_ids`` and ``attention_mask`` of shape (1, max_length)."""

    def __init__(self, config: T5Config, model: T5Encoder, tokenizer, max_length: int):
        self.config = config
        self.model = model
        self.tokenizer = tokenizer
        self.max_length = max_length

    @classmethod
    def from_weights(
        cls, weights_root: Path | str, repo: str, max_length: int = 120,
        device: str | torch.device = "cuda", encoder_dir: str = "text_encoder",
        tokenizer_dir: str = "tokenizer",
    ) -> "T5EncoderPipeline":
        """T5-XXL from ``weights_root/repo/<encoder_dir>`` and its tokenizer
        from ``<tokenizer_dir>`` (ref :265-283 reads text_encoder/ and
        tokenizer/; FLUX.1's public layout keeps T5 in text_encoder_2/ and
        tokenizer_2/)."""
        root = Path(weights_root) / repo
        enc_dir = root / encoder_dir
        if not enc_dir.exists():
            raise FileNotFoundError(
                f"no {encoder_dir} weights under {root}; place the HF repo "
                "layout there or use random_weights=True"
            )
        from transformers import AutoTokenizer

        config = T5Config.xxl()
        model = load_t5_weights(enc_dir, config, device)
        tokenizer = AutoTokenizer.from_pretrained(str(root / tokenizer_dir))
        return cls(config, model, tokenizer, max_length)

    @torch.inference_mode()
    def encode(self, prompt: str) -> tuple[np.ndarray, np.ndarray]:
        """One prompt → its (max_length, d_model) fp32 embeddings and its
        1/0 attention mask, on the host."""
        toks = self.tokenizer(
            prompt, padding="max_length", max_length=self.max_length,
            truncation=True, return_tensors="np",
        )
        device = self.model.final_layer_norm.device
        out = self.model(
            torch.from_numpy(np.asarray(toks["input_ids"])).to(device),
            torch.from_numpy(np.asarray(toks["attention_mask"])).to(device),
        )
        return out[0].float().cpu().numpy(), np.asarray(toks["attention_mask"][0])
