"""Shared building blocks of the diffusion transformers, in PyTorch.

Counterparts of ``ecad_tpu/models/common.py``: `sinusoidal_embedding`
(:82), `TimestepEmbedding` (:99), `TextProjection` (:123), `layer_norm`
(:147), `Attention` with the cross-attention K/V hoist (:540-626),
`FeedForward` with tanh-GELU (:629-696) and `sincos_2d_pos_embed` (:699).
Layouts are the reference's: tokens (B, T, d), attention heads (B, T, H, D).
Attention calls the port's `fused_attention` kernel directly; the plain
Linear products stay `torch.nn.functional.linear`, as the reference left
them to XLA. Under a serving quant mode the projections of `Attention` and
`FeedForward` are built by `ops.quant.dense` (the reference's ``dense``
helper, :563-597 and :641-690), each keyed by the reference's module path
(`path`) in the static modes' calibration table. Mesh sharding comes in a
later slice.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.attention import fused_attention
from ..ops.quant import Int8Dense, dense, quantize_params_tree


def sinusoidal_embedding(
    timesteps: torch.Tensor,
    dim: int = 256,
    *,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """diffusers get_timestep_embedding equivalent (fp32)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    """linear(in→d) → silu → linear(d→d), matching diffusers TimestepEmbedding."""

    def __init__(self, in_dim: int, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim, dtype=dtype)
        self.linear_2 = nn.Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class TextProjection(nn.Module):
    """PixArtAlphaTextProjection: linear → gelu(tanh) → linear."""

    def __init__(self, in_dim: int, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim, dtype=dtype)
        self.linear_2 = nn.Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.gelu(self.linear_1(x), approximate="tanh"))


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without learnable affine, computed in fp32, cast back."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class Attention(nn.Module):
    """Multi-head attention matching diffusers' Attention used by PixArt:
    separate q/k/v linears with bias, one out projection with bias.
    Self-attention when `context` is None, cross-attention otherwise.

    `kv()` exposes the projected keys/values so trajectory-constant
    cross-attention K/V can be computed once per trajectory and passed
    back through `kv=`.

    `quant` is a serving quant mode (``ops/quant.py``), `act_scales` the
    static modes' calibration table and `path` this module's path in the
    reference (``block_3/attn1``), which keys its sites there."""

    def __init__(
        self, dim: int, heads: int, head_dim: int, dtype: torch.dtype,
        quant: Optional[str] = None, act_scales=None, path: str = "",
    ) -> None:
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.head_dim = head_dim

        def proj(name, n_in, n_out):
            return dense(n_in, n_out, dtype, quant, f"{path}/{name}", act_scales)

        self.to_q = proj("to_q", dim, inner)
        self.to_k = proj("to_k", dim, inner)
        self.to_v = proj("to_v", dim, inner)
        self.to_out = proj("to_out", inner, dim)

    def kv(self, ctx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b, tk = ctx.shape[:2]
        k = self.to_k(ctx).view(b, tk, self.heads, self.head_dim)
        v = self.to_v(ctx).view(b, tk, self.heads, self.head_dim)
        return k, v

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        bias: Optional[torch.Tensor] = None,
        kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        b, tq = x.shape[:2]
        q = self.to_q(x).view(b, tq, self.heads, self.head_dim)
        if kv is None:
            kv = self.kv(x if context is None else context)
        out = fused_attention(q, kv[0], kv[1], bias)
        return self.to_out(out.reshape(b, tq, self.heads * self.head_dim))


class FeedForward(nn.Module):
    """d → mult·d → d with tanh-approximate GELU (PixArt's
    activation_fn="gelu-approximate"). `quant`, `act_scales` and `path` as
    in `Attention`."""

    def __init__(
        self, dim: int, mult: int, dtype: torch.dtype,
        quant: Optional[str] = None, act_scales=None, path: str = "",
    ) -> None:
        super().__init__()
        self.proj_in = dense(dim, dim * mult, dtype, quant, f"{path}/proj_in", act_scales)
        self.proj_out = dense(dim * mult, dim, dtype, quant, f"{path}/proj_out", act_scales)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj_out(F.gelu(self.proj_in(x), approximate="tanh"))


def sincos_2d_pos_embed(
    dim: int,
    grid_h: int,
    grid_w: int,
    base_size: int,
    interpolation_scale: float = 1.0,
) -> np.ndarray:
    """diffusers get_2d_sincos_pos_embed equivalent (numpy, fp32)."""
    gh = np.arange(grid_h, dtype=np.float32) / (grid_h / base_size) / interpolation_scale
    gw = np.arange(grid_w, dtype=np.float32) / (grid_w / base_size) / interpolation_scale
    grid = np.meshgrid(gw, gh)  # w first, matching diffusers
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_h, grid_w)

    def _1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
        omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb_h = _1d(dim // 2, grid[0])
    emb_w = _1d(dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


@torch.no_grad()
def randomize_(model: nn.Module, seed: int = 0, std: float = 0.02) -> nn.Module:
    """Fill a transformer's weights in place from a seeded generator on the
    model's device, as the reference's ``init_params`` /
    ``init_flux_params`` initialise them: Linear weights N(0, std), biases
    0, PixArt's modulation tables N(0, 1/√d), FLUX's QK-norm scales 1; an
    `Int8Dense`'s int8 weight uniform in [-127, 127] and its dequant scale
    |N(0, 1)|·std/127 + 1e-6, as the reference's ``random_serving_params``
    fills them (``models/common.py:212-300``)."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    int8_sites = {name for name, m in model.named_modules() if isinstance(m, Int8Dense)}
    for name, param in model.named_parameters():
        site, _, leaf = name.rpartition(".")
        if site in int8_sites and leaf == "weight":
            param.copy_(torch.randint(-127, 128, param.shape, generator=gen,
                                      device=device, dtype=torch.int8))
        elif site in int8_sites and leaf == "scale":
            param.normal_(0.0, 1.0, generator=gen).abs_().mul_(std / 127.0).add_(1e-6)
        elif name.endswith("scale_shift_table"):
            param.normal_(0.0, param.shape[-1] ** -0.5, generator=gen)
        elif name.endswith(("q_scale", "k_scale")):
            param.fill_(1.0)
        elif name.endswith("bias"):
            param.zero_()
        else:
            param.normal_(0.0, std, generator=gen)
    return model


def rebuild(model: nn.Module, config) -> nn.Module:
    """`model`'s architecture built for `config` (another quant mode or
    calibration table) on `model`'s own tensors, without copying them: the
    new module is made on the meta device and takes `model`'s state by
    assignment. Sites that `config` stores as `Int8Dense` and `model` holds
    in float are quantized from their float weights
    (`ops.quant.quantize_params_tree`); everything else is shared."""
    with torch.device("meta"):
        new = type(model)(config)
    state = quantize_params_tree(model.state_dict(), new)
    new.load_state_dict(state, assign=True)
    return new.eval().requires_grad_(False)


def load_module(model: nn.Module, state: dict, device: torch.device) -> nn.Module:
    """`model`, built on the meta device, placed on `device` and filled from
    `state` (a port state_dict of CPU tensors in any float dtype): each
    tensor is copied into its parameter's own dtype, so a module built in
    bf16 takes an fp32 checkpoint as the reference's ``serving_cast`` does,
    while the parameters a module keeps in fp32 stay fp32. Eval mode, no
    gradients."""
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model.eval().requires_grad_(False)


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain softmax attention, (B, T, H, D) q and (B, S, H, D) k, v →
    (B, T, H, D), as ``jax.nn.dot_product_attention`` computes it under XLA
    (the text encoders' attention; no Pallas kernel there, so none here):
    fp32 logits from the operands' own values, times `scale` (1/√D by
    default), plus an fp32 `bias` broadcast to (B, H, T, S), softmax in
    fp32, the probabilities cast to v's dtype, then ·v in that dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)
