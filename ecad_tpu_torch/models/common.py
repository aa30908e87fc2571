"""Shared building blocks of the diffusion transformers, in PyTorch.

Counterparts of ``ecad_tpu/models/common.py``: `sinusoidal_embedding`
(:82), `TimestepEmbedding` (:99), `TextProjection` (:123), `layer_norm`
(:147), `Attention` with the cross-attention K/V hoist (:540-626),
`FeedForward` with tanh-GELU (:629-696) and `sincos_2d_pos_embed` (:699).
Layouts are the reference's: tokens (B, T, d), attention heads (B, T, H, D).
Attention calls the port's `fused_attention` kernel directly; the plain
Linear products stay `torch.nn.functional.linear`, as the reference left
them to XLA. Quantization and mesh sharding are not part of this slice.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.attention import fused_attention


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
    back through `kv=`."""

    def __init__(
        self, dim: int, heads: int, head_dim: int, dtype: torch.dtype
    ) -> None:
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.head_dim = head_dim
        self.to_q = nn.Linear(dim, inner, dtype=dtype)
        self.to_k = nn.Linear(dim, inner, dtype=dtype)
        self.to_v = nn.Linear(dim, inner, dtype=dtype)
        self.to_out = nn.Linear(inner, dim, dtype=dtype)

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
    activation_fn="gelu-approximate")."""

    def __init__(self, dim: int, mult: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.proj_in = nn.Linear(dim, dim * mult, dtype=dtype)
        self.proj_out = nn.Linear(dim * mult, dim, dtype=dtype)

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
    0, PixArt's modulation tables N(0, 1/√d), FLUX's QK-norm scales 1."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, param in model.named_parameters():
        if name.endswith("scale_shift_table"):
            param.normal_(0.0, param.shape[-1] ** -0.5, generator=gen)
        elif name.endswith(("q_scale", "k_scale")):
            param.fill_(1.0)
        elif name.endswith("bias"):
            param.zero_()
        else:
            param.normal_(0.0, std, generator=gen)
    return model
