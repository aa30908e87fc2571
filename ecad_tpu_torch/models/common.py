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
(`path`) in the static modes' calibration table.

Mesh sharding (``ecad_tpu_torch.parallel``): built with a `Mesh`, the
projections of `Attention` and `FeedForward` hold their tp rank's slice —
q/k/v and the first FF product column-parallel (heads, MLP width), the
out projections row-parallel, each followed by one explicit all-reduce
over tp (`row_parallel`) — the reference's logical axes (:33-40, :599-602,
:661-686), marked on each site for `parallel.mesh.shard_params`. Where a
width does not divide by tp, the site stays whole on every rank
(`tp_degree`): the same function, computed replicated. Self-attention on
an sp mesh gathers K and V over sp (`sharded_attention`).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.attention import fused_attention
from ..ops.quant import Int8Dense, QuantLinear, dense, int8_linear, quantize_params_tree


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


def tp_degree(mesh, *widths: int) -> int:
    """The tp degree of a group of sites whose split axes are `widths`
    wide: the mesh's tp where each divides by it, else 1 — the sites then
    stay whole on every tp rank and compute the same function replicated
    (the reference's `_shard_map_attention` returns None there and XLA
    computes the attention unsharded, :444-457)."""
    tp = 1 if mesh is None else mesh.size("tp")
    return tp if all(w % tp == 0 for w in widths) else 1


def column_parallel(site: nn.Module, width: int, tp: int) -> nn.Module:
    """Mark a projection built with `width` / `tp` output features as the
    rank's slice of a `width`-wide column-parallel site (no mark at tp 1)."""
    if tp > 1:
        site.tp_split = (0, (width,))
    return site


def row_parallel_site(site: nn.Module, widths: tuple, tp: int) -> nn.Module:
    """Mark a projection built with sum(`widths`) / `tp` input features as
    the rank's slice of a row-parallel site whose input is the segments
    `widths`, each sliced alike (no mark at tp 1)."""
    if tp > 1:
        site.tp_split = (1, tuple(widths))
    return site


def row_parallel(site: nn.Module, x: torch.Tensor, mesh) -> torch.Tensor:
    """A site's product; at a row-parallel site (`row_parallel_site`) the
    rank's partial product summed over tp by one all-reduce, then the bias
    added once. An int8 site all-reduces its token max-abs and its int32
    sums instead (`ops.quant.int8_linear`'s `reduce`), so that its output
    equals the one-rank product bit for bit."""
    split = getattr(site, "tp_split", None)
    if split is None or split[0] != 1:
        return site(x)

    def reduce(t, op="sum"):
        return mesh.all_reduce(t, "tp", op)

    if isinstance(site, Int8Dense):
        return int8_linear(x, None, site.bias, act_amax=site.act_amax,
                           weight_q=(site.weight, site.scale), dtype=site.dtype,
                           reduce=reduce)
    if isinstance(site, QuantLinear):
        return site.fn(x, site.weight, site.bias, weight_q=site.weight_q(reduce),
                       reduce=reduce)
    y = reduce(F.linear(x, site.weight))
    return y if site.bias is None else y + site.bias


def seq_parallel(mesh, *lengths: int) -> bool:
    """Whether token sequences of `lengths` split over the mesh's sp: an
    sp axis > 1 that divides each. Where one does not divide, every sp rank
    runs the whole sequence (the same function, replicated), as the
    reference's attention wrapper falls back to XLA (:453-454)."""
    sp = 1 if mesh is None else mesh.size("sp")
    return sp > 1 and all(t % sp == 0 for t in lengths)


def sharded_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor] = None, mesh=None, gather_kv: bool = False,
) -> torch.Tensor:
    """`fused_attention` on one rank's shard: the counterpart of the
    reference's `_shard_map_attention` (ecad_tpu/models/common.py:430-490)
    with the models holding the shards. The batch is the rank's dp rows and
    the heads its tp heads already, which needs no collective; on an sp
    mesh the queries are the rank's tokens, and with `gather_kv` (self- or
    joint attention, whose K and V are sharded like the queries) K and V
    are all-gathered along sp before the kernel (:459-465). Cross-attention
    keeps its text K, V and key-padding bias whole on each rank. The kernel
    routes on the local shapes, as the reference's does inside shard_map:
    PixArt-α 256² under sp=2 sends 128 queries against 256 gathered keys to
    K1 and 128 against the 120 text keys to K2."""
    if gather_kv and mesh is not None:
        k = mesh.all_gather(k, "sp", dim=1)
        v = mesh.all_gather(v, "sp", dim=1)
    return fused_attention(q, k, v, bias)


class Attention(nn.Module):
    """Multi-head attention matching diffusers' Attention used by PixArt:
    separate q/k/v linears with bias, one out projection with bias.
    Self-attention when `context` is None, cross-attention otherwise.

    `kv()` exposes the projected keys/values so trajectory-constant
    cross-attention K/V can be computed once per trajectory and passed
    back through `kv=`.

    `quant` is a serving quant mode (``ops/quant.py``), `act_scales` the
    static modes' calibration table and `path` this module's path in the
    reference (``block_3/attn1``), which keys its sites there. With a
    `mesh` the module holds its tp rank's heads (`self.heads` is then the
    local count)."""

    def __init__(
        self, dim: int, heads: int, head_dim: int, dtype: torch.dtype,
        quant: Optional[str] = None, act_scales=None, path: str = "", mesh=None,
    ) -> None:
        super().__init__()
        tp = tp_degree(mesh, heads)
        width = heads * head_dim
        inner = width // tp
        self.heads = heads // tp
        self.head_dim = head_dim
        self.mesh = mesh

        def proj(name, n_in, n_out):
            return dense(n_in, n_out, dtype, quant, f"{path}/{name}", act_scales)

        self.to_q = column_parallel(proj("to_q", dim, inner), width, tp)
        self.to_k = column_parallel(proj("to_k", dim, inner), width, tp)
        self.to_v = column_parallel(proj("to_v", dim, inner), width, tp)
        self.to_out = row_parallel_site(proj("to_out", inner, dim), (width,), tp)

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
        gather_kv: bool = False,
    ) -> torch.Tensor:
        """`gather_kv`: `x` holds the rank's sp share of the tokens, so
        self-attention gathers its K and V over sp."""
        b, tq = x.shape[:2]
        q = self.to_q(x).view(b, tq, self.heads, self.head_dim)
        gather = gather_kv and context is None and kv is None
        if kv is None:
            kv = self.kv(x if context is None else context)
        out = sharded_attention(q, kv[0], kv[1], bias, self.mesh, gather)
        return row_parallel(self.to_out, out.reshape(b, tq, self.heads * self.head_dim),
                            self.mesh)


class FeedForward(nn.Module):
    """d → mult·d → d with tanh-approximate GELU (PixArt's
    activation_fn="gelu-approximate"). `quant`, `act_scales`, `path` and
    `mesh` as in `Attention` (the MLP width splits over tp)."""

    def __init__(
        self, dim: int, mult: int, dtype: torch.dtype,
        quant: Optional[str] = None, act_scales=None, path: str = "", mesh=None,
    ) -> None:
        super().__init__()
        width = dim * mult
        tp = tp_degree(mesh, width)
        self.mesh = mesh
        self.proj_in = column_parallel(
            dense(dim, width // tp, dtype, quant, f"{path}/proj_in", act_scales), width, tp)
        self.proj_out = row_parallel_site(
            dense(width // tp, dim, dtype, quant, f"{path}/proj_out", act_scales), (width,), tp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_parallel(self.proj_out, F.gelu(self.proj_in(x), approximate="tanh"),
                            self.mesh)


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
    (`ops.quant.quantize_params_tree`); everything else is shared. A model
    built for a mesh is remade for the same mesh, its row-parallel sites'
    channel scales taken over the whole rows (an all-reduce over tp)."""
    mesh = getattr(model, "mesh", None)
    with torch.device("meta"):
        new = type(model)(config) if mesh is None else type(model)(config, mesh=mesh)

    def reduce(name):
        split = getattr(new.get_submodule(name), "tp_split", None)
        if split is None or split[0] != 1:
            return None
        return lambda t, op: mesh.all_reduce(t, "tp", op)

    state = quantize_params_tree(model.state_dict(), new, reduce)
    new.load_state_dict(state, assign=True)
    return new.eval().requires_grad_(False)


def shard_module(model: nn.Module, mesh) -> nn.Module:
    """`model` (a whole PixArt or FLUX transformer) remade for `mesh`: the
    same class built with the mesh on the meta device takes this rank's tp
    slice of each marked site (`parallel.mesh.shard_params`, copies) and
    every other tensor of `model` as it is. Eval mode, no gradients."""
    from ..parallel.mesh import shard_params

    with torch.device("meta"):
        local = type(model)(model.config, mesh=mesh)
    local.load_state_dict(shard_params(model.state_dict(), local, mesh), assign=True)
    return local.eval().requires_grad_(False)


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
