"""FLUX.1 transformer (dual-stream + single-stream) with ECAD block caching,
in PyTorch.

Counterpart of ``ecad_tpu/models/flux.py``: 19 dual-stream blocks (joint
attention over [text; image] with per-head RMS q/k norms and 3-axis RoPE,
AdaLayerNormZero modulation per stream) + 38 single-stream blocks (qkv and
MLP projections from one modulated norm, one shared output projection), a
guidance embedding (FLUX.1-dev), packed 2×2 latents (64 channels) and a
final norm whose modulation is chunked scale first, then shift.

Cache semantics are the reference's (cached_flux_transformer_block.py):

* the dual ``full_attn`` caches the (image, text) attention pair
  atomically, before the gates; ``full_ff``/``full_ff_context`` cache the
  feed-forward outputs before the gates;
* ``single_proj_mlp`` caches the PRE-activation projection (the GELU is
  applied after the cache read), ``single_attn`` the attention output,
  ``single_proj_out`` the output projection before the gate;
* every component stores the value it used, recomputed or reused.

The cache is a flat dict ``{f"{component}_{block}": tensor}`` (the pair for
``full_attn``), as in the reference; step 0 starts from ``{}`` and
recomputes everything (`flux_step_masks`). Recompute decisions arrive as
Python bools: a cached component does no work, and neither do the
modulated norms that only it consumes. Every LN·(1+scale)+shift site runs
the port's `modulated_layer_norm` kernel, a dual block's image- and
text-stream norms of one site in one launch (`modulated_layer_norm_pair`)
where both are needed; attention runs `fused_attention`,
which routes FLUX-1024's joint attention (4608 tokens, D=128) to the
row-block clamp kernel and FLUX-256's (768 tokens) to the exact one.

With ``cache_dtype=torch.float8_e4m3fn`` the caches are stored in fp8 and
read back in the compute dtype (the reference's ``_to_cache`` /
``_from_cache``, :61-86), in every quant mode. With ``quant`` the block
projections run the int8 product (``ops/quant.py``), each site built by
`_dense` and keyed by the reference's module path; the adaLN linears take
only the weight-storage modes, with per-token activation scales.

Built with a `parallel.Mesh` (`init_model(..., mesh=)`), the blocks hold
their tp rank's heads and MLP width: q/k/v (both streams), ``ff_in``,
``ff_context_in`` and ``proj_mlp`` column-parallel, ``to_out``,
``to_add_out``, ``ff_out``, ``ff_context_out`` and the single block's
``proj_out`` row-parallel with one all-reduce each — ``proj_out`` reads
[attention ‖ MLP], so its input rows are sliced segment by segment, the
rank's heads then the rank's MLP columns. The caches keep the reference's
layout (`logical_constraint`, ref :405-510): every cached component is the
reduced, replicated tensor — ``single_attn`` too, gathered over tp, which
the reference constrains to the whole width — except ``single_proj_mlp``,
the rank's MLP slice. On an sp mesh both streams are split into the rank's
share of the text and of the image tokens (each must divide by sp; else
every rank runs all of them), RoPE takes those tokens' positions, joint
attention gathers K and V over sp (attention does not depend on the keys'
order), and the image tokens are gathered after the final projection.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..ops.fused import modulated_layer_norm, modulated_layer_norm_pair
from ..ops.quant import WEIGHT_MODES, dense
from .common import (
    TimestepEmbedding,
    column_parallel,
    load_module,
    randomize_,
    row_parallel,
    row_parallel_site,
    seq_parallel,
    shard_module,
    sharded_attention,
    sinusoidal_embedding,
    tp_degree,
)

FULL_COMPONENTS = ("full_attn", "full_ff", "full_ff_context")
SINGLE_COMPONENTS = ("single_attn", "single_proj_mlp", "single_proj_out")


@dataclass(frozen=True)
class FluxConfig:
    """Shapes of FLUX.1-dev (black-forest-labs/FLUX.1-dev transformer)."""

    dim: int = 3072
    num_heads: int = 24
    head_dim: int = 128
    num_blocks: int = 19
    num_single_blocks: int = 38
    in_channels: int = 64  # packed 2×2 × 16 latent channels
    joint_dim: int = 4096  # T5 embeddings
    pooled_dim: int = 768  # CLIP pooled embedding
    mlp_ratio: int = 4
    axes_dims: tuple[int, ...] = (16, 56, 56)
    rope_theta: int = 10000
    text_len: int = 512
    dtype: torch.dtype = torch.bfloat16
    # None | "int8" | "int8_static" | "int8_w" | "int8_w_static"
    # (ops/quant.py): the block projections through the int8 product; the
    # storage modes also hold the adaLN linears in int8 (3.2 B of the
    # 11.9 B parameters). Embedders, norm_out_linear and proj_out stay in
    # `dtype`.
    quant: Any = None
    # the static modes' calibration table: ("block_3/attn/to_q", amax)
    # pairs (ops/quant.py calibrate_dense_amax); a site it lacks keeps
    # per-token scales
    act_scales: Optional[tuple] = None
    # None (caches in `dtype`) or a storage dtype for cached activations
    cache_dtype: Optional[torch.dtype] = None

    @classmethod
    def tiny(cls, **kw) -> "FluxConfig":
        """The reference's ``FluxConfig.tiny`` shapes."""
        defaults = dict(
            dim=64,
            num_heads=4,
            head_dim=16,
            num_blocks=2,
            num_single_blocks=3,
            in_channels=16,
            joint_dim=32,
            pooled_dim=24,
            axes_dims=(4, 6, 6),
            text_len=8,
        )
        defaults.update(kw)
        return cls(**defaults)


# ---------------------------------------------------------------------------
# RoPE (3-axis, diffusers FluxPosEmbed semantics)
# ---------------------------------------------------------------------------


def rope_freqs(
    ids: np.ndarray, axes_dims: tuple[int, ...], theta: int
) -> tuple[np.ndarray, np.ndarray]:
    """ids (S, n_axes) → (cos, sin) of shape (S, head_dim/2), concatenated
    per axis; angles in float64, results in float32 (as the reference)."""
    cos_parts, sin_parts = [], []
    for k, d in enumerate(axes_dims):
        pos = ids[:, k].astype(np.float64)
        freqs = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
        angles = np.outer(pos, freqs)  # (S, d/2)
        cos_parts.append(np.cos(angles))
        sin_parts.append(np.sin(angles))
    return (
        np.concatenate(cos_parts, axis=1).astype(np.float32),
        np.concatenate(sin_parts, axis=1).astype(np.float32),
    )


def make_image_ids(grid_h: int, grid_w: int) -> np.ndarray:
    ids = np.zeros((grid_h, grid_w, 3), dtype=np.float64)
    ids[..., 1] = np.arange(grid_h)[:, None]
    ids[..., 2] = np.arange(grid_w)[None, :]
    return ids.reshape(-1, 3)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved rotary application on (B, S, H, D) in fp32: the pairs are
    the last dim's (even, odd) elements (diffusers apply_rotary_emb,
    use_real_unbind_dim=-1); cast back to x's dtype."""
    b, s, h, d = x.shape
    xf = x.float().reshape(b, s, h, d // 2, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    c = cos[None, :, None, :]
    sn = sin[None, :, None, :]
    return torch.stack([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1).reshape(
        b, s, h, d
    ).to(x.dtype)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _dense(n_in: int, n_out: int, config: FluxConfig, path: str) -> nn.Module:
    """One block projection site under the config's quant mode (ref
    :201-243); `path` is the reference's module path of the site."""
    return dense(n_in, n_out, config.dtype, config.quant, path, config.act_scales)


class AdaNorm(nn.Module):
    """AdaLayerNormZero family: silu(temb) → linear → n_mods (B, 1, d)
    chunks (shift, scale, gates…). The modulated norm itself is applied by
    the caller, only where its consumer is recomputed.

    `quant` is honoured only in the weight-storage modes, and with per-token
    activation scales (temb is one token a sample, so the max-abs costs
    nothing and adaLN stays out of the calibration table), as in the
    reference (:246-279)."""

    def __init__(self, dim: int, n_mods: int, dtype: torch.dtype,
                 quant: Optional[str] = None) -> None:
        super().__init__()
        self.n_mods = n_mods
        self.linear = dense(dim, n_mods * dim, dtype,
                            "int8_w" if quant in WEIGHT_MODES else None)

    def forward(self, temb: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return self.linear(F.silu(temb))[:, None, :].chunk(self.n_mods, dim=-1)


class QKNorm(nn.Module):
    """Per-head RMS norm on q and k (flux qk_norm='rms_norm', eps 1e-6), in
    fp32 with fp32 scales, cast to the compute dtype."""

    def __init__(self, head_dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.q_scale = nn.Parameter(torch.ones(head_dim, dtype=torch.float32))
        self.k_scale = nn.Parameter(torch.ones(head_dim, dtype=torch.float32))

    def _rms(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + 1e-6) * scale).to(self.dtype)

    def forward(self, q: torch.Tensor, k: torch.Tensor):
        return self._rms(q, self.q_scale), self._rms(k, self.k_scale)


def _heads(x: torch.Tensor, c: FluxConfig) -> torch.Tensor:
    """(B, T, heads·head_dim) → (B, T, heads, head_dim), the rank's heads
    under tp."""
    return x.view(x.shape[0], x.shape[1], -1, c.head_dim)


class FluxJointAttention(nn.Module):
    """Dual-stream joint attention: text and image tokens get separate
    qkv/out projections but attend jointly ([text; image] order). With a
    `mesh`, the rank's heads (module docstring)."""

    def __init__(self, config: FluxConfig, path: str = "block_0/attn", mesh=None) -> None:
        super().__init__()
        c = config
        self.config = c
        self.mesh = mesh
        width = c.num_heads * c.head_dim
        tp = tp_degree(mesh, c.num_heads)
        inner = width // tp
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            self.add_module(name, column_parallel(_dense(c.dim, inner, c, f"{path}/{name}"),
                                                  width, tp))
        self.norm_qk = QKNorm(c.head_dim, c.dtype)
        self.norm_added_qk = QKNorm(c.head_dim, c.dtype)
        self.to_out = row_parallel_site(_dense(inner, c.dim, c, f"{path}/to_out"), (width,), tp)
        self.to_add_out = row_parallel_site(_dense(inner, c.dim, c, f"{path}/to_add_out"),
                                            (width,), tp)

    def forward(self, img, txt, cos, sin, gather_kv: bool = False):
        """`gather_kv`: `img` and `txt` are the rank's sp share of the
        tokens, and `cos`, `sin` theirs."""
        c = self.config
        b, tt = txt.shape[:2]
        q, k = self.norm_qk(_heads(self.to_q(img), c), _heads(self.to_k(img), c))
        v = _heads(self.to_v(img), c)
        qc, kc = self.norm_added_qk(
            _heads(self.add_q_proj(txt), c), _heads(self.add_k_proj(txt), c)
        )
        vc = _heads(self.add_v_proj(txt), c)
        # text first, matching diffusers' concatenation order
        q = apply_rope(torch.cat([qc, q], dim=1), cos, sin)
        k = apply_rope(torch.cat([kc, k], dim=1), cos, sin)
        v = torch.cat([vc, v], dim=1)
        out = sharded_attention(q, k, v, None, self.mesh, gather_kv).reshape(b, q.shape[1], -1)
        return (row_parallel(self.to_out, out[:, tt:], self.mesh),
                row_parallel(self.to_add_out, out[:, :tt], self.mesh))


class FluxSingleAttention(nn.Module):
    """Single-stream attention: qkv + QK norm + RoPE + attention, no output
    projection (it is fused into the block's proj_out). With a `mesh`, the
    rank's heads at the block's tp degree `tp`."""

    def __init__(self, config: FluxConfig, path: str = "single_block_0/attn",
                 mesh=None, tp: int = 1) -> None:
        super().__init__()
        c = config
        self.config = c
        self.mesh = mesh
        width = c.num_heads * c.head_dim
        self.to_q = column_parallel(_dense(c.dim, width // tp, c, f"{path}/to_q"), width, tp)
        self.to_k = column_parallel(_dense(c.dim, width // tp, c, f"{path}/to_k"), width, tp)
        self.to_v = column_parallel(_dense(c.dim, width // tp, c, f"{path}/to_v"), width, tp)
        self.norm_qk = QKNorm(c.head_dim, c.dtype)

    def forward(self, x, cos, sin, gather_kv: bool = False) -> torch.Tensor:
        c = self.config
        q, k = self.norm_qk(_heads(self.to_q(x), c), _heads(self.to_k(x), c))
        v = _heads(self.to_v(x), c)
        out = sharded_attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, None,
                                self.mesh, gather_kv)
        return out.reshape(x.shape[0], x.shape[1], -1)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _cast(value, dtype: torch.dtype):
    if isinstance(value, tuple):
        return tuple(v.to(dtype) for v in value)
    return value.to(dtype)


def _pick(recompute: bool, compute, cache: dict, key: str, new: dict, config: FluxConfig):
    """One cached component: run `compute` and store what it gives, or reuse
    the stored value and store it again; either way return the value in the
    compute dtype. With a ``cache_dtype`` the store is cast to it and the
    reuse back (the reference's ``_to_cache`` / ``_from_cache``, :61-86); a
    pair (dual attention) is stored and read as one."""
    store = config.cache_dtype
    if recompute:
        value = compute()
        new[key] = value if store is None else _cast(value, store)
        return value
    new[key] = cache[key]
    return cache[key] if store is None else _cast(cache[key], config.dtype)


class FluxDualBlock(nn.Module):
    """Dual-stream block `index` (its quant sites ``block_<index>/...``);
    with a `mesh`, its tp slice."""

    def __init__(self, config: FluxConfig, index: int = 0, mesh=None) -> None:
        super().__init__()
        c = config
        self.config = c
        self.mesh = mesh
        path = f"block_{index}"
        self.norm1 = AdaNorm(c.dim, 6, c.dtype, c.quant)
        self.norm1_context = AdaNorm(c.dim, 6, c.dtype, c.quant)
        self.attn = FluxJointAttention(c, f"{path}/attn", mesh)
        hidden = c.dim * c.mlp_ratio
        tp = tp_degree(mesh, hidden)
        for name in ("ff", "ff_context"):
            self.add_module(f"{name}_in", column_parallel(
                _dense(c.dim, hidden // tp, c, f"{path}/{name}_in"), hidden, tp))
            self.add_module(f"{name}_out", row_parallel_site(
                _dense(hidden // tp, c.dim, c, f"{path}/{name}_out"), (hidden,), tp))

    def forward(
        self,
        img: torch.Tensor,  # (B, Ti, d)
        txt: torch.Tensor,  # (B, Tt, d)
        temb: torch.Tensor,  # (B, d)
        cos: torch.Tensor,
        sin: torch.Tensor,
        cache: dict[str, Any],  # component → stored value (absent at step 0)
        mask: tuple[bool, bool, bool],  # (full_attn, full_ff, full_ff_context)
        gather_kv: bool = False,  # img, txt: the rank's sp share of the tokens
    ):
        c = self.config
        mesh = self.mesh
        recompute_attn, recompute_ff, recompute_ffc = mask
        shift, scale, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(temb)
        c_shift, c_scale, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = (
            self.norm1_context(temb)
        )
        new: dict[str, Any] = {}
        # the image- and text-stream norms of a site go out as one launch
        # when both are needed
        attn_out, ctx_attn_out = _pick(
            recompute_attn,
            lambda: self.attn(*modulated_layer_norm_pair((img, scale, shift),
                                                         (txt, c_scale, c_shift)), cos, sin,
                              gather_kv),
            cache, "full_attn", new, c,
        )
        img = img + gate_msa * attn_out
        txt = txt + c_gate_msa * ctx_attn_out
        both = recompute_ff and recompute_ffc
        if both:
            img_normed, txt_normed = modulated_layer_norm_pair(
                (img, scale_mlp, shift_mlp), (txt, c_scale_mlp, c_shift_mlp))
        ff = _pick(
            recompute_ff,
            lambda: row_parallel(self.ff_out, _gelu(self.ff_in(
                img_normed if both else modulated_layer_norm(img, scale_mlp, shift_mlp))), mesh),
            cache, "full_ff", new, c,
        )
        img = img + gate_mlp * ff
        ffc = _pick(
            recompute_ffc,
            lambda: row_parallel(self.ff_context_out, _gelu(self.ff_context_in(
                txt_normed if both else modulated_layer_norm(txt, c_scale_mlp, c_shift_mlp))),
                mesh),
            cache, "full_ff_context", new, c,
        )
        txt = txt + c_gate_mlp * ffc
        return img, txt, new


class FluxSingleBlock(nn.Module):
    """Single-stream block `index` (its quant sites ``single_block_<index>/...``);
    with a `mesh`, its tp slice."""

    def __init__(self, config: FluxConfig, index: int = 0, mesh=None) -> None:
        super().__init__()
        c = config
        self.config = c
        self.mesh = mesh
        path = f"single_block_{index}"
        width, hidden = c.num_heads * c.head_dim, c.dim * c.mlp_ratio
        tp = tp_degree(mesh, c.num_heads, hidden)
        self.tp = tp
        self.norm = AdaNorm(c.dim, 3, c.dtype, c.quant)
        self.attn = FluxSingleAttention(c, f"{path}/attn", mesh, tp)
        self.proj_mlp = column_parallel(
            _dense(c.dim, hidden // tp, c, f"{path}/proj_mlp"), hidden, tp)
        # input: [attention (heads·head_dim); activated MLP (mlp_ratio·d)],
        # each segment sliced to the rank's share under tp
        self.proj_out = row_parallel_site(
            _dense((width + hidden) // tp, c.dim, c, f"{path}/proj_out"), (width, hidden), tp)

    def forward(
        self,
        x: torch.Tensor,  # (B, Tt+Ti, d) joint stream
        temb: torch.Tensor,
        cos: torch.Tensor,
        sin: torch.Tensor,
        cache: dict[str, Any],
        mask: tuple[bool, bool, bool],  # (attn, proj_mlp, proj_out)
        gather_kv: bool = False,  # x: the rank's sp share of the tokens
    ):
        c = self.config
        mesh = self.mesh
        recompute_attn, recompute_mlp, recompute_out = mask
        shift, scale, gate = self.norm(temb)
        new: dict[str, Any] = {}
        # the norm is shared by attention and the MLP projection
        normed = (
            modulated_layer_norm(x, scale, shift) if recompute_attn or recompute_mlp else None
        )
        # PRE-activation: the GELU runs after the cache read
        mlp = _pick(recompute_mlp, lambda: self.proj_mlp(normed), cache,
                    "single_proj_mlp", new, c)
        # the cached attention output is the whole width (the reference's
        # layout), gathered over tp; proj_out reads the rank's heads of it
        attn = _pick(recompute_attn, lambda: self._whole(self.attn(normed, cos, sin, gather_kv)),
                     cache, "single_attn", new, c)
        out = _pick(recompute_out,
                    lambda: row_parallel(self.proj_out, torch.cat(
                        [self._rank_heads(attn), _gelu(mlp)], dim=-1), mesh),
                    cache, "single_proj_out", new, c)
        return x + gate * out, new

    def _whole(self, attn: torch.Tensor) -> torch.Tensor:
        return attn if self.tp == 1 else self.mesh.all_gather(attn, "tp", dim=-1)

    def _rank_heads(self, attn: torch.Tensor) -> torch.Tensor:
        return attn if self.tp == 1 else self.mesh.shard(attn, "tp", dim=-1)


class FluxTransformer(nn.Module):
    """Full FLUX transformer over packed latents. `mask` is a tuple of
    per-block component triples, full blocks first then single blocks (the
    schedule's slot order). With a `mesh`, the rank's tp slice and sp share
    of the tokens (module docstring)."""

    def __init__(self, config: FluxConfig, mesh=None) -> None:
        super().__init__()
        c = config
        self.config = c
        self.mesh = mesh
        self.x_embedder = nn.Linear(c.in_channels, c.dim, dtype=c.dtype)
        self.context_embedder = nn.Linear(c.joint_dim, c.dim, dtype=c.dtype)
        self.timestep_embedder = TimestepEmbedding(256, c.dim, c.dtype)
        self.guidance_embedder = TimestepEmbedding(256, c.dim, c.dtype)
        # pooled CLIP projection: the TimestepEmbedding MLP shape
        self.text_embedder = TimestepEmbedding(c.pooled_dim, c.dim, c.dtype)
        self.blocks = nn.ModuleList(FluxDualBlock(c, i, mesh) for i in range(c.num_blocks))
        self.single_blocks = nn.ModuleList(
            FluxSingleBlock(c, i, mesh) for i in range(c.num_single_blocks)
        )
        self.norm_out_linear = nn.Linear(c.dim, 2 * c.dim, dtype=c.dtype)
        self.proj_out = nn.Linear(c.dim, c.in_channels, dtype=c.dtype)
        self._rope_cache: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    def rope(self, text_len: int, grid_hw: tuple[int, int], device) -> tuple:
        """(cos, sin) over the [text; image] ids, fp32, cached per shape."""
        key = (text_len, tuple(grid_hw), str(device))
        out = self._rope_cache.get(key)
        if out is None:
            c = self.config
            ids = np.concatenate([np.zeros((text_len, 3)), make_image_ids(*grid_hw)])
            cos, sin = rope_freqs(ids, c.axes_dims, c.rope_theta)
            out = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))
            self._rope_cache[key] = out
        return out

    def embed_conditions(
        self,
        timestep: torch.Tensor,  # (B,) sigma in [0, 1]
        guidance: torch.Tensor,  # (B,)
        pooled: torch.Tensor,  # (B, pooled_dim)
    ) -> torch.Tensor:
        c = self.config
        temb = self.timestep_embedder(
            sinusoidal_embedding(timestep.float() * 1000.0, 256).to(c.dtype)
        )
        temb = temb + self.guidance_embedder(
            sinusoidal_embedding(guidance.float() * 1000.0, 256).to(c.dtype)
        )
        return temb + self.text_embedder(pooled)

    def forward(
        self,
        latents: torch.Tensor,  # (B, T_img, in_channels) packed
        txt: torch.Tensor,  # (B, T_txt, joint_dim)
        pooled: torch.Tensor,  # (B, pooled_dim)
        timestep: torch.Tensor,  # (B,) sigma
        guidance: torch.Tensor,  # (B,)
        cache: dict[str, Any],
        mask: tuple,
        grid_hw: tuple[int, int],
    ) -> tuple[torch.Tensor, dict[str, Any]]:
        c = self.config
        tt = txt.shape[1]
        img = self.x_embedder(latents)
        txt_h = self.context_embedder(txt)
        temb = self.embed_conditions(timestep, guidance, pooled)
        cos, sin = self.rope(tt, grid_hw, latents.device)
        sp = seq_parallel(self.mesh, tt, img.shape[1])
        if sp:
            # the rank's text tokens then its image tokens, with their positions
            txt_h, img = self.mesh.shard(txt_h, "sp", 1), self.mesh.shard(img, "sp", 1)
            cos, sin = (torch.cat([self.mesh.shard(a[:tt], "sp", 0),
                                   self.mesh.shard(a[tt:], "sp", 0)]) for a in (cos, sin))
            tt = txt_h.shape[1]

        new_cache: dict[str, Any] = {}
        for i, block in enumerate(self.blocks):
            block_cache = {k: cache.get(f"{k}_{i}") for k in FULL_COMPONENTS}
            img, txt_h, updated = block(img, txt_h, temb, cos, sin, block_cache, mask[i], sp)
            for k, v in updated.items():
                new_cache[f"{k}_{i}"] = v

        x = torch.cat([txt_h, img], dim=1)
        for i, block in enumerate(self.single_blocks):
            block_cache = {k: cache.get(f"{k}_{i}") for k in SINGLE_COMPONENTS}
            x, updated = block(x, temb, cos, sin, block_cache, mask[c.num_blocks + i], sp)
            for k, v in updated.items():
                new_cache[f"{k}_{i}"] = v

        # AdaLayerNormContinuous: diffusers chunks SCALE first, then shift
        scale, shift = self.norm_out_linear(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        out = self.proj_out(modulated_layer_norm(x[:, tt:], scale, shift))
        if sp:
            out = self.mesh.all_gather(out, "sp", dim=1)
        return out, new_cache


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def flux_step_masks(schedule, config: FluxConfig) -> list[tuple]:
    """Schedule → per-step masks (full blocks then single blocks), with
    step 0 forced to recompute (there is no cache yet)."""
    n_slots = config.num_blocks + config.num_single_blocks
    masks = []
    for step in range(schedule.num_inference_steps):
        if step == 0:
            masks.append(full_flux_mask(config))
            continue
        row = schedule.mask[step].reshape(n_slots, 3)
        masks.append(tuple(tuple(bool(v) for v in r) for r in row))
    return masks


def full_flux_mask(config: FluxConfig, value: bool = True) -> tuple:
    return tuple(
        ((value,) * 3) for _ in range(config.num_blocks + config.num_single_blocks)
    )


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, H/2·W/2, 4C) FLUX packing (NHWC). Feature order
    within a packed token is (channel, p_h, p_w), as diffusers'
    `_pack_latents` has it."""
    b, h, w, ch = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, ch)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (b, gh, gw, c, ph, pw)
    return x.reshape(b, (h // 2) * (w // 2), 4 * ch)


def unpack_latents(packed: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    b, _, c4 = packed.shape
    ch = c4 // 4
    x = packed.reshape(b, grid_h, grid_w, ch, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)  # (b, gh, ph, gw, pw, c)
    return x.reshape(b, grid_h * 2, grid_w * 2, ch)


def init_model(
    config: FluxConfig, seed: int = 0, device: str | torch.device = "cuda",
    state: Optional[dict] = None, mesh=None,
) -> FluxTransformer:
    """A random-weight FluxTransformer built directly in `config.dtype` on
    `device` (the QK-norm scales in fp32, as the reference keeps them): no
    host copy and no fp32 masters, so the 11.9 B-parameter model takes
    23.8 GB of device memory in bf16 (``int8_w`` sites in int8,
    `randomize_`). With `state`, a loaded state_dict
    (`models.weights.load_flux_params`), the module takes its tensors
    instead, cast into its dtypes (`common.load_module`). Eval mode, no
    gradients. With a `mesh`, the whole model is made so and then cut to
    this rank's tp slice (`common.shard_module`)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = FluxTransformer(config)
    if state is not None:
        model = load_module(model, state, dev)
    else:
        model = randomize_(model.to_empty(device=dev), seed).eval().requires_grad_(False)
    return model if mesh is None else shard_module(model, mesh)
