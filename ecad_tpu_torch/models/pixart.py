"""PixArt-α/Σ diffusion transformer with ECAD block caching, in PyTorch.

Counterpart of ``ecad_tpu/models/pixart.py``: 28 ada_norm_single blocks of
self-attn → cross-attn → gelu-approx FF at d=1152, 16 heads × 72, a shared
AdaLayerNormSingle producing per-step (shift, scale, gate) modulation (plus
the resolution and aspect-ratio size conditions of the 1024² checkpoint),
and a final modulated projection. An optional DiT topology `plan`
(``ecad_tpu_torch.graph``) reorders, skips, repeats or fans out blocks.

Cache design: the cache is an explicit dict ``{component: [per-block
(B, T, d) tensor]}`` threaded through the forward pass. Recompute decisions
arrive as Python bools per (block, component); a cached component is not
computed at all — its branch is skipped. Caches hold the *pre-gate*
component outputs, which are re-gated with the current step's gates
(reference: cached_transformer_block.py:240-244, 313-321). The three
modulated norms run the port's `modulated_layer_norm` kernel.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..ops.fused import modulated_layer_norm
from .common import (
    Attention,
    FeedForward,
    TextProjection,
    TimestepEmbedding,
    randomize_,
    sincos_2d_pos_embed,
    sinusoidal_embedding,
)

# Step mask layout: components per block in schedule order (attn1, attn2, ff)
COMPONENTS = ("attn1", "attn2", "ff")
StepMask = tuple  # tuple[tuple[bool, bool, bool], ...] — one triple per block


@dataclass(frozen=True)
class PixArtConfig:
    """Shapes for PixArt-XL-2. 256-px checkpoints use sample_size=32; the
    1024 checkpoint uses sample_size=128 and the additional size
    conditions (whose two embedders are dim // 3 wide each, so dim must be
    a multiple of 3 with them on)."""

    dim: int = 1152
    num_heads: int = 16
    head_dim: int = 72
    num_blocks: int = 28
    in_channels: int = 4
    out_channels: int = 8
    patch_size: int = 2
    sample_size: int = 32
    caption_dim: int = 4096
    text_len: int = 120
    ff_mult: int = 4
    use_additional_conditions: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def tokens(self) -> int:
        g = self.sample_size // self.patch_size
        return g * g

    @classmethod
    def tiny(cls, **kw) -> "PixArtConfig":
        """2-block, 8×8-latent test double (same shapes as the reference's
        ``PixArtConfig.tiny``)."""
        defaults = dict(
            dim=64,
            num_heads=4,
            head_dim=16,
            num_blocks=2,
            sample_size=8,
            caption_dim=32,
            text_len=8,
        )
        defaults.update(kw)
        return cls(**defaults)


def full_step_mask(config: PixArtConfig, value: bool = True) -> StepMask:
    return tuple(((value,) * 3 for _ in range(config.num_blocks)))


def schedule_step_masks(schedule, config: PixArtConfig) -> list[StepMask]:
    """Per-step masks from a PixArtCacheSchedule, with step-0 cache-miss
    forcing (the reference recomputes on an empty cache regardless of the
    mask; cached_transformer_block.py:344-352)."""
    arr = schedule.to_numpy()  # (steps, blocks, 3)
    masks = []
    for step in range(arr.shape[0]):
        if step == 0:
            if not arr[0].all():
                # stderr: stdout may carry machine-readable output
                print(
                    f"WARNING: schedule {schedule.name!r} requests cache "
                    "reuse at step 0 (no cache exists yet) — recomputing.",
                    file=sys.stderr,
                )
            masks.append(full_step_mask(config))
        else:
            masks.append(
                tuple(tuple(bool(v) for v in row) for row in arr[step])
            )
    return masks


def schedule_mask_array(schedule, config: PixArtConfig) -> np.ndarray:
    """Schedule → (steps, blocks, 3) bool array with step-0 forcing, the
    form `PopulationDenoiser.denoise` takes."""
    arr = np.array(schedule.to_numpy(), dtype=bool)
    arr[0] = True
    return arr


class AdaLayerNormSingle(nn.Module):
    """Produces the shared (B, 6d) modulation vector and the (B, d) embedded
    timestep used by the final layer (diffusers AdaLayerNormSingle). With
    the additional conditions, the (B, 2) resolution and (B,) aspect ratio
    are embedded like timesteps and added to the timestep embedding."""

    def __init__(self, config: PixArtConfig) -> None:
        super().__init__()
        c = config
        self.config = c
        self.timestep_embedder = TimestepEmbedding(256, c.dim, c.dtype)
        if c.use_additional_conditions:
            self.resolution_embedder = TimestepEmbedding(256, c.dim // 3, c.dtype)
            self.aspect_ratio_embedder = TimestepEmbedding(256, c.dim // 3, c.dtype)
        self.linear = nn.Linear(c.dim, 6 * c.dim, dtype=c.dtype)

    def forward(
        self,
        timestep: torch.Tensor,
        resolution: Optional[torch.Tensor] = None,
        aspect_ratio: Optional[torch.Tensor] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        c = self.config
        b = timestep.shape[0]
        t_proj = sinusoidal_embedding(timestep, 256)
        emb = self.timestep_embedder(t_proj.to(c.dtype))
        if c.use_additional_conditions:
            if resolution is None or aspect_ratio is None:
                raise ValueError(
                    "this configuration takes the resolution and aspect_ratio "
                    "size conditions"
                )
            res = sinusoidal_embedding(resolution.reshape(-1), 256)
            res = self.resolution_embedder(res.to(c.dtype)).reshape(b, -1)
            ar = sinusoidal_embedding(aspect_ratio.reshape(-1), 256)
            ar = self.aspect_ratio_embedder(ar.to(c.dtype)).reshape(b, -1)
            emb = emb + torch.cat([res, ar], dim=-1)
        return self.linear(F.silu(emb)), emb


class PixArtBlock(nn.Module):
    """One cached transformer block. `mask` is an (attn1, attn2, ff) bool
    triple; False components are read from `cache` instead of computed.
    Returns the new hidden states and the per-component outputs (pre-gate).

    `enc_kv` optionally supplies precomputed cross-attention keys/values
    (trajectory-constant; see PixArtTransformer.encode_text)."""

    def __init__(self, config: PixArtConfig) -> None:
        super().__init__()
        c = config
        self.config = c
        self.scale_shift_table = nn.Parameter(
            torch.empty(6, c.dim, dtype=c.dtype)
        )
        self.attn1 = Attention(c.dim, c.num_heads, c.head_dim, c.dtype)
        self.attn2 = Attention(c.dim, c.num_heads, c.head_dim, c.dtype)
        self.ff = FeedForward(c.dim, c.ff_mult, c.dtype)

    def cross_kv(self, enc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.attn2.kv(enc)

    def forward(
        self,
        h: torch.Tensor,  # (B, T, d)
        enc: torch.Tensor,  # (B, L, d)
        t6: torch.Tensor,  # (B, 6d) adaln modulation
        enc_bias: Optional[torch.Tensor],  # (B, 1, 1, L) additive bias or None
        cache: dict[str, torch.Tensor],  # component → (B, T, d)
        mask: tuple[bool, bool, bool],
        enc_kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        b = h.shape[0]
        # modulation in fp32, cast to the hidden dtype (pixart.py:230-233)
        mods = (
            self.scale_shift_table[None].float()
            + t6.reshape(b, 6, self.config.dim).float()
        ).to(h.dtype)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            mods[:, i : i + 1] for i in range(6)
        )
        recompute_attn1, recompute_attn2, recompute_ff = mask

        if recompute_attn1:
            a1 = self.attn1(modulated_layer_norm(h, scale_msa, shift_msa))
        else:
            a1 = cache["attn1"]
        h = gate_msa * a1 + h

        # ada_norm_single has no norm before cross-attention
        # (cached_transformer_block.py:263-266)
        if recompute_attn2:
            a2 = self.attn2(h, context=enc, bias=enc_bias, kv=enc_kv)
        else:
            a2 = cache["attn2"]
        h = a2 + h

        if recompute_ff:
            f = self.ff(modulated_layer_norm(h, scale_mlp, shift_mlp))
        else:
            f = cache["ff"]
        h = gate_mlp * f + h
        return h, {"attn1": a1, "attn2": a2, "ff": f}


class PixArtTransformer(nn.Module):
    """Full DiT. The block stage consumes a per-block component mask (the
    cache schedule row for the current step) plus the cache dict; an
    optional `plan` reorders/skips/repeats blocks (the DiT topology search
    space, ``ecad_tpu_torch.graph``)."""

    def __init__(self, config: PixArtConfig) -> None:
        super().__init__()
        c = config
        self.config = c
        self.patch_proj = nn.Linear(
            c.patch_size * c.patch_size * c.in_channels, c.dim, dtype=c.dtype
        )
        self.adaln_single = AdaLayerNormSingle(c)
        self.caption_projection = TextProjection(c.caption_dim, c.dim, c.dtype)
        self.blocks = nn.ModuleList(PixArtBlock(c) for _ in range(c.num_blocks))
        self.proj_out = nn.Linear(
            c.dim, c.patch_size * c.patch_size * c.out_channels, dtype=c.dtype
        )
        self.scale_shift_table = nn.Parameter(torch.empty(2, c.dim, dtype=c.dtype))
        self._pos_cache: dict[tuple, torch.Tensor] = {}

    def _pos_embed(self, gh: int, gw: int, like: torch.Tensor) -> torch.Tensor:
        key = (gh, gw, like.device, like.dtype)
        pos = self._pos_cache.get(key)
        if pos is None:
            c = self.config
            base = c.sample_size // c.patch_size
            interp = max(c.sample_size // 64, 1)
            pos = torch.from_numpy(
                sincos_2d_pos_embed(c.dim, gh, gw, base_size=base,
                                    interpolation_scale=interp)
            ).to(device=like.device, dtype=like.dtype)[None]
            self._pos_cache[key] = pos
        return pos

    def patchify(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) NHWC latents → (B, T, d) tokens + sincos pos."""
        p = self.config.patch_size
        b, hh, ww, ch = latents.shape
        gh, gw = hh // p, ww // p
        x = latents.reshape(b, gh, p, gw, p, ch)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * ch)
        x = self.patch_proj(x)
        return x + self._pos_embed(gh, gw, x)

    def unpatchify(self, tokens: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        c = self.config
        p = c.patch_size
        b = tokens.shape[0]
        x = tokens.reshape(b, gh, gw, p, p, c.out_channels)
        x = x.permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh * p, gw * p, c.out_channels)

    def encode_text(self, text_embeds: torch.Tensor) -> tuple[torch.Tensor, tuple]:
        """Trajectory-constant text work, done once per trajectory: the
        caption projection and every block's cross-attention K/V
        (reference: pixart.py:342-359). Feed the result back through
        `text_precomputed`."""
        enc = self.caption_projection(text_embeds)
        return enc, tuple(block.cross_kv(enc) for block in self.blocks)

    def process_input(
        self,
        latents: torch.Tensor,
        text_embeds: torch.Tensor,
        timestep: torch.Tensor,
        text_mask: Optional[torch.Tensor] = None,
        resolution: Optional[torch.Tensor] = None,
        aspect_ratio: Optional[torch.Tensor] = None,
        text_precomputed: Optional[tuple] = None,
    ):
        """Everything before the block stage: patchify + pos embed, adaln
        modulation (with the size conditions, where the config has them),
        caption projection, text bias."""
        h = self.patchify(latents)
        t6, emb_t = self.adaln_single(timestep, resolution, aspect_ratio)
        if text_precomputed is not None:
            enc, enc_kv = text_precomputed
        else:
            enc, enc_kv = self.caption_projection(text_embeds), None
        enc_bias = None
        if text_mask is not None:
            # computed in fp32 then cast to the hidden dtype, as the
            # reference does (in bf16 −10000 becomes −9984)
            enc_bias = ((1.0 - text_mask.float()) * -10000.0)[
                :, None, None, :
            ].to(h.dtype)
        return h, t6, emb_t, enc, enc_kv, enc_bias

    def create_output(
        self, h: torch.Tensor, emb_t: torch.Tensor, gh: int, gw: int
    ) -> torch.Tensor:
        """Final modulated projection + unpatchify."""
        shift, scale = (
            self.scale_shift_table[None].float() + emb_t[:, None].float()
        ).to(h.dtype).transpose(0, 1)
        h = modulated_layer_norm(h, scale[:, None], shift[:, None])
        return self.unpatchify(self.proj_out(h), gh, gw)

    def forward(
        self,
        latents: torch.Tensor,  # (B, H, W, C) NHWC
        text_embeds: torch.Tensor,  # (B, L, caption_dim)
        timestep: torch.Tensor,  # (B,)
        cache: dict[str, list],  # component → per-block (B, T, d)
        mask: StepMask,
        text_mask: Optional[torch.Tensor] = None,  # (B, L) 1=keep
        resolution: Optional[torch.Tensor] = None,  # (B, 2), size conditions
        aspect_ratio: Optional[torch.Tensor] = None,  # (B,)
        plan: Optional[tuple] = None,  # DiT topology plan (graph.build_plan)
        text_precomputed: Optional[tuple] = None,  # (enc, enc_kv) from encode_text
    ) -> tuple[torch.Tensor, dict[str, list]]:
        p = self.config.patch_size
        gh, gw = latents.shape[1] // p, latents.shape[2] // p
        h, t6, emb_t, enc, enc_kv, enc_bias = self.process_input(
            latents, text_embeds, timestep, text_mask,
            resolution, aspect_ratio, text_precomputed,
        )
        h, new_cache = run_block_stage(
            self.blocks, h, enc, t6, enc_bias, cache, mask, plan, enc_kv
        )
        return self.create_output(h, emb_t, gh, gw), new_cache


def run_block_stage(
    blocks,
    h: torch.Tensor,
    enc: torch.Tensor,
    t6: torch.Tensor,
    enc_bias: Optional[torch.Tensor],
    cache: dict[str, list],
    mask: StepMask,
    plan: Optional[tuple] = None,
    enc_kv: Optional[tuple] = None,
) -> tuple[torch.Tensor, dict[str, list]]:
    """Run the block stage. `plan` is an execution plan of the DiT topology
    DSL (``graph.build_plan``) or a plain sequence of block indices
    (default: 0..N-1). Cache rows are per block whatever the order; a
    repeated block leaves its last application's outputs. Returns the
    hidden states and a new cache dict; the input cache is not mutated."""
    new_rows = {k: list(cache[k]) for k in COMPONENTS}

    def block_apply(i: int, x: torch.Tensor) -> torch.Tensor:
        x, updated = blocks[i](
            x, enc, t6, enc_bias, {k: new_rows[k][i] for k in COMPONENTS},
            mask[i], enc_kv=None if enc_kv is None else enc_kv[i],
        )
        for k in COMPONENTS:
            new_rows[k][i] = updated[k]
        return x

    if plan and hasattr(plan[0], "inputs"):
        from ..graph.interpreter import execute_plan

        h = execute_plan(plan, h, block_apply)
    else:
        for i in range(len(blocks)) if plan is None else plan:
            h = block_apply(i, h)
    return h, new_rows


def init_cache(
    config: PixArtConfig,
    batch: int,
    tokens: int | None = None,
    dtype: torch.dtype | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, list]:
    """Zero-initialized cache {component: [per-block (B, T, d)]}. Step 0
    always recomputes (schedule_step_masks), so the zeros are never read."""
    t = config.tokens if tokens is None else tokens
    shape = (batch, t, config.dim)
    return {
        k: [
            torch.zeros(shape, dtype=dtype or config.dtype, device=device)
            for _ in range(config.num_blocks)
        ]
        for k in COMPONENTS
    }


def init_model(
    config: PixArtConfig, seed: int = 0, device: str | torch.device = "cuda"
) -> PixArtTransformer:
    """A random-weight PixArtTransformer built directly in `config.dtype` on
    `device` (no fp32 masters, no host copy), in eval mode."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = PixArtTransformer(config)
    model = model.to_empty(device=dev)
    return randomize_(model, seed).eval().requires_grad_(False)
