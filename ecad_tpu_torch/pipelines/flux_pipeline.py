"""FLUX denoising pipeline (flow-match Euler, embedded guidance), in PyTorch.

Counterpart of ``ecad_tpu/pipelines/flux_pipeline.py`` (`FluxPipelineConfig`,
`FluxPipeline`). FLUX.1-dev is guidance-distilled: there is no CFG batch
doubling; the guidance scale enters as a per-sample embedding, and the
timestep goes to the model as σ = t/1000. As in the PixArt pipeline, the
reference's two execution modes ("unrolled", "stepwise") are one eager loop
over steps with Python-bool masks, in which a cached component is skipped;
both mode names are accepted. Latents are packed (B, H/16·W/16, 64) inside
the loop and returned unpacked, NHWC (B, H/8, W/8, 16).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..models.flux import (
    FluxConfig,
    FluxTransformer,
    flux_step_masks,
    unpack_latents,
)
from ..schedules.flux import FluxCacheSchedule
from .samplers import FlowMatchSchedule, flow_step, make_flow_schedule

MODES = ("unrolled", "stepwise")


@dataclass(frozen=True)
class FluxPipelineConfig:
    model: FluxConfig
    num_inference_steps: int = 20
    guidance_scale: float = 5.0
    height: int = 256
    width: int = 256

    @property
    def grid_hw(self) -> tuple[int, int]:
        return (self.height // 16, self.width // 16)

    @property
    def image_seq_len(self) -> int:
        gh, gw = self.grid_hw
        return gh * gw


class FluxPipeline:
    """Owns a model + schedule pair and runs denoise trajectories on the
    model's device. Every trajectory starts from an empty cache."""

    def __init__(
        self,
        config: FluxPipelineConfig,
        model: FluxTransformer,
        schedule: Optional[FluxCacheSchedule] = None,
    ) -> None:
        self.config = config
        self.model = model
        self.device = next(model.parameters()).device
        self.flow: FlowMatchSchedule = make_flow_schedule(
            config.num_inference_steps, config.image_seq_len
        )
        self.set_schedule(schedule)

    def set_schedule(self, schedule: Optional[FluxCacheSchedule] = None) -> None:
        """Swap the cache schedule on a resident pipeline (None: the
        all-recompute default)."""
        c = self.config
        if schedule is None:
            schedule = FluxCacheSchedule.default(
                num_inference_steps=c.num_inference_steps,
                num_blocks=c.model.num_blocks,
                num_single_blocks=c.model.num_single_blocks,
            )
        if schedule.num_inference_steps != c.num_inference_steps:
            raise ValueError(
                f"schedule steps {schedule.num_inference_steps} != pipeline "
                f"{c.num_inference_steps}"
            )
        self.schedule = schedule
        self.masks = flux_step_masks(schedule, c.model)

    def _velocity(self, x, txt, pooled, t_value: float, cache, mask):
        b = x.shape[0]
        t = torch.full((b,), t_value, dtype=torch.float32, device=x.device) / 1000.0
        g = torch.full((b,), self.config.guidance_scale, dtype=torch.float32,
                       device=x.device)
        return self.model(x, txt, pooled, t, g, cache, mask, self.config.grid_hw)

    @torch.inference_mode()
    def denoise(
        self,
        noise: torch.Tensor,  # (B, image_seq_len, in_channels) packed
        txt: torch.Tensor,  # (B, text_len, joint_dim)
        pooled: torch.Tensor,  # (B, pooled_dim)
        masks: Optional[list] = None,
    ) -> torch.Tensor:
        """One trajectory: packed noise → packed final latents. `masks`
        overrides the pipeline's own schedule for this call."""
        masks = self.masks if masks is None else masks
        x = noise
        cache: dict = {}
        for i in range(self.flow.num_steps):
            v, cache = self._velocity(
                x, txt, pooled, float(self.flow.timesteps[i]), cache, masks[i]
            )
            x = flow_step(self.flow, i, v, x)
        return x

    def build_denoise_fn(self) -> Callable:
        """(noise, txt, pooled) → packed final latents, for the pipeline's
        current schedule (the reference's jitted trajectory)."""
        masks = self.masks
        return lambda noise, txt, pooled: self.denoise(noise, txt, pooled, masks)

    def generate_latents(
        self,
        txt: torch.Tensor,
        pooled: torch.Tensor,
        *,
        seed: int = 0,
        mode: str = "unrolled",
    ) -> torch.Tensor:
        """Returns UNPACKED latents (B, H/8, W/8, 16). The noise comes from a
        `torch.Generator` on the pipeline's device seeded with `seed` (it
        differs from the reference's jax.random noise)."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        c = self.config
        gen = torch.Generator(device=self.device).manual_seed(seed)
        noise = torch.randn(
            (txt.shape[0], c.image_seq_len, c.model.in_channels),
            generator=gen, device=self.device, dtype=torch.float32,
        ).to(c.model.dtype)
        return unpack_latents(self.denoise(noise, txt, pooled), *c.grid_hw)
