"""PixArt denoising pipeline with ECAD cache schedules, in PyTorch.

Counterpart of ``ecad_tpu/pipelines/pixart_pipeline.py``
(`PixArtPipelineConfig`, `PixArtPipeline`). In eager PyTorch the
reference's two execution modes, "unrolled" (one program per schedule) and
"stepwise" (one program per distinct step mask), are the same Python loop
over steps with Python-bool masks: a cached component is skipped, never
computed and masked. Both mode names are accepted.

Classifier-free guidance follows the reference: the model batch is
[negative; positive] (2B), guidance 4.5, and epsilon is taken from the
first 4 of 8 output channels (learned-sigma checkpoints). The caption
projection and every block's cross-attention K/V are computed once per
trajectory. The 1024² configuration gets its resolution and aspect-ratio
conditions (`_additional_conditions`); a DiT topology schedule gives each
step an execution plan. Latents are NHWC (B, H, W, C).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models.pixart import (
    PixArtConfig,
    PixArtTransformer,
    StepMask,
    init_cache,
    schedule_step_masks,
)
from ..schedules.pixart import PixArtCacheSchedule
from .samplers import DPMSolverSchedule, DPMState, dpm_step, make_dpm_schedule

MODES = ("unrolled", "stepwise")


@dataclass(frozen=True)
class PixArtPipelineConfig:
    model: PixArtConfig
    num_inference_steps: int = 20
    guidance_scale: float = 4.5  # fixed in the reference (pixart_image_generator.py:377)


class PixArtPipeline:
    """Owns a model + schedule pair and runs denoise trajectories on the
    model's device. Stateless across calls: every trajectory starts from a
    fresh cache."""

    def __init__(
        self,
        config: PixArtPipelineConfig,
        model: PixArtTransformer,
        schedule: Optional[PixArtCacheSchedule] = None,
        dit_schedule: Any = None,  # Optional[ecad_tpu_torch.graph.DiTSchedule]
    ) -> None:
        self.config = config
        self.model = model
        self.device = next(model.parameters()).device
        self.dpm: DPMSolverSchedule = make_dpm_schedule(config.num_inference_steps)
        self.set_schedule(schedule, dit_schedule)

    def set_schedule(
        self, schedule: Optional[PixArtCacheSchedule] = None, dit_schedule: Any = None
    ) -> None:
        """Swap the cache (and optionally the topology) schedule on a
        resident pipeline."""
        config = self.config
        if schedule is None:
            schedule = PixArtCacheSchedule.default(
                num_inference_steps=config.num_inference_steps,
                num_blocks=config.model.num_blocks,
            )
        if schedule.num_inference_steps != config.num_inference_steps:
            raise ValueError(
                f"schedule has {schedule.num_inference_steps} steps, pipeline "
                f"configured for {config.num_inference_steps}"
            )
        self.schedule = schedule
        self.masks: list[StepMask] = schedule_step_masks(schedule, config.model)
        self.plans = (
            dit_schedule.step_plans()
            if dit_schedule is not None and not dit_schedule.is_default()
            else [None] * config.num_inference_steps
        )

    def _additional_conditions(self, batch: int):
        """(resolution (batch, 2), aspect_ratio (batch,)) for a config with
        the size conditions — the square latent's pixel side and 1 — else
        (None, None)."""
        c = self.config.model
        if not c.use_additional_conditions:
            return None, None
        side = c.sample_size * 8
        res = torch.full((batch, 2), side, dtype=torch.float32, device=self.device)
        ar = torch.ones((batch,), dtype=torch.float32, device=self.device)
        return res, ar

    def _encode_text(self, enc2: torch.Tensor):
        """The trajectory-constant text work, done once per trajectory."""
        return self.model.encode_text(enc2)

    def _model_eps(
        self,
        latents: torch.Tensor,  # (B, H, W, C)
        enc2: torch.Tensor,  # (2B, L, cap)
        enc_mask2: Optional[torch.Tensor],
        t_value: float,
        cache: dict,
        mask: StepMask,
        resolution: Optional[torch.Tensor] = None,
        aspect_ratio: Optional[torch.Tensor] = None,
        plan=None,
        text_precomputed=None,
    ) -> tuple[torch.Tensor, dict]:
        b = latents.shape[0]
        lat2 = torch.cat([latents, latents], dim=0)
        t = torch.full((2 * b,), t_value, dtype=torch.float32, device=latents.device)
        out, cache = self.model(
            lat2, enc2, t, cache, mask,
            text_mask=enc_mask2, resolution=resolution, aspect_ratio=aspect_ratio,
            plan=plan, text_precomputed=text_precomputed,
        )
        eps2 = out[..., : self.config.model.in_channels]
        eps_neg, eps_pos = eps2.chunk(2, dim=0)
        eps = eps_neg + self.config.guidance_scale * (eps_pos - eps_neg)
        return eps, cache

    @torch.inference_mode()
    def denoise(
        self,
        noise: torch.Tensor,
        text: torch.Tensor,
        neg: torch.Tensor,
        text_mask: Optional[torch.Tensor] = None,
        neg_mask: Optional[torch.Tensor] = None,
        masks: Optional[list[StepMask]] = None,
    ) -> torch.Tensor:
        """One trajectory: noise (B, H, W, C) → final latents. `masks`
        overrides the pipeline's own schedule for this call."""
        masks = self.masks if masks is None else masks
        c = self.config.model
        b = noise.shape[0]
        enc2 = torch.cat([neg, text], dim=0)
        enc_mask2 = None
        if text_mask is not None and neg_mask is not None:
            enc_mask2 = torch.cat([neg_mask, text_mask], dim=0)
        tokens = (noise.shape[1] // c.patch_size) * (noise.shape[2] // c.patch_size)
        cache = init_cache(c, 2 * b, tokens, device=noise.device)
        res, ar = self._additional_conditions(2 * b)
        text_pre = self._encode_text(enc2)
        x = noise * self.dpm.init_noise_sigma
        state = DPMState(x, torch.zeros_like(x, dtype=torch.float32), False)
        for i in range(self.dpm.num_steps):
            eps, cache = self._model_eps(
                state.x, enc2, enc_mask2, float(self.dpm.timesteps[i]),
                cache, masks[i], res, ar, plan=self.plans[i],
                text_precomputed=text_pre,
            )
            state = dpm_step(self.dpm, i, eps, state)
        return state.x

    def build_denoise_fn(self) -> Callable:
        """(noise, text, neg, text_mask, neg_mask) → final latents, for the
        pipeline's current schedule (the reference's jitted trajectory)."""
        masks = self.masks
        return lambda noise, text, neg, text_mask=None, neg_mask=None: self.denoise(
            noise, text, neg, text_mask, neg_mask, masks=masks
        )

    def generate_latents(
        self,
        text: torch.Tensor,
        neg: torch.Tensor,
        *,
        seed: int = 0,
        batch: Optional[int] = None,
        text_mask: Optional[torch.Tensor] = None,
        neg_mask: Optional[torch.Tensor] = None,
        mode: str = "unrolled",
    ) -> torch.Tensor:
        """End-to-end latent generation from prompt embeddings; the noise
        comes from a `torch.Generator` on the pipeline's device seeded with
        `seed` (it differs from the reference's jax.random noise)."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        b = batch or text.shape[0]
        c = self.config.model
        gen = torch.Generator(device=self.device).manual_seed(seed)
        noise = torch.randn(
            (b, c.sample_size, c.sample_size, c.in_channels),
            generator=gen, device=self.device, dtype=torch.float32,
        ).to(c.dtype)
        return self.denoise(noise, text, neg, text_mask, neg_mask)


def dpm_update(x, prev_x0, co, eps):
    """One DPM-Solver++(2M) update in scan form (the reference's
    ``dpm_update``). `co` is one row of samplers.dpm_scan_coeffs; `eps` the
    (already guidance-combined) noise prediction. Gives the same float32
    values as `dpm_step` (tests/test_torch_search_eval.py)."""
    sigma_t, alpha_t, c0, c1, d0, d1 = (float(v) for v in co[1:7])
    x32 = x.float()
    x0 = (x32 - sigma_t * eps.float()) / alpha_t
    d = d0 * x0 + d1 * prev_x0
    new_x = (c0 * x32 - c1 * d).to(x.dtype)
    return new_x, x0


def cfg_dpm_step(x, prev_x0, co, eps2, guidance_scale, in_channels):
    """One classifier-free-guidance combine + DPM-Solver++(2M) update (the
    reference's ``cfg_dpm_step``): `eps2` is the model output for the
    [negative; positive] doubled batch."""
    eps_neg, eps_pos = eps2[..., :in_channels].chunk(2, dim=0)
    eps = eps_neg + guidance_scale * (eps_pos - eps_neg)
    return dpm_update(x, prev_x0, co, eps)


def array_step_masks(arr: np.ndarray) -> list[tuple]:
    """(steps, slots, 3) bool array → per-step tuples of Python-bool
    triples, the form the pipelines' step loops take."""
    return [tuple(tuple(bool(v) for v in row) for row in step) for step in arr]


class PopulationDenoiser:
    """One resident pipeline for a whole candidate population, with each
    candidate's recompute masks given per call as a (steps, blocks, 3) bool
    array (the reference's ``PopulationDenoiser``).

    The reference traces ONE program for every schedule (a lax.cond per
    component, the step loop a lax.scan) and weighs its one compile against
    the per-cond dispatch cost and lost cross-step fusion. In eager
    PyTorch there is no program to compile, so that trade-off does not
    exist here: the array becomes Python-bool step masks and the
    pipeline's own step loop runs them, in which a cached component is
    skipped, never computed and masked."""

    def __init__(self, pipeline: PixArtPipeline):
        self.pipeline = pipeline

    def denoise(
        self, masks, noise, text, neg, text_mask=None, neg_mask=None
    ) -> torch.Tensor:
        """masks: (steps, blocks, 3) bool array (the step-0 row should be
        all True — apply `schedule_mask_array`'s step-0 forcing upstream)."""
        c = self.pipeline.config
        arr = np.asarray(masks, dtype=bool)
        if arr.shape != (c.num_inference_steps, c.model.num_blocks, 3):
            raise ValueError(
                f"masks {arr.shape} != (steps, blocks, 3) = "
                f"{(c.num_inference_steps, c.model.num_blocks, 3)}"
            )
        return self.pipeline.denoise(
            noise, text, neg, text_mask, neg_mask, masks=array_step_masks(arr)
        )


class SharedModelStepper:
    """One resident pipeline shared by a whole candidate population, with
    each candidate's step masks (`schedule_step_masks`) given per call (the
    reference's ``SharedModelStepper``). The pipeline's own schedule is
    never touched, so candidates can share it."""

    def __init__(self, pipeline: PixArtPipeline):
        self.pipeline = pipeline

    def denoise(
        self, masks: list[StepMask], noise, text, neg,
        text_mask=None, neg_mask=None,
    ) -> torch.Tensor:
        return self.pipeline.denoise(
            noise, text, neg, text_mask, neg_mask, masks=masks
        )
