"""TGATE and pass-through variants of the PixArt pipeline, in PyTorch.

Counterpart of ``ecad_tpu/pipelines/tgate.py`` (reference:
ecad/pipelines/tgate.py and the compute_attn_tgate strategy,
cached_transformer_block.py:393-454):

* steps < gate_step — normal CFG (batch 2B); cross-attention is cached as
  the schedule says.
* the gate — the cross-attention cache becomes the AVERAGE of its
  (negative, positive) halves; the other components keep the negative
  half (they are recomputed after the gate anyway).
* steps ≥ gate_step — CFG is dropped: the model runs on the negative half
  only (batch B), reading cross-attention from the averaged cache; there
  is no guidance combine (tgate.py:328-341, 380-389).

The pass-through pipeline returns a zero noise prediction, so a run
isolates the cost of everything around the transformer.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.pixart import StepMask, init_cache
from .pixart_pipeline import PixArtPipeline
from .samplers import DPMState, dpm_step


class TGATEPixArtPipeline(PixArtPipeline):
    def __init__(self, *args, gate_step: int, **kwargs):
        if not gate_step or gate_step < 1:
            raise ValueError(f"gate_step {gate_step} out of range")
        self.gate_step = gate_step
        super().__init__(*args, **kwargs)

    def set_schedule(self, schedule=None, dit_schedule=None) -> None:
        super().set_schedule(schedule, dit_schedule)
        gate_step = self.gate_step
        if gate_step > self.config.num_inference_steps:
            raise ValueError(f"gate_step {gate_step} out of range")
        # after the gate, cross-attention must come from the averaged cache;
        # self-attn/ff caches have CFG batch shape and cannot be reused
        for step in range(gate_step, self.config.num_inference_steps):
            for b, (a1, a2, ff) in enumerate(self.masks[step]):
                if not a1 or not ff:
                    raise ValueError(
                        "TGATE phase 2 requires attn1/ff recompute at step "
                        f"{step} block {b} (CFG-batch caches are dropped at "
                        "the gate)"
                    )
        self.masks = [
            tuple(
                (a1, a2 if step < gate_step else False, ff)
                for (a1, a2, ff) in self.masks[step]
            )
            for step in range(self.config.num_inference_steps)
        ]

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
        """One trajectory in two phases; `masks` overrides the pipeline's
        own (already gated) schedule for this call."""
        masks = self.masks if masks is None else masks
        c = self.config.model
        b = noise.shape[0]
        enc2 = torch.cat([neg, text], dim=0)
        enc_mask2 = None
        if text_mask is not None and neg_mask is not None:
            enc_mask2 = torch.cat([neg_mask, text_mask], dim=0)
        res2, ar2 = self._additional_conditions(2 * b)
        res1, ar1 = self._additional_conditions(b)
        tokens = (noise.shape[1] // c.patch_size) * (noise.shape[2] // c.patch_size)
        cache = init_cache(c, 2 * b, self.model.local_tokens(tokens), device=noise.device,
                           blocks=len(self.model.blocks))
        text_pre = self._encode_text(enc2)
        x = noise * self.dpm.init_noise_sigma
        state = DPMState(x, torch.zeros_like(x, dtype=torch.float32), False)

        # phase 1: CFG
        for i in range(self.gate_step):
            eps, cache = self._model_eps(
                state.x, enc2, enc_mask2, float(self.dpm.timesteps[i]),
                cache, masks[i], res2, ar2, plan=self.plans[i],
                text_precomputed=text_pre,
            )
            state = dpm_step(self.dpm, i, eps, state)

        # the gate: average the CFG halves of the cross-attention cache
        # (negative first: enc2 = [neg, text]); keep the negative half of
        # the others
        gated = {}
        for comp, rows in cache.items():
            halves = [r.chunk(2, dim=0) for r in rows]
            gated[comp] = [
                (u + t) / 2 if comp == "attn2" else u for u, t in halves
            ]
        cache = gated

        # phase 2: the negative half only, no CFG. Cross-attention is read
        # from the cache at every step, so its K/V are not needed; the
        # negative half's caption projection stands in for the text.
        neg_pre = (text_pre[0][:b], None)
        for i in range(self.gate_step, self.dpm.num_steps):
            t = torch.full(
                (b,), float(self.dpm.timesteps[i]), dtype=torch.float32,
                device=noise.device,
            )
            out, cache = self.model(
                state.x, neg, t, cache, masks[i],
                text_mask=neg_mask, resolution=res1, aspect_ratio=ar1,
                plan=self.plans[i], text_precomputed=neg_pre,
            )
            eps = out[..., : c.in_channels]
            state = dpm_step(self.dpm, i, eps, state)
        return state.x


class PassThroughPixArtPipeline(PixArtPipeline):
    """Zero-output transformer — isolates non-transformer pipeline overhead
    (reference ecad/transformer_2d_models/pass_through_transformer_2d.py:61-136,
    ecad/pipelines/pass_through.py:31-47). No text work is done either."""

    def _encode_text(self, enc2):
        return None

    def _model_eps(self, latents, enc2, enc_mask2, t_value, cache, mask,
                   resolution=None, aspect_ratio=None, plan=None,
                   text_precomputed=None):
        return torch.zeros_like(latents), cache
