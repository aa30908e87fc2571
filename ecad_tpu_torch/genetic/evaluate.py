"""Candidate evaluation helpers. This slice of the port carries only
`latents_to_uint8` (ecad_tpu/genetic/evaluate.py:33); the search loop
comes with a later slice."""

from __future__ import annotations

import numpy as np
import torch


def latents_to_uint8(latents) -> np.ndarray:
    """Weight-free latent visualization used when no VAE is attached
    (deterministic; NOT a real decode — supply a VAE for images)."""
    if isinstance(latents, torch.Tensor):
        latents = latents.detach().float().cpu().numpy()
    x = np.asarray(latents, dtype=np.float32)
    x = np.clip((x[..., :3] / 4.0 + 0.5), 0, 1)
    return (x * 255).astype(np.uint8)
