"""DPM-Solver++(2M) for PixArt and flow-match Euler for FLUX, in PyTorch.

Counterpart of ``ecad_tpu/pipelines/samplers.py``. DPM (:27-107,
:160-191): diffusers' DPMSolverMultistepScheduler defaults (dpmsolver++,
order 2, epsilon prediction, linear betas 1e-4→2e-2 over 1000 train steps,
linspace timestep spacing). Flow match (:115-157): FLUX's dynamically
shifted sigmas and the Euler update. The per-step constants are host-side
numpy; the carried state is a small tuple of tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch


@dataclass(frozen=True)
class DPMSolverSchedule:
    """Precomputed per-step constants (host-side numpy)."""

    timesteps: np.ndarray  # (steps,) int — train-timestep indices, descending
    alpha_t: np.ndarray  # (steps,) sqrt(alphas_cumprod)
    sigma_t: np.ndarray  # (steps,)
    lambda_t: np.ndarray  # (steps,) log(alpha/sigma)
    init_noise_sigma: float = 1.0

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)


def make_dpm_schedule(
    num_inference_steps: int,
    num_train_timesteps: int = 1000,
    beta_start: float = 1e-4,
    beta_end: float = 2e-2,
) -> DPMSolverSchedule:
    betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    alphas_cumprod = np.cumprod(1.0 - betas)
    timesteps = (
        np.linspace(0, num_train_timesteps - 1, num_inference_steps + 1)
        .round()[::-1][:-1]
        .astype(np.int64)
    )
    ac = alphas_cumprod[timesteps]
    alpha_t = np.sqrt(ac)
    sigma_t = np.sqrt(1.0 - ac)
    lambda_t = np.log(alpha_t) - np.log(sigma_t)
    return DPMSolverSchedule(
        timesteps=timesteps,
        alpha_t=alpha_t,
        sigma_t=sigma_t,
        lambda_t=lambda_t,
    )


class DPMState(NamedTuple):
    x: torch.Tensor  # current latents
    prev_x0: torch.Tensor  # previous data prediction (fp32, zeros before the first step)
    have_prev: bool  # whether prev_x0 is valid


def dpm_step(
    schedule: DPMSolverSchedule,
    step_index: int,
    eps: torch.Tensor,
    state: DPMState,
) -> DPMState:
    """One DPM-Solver++ 2M update in fp32; the new latents keep x's dtype."""
    s = schedule
    i = step_index
    a_t, s_t, l_t = float(s.alpha_t[i]), float(s.sigma_t[i]), float(s.lambda_t[i])
    x = state.x
    x32 = x.float()
    x0 = (x32 - s_t * eps.float()) / a_t

    if i == s.num_steps - 1:
        # final step: first-order (sigma_next = 0 → x = x0)
        return DPMState(x0.to(x.dtype), x0, True)

    a_n, s_n, l_n = (
        float(s.alpha_t[i + 1]), float(s.sigma_t[i + 1]), float(s.lambda_t[i + 1])
    )
    h = l_n - l_t
    if not state.have_prev:
        # first-order (DPM-Solver++ 1S)
        new_x = (s_n / s_t) * x32 - a_n * (math.exp(-h) - 1.0) * x0
    else:
        r = (l_t - float(s.lambda_t[i - 1])) / h
        d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * state.prev_x0.float()
        new_x = (s_n / s_t) * x32 - a_n * (math.exp(-h) - 1.0) * d
    return DPMState(new_x.to(x.dtype), x0, True)


# ---------------------------------------------------------------------------
# FlowMatch Euler (FLUX), counterpart of samplers.py:115-157
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FlowMatchSchedule:
    sigmas: np.ndarray  # (steps+1,) descending, last = 0
    timesteps: np.ndarray  # (steps,) sigma·1000 as flux model input

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)


# FLUX.1-dev's FlowMatchEulerDiscreteScheduler config (dynamic shifting)
FLOW_BASE_SHIFT = 0.5
FLOW_MAX_SHIFT = 1.15
FLOW_BASE_SEQ_LEN = 256
FLOW_MAX_SEQ_LEN = 4096
FLOW_NUM_TRAIN_TIMESTEPS = 1000


def make_flow_schedule(num_inference_steps: int, image_seq_len: int) -> FlowMatchSchedule:
    """FLUX's resolution-dependent sigma shift ("dynamic shifting"): the
    shift parameter mu interpolates linearly in sequence length (float64)."""
    sigmas = np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps)
    m = (FLOW_MAX_SHIFT - FLOW_BASE_SHIFT) / (FLOW_MAX_SEQ_LEN - FLOW_BASE_SEQ_LEN)
    b = FLOW_BASE_SHIFT - m * FLOW_BASE_SEQ_LEN
    mu = image_seq_len * m + b
    sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    timesteps = sigmas * FLOW_NUM_TRAIN_TIMESTEPS
    sigmas = np.append(sigmas, 0.0)
    return FlowMatchSchedule(sigmas=sigmas, timesteps=timesteps)


def flow_step(
    schedule: FlowMatchSchedule,
    step_index: int,
    velocity: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """One Euler step x + (σ_{i+1} − σ_i)·v in fp32, cast to x's dtype."""
    s = schedule
    dt = float(s.sigmas[step_index + 1] - s.sigmas[step_index])
    return (x.float() + dt * velocity.float()).to(x.dtype)


def dpm_scan_coeffs(schedule: DPMSolverSchedule) -> np.ndarray:
    """Per-step update coefficients for a scan-form DPM-Solver++ 2M loop:

        x_next = c0·x − c1·(d0·x0 + d1·prev_x0)

    where x0 = (x − sigma_t·eps)/alpha_t, the first step is first-order
    (d0=1, d1=0) and the final step integrates to sigma=0 (c0=0, c1=−1 ⇒
    x_next = x0). Returns (steps, 7):
    [timestep, sigma_t, alpha_t, c0, c1, d0, d1]."""
    s = schedule
    n = s.num_steps
    out = np.zeros((n, 7), dtype=np.float64)
    for i in range(n):
        out[i, 0] = s.timesteps[i]
        out[i, 1] = s.sigma_t[i]
        out[i, 2] = s.alpha_t[i]
        if i == n - 1:
            out[i, 3:] = (0.0, -1.0, 1.0, 0.0)
            continue
        h = s.lambda_t[i + 1] - s.lambda_t[i]
        c0 = s.sigma_t[i + 1] / s.sigma_t[i]
        c1 = s.alpha_t[i + 1] * (math.exp(-h) - 1.0)
        if i == 0:
            d0, d1 = 1.0, 0.0
        else:
            r = (s.lambda_t[i] - s.lambda_t[i - 1]) / h
            d0 = 1.0 + 1.0 / (2.0 * r)
            d1 = -1.0 / (2.0 * r)
        out[i, 3:] = (c0, c1, d0, d1)
    return out
