"""In-process candidate evaluation — the offline-eval stage of the ECAD loop
(the port's counterpart of ``ecad_tpu/genetic/evaluate.py``).

The reference ECAD shells out to three subprocesses per generation
(generate_images.py → score_images.py → compute_macs.py, blocking
subprocess.run; ecad/genetic/train_nsga2_single_gpu.py:131-158,198-232),
reloading the model for every candidate (generate_images.py:13-63). Here the
whole stage runs in-process against ONE resident model on the card:

* every candidate's masks go through the same resident pipeline
  (`PopulationDenoiser` / `SharedModelStepper`), each cached component
  skipped,
* MACs come from the analytic model (``ecad_tpu_torch.macs``) instead of a
  profiler,
* the on-disk artifact contract (scores.json per candidate dir, metrics in
  candidate JSONs) is the reference's, so a search started by either
  package resumes in the other.

Single process: the reference's mesh and multi-host branches wait for
ROADMAP.md queue 1 item 8.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..models.pixart import schedule_mask_array, schedule_step_masks
from ..pipelines.pixart_pipeline import PopulationDenoiser, SharedModelStepper
from ..scoring import aggregate_scores, get_scorer, merge_scores
from .population_io import PopulationIOManager


def latents_to_uint8(latents) -> np.ndarray:
    """Weight-free latent visualization used when no VAE is attached
    (deterministic; NOT a real decode — supply a VAE for images)."""
    if isinstance(latents, torch.Tensor):
        latents = latents.detach().float().cpu().numpy()
    x = np.asarray(latents, dtype=np.float32)
    x = np.clip((x[..., :3] / 4.0 + 0.5), 0, 1)
    return (x * 255).astype(np.uint8)


def fidelity_snr_db(latents: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """Per-image trajectory fidelity: SNR (dB) of a candidate's final
    latents against the UNCACHED trajectory of the same model on the same
    noise/prompt batch — the quantity caching actually degrades.

    The reference optimizes ImageReward on generated images
    (ecad/genetic/pixart_problem.py:51-62); fidelity is the weight-free
    stand-in quality objective: real (not a hash), computable without
    checkpoints, and monotone in the caching error. Higher is better;
    capped at 200 dB (an exact-match candidate has mse 0). fp32."""
    lat = latents.float()
    ref = reference.float()
    dims = tuple(range(1, lat.dim()))
    mse = ((lat - ref) ** 2).mean(dim=dims)
    power = (ref**2).mean(dim=dims)
    safe_mse = torch.where(mse > 0, mse, torch.ones_like(mse))
    snr = 10.0 * torch.log10((power + 1e-20) / safe_mse)
    capped = torch.full_like(snr, 200.0)
    return torch.where(mse > 0, torch.minimum(snr, capped), capped)


@dataclass
class EvalConfig:
    images_per_prompt: int = 1
    start_seed: int = 0
    seed_step: int = 1
    scorer: str = "mock"
    batch_size: int = 0  # 0 → all (prompts × images) in one device batch
    # "dynamic": the candidate's masks as one (steps, blocks, 3) array
    #   (`PopulationDenoiser`); "stepwise": per-step mask tuples
    #   (`SharedModelStepper`). The reference compiles one lax.cond program
    #   for the first and memoized per-(step, mask) programs for the second;
    #   in eager PyTorch both run the same step loop, in which a cached
    #   component is skipped.
    mode: str = "dynamic"
    # False: decoded images are not gathered to the host (scoring happens
    # per chunk) and evaluate_candidate returns (scores, None). The search
    # loop only needs scores.
    return_images: bool = True


class CandidateEvaluator:
    """Evaluates every candidate of a generation and writes the score/MACs
    artifacts the NSGA-II loop consumes. PixArt flavor; see
    FluxCandidateEvaluator for the flux stack.

    `noise` optionally fixes the noise batch: a (images_per_prompt · P, H,
    W, C) tensor, image-major as `_noise_batch` lays it out (seed i's P
    images first), used instead of drawing one. Otherwise the noise comes
    from a `torch.Generator` on the pipeline's device, reseeded per image
    as the reference reseeds (seed = start + i·step); its numbers differ
    from the reference's ``jax.random`` ones."""

    def __init__(
        self,
        pipeline,  # PixArtPipeline
        text: torch.Tensor,  # (P, L, cap) prompt embeddings
        neg: torch.Tensor,  # (P, L, cap) negative embeddings
        prompts: Sequence[str],
        config: EvalConfig | None = None,
        prompt_ids: Optional[Sequence[str]] = None,
        decode_fn: Optional[Callable[[torch.Tensor], np.ndarray]] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> None:
        self.pipeline = pipeline
        self.stepper = SharedModelStepper(pipeline)
        self.dynamic = PopulationDenoiser(pipeline)
        self.text = text
        self.neg = neg
        self._init_common(prompts, config, prompt_ids, decode_fn, noise)

    def _init_common(self, prompts, config, prompt_ids, decode_fn, noise) -> None:
        self.prompts = list(prompts)
        self.prompt_ids = list(prompt_ids) if prompt_ids else None
        self.config = config or EvalConfig()
        self.decode_fn = decode_fn or latents_to_uint8
        self.noise = noise

    def _noise_shape(self, p: int) -> tuple:
        c = self.pipeline.config.model
        return (p, c.sample_size, c.sample_size, c.in_channels)

    def _noise_batch(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, list, list]:
        """Expand prompts × images_per_prompt into one batch with the
        reference's per-image reseeding (seed = start + i·step;
        pixart_image_generator.py:314-393): (noise, text, second
        conditioning, prompts, prompt ids)."""
        n_img = self.config.images_per_prompt
        p = len(self.prompts)
        dev = self.pipeline.device
        dtype = self.pipeline.config.model.dtype
        if self.noise is not None:
            noise = self.noise.to(dev, dtype)
            want = (n_img * p, *self._noise_shape(p)[1:])
            if tuple(noise.shape) != want:
                raise ValueError(f"noise {tuple(noise.shape)} != {want}")
        else:
            chunks = []
            for i in range(n_img):
                seed = self.config.start_seed + i * self.config.seed_step
                gen = torch.Generator(device=dev).manual_seed(seed)
                chunks.append(torch.randn(
                    self._noise_shape(p), generator=gen, device=dev,
                    dtype=torch.float32,
                ).to(dtype))
            noise = torch.cat(chunks)
        ids = self.prompt_ids if self.prompt_ids else [str(j) for j in range(p)]
        return (
            noise,
            torch.cat([self.text] * n_img),
            torch.cat([self._second()] * n_img),
            self.prompts * n_img,
            list(ids) * n_img,
        )

    def _second(self) -> torch.Tensor:
        """The second conditioning input of a denoise call: the negative
        embeddings (PixArt's CFG batch)."""
        return self.neg

    def evaluate_candidate(self, schedule) -> tuple[dict, Optional[np.ndarray]]:
        if self.config.mode == "dynamic":
            masks = schedule_mask_array(schedule, self.pipeline.config.model)
        else:
            masks = self._schedule_masks(schedule)
        return self._eval_with_masks(masks, self._denoiser())

    def _eval_with_masks(self, masks, denoise) -> tuple[dict, Optional[np.ndarray]]:
        """Chunked denoise → score loop shared by both model flavors.

        scorer == "fidelity" scores in LATENT space against the uncached
        trajectory (no decode unless images were asked for); every other
        scorer sees the decoded images as `decode_fn` returns them — a
        device decode (the search CLI's, with a checkpoint's VAE) keeps
        decode → resize → towers on the device, and only the scores come
        to the host."""
        *arrays, prompts, ids = self._noise_batch()
        fidelity = self.config.scorer == "fidelity"
        scorer = None if fidelity else get_scorer(self.config.scorer)
        ref = self._reference_latents() if fidelity else None
        bs = self.config.batch_size or len(prompts)
        imgs_all, score_chunks = [], []
        for lo in range(0, len(prompts), bs):
            hi = min(lo + bs, len(prompts))
            latents = denoise(masks, *(a[lo:hi] for a in arrays))
            if fidelity:
                per_image = fidelity_snr_db(latents, ref[lo:hi]).cpu().numpy()
                score_chunks.append(
                    aggregate_scores(per_image, prompts[lo:hi], ids[lo:hi])
                )
                if not self.config.return_images:
                    continue
            imgs = self._decode(latents)
            if not fidelity:
                score_chunks.append(scorer(imgs, prompts[lo:hi], ids[lo:hi]))
            if self.config.return_images:
                imgs_all.append(imgs.cpu().numpy() if isinstance(imgs, torch.Tensor)
                                else np.asarray(imgs))
        scores = merge_scores(score_chunks)
        if not self.config.return_images:
            return scores, None
        return scores, np.concatenate(imgs_all)

    def _decode(self, latents):
        return self.decode_fn(latents)

    def _all_true_masks(self):
        """All-compute masks (the default schedule) in the active eval
        mode's format — the uncached reference trajectory's masks."""
        c = self.pipeline.config.model
        steps = self.pipeline.config.num_inference_steps
        if self.config.mode == "dynamic":
            return np.ones((steps, c.num_blocks, 3), dtype=bool)
        return [tuple(((True,) * 3) for _ in range(c.num_blocks))] * steps

    def _denoiser(self):
        return self.dynamic.denoise if self.config.mode == "dynamic" else self.stepper.denoise

    def _reference_latents(self) -> torch.Tensor:
        """Final latents of the UNCACHED trajectory for the evaluator's
        (deterministic) noise batch, through the SAME denoise calls the
        candidates make — computed once per eval mode and kept on the
        device (a population's whole generation shares it)."""
        key = self.config.mode
        if getattr(self, "_ref_latents_key", None) != key:
            masks = self._all_true_masks()
            denoise = self._denoiser()
            *arrays, prompts, _ids = self._noise_batch()
            bs = self.config.batch_size or len(prompts)
            chunks = []
            for lo in range(0, len(prompts), bs):
                hi = min(lo + bs, len(prompts))
                chunks.append(denoise(masks, *(a[lo:hi] for a in arrays)))
            self._ref_latents = torch.cat(chunks)
            self._ref_latents_key = key
        return self._ref_latents

    def _schedule_masks(self, schedule):
        return schedule_step_masks(schedule, self.pipeline.config.model)

    def evaluate_generation(
        self,
        manager: PopulationIOManager,
        generation: Optional[int] = None,
        skip_existing: bool = True,
        verbose: bool = True,
    ) -> dict[int, dict]:
        """Run the full offline-eval stage: per-candidate scores.json +
        analytic MACs written into candidate JSONs. A candidate whose
        scores.json exists is kept as it is when `skip_existing`."""
        results = {}
        t0 = time.perf_counter()
        for idx, sched in manager.load_population_schedules(generation):
            cand_dir = manager.score_dir(generation) / f"cand_{idx:03d}"
            score_file = cand_dir / "scores.json"
            if skip_existing and score_file.exists():
                continue
            scores, _ = self.evaluate_candidate(sched)
            cand_dir.mkdir(parents=True, exist_ok=True)
            with score_file.open("w") as f:
                json.dump(scores, f, indent=4)
            results[idx] = scores
            if verbose:
                dt = time.perf_counter() - t0
                print(
                    f"  cand_{idx:03d}: total_score="
                    f"{scores['total_score']:.4f} ({dt:.1f}s elapsed)"
                )
        manager.compute_macs_for_generation(generation)
        return results


class FluxCandidateEvaluator(CandidateEvaluator):
    """FLUX flavor: embedded guidance (no CFG batch), packed latents, and
    the (text, pooled) embedding pair instead of (text, negative). `noise`
    is packed: (images_per_prompt · P, image_seq_len, in_channels)."""

    def __init__(
        self,
        pipeline,  # FluxPipeline
        text: torch.Tensor,  # (P, L, joint_dim)
        pooled: torch.Tensor,  # (P, pooled_dim)
        prompts: Sequence[str],
        config: EvalConfig | None = None,
        prompt_ids: Optional[Sequence[str]] = None,
        decode_fn: Optional[Callable[[torch.Tensor], np.ndarray]] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> None:
        from ..pipelines.flux_pipeline import FluxPopulationDenoiser, SharedFluxStepper

        self.pipeline = pipeline
        self.stepper = SharedFluxStepper(pipeline)
        self.dynamic = FluxPopulationDenoiser(pipeline)
        self.text = text
        self.pooled = pooled
        self._init_common(prompts, config, prompt_ids, decode_fn, noise)

    def _second(self) -> torch.Tensor:
        return self.pooled

    def _noise_shape(self, p: int) -> tuple:
        c = self.pipeline.config
        return (p, c.image_seq_len, c.model.in_channels)

    def _schedule_masks(self, schedule):
        from ..models.flux import flux_step_masks

        return flux_step_masks(schedule, self.pipeline.config.model)

    def evaluate_candidate(self, schedule):
        if self.config.mode == "dynamic":
            c = self.pipeline.config.model
            n_slots = c.num_blocks + c.num_single_blocks
            masks = np.array(schedule.mask, dtype=bool).reshape(
                schedule.num_inference_steps, n_slots, 3
            ).copy()
            masks[0] = True  # step-0 cache-miss forcing
        else:
            masks = self._schedule_masks(schedule)
        return self._eval_with_masks(masks, self._denoiser())

    def _decode(self, packed):
        from ..models.flux import unpack_latents

        gh, gw = self.pipeline.config.grid_hw
        return self.decode_fn(unpack_latents(packed, gh, gw))

    def _all_true_masks(self):
        from ..models.flux import full_flux_mask

        c = self.pipeline.config.model
        steps = self.pipeline.config.num_inference_steps
        if self.config.mode == "dynamic":
            n_slots = c.num_blocks + c.num_single_blocks
            return np.ones((steps, n_slots, 3), dtype=bool)
        return [full_flux_mask(c)] * steps
