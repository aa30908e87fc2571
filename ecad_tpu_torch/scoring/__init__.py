"""Image scoring backends (the port's own copy of
``ecad_tpu/scoring/__init__.py``).

The reference scores candidates with ImageReward-v1.0 (torch, downloaded at
runtime; ecad/benchmark/score_images.py:31-40). Networks and weights are not
available in every deployment, so scorers are a registry:

* ``mock`` — deterministic, weight-free scorer for tests and loop plumbing:
  hashes image content into a stable pseudo-score. NOT a quality metric.
* ``fidelity`` — trajectory fidelity vs the uncached run of the SAME model
  (latent-space SNR in dB); a real, weight-free quality objective — the
  quantity caching actually degrades. Implemented inside the candidate
  evaluator (it needs the reference trajectory), see
  ``ecad_tpu_torch/genetic/evaluate.py`` `fidelity_snr_db`.
* ``image_reward`` — ImageReward-v1.0 (BLIP ViT-L/16 + BERT + MLP head),
  ``scoring/image_reward.py``; local weights from
  ``ECAD_IMAGE_REWARD_CHECKPOINT`` / ``ECAD_IMAGE_REWARD_TOKENIZER``.
* ``clip`` — CLIP text-image similarity (clip-score parity),
  ``scoring/clip_score.py``; local weights from ``ECAD_CLIP_MODEL_DIR``.

`get_scorer` imports the module that registers a weight-backed name the
first time it is asked for it. Scorers take (N, H, W, 3) uint8 images as a
numpy array or as a tensor; the weight-backed ones run on a tensor's own
device (without copying it), so decoded images scored on the card stay
there and only the scores come to the host.

All scorers return the reference's scores.json payload shape:
{"total_score": float, "avg_by_prompt": {...}, "score_by_prompt_id": {...}}
(score_images.py:187-238).
"""

from __future__ import annotations

import hashlib
import importlib
from typing import Protocol, Sequence

import numpy as np
import torch

from ..registry import Registry


class Scorer(Protocol):
    def __call__(
        self,
        images: np.ndarray | torch.Tensor,  # (N, H, W, 3) uint8 or float
        prompts: Sequence[str],
        prompt_ids: Sequence[str] | None = None,
    ) -> dict: ...


ScorerRegistry: Registry = Registry("scorer", default="mock")


def _aggregate(
    per_image: np.ndarray,
    prompts: Sequence[str],
    prompt_ids: Sequence[str] | None,
) -> dict:
    if prompt_ids is None:
        prompt_ids = [str(i) for i in range(len(prompts))]
    by_prompt: dict[str, list[float]] = {}
    for pid, s in zip(prompt_ids, per_image):
        by_prompt.setdefault(str(pid), []).append(float(s))
    avg_by_prompt = {pid: float(np.mean(v)) for pid, v in by_prompt.items()}
    return {
        "total_score": float(np.mean(list(avg_by_prompt.values()))),
        "avg_by_prompt": avg_by_prompt,
        "score_by_prompt_id": by_prompt,
    }


# public alias: evaluator-side scorers (fidelity) reuse the same
# scores.json aggregation
aggregate_scores = _aggregate


@ScorerRegistry.register(name="mock")
def mock_scorer(
    images: np.ndarray,
    prompts: Sequence[str],
    prompt_ids: Sequence[str] | None = None,
) -> dict:
    """Deterministic content-hash pseudo-score in [-1, 1]. Distinct images →
    distinct stable scores; identical pipelines reproduce identical scores.
    A tensor is hashed from its host copy."""
    if isinstance(images, torch.Tensor):
        images = images.cpu().numpy()
    per_image = []
    for img in images:
        arr = np.ascontiguousarray(np.asarray(img))
        h = hashlib.sha256(arr.tobytes()).digest()
        per_image.append(int.from_bytes(h[:8], "little") / 2**63 - 1.0)
    return _aggregate(np.array(per_image), prompts, prompt_ids)


def merge_scores(chunks: Sequence[dict]) -> dict:
    """Merge per-chunk scorer outputs (the scores.json payload shape) into
    one aggregate — used by the evaluator's chunked scoring path so images
    can be scored batch-by-batch on device instead of being gathered to
    the host first."""
    by_prompt: dict[str, list[float]] = {}
    for c in chunks:
        for pid, vals in c["score_by_prompt_id"].items():
            by_prompt.setdefault(pid, []).extend(float(v) for v in vals)
    avg_by_prompt = {pid: float(np.mean(v)) for pid, v in by_prompt.items()}
    return {
        "total_score": float(np.mean(list(avg_by_prompt.values()))),
        "avg_by_prompt": avg_by_prompt,
        "score_by_prompt_id": by_prompt,
    }


# weight-backed scorer → the module that registers it
WEIGHT_BACKED = {"image_reward": "image_reward", "clip": "clip_score"}


def get_scorer(name: str | None = None) -> Scorer:
    if name in WEIGHT_BACKED and name not in ScorerRegistry:
        # imported when first asked for, so the registry stays light
        importlib.import_module(f".{WEIGHT_BACKED[name]}", __name__)
    return ScorerRegistry.get(name)
