"""FID: Fréchet distance over pluggable feature extractors, with cached
dataset statistics (the port's counterpart of ``ecad_tpu/scoring/fid.py``).

The reference uses clean-fid with precomputed custom stats for mjhq-30k
(ecad/benchmark/compute_fid.py:9-50). The protocol is kept: feature
statistics (mu, sigma) cached as .npz, in the same layout as the JAX
package's, so a stats file written by either package loads in the other.
The feature extractor is a registry entry. ``pixel_stats`` is weight-free
and runs on the device; ``inception`` and ``clip_vision`` need their
networks and weights, which wait for ROADMAP.md queue 1 item 6.
Statistics from different extractors are incomparable: the stats file
records the extractor's name and the loader enforces the match.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..registry import Registry

# (images (N, H, W, 3) uint8, device) → features (N, D)
FeatureExtractor = Callable[[np.ndarray, torch.device], np.ndarray]

FeatureExtractorRegistry: Registry = Registry("fid_feature_extractor")

WEIGHT_BACKED = ("inception", "clip_vision")

PIXEL_STATS_SIDE = 8


def triangle_resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) weights of one axis of ``jax.image.resize(...,
    "linear")`` (antialias on): the triangle kernel, widened by the factor
    when downsampling, each column normalised to sum 1, columns whose
    sample lies outside the input zeroed — the formula of JAX's
    ``compute_weight_mat``, in float32."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    f32 = dict(dtype=torch.float32, device=device)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, **f32)[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@FeatureExtractorRegistry.register(name="pixel_stats")
def pixel_stats_extractor(images: np.ndarray, device="cuda") -> np.ndarray:
    """Weight-free fallback: pixels in [0, 1] downsampled to 8×8×3, as the
    JAX package's ``jax.image.resize(x, (N, 8, 8, 3), "linear")``, through
    one separable weight matrix per axis. Only meaningful for smoke tests
    and relative comparisons within one run."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(images)).to(dev, torch.float32) / 255.0
    n, h, w, _ = x.shape
    side = PIXEL_STATS_SIDE
    if h != side:  # JAX skips an axis whose size does not change
        x = torch.einsum("nhwc,hp->npwc", x, triangle_resize_weights(h, side, dev))
    if w != side:
        x = torch.einsum("nhwc,wq->nhqc", x, triangle_resize_weights(w, side, dev))
    return x.reshape(n, -1).cpu().numpy()


def compute_statistics(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray
) -> float:
    """FID = |mu1−mu2|² + Tr(S1 + S2 − 2(S1 S2)^½), via the eigenvalues of
    the product (no scipy dependency)."""
    diff = mu1 - mu2
    prod = sigma1 @ sigma2
    eigvals = np.linalg.eigvals(prod)
    covmean_trace = np.sum(np.sqrt(np.maximum(eigvals.real, 0.0)))
    return float(
        diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * covmean_trace
    )


def get_extractor(name: str) -> FeatureExtractor:
    if name in WEIGHT_BACKED and name not in FeatureExtractorRegistry:
        raise NotImplementedError(
            f"FID extractor {name!r} needs its network and local weights, "
            "which ecad_tpu_torch does not port yet (ROADMAP.md queue 1 item "
            "6, the scorer towers); use 'pixel_stats'"
        )
    return FeatureExtractorRegistry.get(name)


class FIDStats:
    """Cached (mu, sigma) with the clean-fid custom-stats workflow."""

    def __init__(self, mu, sigma, extractor: str, n: int):
        self.mu = mu
        self.sigma = sigma
        self.extractor = extractor
        self.n = n

    @classmethod
    def from_images(
        cls, images: np.ndarray, extractor: str = "pixel_stats",
        batch_size: int = 256, device="cuda",
    ) -> "FIDStats":
        fn = get_extractor(extractor)
        feats = np.concatenate(
            [
                fn(images[lo : lo + batch_size], device)
                for lo in range(0, len(images), batch_size)
            ]
        )
        mu, sigma = compute_statistics(feats)
        return cls(mu, sigma, extractor, len(images))

    def save(self, path: Path | str) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            path, mu=self.mu, sigma=self.sigma,
            extractor=np.array(self.extractor), n=np.array(self.n),
        )

    @classmethod
    def load(cls, path: Path | str, expect_extractor: Optional[str] = None):
        with np.load(Path(path)) as d:
            stats = cls(
                d["mu"], d["sigma"], str(d["extractor"]), int(d["n"])
            )
        if expect_extractor and stats.extractor != expect_extractor:
            raise ValueError(
                f"stats computed with {stats.extractor!r}, expected "
                f"{expect_extractor!r}"
            )
        return stats


def fid_between(stats_a: FIDStats, stats_b: FIDStats) -> float:
    if stats_a.extractor != stats_b.extractor:
        raise ValueError(
            f"incomparable stats: {stats_a.extractor} vs {stats_b.extractor}"
        )
    return frechet_distance(stats_a.mu, stats_a.sigma, stats_b.mu, stats_b.sigma)
