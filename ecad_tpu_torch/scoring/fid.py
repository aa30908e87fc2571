"""FID: Fréchet distance over pluggable feature extractors, with cached
dataset statistics (the port's counterpart of ``ecad_tpu/scoring/fid.py``).

The reference uses clean-fid with precomputed custom stats for mjhq-30k
(ecad/benchmark/compute_fid.py:9-50). The protocol is kept: feature
statistics (mu, sigma) cached as .npz, in the same layout as the JAX
package's, so a stats file written by either package loads in the other.
The feature extractor is a registry entry, run on the device:
``pixel_stats`` is weight-free; ``inception`` (``scoring/inception.py``,
a pt_inception checkpoint from ``ECAD_INCEPTION_CHECKPOINT``) and
``clip_vision`` (the CLIP vision tower's pooled output, from
``ECAD_CLIP_MODEL_DIR``) need their weights. Statistics from different
extractors are incomparable: the stats file records the extractor's name
and the loader enforces the match.

The scorer towers' shared preprocessing lives here too: `image_batch`
(uint8 images, on the host or already on the device, to fp32 NCHW in
[0, 1]), `resize_images` (``jax.image.resize``'s antialiased bicubic and
bilinear) and `ieee_fp32` (the towers' fp32 precision on the card).
"""

from __future__ import annotations

import functools
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from torch.nn import functional as F

from .. import resolve_device
from ..registry import Registry

# (images (N, H, W, 3) uint8, device) → features (N, D)
FeatureExtractor = Callable[[np.ndarray, torch.device], np.ndarray]

FeatureExtractorRegistry: Registry = Registry("fid_feature_extractor")

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


def image_batch(images, device) -> torch.Tensor:
    """(N, H, W, 3) images, a numpy array or a tensor (moved to `device` if
    it lies elsewhere; a uint8 tensor already there is not copied), →
    float32 (N, 3, H, W) divided by 255, as the reference's
    ``jnp.asarray(images, jnp.float32) / 255.0``."""
    x = images if isinstance(images, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(images))
    return x.to(device).permute(0, 3, 1, 2).float() / 255.0


def resize_images(x: torch.Tensor, size: int, method: str) -> torch.Tensor:
    """(N, C, H, W) float → (N, C, size, size), as ``jax.image.resize(x,
    (N, size, size, C), method)`` on the NHWC array: ``"bicubic"`` (Keys'
    cubic, a = −0.5) or ``"bilinear"``, half-pixel centres, and — because
    JAX antialiases whenever it shrinks — the kernel widened by the
    factor when downsampling. ``F.interpolate`` computes exactly that with
    ``antialias=True`` (within 2e-6 on [0, 1] pixels at 256→224 and
    1024→224 bicubic, 256→299 and 1024→299 bilinear; without it, 0.2–0.77
    off at every downsample)."""
    return F.interpolate(x, size=(size, size), mode=method, antialias=True,
                         align_corners=False)


@contextmanager
def ieee_fp32_context():
    """cuDNN convolutions and cuBLAS products in IEEE fp32 while the block
    runs — no TF32, whose 10-bit mantissa PyTorch allows for convolutions
    by default (``torch.backends.cudnn.allow_tf32``) — the flags restored
    after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def ieee_fp32(forward):
    """A module's `forward` run under `ieee_fp32_context`: the scorer
    towers compute in fp32 as the reference's do, on the card as on the
    CPU."""

    @functools.wraps(forward)
    def wrapped(*args, **kwargs):
        with ieee_fp32_context():
            return forward(*args, **kwargs)

    return wrapped


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


@FeatureExtractorRegistry.register(name="clip_vision")
def clip_vision_extractor(images: np.ndarray, device="cuda") -> np.ndarray:
    """The CLIP vision tower's pooled, post-LayerNorm output (before the
    projection) of the model in ``ECAD_CLIP_MODEL_DIR``. The reference
    rebuilds its scorer for every batch; the port keeps the one resident
    CLIP scorer, whose features are the same."""
    from .clip_score import resident_scorer

    return resident_scorer(device).image_features(images).cpu().numpy()


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
    if name == "inception" and name not in FeatureExtractorRegistry:
        from . import inception  # noqa: F401  (registers it)
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
