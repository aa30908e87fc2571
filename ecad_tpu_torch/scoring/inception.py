"""FID InceptionV3 feature extractor in PyTorch.

Counterpart of ``ecad_tpu/scoring/inception.py``. The reference computes
FID with clean-fid, whose backbone is the TF-ported
"pt_inception-2015-12-05" InceptionV3 (torchvision topology with the
FID-specific pooling variants: InceptionA/C branch pools are average-pool
with count_include_pad=False, the final InceptionE uses a max branch
pool). Features are the 2048-d pool3 activations.

Weights load from a local pt_inception checkpoint
(`InceptionFeatureExtractor.from_weights`, torchvision naming:
Conv2d_1a_3x3.conv/bn, Mixed_5b.branch1x1.conv, …), through the
reference's param tree (`convert_inception_state_dict`) and
`bridge.inception_state_dict`. Preprocessing follows pytorch-fid /
clean-fid: bilinear resize to 299² on [0, 1] inputs (antialiased, as
``jax.image.resize``), then 2x − 1. NCHW throughout, PyTorch's layout.

Precision: fp32; the network runs under `fid.ieee_fp32`, so on the card
its convolutions are IEEE fp32 — cuDNN would otherwise take TF32 for them
by default.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..models.common import load_module
from .fid import FeatureExtractorRegistry, ieee_fp32, image_batch, resize_images

BN_EPS = 1e-3
ENV_CHECKPOINT = "ECAD_INCEPTION_CHECKPOINT"


class BasicConv(nn.Module):
    """conv (no bias) + batchnorm (eval, eps 1e-3) + relu; the batchnorm's
    affine and running statistics under the reference's names."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        for name in ("bn_scale", "bn_bias", "bn_mean", "bn_var"):
            setattr(self, name, nn.Parameter(torch.empty(cout)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.batch_norm(self.conv(x), self.bn_mean, self.bn_var, self.bn_scale,
                         self.bn_bias, training=False, eps=BN_EPS)
        return F.relu(x)


def avg_pool_fid(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 avg pool, pad 1, count_include_pad=False."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2, pad: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, window, stride=stride, padding=pad)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(avg_pool_fid(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(avg_pool_fid(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool: str) -> None:
        """`pool`: "avg" (Mixed_7b) or "max" (Mixed_7c, the FID variant)."""
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = max_pool(x, 3, 1, 1) if self.pool == "max" else avg_pool_fid(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


STEM = (("Conv2d_1a_3x3", 3, 32, 3, 2, 0), ("Conv2d_2a_3x3", 32, 32, 3, 1, 0),
        ("Conv2d_2b_3x3", 32, 64, 3, 1, 1), ("Conv2d_3b_1x1", 64, 80, 1, 1, 0),
        ("Conv2d_4a_3x3", 80, 192, 3, 1, 0))


class InceptionV3FID(nn.Module):
    """Input (B, 3, 299, 299) in [−1, 1] → (B, 2048) pool3 features."""

    def __init__(self) -> None:
        super().__init__()
        for name, cin, cout, k, s, p in STEM:
            self.add_module(name, BasicConv(cin, cout, k, stride=s, padding=p))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    @ieee_fp32
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(max_pool(x)))
        x = max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                     "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
                     "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # adaptive avg pool → (B, 2048)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

_BLOCKS = {
    ("Mixed_5b", "Mixed_5c", "Mixed_5d"): (
        "branch1x1", "branch5x5_1", "branch5x5_2",
        "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"),
    ("Mixed_6a",): ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
    ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"): (
        "branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
        "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
        "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"),
    ("Mixed_7a",): ("branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2",
                    "branch7x7x3_3", "branch7x7x3_4"),
    ("Mixed_7b", "Mixed_7c"): (
        "branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
        "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
        "branch3x3dbl_3b", "branch_pool"),
}


def convert_inception_state_dict(state: dict) -> dict:
    """torchvision/pt_inception naming → the reference's param tree (ref
    :193-243), as views: conv weights (O, I, kh, kw) → (kh, kw, I, O);
    batchnorm statistics carried as params."""

    def basic(key):
        return {
            "conv": {"kernel": state[f"{key}.conv.weight"].permute(2, 3, 1, 0)},
            "bn_scale": state[f"{key}.bn.weight"],
            "bn_bias": state[f"{key}.bn.bias"],
            "bn_mean": state[f"{key}.bn.running_mean"],
            "bn_var": state[f"{key}.bn.running_var"],
        }

    params: dict[str, Any] = {name: basic(name) for name, *_ in STEM}
    for names, branches in _BLOCKS.items():
        for name in names:
            params[name] = {b: basic(f"{name}.{b}") for b in branches}
    return params


class InceptionFeatureExtractor:
    def __init__(self, model: InceptionV3FID):
        self.model = model
        self.device = model.Mixed_7c.branch_pool.bn_mean.device

    @classmethod
    def from_weights(cls, checkpoint: Path | str,
                     device: str | torch.device = "cuda") -> "InceptionFeatureExtractor":
        from ..models.bridge import inception_state_dict

        state = torch.load(checkpoint, map_location="cpu", weights_only=True)
        with torch.device("meta"):
            model = InceptionV3FID()
        return cls(load_module(model, inception_state_dict(
            convert_inception_state_dict(state)), resolve_device(device)))

    @torch.inference_mode()
    def features(self, images) -> torch.Tensor:
        """uint8 (N, H, W, 3) → (N, 2048) features on the model's device
        (pytorch-fid preprocessing: bilinear 299² on [0, 1], then 2x − 1)."""
        x = resize_images(image_batch(images, self.device), 299, "bilinear")
        return self.model(2.0 * x - 1.0)

    def __call__(self, images) -> np.ndarray:
        return self.features(images).cpu().numpy()


_RESIDENT: Optional[InceptionFeatureExtractor] = None


def _inception_extractor(images: np.ndarray, device="cuda") -> np.ndarray:
    """Registry entry: the resident extractor on `device`, built at first
    use (and again for another device) from ECAD_INCEPTION_CHECKPOINT."""
    global _RESIDENT
    dev = resolve_device(device)
    if _RESIDENT is None or _RESIDENT.device.type != dev.type:
        import os

        ckpt = os.environ.get(ENV_CHECKPOINT)
        if not ckpt:
            raise RuntimeError(
                f"inception FID features need a local pt_inception checkpoint: "
                f"set {ENV_CHECKPOINT}, or use --extractor clip_vision/pixel_stats"
            )
        _RESIDENT = InceptionFeatureExtractor.from_weights(ckpt, dev)
    return _RESIDENT(images)


FeatureExtractorRegistry.register(_inception_extractor, name="inception")
