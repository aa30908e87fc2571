"""compute_fid — FID between generated images and cached dataset stats.

Counterpart of ``ecad_tpu/benchmark/compute_fid.py``, plus ``--device``
(default ``cuda``, which must exist; ``--device cpu`` runs the plain
PyTorch path): the features are extracted there. Parity with
ecad/benchmark/compute_fid.py (clean-fid with cached custom stats named
e.g. "mjhq-30k"): stats are created once with --make-stats and reused;
results are written to fid_scores.json in the image dir. The stats file is
the JAX package's layout, so either package reads the other's.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from .. import resolve_device
from ..scoring.fid import FIDStats, fid_between


def load_images(directory: Path, limit: int | None = None) -> np.ndarray:
    from PIL import Image

    files = sorted(directory.rglob("*.png")) + sorted(directory.rglob("*.jpg"))
    if limit:
        files = files[:limit]
    if not files:
        raise SystemExit(f"no images under {directory}")
    return np.stack(
        [np.asarray(Image.open(f).convert("RGB")) for f in files]
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image-dir", type=Path, required=True)
    p.add_argument("--stats", type=Path, required=True,
                   help="cached stats npz (create with --make-stats)")
    p.add_argument("--make-stats", action="store_true",
                   help="compute stats from --image-dir and save to --stats")
    p.add_argument("--extractor", default="pixel_stats",
                   help="fid feature extractor registry name")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda must be present")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    images = load_images(args.image_dir, args.limit)
    if args.make_stats:
        FIDStats.from_images(images, args.extractor, device=device).save(args.stats)
        print(f"Saved stats for {len(images)} images → {args.stats}")
        return
    ref = FIDStats.load(args.stats, expect_extractor=args.extractor)
    ours = FIDStats.from_images(images, args.extractor, device=device)
    fid = fid_between(ref, ours)
    out = args.output or (args.image_dir / "fid_scores.json")
    with out.open("w") as f:
        json.dump(
            {"fid": fid, "n_images": len(images), "extractor": args.extractor},
            f, indent=4,
        )
    print(f"FID = {fid:.4f} ({len(images)} images) → {out}")


if __name__ == "__main__":
    main()
