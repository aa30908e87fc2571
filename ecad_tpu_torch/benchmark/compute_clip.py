"""compute_clip — CLIP score for generated images against their prompts.

Counterpart of ``ecad_tpu/benchmark/compute_clip.py``, plus ``--device``
(default ``cuda``, which must exist; ``--device cpu`` for a machine
without one). Parity with ecad/benchmark/compute_clip.py: prompts are
resolved from image filenames via the naming-mode regexes (:18-33), each
schedule directory is scored, and clip_scores.json written. The ``clip``
scorer needs the CLIP towers and their weights, which wait for ROADMAP.md
queue 1 item 6: `get_scorer` raises for it; ``--scorer mock`` drives the
tool.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from .. import resolve_device
from ..scoring import get_scorer
from .score_images import NAMING_MODES, load_named_images, prompts_by_id


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image-dir", type=Path, required=True)
    p.add_argument("--prompt-file", type=Path, required=True)
    p.add_argument("--naming", choices=sorted(NAMING_MODES),
                   default="image_reward")
    p.add_argument("--scorer", default="clip",
                   help="scorer registry name (clip waits for its weights; "
                        "mock for smoke tests)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda must be present")
    args = p.parse_args(argv)

    resolve_device(args.device)
    prompts = prompts_by_id(args.prompt_file)
    leaf_dirs = sorted({q.parent for q in args.image_dir.rglob("*.png")})
    scorer = get_scorer(args.scorer)
    for d in leaf_dirs:
        images, texts, ids = load_named_images(sorted(d.glob("*.png")), prompts,
                                               args.naming, warn=False)
        if not images:
            continue
        result = scorer(np.stack(images), texts, ids)
        out = d / "clip_scores.json"
        with out.open("w") as f:
            json.dump(result, f, indent=4)
        print(f"{d}: CLIP score = {result['total_score']:.4f}")


if __name__ == "__main__":
    main()
