"""score_images — score rendered images per schedule directory.

Counterpart of ``ecad_tpu/benchmark/score_images.py``, plus ``--device``
(default ``cuda``, which must exist; ``--device cpu`` for a machine
without one): each directory's images are stacked there, and the
weight-backed scorers (``image_reward``, ``clip``) run on it; the
``mock`` scorer hashes them on the host. Parity with
ecad/benchmark/score_images.py: filename-regex naming modes (image_reward
/ parti / toca, :19-28), exact-image-count gating before scoring
(:200-205), skip when scores.json exists (:206-207), --delete-after
removes PNGs (:187-238). The scorer comes from the port's registry
(`ecad_tpu_torch.scoring.get_scorer`; the weight-backed ones read their
weights' paths from the ECAD_IMAGE_REWARD_* / ECAD_CLIP_MODEL_DIR
variables). Every leaf directory is scored in one process
(`_processes.host_shard`).
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..scoring import get_scorer
from ._processes import host_shard, initialize
from .prompts import normalize_prompt_id, read_benchmark_prompts

FILENAME_PATTERN = re.compile(
    r".*__prompt_id:(?P<prompt_id>.+?)__.*?__image_seed:(?P<image_seed>\d+)"
)
FILENAME_PATTERN_PARTI = re.compile(
    r"(?P<prompt_num>\d+)__prompt_seed:(?P<prompt_seed>.+?)__image_seed:(?P<image_seed>\d+)"
)
FILENAME_PATTERN_TOCA = re.compile(r"(?P<prompt_num>\d+)__.*")
FILENAME_PATTERN_TOCA_SEEDED = re.compile(
    r"(?P<prompt_num>\d+)__.*?image_seed:(?P<image_seed>\d+)"
)

NAMING_MODES = {
    "image_reward": FILENAME_PATTERN,
    "parti": FILENAME_PATTERN_PARTI,
    "toca": FILENAME_PATTERN_TOCA,
    "toca_seeded": FILENAME_PATTERN_TOCA_SEEDED,
}


def parse_prompt_id(name: str, mode: str) -> str | None:
    m = NAMING_MODES[mode].match(name)
    if not m:
        return None
    gd = m.groupdict()
    pid = gd.get("prompt_id") or gd.get("prompt_num")
    return normalize_prompt_id(pid) if pid is not None else None


def prompts_by_id(prompt_file: Path) -> dict[str, str]:
    """Normalized prompt id → prompt text, from a benchmark prompt file."""
    out = {}
    for name, prompt in read_benchmark_prompts(prompt_file).items():
        m = re.search(r"prompt_id:(?P<pid>.+?)__", name)
        pid = m.group("pid") if m else name.split("__")[0]
        out[normalize_prompt_id(pid)] = prompt
    return out


def load_named_images(pngs, prompts: dict[str, str], naming: str, warn: bool = True):
    """(images, prompts, prompt ids) of the PNGs whose names parse under
    `naming` (each other one skipped, with a warning if `warn`); a prompt
    id missing from `prompts` stands for its text."""
    from PIL import Image

    images, texts, ids = [], [], []
    for p in pngs:
        pid = parse_prompt_id(p.stem, naming)
        if pid is None:
            if warn:
                print(f"WARNING: cannot parse prompt id from {p.name}; skipping")
            continue
        images.append(np.asarray(Image.open(p).convert("RGB")))
        texts.append(prompts.get(pid, pid))
        ids.append(pid)
    return images, texts, ids


def score_schedule_dir(
    image_dir: Path,
    prompts: dict[str, str],
    scorer_name: str,
    exactly_n_images: int | None,
    delete_after: bool,
    naming: str,
    device="cuda",
) -> dict | None:
    pngs = sorted(image_dir.rglob("*.png"))
    score_file = image_dir / "scores.json"
    if score_file.exists():
        print(f"Skipping {image_dir}: scores.json exists.")
        return None
    if exactly_n_images is not None and len(pngs) != exactly_n_images:
        print(
            f"Skipping {image_dir}: {len(pngs)} images, expected "
            f"{exactly_n_images}."
        )
        return None
    if not pngs:
        return None

    images, texts, ids = load_named_images(pngs, prompts, naming)
    if not images:
        print(
            f"Skipping {image_dir}: none of {len(pngs)} filenames match "
            f"naming mode '{naming}' — check --naming."
        )
        return None
    scorer = get_scorer(scorer_name)
    result = scorer(torch.from_numpy(np.stack(images)).to(device), texts, ids)
    with score_file.open("w") as f:
        json.dump(result, f, indent=4)
    print(f"{image_dir}: total_score={result['total_score']:.4f}")
    if delete_after:
        for p in pngs:
            p.unlink()
    return result


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image-dir", type=Path, required=True,
                   help="schedule-dir tree of images (scored per leaf dir)")
    p.add_argument("--prompt-file", type=Path, default=None,
                   help="prompt source to resolve prompt ids → text")
    p.add_argument("--scorer", default="mock")
    p.add_argument("--naming", choices=sorted(NAMING_MODES), default="image_reward")
    p.add_argument("--exactly-n-images", type=int, default=None)
    p.add_argument("--delete-after", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda must be present")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    get_scorer(args.scorer)  # an unknown name raises here
    prompts = prompts_by_id(args.prompt_file) if args.prompt_file else {}
    initialize()  # one process; raises if the environment asks for more
    # leaf dirs = dirs containing pngs directly
    leaf_dirs = host_shard(
        sorted({p.parent for p in args.image_dir.rglob("*.png")})
        or [args.image_dir]
    )
    n = 0
    for d in leaf_dirs:
        if score_schedule_dir(
            d, prompts, args.scorer, args.exactly_n_images,
            args.delete_after, args.naming, device,
        ):
            n += 1
    print(f"Scored {n} directories.")


if __name__ == "__main__":
    main()
