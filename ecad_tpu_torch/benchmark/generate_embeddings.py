"""generate_embeddings — prompt files → per-prompt embedding files.

Counterpart of ``ecad_tpu/benchmark/generate_embeddings.py``, plus
``--device`` (default ``cuda``, which must exist; ``--device cpu`` runs the
plain PyTorch path). One CLI covers the reference's four dumpers
(generate_embeddings.py, generate_embeddings_parti.py,
generate_coco_embeddings.py, generate_mjhq_embeddings.py) via --mode; the
file names match the reference's schemes, so the scorers' regexes work
unchanged.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..image_generators import get_image_generator_type
from .prompts import coco_megabatches, mjhq_categories, read_benchmark_prompts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image_generator")
    p.add_argument("--prompt-file", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument(
        "--mode",
        choices=["benchmark", "parti", "coco", "mjhq"],
        default="benchmark",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--megabatch-size", type=int, default=3000)
    p.add_argument("--weights-root", type=Path, default=None)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--format", choices=[".pt", ".npz"], default=".pt")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda must be present")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    gen = get_image_generator_type(args.image_generator)(
        start_seed=args.seed,
        seed_step=0,
        weights_root=args.weights_root,
        random_weights=args.random_weights or args.weights_root is None,
        device=args.device,
    )

    if args.mode == "coco":
        lines = [
            l.strip()
            for l in args.prompt_file.read_text().splitlines()
            if l.strip()
        ]
        groups = list(coco_megabatches(lines, args.megabatch_size))
    elif args.mode == "mjhq":
        meta = json.loads(args.prompt_file.read_text())
        groups = list(mjhq_categories(meta))
    else:
        groups = [("", read_benchmark_prompts(args.prompt_file))]

    total = 0
    for subdir, named_prompts in groups:
        out = args.output_dir / subdir if subdir else args.output_dir
        names = list(named_prompts.keys())
        prompts = [named_prompts[n] for n in names]
        for lo in range(0, len(prompts), args.batch_size):
            hi = min(lo + args.batch_size, len(prompts))
            gen.encode_and_save_prompts(
                prompts[lo:hi], out, names=names[lo:hi], fmt=args.format
            )
            total += hi - lo
        print(f"Encoded {len(prompts)} prompts → {out}")
    print(f"Done: {total} embeddings.")


if __name__ == "__main__":
    main()
