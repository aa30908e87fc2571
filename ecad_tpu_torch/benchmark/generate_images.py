"""generate_images — render saved embeddings for a schedule file or a whole
schedule directory tree.

Counterpart of ``ecad_tpu/benchmark/generate_images.py``, plus ``--device``
(default ``cuda``, which must exist; ``--device cpu`` runs the plain
PyTorch path). Parity with ecad/benchmark/generate_images.py: one output
subdir per schedule stem, mirrored recursion over schedule directories,
skip/regenerate keyed on the exact PNG count (:25-43). Over a directory
one resident generator serves the whole tree: each schedule swaps in
through `set_schedule`, instead of the reference's model reload per
schedule (:13-63). Under several processes (``torchrun``: ``WORLD_SIZE``
> 1, or the reference's ``JAX_NUM_PROCESSES``) each process renders its
strided share of the schedule files (`parallel.host_shard`, :107-110).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..image_generators import get_image_generator_type
from ..utils.io import load_embedding_dir
from ..parallel.distributed import host_shard, initialize


def expected_images(n_embeddings: int, images_per_prompt: int) -> int:
    return n_embeddings * images_per_prompt


def _new_generator(gen_type, args, schedule_path=None):
    return gen_type(
        start_seed=args.start_seed,
        seed_step=args.seed_step,
        schedule_path=schedule_path,
        weights_root=args.weights_root,
        random_weights=args.random_weights or args.weights_root is None,
        batch_size=args.batch_size,
        device=args.device,
    )


def generate_for_schedule(
    gen_type,
    schedule_path: Path,
    embeddings_dir: Path,
    output_dir: Path,
    args,
    shared_gen=None,
) -> int:
    out = output_dir / schedule_path.stem
    entries = load_embedding_dir(embeddings_dir)
    want = expected_images(len(entries), args.images_per_prompt)
    have = len(list(out.rglob("*.png"))) if out.exists() else 0
    if have == want and not args.regenerate:
        print(f"Skipping {schedule_path.stem}: {have}/{want} images present.")
        return 0
    if 0 < have != want:
        print(f"Regenerating {schedule_path.stem}: {have}/{want} images.")
        for p in out.rglob("*.png"):
            p.unlink()

    if shared_gen is not None:
        # swap the schedule on the resident model through the full loader
        # (honors the embedded pipeline/steps/resolution config)
        gen = shared_gen
        gen.set_schedule(schedule_path)
    else:
        gen = _new_generator(gen_type, args, schedule_path)
    n = gen.generate_from_saved_prompts(
        embeddings_dir, out, args.images_per_prompt, args.batch_size
    )
    print(f"{schedule_path.stem}: wrote {n} images → {out}")
    return n


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image_generator")
    p.add_argument("--input-embeddings", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    sched = p.add_mutually_exclusive_group(required=True)
    sched.add_argument("--schedule", type=Path)
    sched.add_argument("--schedule-dir", type=Path)
    p.add_argument("--images-per-prompt", type=int, default=1)
    p.add_argument("--start-seed", type=int, default=0)
    p.add_argument("--seed-step", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--regenerate", action="store_true")
    p.add_argument("--weights-root", type=Path, default=None)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda must be present")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend under torchrun (WORLD_SIZE > 1): "
                        "nccl by default, one card a rank; gloo where ranks "
                        "share a card or on the CPU")
    args = p.parse_args(argv)

    initialize(args.dist_backend, args.device)  # no-op for one process
    gen_type = get_image_generator_type(args.image_generator)
    if args.schedule is not None:
        generate_for_schedule(
            gen_type, args.schedule, args.input_embeddings, args.output_dir,
            args,
        )
        return

    # resident generator shared across the whole schedule tree
    shared = _new_generator(gen_type, args)
    total = 0
    for sp in host_shard(sorted(args.schedule_dir.rglob("*.json"))):
        rel = sp.parent.relative_to(args.schedule_dir)
        total += generate_for_schedule(
            gen_type, sp, args.input_embeddings, args.output_dir / rel, args,
            shared_gen=shared,
        )
    print(f"Done: {total} images.")


if __name__ == "__main__":
    main()
