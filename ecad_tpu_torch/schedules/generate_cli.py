"""generate_schedules — run heuristic schedule generators (the port's own
copy of ``ecad_tpu/schedules/generate_cli.py``; its DiT families use
``ecad_tpu_torch/graph/generators.py``).

    python -m ecad_tpu_torch.schedules.generate_cli pixart_cache -f all \\
        --output-dir schedules_out

One CLI covering the reference's three generator entry points
(ecad/schedulers/cache_scheduler/generators/pixart_generate_schedules.py,
flux_generate_schedules.py and dit_scheduler/generators/generate_schedules.py):
`-f gen_xxx | all` runs registry generators, one subdir per generator
function, with optional --visualize for DiT topology schedules.
"""

from __future__ import annotations

import argparse
from pathlib import Path

FAMILIES = {
    "pixart_cache": dict(blocks=28, steps=20),
    "flux_cache": dict(blocks=19, single=38, steps=20),
    "pixart_dit": dict(blocks=28, steps=20),
    "flux_dit": dict(blocks=19, steps=20),
}


def get_registry(family: str):
    if family == "pixart_cache":
        from .generators.pixart_cache import GEN_FUNCTIONS
    elif family == "flux_cache":
        from .generators.flux_cache import GEN_FUNCTIONS
    elif family in ("pixart_dit", "flux_dit"):
        from ..graph.generators import GEN_FUNCTIONS

        if family == "flux_dit":
            # only the sequential default exists for FLUX topologies
            # (reference flux_schedule_generators.py:12-46)
            GEN_FUNCTIONS = {"gen_default": GEN_FUNCTIONS["gen_default"]}
    else:
        raise ValueError(family)
    return GEN_FUNCTIONS


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("family", choices=sorted(FAMILIES))
    p.add_argument("-f", "--functions", default="all",
                   help="comma-separated gen_* names, or 'all'")
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--num-blocks", type=int, default=None)
    p.add_argument("--num-single-blocks", type=int, default=None)
    p.add_argument("--num-inference-steps", type=int, default=None)
    p.add_argument("--visualize", action="store_true",
                   help="write .dot graphs next to DiT schedules")
    args = p.parse_args(argv)

    registry = get_registry(args.family)
    if args.functions == "all":
        names = sorted(registry)
    else:
        names = args.functions.split(",")
        unknown = [n for n in names if n not in registry]
        if unknown:
            raise SystemExit(
                f"unknown generators {unknown}; available: {sorted(registry)}"
            )

    defaults = FAMILIES[args.family]
    blocks = args.num_blocks or defaults["blocks"]
    steps = args.num_inference_steps or defaults["steps"]
    is_dit = args.family.endswith("_dit")

    total = 0
    for name in names:
        out = args.output_dir / name
        gen_args = [blocks]
        if args.family == "flux_cache":
            gen_args.append(args.num_single_blocks or defaults["single"])
        gen_args.append(steps)
        schedules = list(registry[name](*gen_args))
        if is_dit:
            from ..graph.generators import save_dit_schedules

            written = save_dit_schedules(schedules, out)
            if args.visualize:
                for s in schedules:
                    s.visualize(out / "viz")
        else:
            from .generators.helpers import save_schedules

            written = save_schedules(schedules, out, verbose=False)
        total += len(written)
        print(f"{name}: {len(written)} schedules → {out}")
    print(f"Done: {total} schedules.")


if __name__ == "__main__":
    main()
