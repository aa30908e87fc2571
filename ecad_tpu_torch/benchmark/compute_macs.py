"""compute_macs — write per-step MACs/FLOPs metrics into schedule JSONs.

The port's own copy of ``ecad_tpu/benchmark/compute_macs.py``, on the
port's analytic cost model (``ecad_tpu_torch.macs``): parity with
ecad/benchmark/compute_macs.py (calflops-based, :147-303), the same
metrics byte for byte as the JAX package's tool. It is arithmetic on the
schedule and needs no device, so it takes no ``--device``. Metrics are
written into the schedule JSON under `metrics` (:224-236).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..macs import attach_metrics
from ..schedules import CacheSchedule, FluxCacheSchedule, PixArtCacheSchedule


def load_any_schedule(path: Path):
    with path.open() as f:
        data = json.load(f)
    if "dit_schedule" in data:
        from ..graph import DiTSchedule

        return DiTSchedule.from_dict(data)
    cs = data.get("cache_schedule", {})
    cls = FluxCacheSchedule if "num_single_blocks" in cs else PixArtCacheSchedule
    return cls.from_dict(data)


def compute_for_file(path: Path, overwrite: bool) -> bool:
    sched = load_any_schedule(path)
    if sched.metrics.get("total_macs_T") is not None and not overwrite:
        print(f"Skipping {path.name}: metrics present.")
        return False
    from ..graph import DiTSchedule

    if isinstance(sched, DiTSchedule):
        from ..macs import compute_dit_schedule_metrics

        sched.metrics.update(compute_dit_schedule_metrics(sched))
    else:
        attach_metrics(sched)
    sched.to_json(path)
    print(f"{path.name}: total_macs_T={sched.metrics['total_macs_T']:.6f}")
    return True


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    target = p.add_mutually_exclusive_group(required=True)
    target.add_argument("--schedule", type=Path)
    target.add_argument("--input-dir", type=Path)
    p.add_argument("--overwrite", action="store_true")
    args = p.parse_args(argv)

    if args.schedule is not None:
        compute_for_file(args.schedule, args.overwrite)
        return
    n = sum(
        compute_for_file(f, args.overwrite)
        for f in sorted(args.input_dir.rglob("*.json"))
    )
    print(f"Updated {n} schedule files.")


if __name__ == "__main__":
    main()
