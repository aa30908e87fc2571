"""Shared helpers for heuristic schedule generation (the port's own copy of
``ecad_tpu/schedules/generators/helpers.py``).

Mask-based equivalents of ecad/schedulers/cache_scheduler/generators/helpers.py
and the step-placement helpers in
ecad/schedulers/dit_scheduler/generators/helpers.py:9-28.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from ..cache_schedule import CacheSchedule


def apply_n_times_centered(num_inference_steps: int, apply_n_times: int) -> list[int]:
    """Place ``apply_n_times`` steps centered within the trajectory via
    linspace (reference dit_scheduler/generators/helpers.py:9-20)."""
    pts = np.linspace(
        0, num_inference_steps + 1, num=apply_n_times + 2, endpoint=True
    )[1:-1]
    pts = np.ceil(pts - 1).astype(int).tolist()
    assert len(pts) == apply_n_times
    assert all(0 <= pt < num_inference_steps for pt in pts)
    return pts


def evenly_spaced(start: int, stop: int, count: int) -> list[int]:
    """`count` evenly spaced ints from start to stop inclusive
    (reference helpers.py:23-28)."""
    if count == 1:
        return [start]
    step = (stop - start) / (count - 1)
    return [int(round(start + i * step)) for i in range(count)]


def middle_range(num_blocks: int, num_affected: int) -> range:
    """Centered block range used by middle_cache / middle_skip
    (reference cache generators helpers.py:76-99)."""
    middle = num_blocks // 2
    start = middle - (num_affected // 2)
    end = middle + (num_affected // 2)
    if num_affected % 2 == 0:
        end -= 1
    return range(start, end + 1)


def save_schedules(
    schedules: Iterable[CacheSchedule],
    output_dir: Path | str,
    skip_existing: bool = True,
    verbose: bool = True,
) -> list[Path]:
    """Write schedules as `<name>.json`, renaming on collision
    (reference helpers.py:13-39)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    written: list[Path] = []
    for schedule in schedules:
        fname = output_dir / f"{schedule.name}.json"
        if skip_existing and fname.exists():
            continue
        while fname.exists():
            fname = fname.with_name(f"{fname.stem}_1{fname.suffix}")
        schedule.to_json(fname)
        written.append(fname)
        if verbose:
            print(f"Saved schedule {schedule.name} to {fname}")
    if not written and verbose:
        print("WARNING: No schedules saved.")
    return written
