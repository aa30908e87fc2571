"""DiT topology schedule generators.

Parity with ecad/schedulers/dit_scheduler/generators/pixart_schedule_generators.py
(15 gen_* functions: skip individual/all/progressive, middle skip / parallel
/ looped-parallel / repeat / reverse × {all_timesteps, progressive,
evenly_spaced}) and flux_schedule_generators.py (gen_default only —
non-sequential FLUX topologies are unimplemented upstream too,
flux_builder.py:81-88). Names and attribute dicts match the reference.
The port's own copy of ``ecad_tpu/graph/generators.py``.
"""

from __future__ import annotations

import sys
from typing import Iterator

from ..registry import build_function_registry
from ..schedules.generators.helpers import apply_n_times_centered, evenly_spaced
from .configs import middle_repeat, middle_skip, parallel, reverse, skip_blocks
from .dit_schedule import DiTSchedule, default_config


def get_progressive_steps(num_inference_steps: int) -> list[int]:
    """Every other step starting at 25%, always including the final step
    (reference dit helpers.py:31-37)."""
    return list(
        range(int(num_inference_steps * 0.25), num_inference_steps, 2)
    ) + [num_inference_steps - 1]


def every_other_step(start: int, stop: int) -> list[int]:
    steps = list(range(start, stop, 2))
    if steps[-1] != stop:
        steps.append(stop)
    return steps


def _uniform(num_blocks, steps, name, config, attributes=None) -> DiTSchedule:
    return DiTSchedule(
        num_blocks, steps, name,
        {s: config for s in range(steps)}, attributes=attributes,
    )


def _from_step(num_blocks, steps, name, start, config, attributes=None):
    sched = {
        s: (default_config(num_blocks) if s < start else config)
        for s in range(steps)
    }
    return DiTSchedule(num_blocks, steps, name, sched, attributes=attributes)


def _centered(num_blocks, steps, name, n_affected_steps, config, attributes=None):
    sched = {s: default_config(num_blocks) for s in range(steps)}
    for s in apply_n_times_centered(steps, n_affected_steps):
        sched[s] = config
    return DiTSchedule(num_blocks, steps, name, sched, attributes=attributes)


def gen_default(num_blocks, num_inference_steps) -> Iterator[DiTSchedule]:
    yield _uniform(
        num_blocks, num_inference_steps, "default", default_config(num_blocks)
    )


def gen_skip_block_individual_evenly_spaced(num_blocks, num_inference_steps):
    for n_steps in range(1, num_inference_steps + 1, 2):
        for block in range(num_blocks):
            yield _centered(
                num_blocks, num_inference_steps,
                f"individual_skip_affected_{block:03}_affected_steps_{n_steps:03}",
                n_steps, skip_blocks(num_blocks, [block]),
                {"affected_block": block, "num_affected_steps": n_steps},
            )


def gen_skip_block_all_timesteps(num_blocks, num_inference_steps):
    for block in range(num_blocks):
        yield _uniform(
            num_blocks, num_inference_steps,
            f"skip_block_{block}_all_timesteps",
            skip_blocks(num_blocks, [block]),
        )


def gen_skip_block_progressive(num_blocks, num_inference_steps):
    for start in get_progressive_steps(num_inference_steps):
        for block in range(num_blocks):
            yield _from_step(
                num_blocks, num_inference_steps,
                f"skip_block_{block}_from_timestep_{start}",
                start, skip_blocks(num_blocks, [block]),
            )


def gen_middle_skip_progressive(num_blocks, num_inference_steps):
    for start in every_other_step(0, num_inference_steps - 1):
        for n_blocks in range(1, num_blocks, 2):
            yield _from_step(
                num_blocks, num_inference_steps,
                f"middle_skip_affected_{n_blocks:03}_from_timestep_{start:03}",
                start, middle_skip(num_blocks, n_blocks),
                {"num_affected_blocks": n_blocks, "from_timestep": start},
            )


def gen_middle_skip_evenly_spaced(num_blocks, num_inference_steps):
    for n_steps in range(1, num_inference_steps + 1):
        for n_blocks in range(1, num_blocks):
            yield _centered(
                num_blocks, num_inference_steps,
                f"middle_skip_affected_{n_blocks:03}_affected_steps_{n_steps:03}",
                n_steps, middle_skip(num_blocks, n_blocks),
                {"num_affected_blocks": n_blocks, "num_affected_steps": n_steps},
            )


def _parallel_ranges(num_blocks, start_frac=False, step=1):
    if start_frac:
        first, last = int(num_blocks * 0.25), int(num_blocks * 0.75)
    else:
        first, last = 0, num_blocks - 1
    while first < last:
        yield first, last
        first += step
        last -= step


def gen_middle_parallel_all_timesteps(num_blocks, num_inference_steps):
    for first, last in _parallel_ranges(num_blocks, start_frac=True):
        yield _uniform(
            num_blocks, num_inference_steps,
            f"middle_parallel_avg_{first}_to_{last}_all_timesteps",
            parallel(num_blocks, first, last, 0, "avg"),
        )


def gen_middle_parallel_progressive(num_blocks, num_inference_steps):
    for start in every_other_step(0, num_inference_steps - 1):
        for first, last in _parallel_ranges(num_blocks):
            n = last - first + 1
            yield _from_step(
                num_blocks, num_inference_steps,
                f"middle_parallel_avg_affected_{n:03}_from_timestep_{start:03}",
                start, parallel(num_blocks, first, last, 0, "avg"),
                {
                    "num_affected_blocks": n,
                    "from_timestep": start,
                    "affected_start": first,
                    "affected_end": last,
                },
            )


def gen_middle_parallel_evenly_spaced(num_blocks, num_inference_steps):
    for n_steps in range(1, num_inference_steps + 1, 2):
        for first, last in _parallel_ranges(num_blocks):
            n = last - first + 1
            yield _centered(
                num_blocks, num_inference_steps,
                f"middle_parallel_avg_affected_{n:03}_affected_steps_{n_steps:03}",
                n_steps, parallel(num_blocks, first, last, 0, "avg"),
                {
                    "num_affected_blocks": n,
                    "num_affected_steps": n_steps,
                    "affected_start": first,
                    "affected_end": last,
                },
            )


def gen_middle_looped_parallel_all_timesteps(num_blocks, num_inference_steps):
    for loop_count in range(1, num_blocks):
        for first, last in _parallel_ranges(num_blocks, start_frac=True):
            yield _uniform(
                num_blocks, num_inference_steps,
                f"middle_looped_parallel_avg_{first}_to_{last}"
                f"_looped_{loop_count}_all_timesteps",
                parallel(num_blocks, first, last, loop_count, "avg"),
            )


def gen_middle_looped_parallel_progressive(num_blocks, num_inference_steps):
    for start in [0, 3, 6, 9, 12, 15, 18, 19]:
        if start >= num_inference_steps:
            continue
        for loop_count in range(1, num_blocks):
            for first, last in _parallel_ranges(num_blocks, step=2):
                n = last - first + 1
                yield _from_step(
                    num_blocks, num_inference_steps,
                    f"middle_looped_parallel_avg_affected_{n:03}"
                    f"_looped_{loop_count:03}_from_timestep_{start:03}",
                    start, parallel(num_blocks, first, last, loop_count, "avg"),
                    {
                        "num_affected_blocks": n,
                        "from_timestep": start,
                        "affected_start": first,
                        "affected_end": last,
                        "loop_count": loop_count,
                    },
                )


def gen_middle_looped_parallel_evenly_spaced(num_blocks, num_inference_steps):
    # 5×5×5 grid (reference :328-384)
    n_steps_vals = evenly_spaced(1, num_inference_steps, 5)
    loop_vals = evenly_spaced(1, num_blocks - 1, 5)
    first_vals = evenly_spaced(0, (num_blocks // 2) - 1, 5)
    last_vals = evenly_spaced(num_blocks - 1, num_blocks // 2, 5)
    for n_steps in n_steps_vals:
        for loop_count in loop_vals:
            for first, last in zip(first_vals, last_vals):
                n = last - first + 1
                yield _centered(
                    num_blocks, num_inference_steps,
                    f"middle_looped_parallel_avg_affected_{n:03}"
                    f"_looped_{loop_count:03}_affected_steps_{n_steps:03}",
                    n_steps, parallel(num_blocks, first, last, loop_count, "avg"),
                    {
                        "num_affected_blocks": n,
                        "num_affected_steps": n_steps,
                        "affected_start": first,
                        "affected_end": last,
                        "loop_count": loop_count,
                    },
                )


def _repeat_ranges(num_blocks):
    start, end = 1, num_blocks - 2
    while start < end:
        yield start, end
        start += 1
        end -= 1


def gen_middle_repeat_all_timesteps(num_blocks, num_inference_steps):
    assert num_blocks >= 3, "num_blocks must be at least 3 for middle_repeat"
    for start, end in _repeat_ranges(num_blocks):
        yield _uniform(
            num_blocks, num_inference_steps,
            f"middle_repeat_{start}_to_{end}_all_timesteps",
            middle_repeat(num_blocks, start, end),
        )


def gen_middle_repeat_progressive(num_blocks, num_inference_steps):
    assert num_blocks >= 3
    for from_step in every_other_step(0, num_inference_steps - 1):
        for start, end in _repeat_ranges(num_blocks):
            n = end - start + 1
            yield _from_step(
                num_blocks, num_inference_steps,
                f"middle_repeat_affected_{n:03}_from_timestep_{from_step:03}",
                from_step, middle_repeat(num_blocks, start, end),
                {
                    "num_affected_blocks": n,
                    "from_timestep": from_step,
                    "affected_start": start,
                    "affected_end": end,
                },
            )


def gen_middle_repeat_evenly_spaced(num_blocks, num_inference_steps):
    for n_steps in range(1, num_inference_steps + 1, 2):
        for start, end in _repeat_ranges(num_blocks):
            n = end - start + 1
            yield _centered(
                num_blocks, num_inference_steps,
                f"middle_repeat_affected_{n:03}_affected_steps_{n_steps:03}",
                n_steps, middle_repeat(num_blocks, start, end),
                {
                    "num_affected_blocks": n,
                    "num_affected_steps": n_steps,
                    "affected_start": start,
                    "affected_end": end,
                },
            )


def gen_reverse_all_timesteps(num_blocks, num_inference_steps):
    # reference :501-521 (stride 2 with a final granularity fix-up)
    first, last = 0, num_blocks - 1
    while first < last:
        yield _uniform(
            num_blocks, num_inference_steps,
            f"reverse_{first}_to_{last}_all_timesteps",
            reverse(num_blocks, first, last),
        )
        first += 2
        last -= 2
        if first >= last:
            first -= 1
            last += 1


def gen_middle_reverse_progressive(num_blocks, num_inference_steps):
    for start in every_other_step(0, num_inference_steps - 1):
        for first, last in _parallel_ranges(num_blocks):
            n = last - first + 1
            yield _from_step(
                num_blocks, num_inference_steps,
                f"reverse_num_affected_{n:03}_from_timestep_{start:03}",
                start, reverse(num_blocks, first, last),
                {
                    "num_affected_blocks": n,
                    "from_timestep": start,
                    "affected_start": first,
                    "affected_end": last,
                },
            )


def gen_middle_reverse_evenly_spaced(num_blocks, num_inference_steps):
    for n_steps in range(1, num_inference_steps + 1, 2):
        for first, last in _parallel_ranges(num_blocks):
            n = last - first + 1
            yield _centered(
                num_blocks, num_inference_steps,
                f"reverse_num_affected_{n:03}_affected_steps_{n_steps:03}",
                n_steps, reverse(num_blocks, first, last),
                {
                    "num_affected_blocks": n,
                    "num_affected_steps": n_steps,
                    "affected_start": first,
                    "affected_end": last,
                },
            )


GEN_FUNCTIONS = build_function_registry(dict(vars(sys.modules[__name__])))


def save_dit_schedules(schedules, output_dir, skip_existing=True, verbose=False):
    """save_schedules analogue for DiT schedules."""
    from pathlib import Path

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for s in schedules:
        p = output_dir / f"{s.name}.json"
        if skip_existing and p.exists():
            continue
        while p.exists():
            p = p.with_name(f"{p.stem}_1{p.suffix}")
        s.to_json(p)
        written.append(p)
        if verbose:
            print(f"Saved {s.name} → {p}")
    return written
