"""Heuristic FLUX cache-schedule generators (the port's own copy of
``ecad_tpu/schedules/generators/flux_cache.py``).

Mask-based re-implementations of
ecad/schedulers/cache_scheduler/generators/flux_schedule_generators.py:15-373.
Slot layout per step: 19 full blocks × (full_attn, full_ff, full_ff_context)
then 38 single blocks × (single_attn, single_proj_mlp, single_proj_out).
"""

from __future__ import annotations

import sys
from typing import Iterator

import numpy as np

from ...registry import build_function_registry
from ..flux import (
    FLUX_NUM_BLOCKS,
    FLUX_NUM_SINGLE_BLOCKS,
    FluxCacheSchedule,
)
from .helpers import apply_n_times_centered, evenly_spaced

# component columns within a block triple
ATTN, C1, C2 = 0, 1, 2  # full: (attn, ff, ff_context); single: (attn, proj_mlp, proj_out)


def _make(mask3, name, attributes, num_blocks, num_single_blocks, **kw):
    steps = mask3.shape[0]
    return FluxCacheSchedule(
        num_blocks=num_blocks,
        num_inference_steps=steps,
        num_single_blocks=num_single_blocks,
        name=name,
        mask=mask3.reshape(steps, -1),
        attributes=attributes,
        **kw,
    )


def _full_mask(steps, num_blocks, num_single_blocks):
    return np.ones(
        (steps, num_blocks + num_single_blocks, 3), dtype=np.bool_
    )


def gen_default(
    num_blocks: int,
    num_single_blocks: int,
    num_inference_steps: int,
    height: int | None = None,
    width: int | None = None,
    guidance_scale: float | None = None,
) -> Iterator[FluxCacheSchedule]:
    if height is None or width is None or guidance_scale is None:
        top_level_config = None
    else:
        top_level_config = {
            "height": height,
            "width": width,
            "guidance_scale": guidance_scale,
        }
    yield _make(
        _full_mask(num_inference_steps, num_blocks, num_single_blocks),
        f"default_{height}x{width}_gs_{guidance_scale}",
        {},
        num_blocks,
        num_single_blocks,
        top_level_config=top_level_config,
    )


def gen_default_256(num_blocks, num_single_blocks, num_inference_steps):
    yield from gen_default(
        num_blocks, num_single_blocks, num_inference_steps, 256, 256, None
    )


def gen_default_1024(num_blocks, num_single_blocks, num_inference_steps):
    yield from gen_default(
        num_blocks, num_single_blocks, num_inference_steps, 1024, 1024, None
    )


def gen_default_varied_guidance_256(
    num_blocks, num_single_blocks, num_inference_steps
):
    for gs in [2, 3.5, 5, 7]:
        yield from gen_default(
            num_blocks, num_single_blocks, num_inference_steps, 256, 256, gs
        )


def _recompute_every_n(
    num_blocks: int,
    num_single_blocks: int,
    num_inference_steps: int,
    always_single: tuple[bool, bool, bool],
    always_full: tuple[bool, bool, bool],
    name_prefix: str,
) -> Iterator[FluxCacheSchedule]:
    for n in range(2, num_inference_steps + 1):
        mask = np.zeros(
            (num_inference_steps, num_blocks + num_single_blocks, 3),
            dtype=np.bool_,
        )
        affected_steps = 0
        for i in range(num_inference_steps):
            r = i % n == 0
            for c in range(3):
                mask[i, :num_blocks, c] = r or always_full[c]
                mask[i, num_blocks:, c] = r or always_single[c]
            affected_steps += int(r)
        yield _make(
            mask,
            f"{name_prefix}_every_{n:03}",
            {
                "num_affected_blocks": num_blocks,
                "num_affected_single_blocks": num_single_blocks,
                "num_affected_steps": affected_steps,
                "recompute_single_attn_every_n": n if not always_single[0] else 1,
                "recompute_single_proj_mlp_every_n": n if not always_single[1] else 1,
                "recompute_single_proj_out_every_n": n if not always_single[2] else 1,
                "recompute_full_attn_every_n": n if not always_full[0] else 1,
                "recompute_full_ff_every_n": n if not always_full[1] else 1,
                "recompute_full_ff_context_every_n": n if not always_full[2] else 1,
            },
            num_blocks,
            num_single_blocks,
        )


def gen_recompute_all_every_n(num_blocks, num_single_blocks, num_inference_steps):
    yield from _recompute_every_n(
        num_blocks, num_single_blocks, num_inference_steps,
        (False, False, False), (False, False, False), "recompute_all",
    )


def gen_recompute_attn_every_n(num_blocks, num_single_blocks, num_inference_steps):
    yield from _recompute_every_n(
        num_blocks, num_single_blocks, num_inference_steps,
        (False, True, True), (False, True, True), "recompute_attn",
    )


def _evenly_cache_evenly_spaced(
    num_blocks: int,
    num_single_blocks: int,
    num_inference_steps: int,
    single_vals: tuple[bool, bool, bool],
    full_vals: tuple[bool, bool, bool],
    name_prefix: str,
    every_s_steps: int,
    every_b_blocks: int,
) -> Iterator[FluxCacheSchedule]:
    total = num_blocks + num_single_blocks
    for n_steps in range(1, num_inference_steps + 1, every_s_steps):
        for n_blocks in range(1, total, every_b_blocks):
            mask = _full_mask(num_inference_steps, num_blocks, num_single_blocks)
            blocks = evenly_spaced(0, total - 1, n_blocks)
            for step in apply_n_times_centered(num_inference_steps, n_steps):
                for b in blocks:
                    vals = full_vals if b < num_blocks else single_vals
                    mask[step, b] = vals
            yield _make(
                mask,
                f"{name_prefix}_affected_{n_blocks:03}_affected_steps_{n_steps:03}",
                {
                    "num_total_affected_blocks": n_blocks,
                    "num_affected_steps": n_steps,
                },
                num_blocks,
                num_single_blocks,
            )


def gen_evenly_cache_mlp_ff_evenly_spaced(
    num_blocks, num_single_blocks, num_inference_steps
):
    yield from _evenly_cache_evenly_spaced(
        num_blocks, num_single_blocks, num_inference_steps,
        (True, False, False), (True, False, False),
        "evenly_cache_mlp_ff_evenly_spaced", 3, 5,
    )


def gen_evenly_cache_single_full_attn_evenly_spaced(
    num_blocks, num_single_blocks, num_inference_steps
):
    # NOTE: the reference reuses the mlp_ff name prefix here
    # (flux_schedule_generators.py:355-373); we keep that for artifact parity.
    yield from _evenly_cache_evenly_spaced(
        num_blocks, num_single_blocks, num_inference_steps,
        (False, True, True), (False, True, True),
        "evenly_cache_mlp_ff_evenly_spaced", 5, 15,
    )


GEN_FUNCTIONS = build_function_registry(dict(vars(sys.modules[__name__])))
