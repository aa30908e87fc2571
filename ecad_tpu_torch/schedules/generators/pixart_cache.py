"""Heuristic PixArt cache-schedule generators (search-space priors/baselines;
the port's own copy of ``ecad_tpu/schedules/generators/pixart_cache.py``).

Mask-based re-implementations matching the reference generator family in
ecad/schedulers/cache_scheduler/generators/pixart_schedule_generators.py:20-557:
default, middle/evenly-spaced caching grids per component, FORA-style
recompute-every-n, and the TGATE family (with/without cross-attention
averaging). Names and attribute dicts match so generated JSONs are
interchangeable with the reference's committed artifacts.
"""

from __future__ import annotations

import sys
from typing import Iterable, Iterator

import numpy as np

from ...registry import build_function_registry
from ..pixart import PixArtCacheSchedule
from .helpers import apply_n_times_centered, evenly_spaced, middle_range

A1, A2, FF = 0, 1, 2  # component columns in the (steps, blocks, 3) mask


def _full_mask(steps: int, blocks: int) -> np.ndarray:
    return np.ones((steps, blocks, 3), dtype=np.bool_)


def _make(
    mask: np.ndarray, name: str, attributes: dict, **kwargs
) -> PixArtCacheSchedule:
    steps, blocks, _ = mask.shape
    return PixArtCacheSchedule(
        num_blocks=blocks,
        num_inference_steps=steps,
        name=name,
        mask=mask.reshape(steps, blocks * 3),
        attributes=attributes,
        **kwargs,
    )


def gen_default(
    num_blocks: int, num_inference_steps: int
) -> Iterator[PixArtCacheSchedule]:
    yield _make(
        _full_mask(num_inference_steps, num_blocks), "default", {}
    )


def _grid_cache(
    num_blocks: int,
    num_inference_steps: int,
    comp_values: tuple[bool, bool, bool],
    name_prefix: str,
    block_picker,
) -> Iterator[PixArtCacheSchedule]:
    """Shared grid over (num_affected_steps odd × num_affected_blocks odd);
    ``block_picker(num_blocks, n)`` chooses the affected blocks."""
    for num_affected_steps in range(1, num_inference_steps + 1, 2):
        for num_affected_blocks in range(1, num_blocks, 2):
            mask = _full_mask(num_inference_steps, num_blocks)
            blocks = list(block_picker(num_blocks, num_affected_blocks))
            for step in apply_n_times_centered(
                num_inference_steps, num_affected_steps
            ):
                for b in blocks:
                    mask[step, b] = comp_values
            name = (
                f"{name_prefix}_affected_{num_affected_blocks:03}"
                f"_affected_steps_{num_affected_steps:03}"
            )
            yield _make(
                mask,
                name,
                {
                    "num_affected_blocks": num_affected_blocks,
                    "num_affected_steps": num_affected_steps,
                },
            )


# (attn1, attn2, ff) recompute values applied to affected blocks:
# "ca" grids cache cross-attention only, etc. (reference :33-99)
def gen_middle_cache_ca_evenly_spaced(num_blocks, num_inference_steps):
    yield from _grid_cache(
        num_blocks, num_inference_steps, (True, False, True),
        "middle_cache_ca_evenly_spaced", middle_range,
    )


def gen_middle_cache_sa_evenly_spaced(num_blocks, num_inference_steps):
    yield from _grid_cache(
        num_blocks, num_inference_steps, (False, True, True),
        "middle_cache_sa_evenly_spaced", middle_range,
    )


def gen_middle_cache_ff_evenly_spaced(num_blocks, num_inference_steps):
    yield from _grid_cache(
        num_blocks, num_inference_steps, (True, True, False),
        "middle_cache_ff_evenly_spaced", middle_range,
    )


def _evenly_picker(num_blocks: int, n: int) -> list[int]:
    return evenly_spaced(0, num_blocks - 1, n)


def gen_evenly_cache_ca_evenly_spaced(num_blocks, num_inference_steps):
    yield from _grid_cache(
        num_blocks, num_inference_steps, (True, False, True),
        "evenly_cache_ca_evenly_spaced", _evenly_picker,
    )


def gen_evenly_cache_sa_evenly_spaced(num_blocks, num_inference_steps):
    yield from _grid_cache(
        num_blocks, num_inference_steps, (False, True, True),
        "evenly_cache_sa_evenly_spaced", _evenly_picker,
    )


def gen_evenly_cache_ff_evenly_spaced(num_blocks, num_inference_steps):
    yield from _grid_cache(
        num_blocks, num_inference_steps, (True, True, False),
        "evenly_cache_ff_evenly_spaced", _evenly_picker,
    )


def _recompute_every_n(
    num_blocks: int,
    num_inference_steps: int,
    always: tuple[bool, bool, bool],
    name_prefix: str,
) -> Iterator[PixArtCacheSchedule]:
    """FORA-style: all components recomputed on steps ≡ 0 (mod n); the
    `always` components recomputed every step (reference :172-244)."""
    for n in range(2, num_inference_steps + 1):
        mask = np.zeros((num_inference_steps, num_blocks, 3), dtype=np.bool_)
        num_affected_steps = 0
        for i in range(num_inference_steps):
            recompute = i % n == 0
            mask[i, :, A1] = recompute or always[A1]
            mask[i, :, A2] = recompute or always[A2]
            mask[i, :, FF] = recompute or always[FF]
            num_affected_steps += int(recompute)
        yield _make(
            mask,
            f"{name_prefix}_every_{n:03}",
            {
                "num_affected_blocks": num_blocks,
                "num_affected_steps": num_affected_steps,
                "recompute_attn1_every": n if not always[A1] else 1,
                "recompute_attn2_every": n if not always[A2] else 1,
                "recompute_ff_every": n if not always[FF] else 1,
            },
        )


def gen_recompute_all_every_n(num_blocks, num_inference_steps):
    yield from _recompute_every_n(
        num_blocks, num_inference_steps, (False, False, False), "recompute_all"
    )


def gen_recompute_ca_sa_every_n(num_blocks, num_inference_steps):
    yield from _recompute_every_n(
        num_blocks, num_inference_steps, (False, False, True), "recompute_ca_sa"
    )


def _tgate_mask(
    num_blocks: int,
    num_inference_steps: int,
    gate_step: int,
    sp_interval: int,
    fi_interval: int,
    warmup: int,
) -> tuple[np.ndarray, int]:
    """TGATE recompute pattern (reference :289-366): before the gate step,
    self-attn recomputed during warmup then every sp_interval; cross-attn
    always. After the gate, self-attn every fi_interval, cross-attn reused.
    FF always recomputed."""
    mask = np.ones((num_inference_steps, num_blocks, 3), dtype=np.bool_)
    num_affected_steps = 0
    for step in range(num_inference_steps):
        if step < gate_step:
            attn1 = (step < warmup) or (step % sp_interval == 0)
            attn2 = True
        else:
            attn1 = step % fi_interval == 0
            attn2 = False
        mask[step, :, A1] = attn1
        mask[step, :, A2] = attn2
        if not (attn1 and attn2):
            num_affected_steps += 1
    return mask, num_affected_steps


def _tgate_family(
    num_blocks: int,
    num_inference_steps: int,
    gate_steps: Iterable[int],
    sp_intervals: Iterable[int],
    fi_intervals: Iterable[int],
    warmups: Iterable[int],
    with_ca_avg: bool,
    transformer_weights: str | None = None,
) -> Iterator[PixArtCacheSchedule]:
    for gate_step in gate_steps:
        for sp_interval in sp_intervals:
            for fi_interval in fi_intervals:
                for warmup in warmups:
                    mask, affected = _tgate_mask(
                        num_blocks, num_inference_steps,
                        gate_step, sp_interval, fi_interval, warmup,
                    )
                    attrs = {
                        "num_affected_blocks": (
                            num_blocks if affected else 0
                        ),
                        "num_affected_steps": affected,
                        "gate_step": gate_step,
                        "sp_interval": sp_interval,
                        "fi_interval": fi_interval,
                        "warmup": warmup,
                    }
                    kwargs: dict = {}
                    if with_ca_avg:
                        # per-block custom compute fn + tgate pipeline config
                        # (reference :497-527)
                        kwargs["custom_funcs"] = {
                            (s, str(b)): {
                                "custom_compute_attn": {
                                    "name": "compute_attn_tgate",
                                    "kwargs": {"gate_step": gate_step},
                                }
                            }
                            for s in range(num_inference_steps)
                            for b in range(num_blocks)
                        }
                        config: dict = {
                            "pipeline": {
                                "name": "tgate",
                                "kwargs": {"gate_step": gate_step},
                            }
                        }
                        if transformer_weights is not None:
                            config["transformer_weights"] = transformer_weights
                        kwargs["top_level_config"] = config
                        name = (
                            f"tgate_m_{gate_step:03}_sp_{sp_interval:03}"
                            f"_fi_{fi_interval:03}_warmup_{warmup:03}"
                        )
                    else:
                        name = (
                            f"tgate_without_ca_avg_m_{gate_step:03}"
                            f"_sp_{sp_interval:03}_fi_{fi_interval:03}"
                            f"_warmup_{warmup:03}"
                        )
                    yield _make(mask, name, attrs, **kwargs)


def gen_tgate(num_blocks, num_inference_steps):
    assert num_inference_steps == 20, "hardcoded for 20 steps"
    yield from _tgate_family(
        num_blocks, num_inference_steps, [10, 15], [1, 3, 5], [1], [2], True
    )


def gen_tgate_1024(num_blocks, num_inference_steps):
    assert num_inference_steps == 20, "hardcoded for 20 steps"
    yield from _tgate_family(
        num_blocks, num_inference_steps,
        [9, 10, 11, 14, 15, 16], [1, 3, 5], [1], [2], True,
        transformer_weights="PixArt-alpha/PixArt-XL-2-1024-MS",
    )


def gen_tgate_m_k_expanded(num_blocks, num_inference_steps):
    yield from _tgate_family(
        num_blocks, num_inference_steps,
        range(2, num_inference_steps + 1, 2),
        range(1, num_inference_steps, 2), [1], [2], True,
    )


def gen_tgate_without_ca_avg(num_blocks, num_inference_steps):
    assert num_inference_steps == 20, "hardcoded for 20 steps"
    yield from _tgate_family(
        num_blocks, num_inference_steps, [10, 15], [1, 3, 5], [1], [2], False
    )


def gen_tgate_without_ca_avg_m_k_expanded(num_blocks, num_inference_steps):
    yield from _tgate_family(
        num_blocks, num_inference_steps,
        range(1, num_inference_steps + 1, 2),
        range(1, num_inference_steps, 2), [1], [2], False,
    )


GEN_FUNCTIONS = build_function_registry(dict(vars(sys.modules[__name__])))
