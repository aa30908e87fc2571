"""Single-process stand-ins for ``ecad_tpu.parallel``'s ``initialize`` and
``host_shard``, which `generate_images` and `score_images` call.

The port runs the benchmark tier in one process, which takes every item.
An environment that asks for more processes (``WORLD_SIZE`` or
``JAX_NUM_PROCESSES`` above 1) is refused: sharding the work across
processes waits for ROADMAP.md queue 1 item 8.
"""

from __future__ import annotations

import os
from typing import Sequence, TypeVar

T = TypeVar("T")

_PROCESS_COUNT_VARS = ("WORLD_SIZE", "JAX_NUM_PROCESSES")


def initialize() -> None:
    """Raises when the environment asks for more than one process."""
    for var in _PROCESS_COUNT_VARS:
        n = int(os.environ.get(var) or 1)
        if n > 1:
            raise NotImplementedError(
                f"{var}={n}: ecad_tpu_torch's benchmark tier runs in one "
                "process; sharding its work across processes waits for "
                "ROADMAP.md queue 1 item 8"
            )


def host_shard(items: Sequence[T]) -> list[T]:
    """This process's share of a work list: all of it."""
    return list(items)
