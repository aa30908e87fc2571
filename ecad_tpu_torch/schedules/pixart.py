"""PixArt cache schedule: 28 blocks × {attn1, attn2, ff}.

Reference: ecad/schedulers/cache_scheduler/pixart_cache_schedule.py.
Genome layout (steps, blocks, 3) flattened row-major → n_var = 20·28·3 = 1680
(ecad/genetic/pixart_problem.py:40-45).
"""

from __future__ import annotations

from .cache_schedule import CacheSchedule

PIXART_COMPONENTS = ("attn1", "attn2", "ff")
PIXART_NUM_BLOCKS = 28
PIXART_DEFAULT_STEPS = 20


class PixArtCacheSchedule(CacheSchedule):
    components = PIXART_COMPONENTS

    @classmethod
    def default(
        cls,
        num_inference_steps: int = PIXART_DEFAULT_STEPS,
        num_blocks: int = PIXART_NUM_BLOCKS,
        name: str = "default",
    ) -> "PixArtCacheSchedule":
        """All-recompute schedule (the uncached baseline)."""
        return cls(
            num_blocks=num_blocks,
            num_inference_steps=num_inference_steps,
            name=name,
        )
