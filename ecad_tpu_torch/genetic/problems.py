"""Problem definitions for the caching-schedule search (the port's own copy
of ``ecad_tpu/genetic/problems.py``).

Reference: ecad/genetic/{pixart,flux}_problem.py — pymoo ElementwiseProblem
shells declaring n_var = steps·blocks·components (PixArt 20·28·3 = 1680,
FLUX 20·(19·3 + 38·3) = 3420), n_obj = 2 (1 − ImageReward, total_macs_T),
n_ieq_constr = 1 (min hamming distance from the default schedule), binary
bounds; evaluation is ask/tell-only (the reference's _evaluate raises).
Here the same facts parameterize the NSGA2 engine and the IO manager.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..schedules import (
    FLUX_NUM_BLOCKS,
    FLUX_NUM_SINGLE_BLOCKS,
    PIXART_NUM_BLOCKS,
)


@dataclass(frozen=True)
class CachingScheduleProblem:
    """n_var/n_obj/n_constr facts for one model family."""

    name: str
    num_inference_steps: int
    num_blocks: int
    components_per_block: int
    num_single_blocks: int = 0
    single_components: int = 0
    n_obj: int = 2
    n_ieq_constr: int = 1

    @property
    def n_var(self) -> int:
        return self.num_inference_steps * (
            self.num_blocks * self.components_per_block
            + self.num_single_blocks * self.single_components
        )


def pixart_problem(num_inference_steps: int = 20) -> CachingScheduleProblem:
    """n_var = 20·28·3 = 1680 (pixart_problem.py:40-45)."""
    return CachingScheduleProblem(
        name="pixart",
        num_inference_steps=num_inference_steps,
        num_blocks=PIXART_NUM_BLOCKS,
        components_per_block=3,
    )


def flux_problem(num_inference_steps: int = 20) -> CachingScheduleProblem:
    """n_var = 20·(19·3 + 38·3) = 3420 (flux_problem.py:50-58)."""
    return CachingScheduleProblem(
        name="flux",
        num_inference_steps=num_inference_steps,
        num_blocks=FLUX_NUM_BLOCKS,
        components_per_block=3,
        num_single_blocks=FLUX_NUM_SINGLE_BLOCKS,
        single_components=3,
    )
