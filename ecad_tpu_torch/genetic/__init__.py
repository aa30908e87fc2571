from .evaluate import (
    CandidateEvaluator,
    EvalConfig,
    FluxCandidateEvaluator,
    fidelity_snr_db,
    latents_to_uint8,
)
from .nsga2 import (
    NSGA2,
    crowding_distance,
    fast_non_dominated_sort,
    hypervolume_2d,
)
from .population_io import (
    FluxPopulationIOManager,
    PixArtPopulationIOManager,
    PopulationIOManager,
)
from .problems import CachingScheduleProblem, flux_problem, pixart_problem

__all__ = [
    "NSGA2",
    "fast_non_dominated_sort",
    "crowding_distance",
    "PopulationIOManager",
    "PixArtPopulationIOManager",
    "FluxPopulationIOManager",
    "CandidateEvaluator",
    "FluxCandidateEvaluator",
    "EvalConfig",
    "latents_to_uint8",
    "fidelity_snr_db",
    "hypervolume_2d",
    "CachingScheduleProblem",
    "pixart_problem",
    "flux_problem",
]
