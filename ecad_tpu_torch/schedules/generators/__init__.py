from . import flux_cache, pixart_cache
from .helpers import (
    apply_n_times_centered,
    evenly_spaced,
    middle_range,
    save_schedules,
)

__all__ = [
    "pixart_cache",
    "flux_cache",
    "apply_n_times_centered",
    "evenly_spaced",
    "middle_range",
    "save_schedules",
]
