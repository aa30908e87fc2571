from .cache_schedule import CacheSchedule
from .flux import (
    FLUX_DEFAULT_STEPS,
    FLUX_FULL_COMPONENTS,
    FLUX_NUM_BLOCKS,
    FLUX_NUM_SINGLE_BLOCKS,
    FLUX_SINGLE_COMPONENTS,
    FluxCacheSchedule,
)
from .pixart import (
    PIXART_COMPONENTS,
    PIXART_DEFAULT_STEPS,
    PIXART_NUM_BLOCKS,
    PixArtCacheSchedule,
)

__all__ = [
    "CacheSchedule",
    "PixArtCacheSchedule",
    "PIXART_COMPONENTS",
    "PIXART_NUM_BLOCKS",
    "PIXART_DEFAULT_STEPS",
    "FluxCacheSchedule",
    "FLUX_FULL_COMPONENTS",
    "FLUX_SINGLE_COMPONENTS",
    "FLUX_NUM_BLOCKS",
    "FLUX_NUM_SINGLE_BLOCKS",
    "FLUX_DEFAULT_STEPS",
]
