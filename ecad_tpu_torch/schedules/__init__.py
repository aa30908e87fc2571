from .cache_schedule import CacheSchedule
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
]
