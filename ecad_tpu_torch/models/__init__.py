from .flux import FluxConfig, FluxTransformer
from .pixart import (
    PixArtConfig,
    PixArtTransformer,
    full_step_mask,
    init_cache,
    init_model,
    schedule_mask_array,
    schedule_step_masks,
)

__all__ = [
    "FluxConfig",
    "FluxTransformer",
    "PixArtConfig",
    "PixArtTransformer",
    "full_step_mask",
    "init_cache",
    "init_model",
    "schedule_mask_array",
    "schedule_step_masks",
]
