from .pixart import (
    PixArtConfig,
    PixArtTransformer,
    full_step_mask,
    init_cache,
    init_model,
    schedule_step_masks,
)

__all__ = [
    "PixArtConfig",
    "PixArtTransformer",
    "full_step_mask",
    "init_cache",
    "init_model",
    "schedule_step_masks",
]
