from .clip import CLIPTextConfig, CLIPTextEncoder, CLIPTextPipeline
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
from .t5 import T5Config, T5Encoder, T5EncoderPipeline
from .weights import load_flux_params, load_pixart_params, load_state_dict

__all__ = [
    "CLIPTextConfig",
    "CLIPTextEncoder",
    "CLIPTextPipeline",
    "FluxConfig",
    "FluxTransformer",
    "PixArtConfig",
    "PixArtTransformer",
    "T5Config",
    "T5Encoder",
    "T5EncoderPipeline",
    "full_step_mask",
    "init_cache",
    "init_model",
    "load_flux_params",
    "load_pixart_params",
    "load_state_dict",
    "schedule_mask_array",
    "schedule_step_masks",
]
