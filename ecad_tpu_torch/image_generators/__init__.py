"""Image-generator registry (reference: load_image_generator.py:16-85)."""

from __future__ import annotations

from ..registry import Registry
from .base import ImageGenerator
from .flux import FluxImageGenerator, TinyFluxImageGenerator
from .pixart import (
    PixArtAlphaImageGenerator,
    PixArtImageGenerator,
    PixArtSigmaImageGenerator,
    TinyPixArtImageGenerator,
)

ImageGeneratorRegistry: Registry = Registry("image_generator")
ImageGeneratorRegistry.register(
    PixArtAlphaImageGenerator, name="PixArtAlphaImageGenerator"
)
ImageGeneratorRegistry.register(
    PixArtSigmaImageGenerator, name="PixArtSigmaImageGenerator"
)
ImageGeneratorRegistry.register(
    TinyPixArtImageGenerator, name="TinyPixArtImageGenerator"
)
ImageGeneratorRegistry.register(FluxImageGenerator, name="FluxImageGenerator")
ImageGeneratorRegistry.register(TinyFluxImageGenerator, name="TinyFluxImageGenerator")


def get_image_generator_type(name: str) -> type[ImageGenerator]:
    return ImageGeneratorRegistry.get(name)


__all__ = [
    "ImageGenerator",
    "ImageGeneratorRegistry",
    "FluxImageGenerator",
    "TinyFluxImageGenerator",
    "PixArtImageGenerator",
    "PixArtAlphaImageGenerator",
    "PixArtSigmaImageGenerator",
    "TinyPixArtImageGenerator",
    "get_image_generator_type",
]
