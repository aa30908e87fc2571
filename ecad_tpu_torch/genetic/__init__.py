from .evaluate import latents_to_uint8

__all__ = ["latents_to_uint8"]
