"""PixArt image generators (α, Σ and the tiny test double).

Counterpart of ``ecad_tpu/image_generators/pixart.py``. With a
`weights_root` (and not `random_weights`) the T5-XXL encoder and its
tokenizer come from ``<pipeline repo>/text_encoder`` and ``tokenizer`` (the
pipeline repo, else the transformer's), the transformer from
``<transformer repo>/transformer`` and the VAE from ``<pipeline repo>/vae``
(ref :43-75, :211-240). Without weights the exact architecture runs with
seeded random parameters built on the device, and prompts go through the
deterministic `_HashEncoder`.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Sequence

import numpy as np
import torch

from ..models.common import rebuild
from ..models.pixart import PixArtConfig, full_step_mask, init_cache, init_model
from ..models.weights import load_pixart_params
from ..ops.quant import calibrate_dense_amax, merge_amax
from ..pipelines import PixArtPipeline, PixArtPipelineConfig, pipeline_from_config
from ..schedules.pixart import PixArtCacheSchedule
from .base import ImageGenerator

class PixArtImageGenerator(ImageGenerator):
    schedule_cls = PixArtCacheSchedule
    default_pipeline = "pixart_alpha"
    guidance_scale = 4.5  # fixed (pixart_image_generator.py:377)
    text_len = 120
    caption_dim = 4096

    def model_config(self) -> PixArtConfig:
        if "1024" in self.transformer_weights:
            return PixArtConfig(sample_size=128, use_additional_conditions=True,
                                quant=self.quant)
        return PixArtConfig(sample_size=self.height // 8, quant=self.quant)

    # -- pipelines ---------------------------------------------------------

    def create_encoder_pipeline(self):
        if self._encoder is not None:
            return self._encoder
        if self.loads_weights():
            from ..models.t5 import T5EncoderPipeline

            self._encoder = T5EncoderPipeline.from_weights(
                self.weights_root, self._pipeline_repo(), max_length=self.text_len,
                device=self.device,
            )
        else:
            self._encoder = _HashEncoder(self.text_len, self.caption_dim)
        return self._encoder

    def create_diffusion_pipeline(self) -> PixArtPipeline:
        if self._pipeline is not None:
            return self._pipeline
        config = self.model_config()
        model = self._resident_model(config, init_model, lambda: load_pixart_params(
            self.weights_root, self.transformer_weights, config))
        pcfg = PixArtPipelineConfig(
            model=model.config,
            num_inference_steps=self.num_inference_steps,
            guidance_scale=self.guidance_scale,
        )
        cls, kwargs = pipeline_from_config(
            self.pipeline_name or "pixart_alpha", self.pipeline_kwargs
        )
        self._pipeline = cls(
            pcfg, model, self.cache_schedule,
            dit_schedule=self.dit_schedule, **kwargs,
        )
        return self._pipeline

    @torch.inference_mode()
    def _calibrate_static_scales(self, model) -> tuple:
        """The static quant modes' per-site activation max-abs table (ref
        ``image_generators/pixart.py:74-150``): one forward of every block
        at timesteps 999, 500 and 20, folded with `merge_amax`, on the
        encoder's embeddings of "" (the CFG negative every generation runs)
        and "a detailed photograph", from seeded noise, with no text mask
        (as the reference). ``int8_static`` calibrates the float model on
        `model`'s weights, ``int8_w_static`` the ``int8_w`` one."""
        c = model.config
        base = rebuild(model, dataclasses.replace(
            c, quant="int8_w" if c.quant == "int8_w_static" else None, act_scales=None))
        enc = self.create_encoder_pipeline()
        text = torch.stack([
            torch.from_numpy(enc.encode(p)[0]) for p in ("", "a detailed photograph")
        ]).to(self.device, c.dtype)
        b = text.shape[0]
        gen = torch.Generator(device=self.device).manual_seed(0)
        noise = torch.randn((b, c.sample_size, c.sample_size, c.in_channels),
                            generator=gen, device=self.device).to(c.dtype)
        kwargs = {}
        if c.use_additional_conditions:
            size = float(c.sample_size * 8)
            kwargs = dict(resolution=torch.full((b, 2), size, device=self.device),
                          aspect_ratio=torch.ones((b, 1), device=self.device))
        cache = init_cache(c, b, device=self.device)
        table = merge_amax(*(
            calibrate_dense_amax(base, noise, text, torch.full((b,), t, device=self.device),
                                 cache, full_step_mask(c), **kwargs)
            for t in (999.0, 500.0, 20.0)
        ))
        return tuple(sorted(table.items()))

    # -- encoding ----------------------------------------------------------

    def encode_prompts(self, prompts: Sequence[str]) -> list[dict[str, Any]]:
        """Reference embedding keys (types.py:13-18): prompt_embeds,
        prompt_attention_mask, negative_prompt_embeds,
        negative_prompt_attention_mask. Negative = empty prompt ""."""
        enc = self.create_encoder_pipeline()
        neg_e, neg_m = enc.encode("")
        out = []
        for i, p in enumerate(prompts):
            e, m = enc.encode(p)
            out.append(
                {
                    "name": f"{i:03d}__prompt_seed:{self.start_seed:03}",
                    "prompt_embeds": e,
                    "prompt_attention_mask": m,
                    "negative_prompt_embeds": neg_e,
                    "negative_prompt_attention_mask": neg_m,
                }
            )
        return out

    # -- generation --------------------------------------------------------

    def _generate_latents(
        self, embeddings: list[dict[str, Any]], seed: int
    ) -> torch.Tensor:
        pipe = self.create_diffusion_pipeline()
        dtype = pipe.config.model.dtype
        text = self._stack(embeddings, "prompt_embeds", dtype)
        neg = self._stack(embeddings, "negative_prompt_embeds", dtype)
        tm = nm = None
        if "prompt_attention_mask" in embeddings[0]:
            tm = self._stack(embeddings, "prompt_attention_mask")
            nm = self._stack(embeddings, "negative_prompt_attention_mask")
        return pipe.generate_latents(
            text, neg, seed=seed, text_mask=tm, neg_mask=nm,
        )


class PixArtAlphaImageGenerator(PixArtImageGenerator):
    """Weights per reference pixart_alpha_image_generator.py:18-20."""

    default_transformer_weights = "PixArt-alpha/PixArt-XL-2-256x256"
    default_pipeline_weights = "PixArt-alpha/PixArt-XL-2-1024-MS"
    default_pipeline = "pixart_alpha"


class PixArtSigmaImageGenerator(PixArtImageGenerator):
    """Weights per reference pixart_sigma_image_generator.py:18-20."""

    default_transformer_weights = "PixArt-alpha/PixArt-Sigma-XL-2-256x256"
    default_pipeline_weights = "PixArt-alpha/PixArt-Sigma-XL-2-1024-MS"
    default_pipeline = "pixart_sigma"


class TinyPixArtImageGenerator(PixArtImageGenerator):
    """2-block, 8×8-latent smoke-test generator (always random weights,
    fp32) — keeps every CLI drivable in seconds."""

    default_transformer_weights = "tiny"
    default_pipeline = "pixart_alpha"
    num_blocks = 2
    default_num_inference_steps = 4
    text_len = 8
    caption_dim = 32

    def __init__(self, *args, **kwargs):
        kwargs["random_weights"] = True
        super().__init__(*args, **kwargs)

    def model_config(self) -> PixArtConfig:
        return PixArtConfig.tiny(dtype=torch.float32, quant=self.quant)

    def _load_schedule_file(self, schedule_path):
        sched = super()._load_schedule_file(schedule_path)
        if sched.num_blocks != self.num_blocks:
            raise ValueError(
                f"schedule has {sched.num_blocks} blocks; tiny model has "
                f"{self.num_blocks}"
            )
        return sched


class _HashEncoder:
    """Deterministic stand-in encoder: stable pseudo-embeddings from prompt
    content (the same bytes as the reference's ``_HashEncoder``)."""

    def __init__(self, text_len: int, dim: int):
        self.text_len = text_len
        self.dim = dim

    def encode(self, prompt: str) -> tuple[np.ndarray, np.ndarray]:
        seed = int.from_bytes(
            hashlib.sha256(prompt.encode()).digest()[:4], "little"
        )
        rng = np.random.default_rng(seed)
        emb = rng.standard_normal((self.text_len, self.dim), dtype=np.float32)
        n_tokens = max(1, min(self.text_len, len(prompt.split()) + 1))
        mask = np.zeros((self.text_len,), dtype=np.int32)
        mask[:n_tokens] = 1
        emb[n_tokens:] = 0.0
        return emb, mask
