"""FLUX.1-dev image generators (full width and the tiny test double).

Counterpart of ``ecad_tpu/image_generators/flux.py`` (reference:
ecad/image_generators/flux_image_generator.py): defaults 19+38 blocks, 20
steps, 256², guidance 5, with height, width and guidance taken from the
schedule's config. Embeddings are {prompt_embeds, pooled_prompt_embeds}.
With a `weights_root` (and not `random_weights`) everything comes from
``<transformer repo>`` (ref :62-95, :207-236): the transformer from
``transformer/``, the 16-channel VAE from ``vae/``, CLIP-L's pooled
embedding from ``text_encoder/`` and ``tokenizer/``, and T5-XXL from
``text_encoder_2/`` and ``tokenizer_2/`` (FLUX.1-dev's public layout) where
that directory exists, else from ``text_encoder/`` and ``tokenizer/``,
where the reference reads it. Without weights the exact architecture runs
with seeded random bf16 parameters built on the device, and prompts go
through `_FluxHashEncoder`, which gives the same bytes as the reference's.
``cache_dtype="float8_e4m3fn"`` stores the caches in fp8.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Sequence

import numpy as np
import torch

from ..models.common import rebuild
from ..models.flux import FluxConfig, full_flux_mask, init_model
from ..models.weights import load_flux_params
from ..ops.quant import calibrate_dense_amax, merge_amax
from ..pipelines.flux_pipeline import FluxPipeline, FluxPipelineConfig
from ..schedules.flux import FluxCacheSchedule
from .base import ImageGenerator

_CACHE_DTYPES = {"float8_e4m3fn": torch.float8_e4m3fn}


class FluxImageGenerator(ImageGenerator):
    schedule_cls = FluxCacheSchedule
    supports_cache_dtype = True
    default_transformer_weights = "black-forest-labs/FLUX.1-dev"
    default_pipeline_weights = "black-forest-labs/FLUX.1-dev"
    default_pipeline = "flux"
    num_blocks = 19
    num_single_blocks = 38
    vae_latent_channels = 16
    guidance_scale = 5.0
    text_len = 512
    joint_dim = 4096
    pooled_dim = 768

    @classmethod
    def allow_guidance_override(cls) -> bool:
        return True  # flux guidance is a per-schedule config value

    def _default_schedule(self) -> FluxCacheSchedule:
        return FluxCacheSchedule.default(
            num_inference_steps=self.num_inference_steps,
            num_blocks=self.num_blocks,
            num_single_blocks=self.num_single_blocks,
            top_level_config={
                "height": self.height,
                "width": self.width,
                "guidance_scale": self.guidance_scale,
            },
        )

    def _cache_torch_dtype(self):
        if self.cache_dtype is None:
            return None
        if self.cache_dtype not in _CACHE_DTYPES:
            raise ValueError(
                f"cache_dtype {self.cache_dtype!r} is not one of {list(_CACHE_DTYPES)}"
            )
        return _CACHE_DTYPES[self.cache_dtype]

    def model_config(self) -> FluxConfig:
        return FluxConfig(quant=self.quant, cache_dtype=self._cache_torch_dtype())

    def create_encoder_pipeline(self):
        if self._encoder is not None:
            return self._encoder
        if not self.loads_weights():
            self._encoder = _FluxHashEncoder(self.text_len, self.joint_dim, self.pooled_dim)
            return self._encoder
        from ..models.clip import CLIPTextPipeline
        from ..models.t5 import T5EncoderPipeline

        repo = self.transformer_weights
        public = (self.weights_root / repo / "text_encoder_2").is_dir()
        self._encoder = _FluxRealEncoder(
            T5EncoderPipeline.from_weights(
                self.weights_root, repo, max_length=self.text_len, device=self.device,
                encoder_dir="text_encoder_2" if public else "text_encoder",
                tokenizer_dir="tokenizer_2" if public else "tokenizer",
            ),
            CLIPTextPipeline.from_weights(self.weights_root, repo, device=self.device),
        )
        return self._encoder

    def _pipeline_repo(self) -> str:
        return self.transformer_weights  # the VAE too comes from it (ref :207-218)

    def create_diffusion_pipeline(self) -> FluxPipeline:
        if self._pipeline is not None:
            return self._pipeline
        config = self.model_config()
        model = self._resident_model(config, init_model, lambda: load_flux_params(
            self.weights_root, self.transformer_weights, config))
        pcfg = FluxPipelineConfig(
            model=model.config,
            num_inference_steps=self.num_inference_steps,
            guidance_scale=self.guidance_scale,
            height=self.height,
            width=self.width,
        )
        self._pipeline = FluxPipeline(pcfg, model, self.cache_schedule)
        return self._pipeline

    @torch.inference_mode()
    def _calibrate_static_scales(self, model) -> tuple:
        """The static quant modes' activation max-abs table (ref
        ``image_generators/flux.py:95-176``): one forward of every block at
        σ 1.0, 0.5 and 0.05 at the generator's size and guidance, on the
        encoder's embeddings (and pooled embeddings) of "" and "a detailed
        photograph", from seeded noise. ``int8_static`` calibrates the float
        model on `model`'s weights, ``int8_w_static`` the ``int8_w`` one."""
        c = model.config
        base = rebuild(model, dataclasses.replace(
            c, quant="int8_w" if c.quant == "int8_w_static" else None, act_scales=None))
        enc = self.create_encoder_pipeline()
        pairs = [enc.encode(p) for p in ("", "a detailed photograph")]
        txt = torch.from_numpy(np.stack([e for e, _ in pairs])).to(self.device, c.dtype)
        pooled = torch.from_numpy(np.stack([p for _, p in pairs])).to(self.device, c.dtype)
        b = txt.shape[0]
        gh, gw = self.height // 16, self.width // 16
        gen = torch.Generator(device=self.device).manual_seed(0)
        noise = torch.randn((b, gh * gw, c.in_channels), generator=gen,
                            device=self.device).to(c.dtype)
        guidance = torch.full((b,), self.guidance_scale, device=self.device)
        table = merge_amax(*(
            calibrate_dense_amax(base, noise, txt, pooled, torch.full((b,), t, device=self.device),
                                 guidance, {}, full_flux_mask(c), (gh, gw))
            for t in (1.0, 0.5, 0.05)
        ))
        return tuple(sorted(table.items()))

    def encode_prompts(self, prompts: Sequence[str]) -> list[dict[str, Any]]:
        enc = self.create_encoder_pipeline()
        out = []
        for i, p in enumerate(prompts):
            embeds, pooled = enc.encode(p)
            out.append(
                {
                    "name": f"{i:03d}__prompt_seed:{self.start_seed:03}",
                    "prompt_embeds": embeds,
                    "pooled_prompt_embeds": pooled,
                }
            )
        return out

    def _generate_latents(
        self, embeddings: list[dict[str, Any]], seed: int
    ) -> torch.Tensor:
        pipe = self.create_diffusion_pipeline()
        dtype = pipe.config.model.dtype
        return pipe.generate_latents(
            self._stack(embeddings, "prompt_embeds", dtype),
            self._stack(embeddings, "pooled_prompt_embeds", dtype),
            seed=seed,
        )


class TinyFluxImageGenerator(FluxImageGenerator):
    """Tiny FLUX test double (2+3 blocks, 32×32 images, fp32, always random
    weights)."""

    num_blocks = 2
    num_single_blocks = 3
    # its latents have 4 channels (16 packed 2×2), which the random VAE
    # decodes; the reference builds the 16-channel one and fails on them
    vae_latent_channels = 4
    default_num_inference_steps = 4
    text_len = 8
    joint_dim = 32
    pooled_dim = 24
    height = 32
    width = 32

    def __init__(self, *args, **kwargs):
        kwargs["random_weights"] = True
        super().__init__(*args, **kwargs)

    def model_config(self) -> FluxConfig:
        return FluxConfig.tiny(dtype=torch.float32, quant=self.quant,
                               cache_dtype=self._cache_torch_dtype())

    def _load_schedule_file(self, schedule_path):
        sched = super()._load_schedule_file(schedule_path)
        if sched.num_blocks != self.num_blocks:
            raise ValueError(
                f"schedule has {sched.num_blocks} blocks; tiny flux has "
                f"{self.num_blocks}"
            )
        return sched


class _FluxHashEncoder:
    """Deterministic stand-in for the CLIP+T5 encoder stack: the same bytes
    as the reference's ``_FluxHashEncoder``."""

    def __init__(self, text_len: int, joint_dim: int, pooled_dim: int):
        self.text_len = text_len
        self.joint_dim = joint_dim
        self.pooled_dim = pooled_dim

    def encode(self, prompt: str) -> tuple[np.ndarray, np.ndarray]:
        seed = int.from_bytes(hashlib.sha256(prompt.encode()).digest()[:4], "little")
        rng = np.random.default_rng(seed)
        emb = rng.standard_normal((self.text_len, self.joint_dim), dtype=np.float32)
        pooled = rng.standard_normal((self.pooled_dim,), dtype=np.float32)
        return emb, pooled


class _FluxRealEncoder:
    """T5-XXL's embeddings and CLIP-L's pooled embedding of one prompt."""

    def __init__(self, t5, clip):
        self.t5 = t5
        self.clip = clip

    def encode(self, prompt: str) -> tuple[np.ndarray, np.ndarray]:
        embeds, _mask = self.t5.encode(prompt)
        return embeds, self.clip.encode_pooled(prompt)
