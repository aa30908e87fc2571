"""ImageGenerator — the port's main object-oriented surface.

Counterpart of ``ecad_tpu/image_generators/base.py``: encode_prompts,
encode_and_save_prompts, generate_images, and the entry points the benchmark
tier calls (`set_schedule`, `generate_from_saved_prompts`,
`generate_images_timed`, `time_image_generation`, `decode_latents_device`
with `use_random_vae`). Generators run on ``cuda`` unless constructed with
``device="cpu"``; without a GPU and without that request construction
raises.

Weights resolve from a local checkpoint tree (``weights_root/<repo>/…`` in
the HuggingFace layout: the transformer, the text encoders and the VAE, read
by `models.weights`); with ``random_weights=True``, or without a
``weights_root``, the exact architecture runs with seeded random parameters,
prompts go through a hash encoder and images are the latent visualisation.
Either way the transformer is built on the meta device and then takes its
weights in ``config.dtype`` on the device. FLUX generators take
``cache_dtype="float8_e4m3fn"``; the others reject it. ``quant`` picks a
serving quantization mode of the transformer's block projections
(``ops/quant.py``); the static modes calibrate their activation scales
when the resident model is built (`_calibrate_static_scales`). A schedule JSON
carries a cache schedule or a DiT topology schedule (``dit_schedule``),
plus the config that picks the checkpoint, resolution and pipeline (with
its kwargs, e.g. TGATE's ``gate_step``). The reference's two execution
modes ("unrolled", "stepwise") have no counterpart here: the port runs
one eager step loop.
"""

from __future__ import annotations

import dataclasses
import json
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..models.common import rebuild
from ..ops.quant import STATIC_MODES
from ..schedules.cache_schedule import CacheSchedule
from ..utils.io import load_embedding_dir, save_embedding
from ..utils.timing import wall_ms


class ImageGenerator(ABC):
    default_transformer_weights: str = ""
    default_pipeline_weights: str = ""
    default_pipeline: str = ""
    num_blocks: int = 28
    default_num_inference_steps: int = 20
    height: int = 256
    width: int = 256
    guidance_scale: float = 4.5

    schedule_cls: type[CacheSchedule] = CacheSchedule
    supports_cache_dtype = False  # FLUX generators opt in
    vae_latent_channels = 4  # the autoencoder `use_random_vae` builds

    def __init__(
        self,
        start_seed: int = 0,
        seed_step: int = 1,
        schedule_path: Optional[Path | str] = None,
        weights_root: Optional[Path | str] = None,
        random_weights: bool = False,
        num_inference_steps: Optional[int] = None,
        batch_size: int = 8,
        device: str | torch.device = "cuda",
        cache_dtype: Optional[str] = None,
        quant: Optional[str] = None,
    ) -> None:
        self.device = resolve_device(device)
        # None | "int8" | "int8_static" | "int8_w" | "int8_w_static":
        # serving quantization of the transformer's block projections,
        # threaded into model_config()
        self.quant = quant
        # None | "float8_e4m3fn": storage dtype of the cached activations
        # (FLUX only, as in the reference)
        if cache_dtype is not None and not self.supports_cache_dtype:
            raise ValueError(
                "cache_dtype is a FLUX option (models/flux.py); "
                f"{type(self).__name__} stores caches in the compute dtype"
            )
        self.cache_dtype = cache_dtype
        self.start_seed = start_seed
        self.seed_step = seed_step
        self.weights_root = Path(weights_root) if weights_root else None
        self.random_weights = random_weights
        self.batch_size = batch_size
        self.num_inference_steps = (
            num_inference_steps or self.default_num_inference_steps
        )

        self.transformer_weights = self.default_transformer_weights
        self.pipeline_weights = self.default_pipeline_weights
        self.pipeline_name = self.default_pipeline
        self.pipeline_kwargs: dict[str, Any] = {}

        self.dit_schedule = None
        self.cache_schedule = self._load_schedule_file(schedule_path)
        self._encoder = None
        self._pipeline = None
        self._model = None  # transformer, built once per generator
        self._model_key = None  # the config (and checkpoint) `_model` was built for
        self._vae = None  # VAE decoder pipeline, built once per generator
        # decode through a random-weight VAE so the latency protocol carries
        # the real decode cost without checkpoints (compute_latency
        # --random-vae)
        self.use_random_vae = False

    def set_schedule(self, schedule_path) -> None:
        """Point a resident generator at another schedule file, honoring
        everything the schedule JSON carries (what its config leaves out
        takes the class default, as in a generator built on the file, where
        the reference keeps the previous file's). When only the recompute
        masks changed the pipeline swaps them in place; otherwise it is rebuilt
        around the resident model on the next generation (the model itself
        is rebuilt only if the schedule asks for another architecture)."""
        def pipeline_key():
            return (self.num_inference_steps, self.pipeline_name,
                    json.dumps(self.pipeline_kwargs, sort_keys=True), self.height,
                    self.width, self.guidance_scale, self.transformer_weights,
                    self.quant)

        old = pipeline_key()
        cls = type(self)
        self.transformer_weights = cls.default_transformer_weights
        self.pipeline_weights = cls.default_pipeline_weights
        self.pipeline_name = cls.default_pipeline
        self.pipeline_kwargs = {}
        self.height, self.width = cls.height, cls.width
        self.guidance_scale = cls.guidance_scale
        self.dit_schedule = None
        self.cache_schedule = self._load_schedule_file(schedule_path)
        pipe = self._pipeline
        if pipe is not None and pipeline_key() == old and self.dit_schedule is None:
            pipe.set_schedule(self.cache_schedule)
            return
        self._pipeline = None

    def loads_weights(self) -> bool:
        """Whether this generator serves the checkpoint tree under
        `weights_root` (else seeded random weights)."""
        return not self.random_weights and self.weights_root is not None

    def _pipeline_repo(self) -> str:
        """The repo whose text encoder and VAE the generator loads."""
        return self.pipeline_weights or self.transformer_weights

    def _resident_model(self, config, init_model, load_state=None):
        """The transformer for `config`: the resident one when it was built
        for the same config (and checkpoint), else a fresh one, built on the
        meta device, that takes `load_state()`, a loaded state_dict, when
        the generator serves a checkpoint, else seeded random weights. In a
        static quant mode the model carries the calibration table (its
        ``config.act_scales``) that `_calibrate_static_scales` measures on
        it when it is built."""
        key = (config, self.transformer_weights if self.loads_weights() else None)
        if self._model is None or self._model_key != key:
            self._model = None  # free the old one before building the next
            state = load_state() if self.loads_weights() else None
            model = init_model(config, 0, self.device, state=state)
            del state
            if config.quant in STATIC_MODES and config.act_scales is None:
                table = self._calibrate_static_scales(model)
                model = rebuild(model, dataclasses.replace(config, act_scales=table))
            self._model, self._model_key = model, key
        return self._model

    def _calibrate_static_scales(self, model) -> tuple:
        """The static quant modes' calibration table for `model`."""
        raise NotImplementedError(f"{type(self).__name__} has no static quant modes")

    # -- schedule / config resolution -------------------------------------

    def _load_schedule_file(
        self, schedule_path: Optional[Path | str]
    ) -> CacheSchedule:
        """Load the cache schedule (default all-recompute when None) and
        apply its embedded config overrides (reference
        image_generator.py:99-191). A JSON with a ``dit_schedule`` is a
        topology schedule: the cache schedule is then the default."""
        if schedule_path is None:
            sched = self._default_schedule()
        else:
            with open(schedule_path) as f:
                raw = json.load(f)
            if "dit_schedule" in raw:
                from ..graph import DiTSchedule

                self.dit_schedule = DiTSchedule.from_dict(raw)
                self.num_inference_steps = self.dit_schedule.num_inference_steps
                sched = self._default_schedule()
                sched.top_level_config = self.dit_schedule.top_level_config
            else:
                sched = self.schedule_cls.from_dict(raw)
                self.num_inference_steps = sched.num_inference_steps
        cfg = sched.top_level_config or {}
        self.transformer_weights = cfg.get(
            "transformer_weights", self.transformer_weights
        )
        self.pipeline_weights = cfg.get("pipeline_weights", self.pipeline_weights)
        pipe = cfg.get("pipeline") or {}
        if pipe:
            self.pipeline_name = pipe.get("name", self.pipeline_name)
            self.pipeline_kwargs = pipe.get("kwargs", {})
        self.height = cfg.get("height", self.height)
        self.width = cfg.get("width", self.width)
        if type(self).allow_guidance_override():
            self.guidance_scale = cfg.get("guidance_scale", self.guidance_scale)
        return sched

    @classmethod
    def allow_guidance_override(cls) -> bool:
        # PixArt fixes guidance at 4.5 (reference inference.py:210-215)
        return False

    def _default_schedule(self) -> CacheSchedule:
        return self.schedule_cls.default(
            num_inference_steps=self.num_inference_steps,
            num_blocks=self.num_blocks,
        )

    # -- abstract construction --------------------------------------------

    @abstractmethod
    def create_encoder_pipeline(self):
        """Text-encoder stack."""

    @abstractmethod
    def create_diffusion_pipeline(self):
        """Denoising pipeline for the loaded schedule."""

    @abstractmethod
    def encode_prompts(self, prompts: Sequence[str]) -> list[dict[str, Any]]:
        """Prompt strings → embedding dicts (reference embedding keys)."""

    @abstractmethod
    def _generate_latents(
        self, embeddings: list[dict[str, Any]], seed: int
    ) -> torch.Tensor:
        """One batch of final latents for the given embeddings and seed."""

    def decode_latents(self, latents) -> np.ndarray:
        """Latents → (N, H, W, 3) uint8 images on the host: through the
        checkpoint's VAE, else the latent visualization (also with
        `use_random_vae`: a random-weight VAE adds the decode's cost, not an
        image), as in the reference."""
        vae = self._ensure_vae()
        if vae is not None and not self.use_random_vae:
            return vae.decode(latents)
        from ..genetic.evaluate import latents_to_uint8

        return latents_to_uint8(latents)

    def _stack(self, embeddings, key: str, dtype=None) -> torch.Tensor:
        """One embedding field of a batch, stacked on the generator's device
        (fields held as tensors are stacked where they lie)."""
        vals = [e[key] for e in embeddings]
        if isinstance(vals[0], torch.Tensor):
            arr = torch.stack(vals)
        else:
            arr = torch.from_numpy(np.stack([np.asarray(v) for v in vals]))
        return arr.to(device=self.device, dtype=dtype)

    # -- embedding round trip ----------------------------------------------

    def encode_and_save_prompts(
        self,
        prompts: Sequence[str],
        output_dir: Path | str,
        names: Optional[Sequence[str]] = None,
        fmt: str = ".pt",
    ) -> list[Path]:
        output_dir = Path(output_dir)
        embeddings = self.encode_prompts(prompts)
        paths = []
        for i, emb in enumerate(embeddings):
            name = names[i] if names else f"{i:03d}__prompt_seed:{self.start_seed:03}"
            paths.append(save_embedding(output_dir / f"{name}{fmt}", emb))
        return paths

    # -- generation ---------------------------------------------------------

    def generate_images(
        self,
        embeddings: list[dict[str, Any]],
        images_per_prompt: int = 1,
        output_dir: Optional[Path | str] = None,
    ) -> list[np.ndarray]:
        """images_per_prompt images per embedding; seeds follow the
        reference protocol seed_i = start_seed + i·seed_step. Saved as
        `<name>__image_seed:NNN.png` under rel_path subdirs."""
        from PIL import Image

        all_images = []
        for i in range(images_per_prompt):
            seed = self.start_seed + i * self.seed_step
            latents = self._generate_latents(embeddings, seed)
            images = self.decode_latents(latents)
            for emb, img in zip(embeddings, images):
                all_images.append(img)
                if output_dir is not None:
                    rel = Path(emb.get("relative_path", f"{emb['name']}.x")).parent
                    out = (
                        Path(output_dir)
                        / rel
                        / f"{emb['name']}__image_seed:{seed:03}.png"
                    )
                    out.parent.mkdir(parents=True, exist_ok=True)
                    Image.fromarray(img).save(out)
        return all_images

    def generate_from_saved_prompts(
        self,
        input_dir: Path | str,
        output_dir: Path | str,
        images_per_prompt: int = 1,
        batch_size: Optional[int] = None,
    ) -> int:
        """Batched generation over an embeddings directory
        (image_generator.py:366-421)."""
        entries = load_embedding_dir(input_dir)
        bs = batch_size or self.batch_size
        count = 0
        for lo in range(0, len(entries), bs):
            batch = entries[lo : lo + bs]
            imgs = self.generate_images(batch, images_per_prompt, output_dir)
            count += len(imgs)
        return count

    # -- timing -------------------------------------------------------------

    def _ensure_vae(self):
        """The checkpoint's VAE (fp32, ``<pipeline repo>/vae``) when the
        generator serves a checkpoint, else the random-weight VAE when
        `use_random_vae` is set, else None."""
        if self._vae is None and self.loads_weights():
            from ..models.vae import VAEDecoderPipeline

            self._vae = VAEDecoderPipeline.from_weights(
                self.weights_root, self._pipeline_repo(), self.vae_latent_channels,
                self.device,
            )
        elif self._vae is None and self.use_random_vae:
            from ..models.vae import random_decoder_pipeline

            self._vae = random_decoder_pipeline(self.vae_latent_channels, self.device)
        return self._vae

    def decode_latents_device(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents → uint8 images, left on the device: through the VAE when
        one is attached (the checkpoint's, or `use_random_vae`), else the
        weight-free latent visualization (`latents_to_uint8` without the
        host copy)."""
        vae = self._ensure_vae()
        if vae is not None:
            return vae.decode_device(latents)
        x = torch.clamp(latents[..., :3].float() / 4.0 + 0.5, 0, 1)
        return (x * 255).to(torch.uint8)

    def generate_images_timed(
        self, embeddings: list[dict[str, Any]], seed: int = 0
    ) -> float:
        """Wall-clock ms of one batch: the reference's timed region (the
        full pipeline __call__, image_generator.py:442-487), denoise and
        decode to uint8 pixels, ending at a device sync. The images stay on
        the device: nothing in the region copies them to the host. Timed by
        `wall_ms`: CUDA events from an idle device to a host sync, or
        perf_counter on the CPU."""
        return wall_ms(
            lambda: self.decode_latents_device(self._generate_latents(embeddings, seed)),
            self.device,
        )

    def time_image_generation(
        self,
        input_dir: Path | str,
        warmup_steps: int = 10,
        num_samples: int = 5,
        batch_size: Optional[int] = None,
    ) -> dict[str, Any]:
        """Latency protocol of compute_latency.py:52-85: warmups, then timed
        sample batches, per-image ms; the result is metrics.latency."""
        entries = load_embedding_dir(input_dir)
        bs = batch_size or self.batch_size
        batch = (entries * ((bs // max(len(entries), 1)) + 1))[:bs]
        warmups = [
            self.generate_images_timed(batch, seed=s) for s in range(warmup_steps)
        ]
        latencies = [
            self.generate_images_timed(batch, seed=s) for s in range(num_samples)
        ]
        per_image = [t / len(batch) for t in latencies]
        return {
            "avg": float(np.mean(per_image)),
            "batch_size": len(batch),
            "num_samples": num_samples,
            "warmup_steps": warmup_steps,
            "gpu": (torch.cuda.get_device_name(self.device)
                    if self.device.type == "cuda" else "cpu"),
            "warmups": [t / len(batch) for t in warmups],
            "latencies": per_image,
        }

    # -- misc ---------------------------------------------------------------

    def describe(self) -> dict[str, Any]:
        return {
            "class": type(self).__name__,
            "schedule": self.cache_schedule.name,
            "num_inference_steps": self.num_inference_steps,
            "transformer_weights": self.transformer_weights,
            "pipeline": self.pipeline_name,
            "height": self.height,
            "width": self.width,
            "guidance_scale": self.guidance_scale,
            "random_weights": self.random_weights,
            "cache_dtype": self.cache_dtype,
            "quant": self.quant,
            "device": str(self.device),
        }
