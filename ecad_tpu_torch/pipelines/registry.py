"""Pipeline registry: name → pipeline class (the port's counterpart of
``ecad_tpu/pipelines/registry.py``).

Reference: ecad/pipelines/load_pipeline.py:16-58 — {pixart_alpha,
pixart_sigma, tgate, flux, pass_through}, with per-schedule pipeline kwargs
closed over at construction (the schedule JSON's config.pipeline entry)."""

from __future__ import annotations

from typing import Any

from ..registry import Registry
from .flux_pipeline import FluxPipeline
from .pixart_pipeline import PixArtPipeline
from .tgate import PassThroughPixArtPipeline, TGATEPixArtPipeline

PipelineRegistry: Registry = Registry("pipeline", default="pixart_alpha")
PipelineRegistry.register(PixArtPipeline, name="pixart_alpha")
PipelineRegistry.register(PixArtPipeline, name="pixart_sigma")
PipelineRegistry.register(TGATEPixArtPipeline, name="tgate")
PipelineRegistry.register(FluxPipeline, name="flux")
PipelineRegistry.register(PassThroughPixArtPipeline, name="pass_through")


def pipeline_from_config(
    name: str | None, pipeline_kwargs: dict[str, Any] | None = None
):
    """Returns (cls, kwargs) resolved from a schedule's pipeline config
    (load_pipeline.py:44-58)."""
    cls = PipelineRegistry.get(name)
    return cls, dict(pipeline_kwargs or {})
