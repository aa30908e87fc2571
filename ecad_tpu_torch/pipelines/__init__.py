from .pixart_pipeline import PixArtPipeline, PixArtPipelineConfig
from .registry import PipelineRegistry, pipeline_from_config
from .samplers import (
    DPMSolverSchedule,
    DPMState,
    dpm_scan_coeffs,
    dpm_step,
    make_dpm_schedule,
)
from .tgate import PassThroughPixArtPipeline, TGATEPixArtPipeline

__all__ = [
    "PixArtPipeline",
    "PixArtPipelineConfig",
    "TGATEPixArtPipeline",
    "PassThroughPixArtPipeline",
    "PipelineRegistry",
    "pipeline_from_config",
    "DPMSolverSchedule",
    "DPMState",
    "dpm_scan_coeffs",
    "dpm_step",
    "make_dpm_schedule",
]
