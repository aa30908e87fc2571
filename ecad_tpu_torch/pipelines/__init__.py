from .flux_pipeline import FluxPipeline, FluxPipelineConfig
from .pixart_pipeline import PixArtPipeline, PixArtPipelineConfig
from .registry import PipelineRegistry, pipeline_from_config
from .samplers import (
    DPMSolverSchedule,
    DPMState,
    FlowMatchSchedule,
    dpm_scan_coeffs,
    dpm_step,
    flow_step,
    make_dpm_schedule,
    make_flow_schedule,
)
from .tgate import PassThroughPixArtPipeline, TGATEPixArtPipeline

__all__ = [
    "FluxPipeline",
    "FluxPipelineConfig",
    "FlowMatchSchedule",
    "flow_step",
    "make_flow_schedule",
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
