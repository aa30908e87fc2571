from .pixart_pipeline import PixArtPipeline, PixArtPipelineConfig
from .samplers import (
    DPMSolverSchedule,
    DPMState,
    dpm_scan_coeffs,
    dpm_step,
    make_dpm_schedule,
)

__all__ = [
    "PixArtPipeline",
    "PixArtPipelineConfig",
    "DPMSolverSchedule",
    "DPMState",
    "dpm_scan_coeffs",
    "dpm_step",
    "make_dpm_schedule",
]
