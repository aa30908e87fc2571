"""Multi-process parallelism of the port: the counterpart of
``ecad_tpu/parallel/`` (`distributed`, `mesh`, `pipeline`), with
`launch.spawn` to start ranks with a deadline and `dryrun_multichip`, the
counterpart of ``__graft_entry__.dryrun_multichip``."""

from .distributed import (
    barrier,
    host_shard,
    initialize,
    is_coordinator,
    process_count,
    process_index,
)
from .dryrun import dryrun_multichip
from .launch import spawn
from .mesh import (
    Mesh,
    batch_sharding,
    create_mesh,
    rank_layout,
    shard_params,
)
from .pipeline import (
    PipelinedPopulationDenoiser,
    PixArtStage,
    TGATEPipelinedDenoiser,
    build_pp_forward,
    create_pp_mesh,
)

__all__ = [
    "Mesh",
    "PipelinedPopulationDenoiser",
    "PixArtStage",
    "TGATEPipelinedDenoiser",
    "barrier",
    "batch_sharding",
    "build_pp_forward",
    "create_mesh",
    "create_pp_mesh",
    "dryrun_multichip",
    "host_shard",
    "initialize",
    "is_coordinator",
    "process_count",
    "process_index",
    "rank_layout",
    "shard_params",
    "spawn",
]
