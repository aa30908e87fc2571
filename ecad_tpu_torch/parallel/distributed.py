"""Multi-process initialization and work partitioning, in PyTorch.

Counterpart of ``ecad_tpu/parallel/distributed.py`` (`initialize` :35,
`host_shard` :66, `is_coordinator` :78, `barrier` :84). A torch process
usually owns one card, so the port's dp, tp, sp and pp are processes in a
``torch.distributed`` process group, launched by ``torchrun`` (or
`parallel.launch.spawn`):

1. every process calls `initialize`, a no-op for one process and when the
   group exists already, so the same entry point runs on one card or many;
2. meshes from `parallel.mesh.create_mesh` then lay the group's ranks out
   as dp × (sp ×) tp;
3. the pleasingly parallel tiers (candidates, prompt files) take their
   share with `host_shard`, as the reference's do.

The backend is an explicit choice: ``nccl`` on the card with one card a
local rank, ``gloo`` for ``device="cpu"``. Ranks that would share a card
(more local ranks than cards) need ``backend="gloo"`` passed in; without
it `initialize` raises rather than choosing gloo itself.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, TypeVar

import torch
import torch.distributed as dist

T = TypeVar("T")


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _map_reference_env() -> None:
    """Where only the reference's ``JAX_COORDINATOR_ADDRESS`` (host:port),
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` are set, torchrun's
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` take
    their values (and ``LOCAL_RANK`` the rank's: one host)."""
    if "WORLD_SIZE" in os.environ or "JAX_NUM_PROCESSES" not in os.environ:
        return
    os.environ["WORLD_SIZE"] = os.environ["JAX_NUM_PROCESSES"]
    os.environ.setdefault("RANK", os.environ.get("JAX_PROCESS_ID", "0"))
    os.environ.setdefault("LOCAL_RANK", os.environ["RANK"])
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        host, _, port = addr.rpartition(":")
        os.environ.setdefault("MASTER_ADDR", host or "localhost")
        os.environ.setdefault("MASTER_PORT", port)


def initialize(
    backend: Optional[str] = None,
    device: str = "cuda",
    *,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: float = 300.0,
) -> None:
    """Bring up the process group when more than one process runs; a
    documented no-op otherwise, and when the group exists already.

    `world_size` and `rank` default from torchrun's ``WORLD_SIZE`` and
    ``RANK`` (``LOCAL_RANK`` picks the card, ``MASTER_ADDR`` /
    ``MASTER_PORT`` the rendezvous of the default ``env://`` method), or
    from the reference's ``JAX_*`` variables where only those are set.
    `backend` defaults to ``nccl`` on the card, each local rank on a card
    of its own, and to ``gloo`` for ``device="cpu"``; where the local ranks
    outnumber the cards, a backend must be given (``gloo``: NCCL takes one
    rank a card). `timeout_s` bounds every collective of the group, so a
    rank that dies fails the others instead of hanging them."""
    if dist.is_initialized():
        return
    _map_reference_env()
    world = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if (world or 1) == 1 and init_method is None:
        return  # one process: nothing to initialize
    rank = rank if rank is not None else (_env_int("RANK") or 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError(
                "ecad_tpu_torch.parallel.initialize: device='cuda' but no card is "
                "visible; pass device='cpu' for gloo ranks on the CPU"
            )
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
        local_world = _env_int("LOCAL_WORLD_SIZE") or world
        if backend is None:
            if local_world > cards:
                raise ValueError(
                    f"{local_world} local ranks would share {cards} card(s): NCCL "
                    "takes one rank a card, so pass backend='gloo' to run them on "
                    "shared cards"
                )
            backend = "nccl"
        torch.cuda.set_device(local_rank % cards)
        torch.cuda.init()
    elif dev.type == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def host_shard(items: Sequence[T]) -> list[T]:
    """This process's slice of a pleasingly parallel work list (candidates,
    prompt files), strided by rank so any length divides up to one item a
    process: ``items[rank::world]``, as the reference's (:66-75)."""
    return list(items[process_index() :: process_count()])


def is_coordinator() -> bool:
    """True on the process that writes shared artifacts (configs,
    checkpoints) when the file system is shared."""
    return process_index() == 0


def barrier(name: str = "") -> None:
    """Block until every process reaches this point (no-op for one
    process). `name` labels the point, as the reference's
    ``sync_global_devices(name)`` does."""
    if process_count() == 1:
        return
    dist.barrier()
