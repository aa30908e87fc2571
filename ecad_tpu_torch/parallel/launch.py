"""Start a function in several processes with a process group each, with
a deadline: what the port's tests, `dryrun_multichip` and chip_smoke use
where ``torchrun`` would start the ranks.

`spawn(fn, n, args)` runs ``fn(rank, n, *args)`` in `n` fresh processes
(the ``spawn`` start method), each of which first joins a group through a
``file://`` rendezvous in `init_dir` (no port to collide on) with the
given backend and device. The parent waits at most `timeout_s` seconds:
past that, or as soon as one rank fails, every rank is killed and the call
raises, so a hung collective fails instead of hanging its caller.
"""

from __future__ import annotations

import os
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .distributed import initialize


def _rank_main(rank, fn, world, init_file, backend, device, threads, group_timeout_s, args):
    if threads:
        torch.set_num_threads(threads)
    initialize(backend, device, init_method=f"file://{init_file}", world_size=world,
               rank=rank, timeout_s=group_timeout_s)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args: tuple = (), *, backend: str = "gloo", device: str = "cpu",
          timeout_s: float = 120.0, init_dir: str | os.PathLike | None = None,
          threads: int | None = None) -> None:
    """Run ``fn(rank, nprocs, *args)`` in `nprocs` processes, each in one
    process group (`distributed.initialize` with `backend` and `device`),
    and wait for all of them at most `timeout_s` seconds. `fn` must be
    importable by name (a module-level function). `threads` caps each
    rank's intra-op threads. Raises if a rank raises, exits non-zero or
    outlives the deadline; every rank is stopped before it returns."""
    with tempfile.TemporaryDirectory(dir=init_dir) as tmp:
        init_file = Path(tmp) / "rendezvous"
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, nprocs, str(init_file), backend, device, threads, timeout_s, args),
            nprocs=nprocs, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{nprocs} ranks of {getattr(fn, '__name__', fn)} still running "
                        f"after {timeout_s:.0f} s"
                    )
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
