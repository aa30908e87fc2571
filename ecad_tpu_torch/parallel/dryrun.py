"""`dryrun_multichip(n)`: one population-evaluation step on n ranks, the
port's counterpart of ``__graft_entry__.dryrun_multichip``.

    python -c "from ecad_tpu_torch.parallel import dryrun_multichip; dryrun_multichip(2)"

dp over the (candidate × prompt) batch, tp=2 over heads and MLP width
(where n is even), at the tiny PixArt shapes: one candidate evaluated
cooperatively by `genetic.evaluate.CandidateEvaluator` on a mesh over the
n ranks (fidelity scorer). With n cards visible the ranks run on them, one
card each, over NCCL; with fewer, the ranks run on the CPU over gloo — an
explicit branch that says so on stderr, as the reference re-executes on a
virtual CPU mesh when fewer devices are visible.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .launch import spawn

STEPS = 4


def _dryrun_rank(rank: int, world: int, device: str) -> None:
    from ..genetic.evaluate import CandidateEvaluator, EvalConfig
    from ..models.pixart import PixArtConfig, init_model
    from ..pipelines import PixArtPipeline, PixArtPipelineConfig
    from ..schedules import PixArtCacheSchedule
    from .mesh import create_mesh

    tp = 2 if world % 2 == 0 else 1
    mesh = create_mesh(dp=world // tp, tp=tp)
    config = PixArtConfig.tiny(num_heads=4, head_dim=16)
    pipe = PixArtPipeline(PixArtPipelineConfig(model=config, num_inference_steps=STEPS),
                          init_model(config, 0, device, mesh=mesh))
    rng = np.random.default_rng(0)
    sched = PixArtCacheSchedule.from_numpy(
        rng.random(STEPS * config.num_blocks * 3) < 0.5, STEPS, config.num_blocks,
        name="dryrun",
    )
    n_prompts = mesh.size("dp") * 2  # a couple of work items per dp rank
    gen = torch.Generator(device=device).manual_seed(0)
    text, neg = (torch.randn((n_prompts, config.text_len, config.caption_dim), generator=gen,
                             device=device).to(config.dtype) for _ in range(2))
    evaluator = CandidateEvaluator(
        pipe, text, neg, [f"p{i}" for i in range(n_prompts)],
        EvalConfig(scorer="fidelity", return_images=False), mesh=mesh,
    )
    scores, _ = evaluator.evaluate_candidate(sched)
    if not np.isfinite(scores["total_score"]):
        raise RuntimeError(f"dryrun_multichip: score {scores['total_score']}")
    if rank == 0:
        print(f"dryrun_multichip OK: {world} ranks on {device}, mesh dp={mesh.size('dp')} "
              f"tp={mesh.size('tp')}, {n_prompts} prompts, total_score "
              f"{scores['total_score']:.4f}, collectives {dict(mesh.calls)}", flush=True)


def dryrun_multichip(n_devices: int, timeout_s: float = 300.0) -> None:
    """Run `_dryrun_rank` on `n_devices` ranks (module docstring); raises if
    a rank fails or outlives `timeout_s`."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards >= n_devices:
        backend, device = "nccl", "cuda"
    else:
        print(f"dryrun_multichip: {cards} card(s) visible for {n_devices} ranks: running "
              f"{n_devices} gloo ranks on the CPU", file=sys.stderr, flush=True)
        backend, device = "gloo", "cpu"
    spawn(_dryrun_rank, n_devices, (device,), backend=backend, device=device,
          timeout_s=timeout_s)
