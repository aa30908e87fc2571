"""`dryrun_multichip(n)`: one population-evaluation step on n ranks, the
port's counterpart of ``__graft_entry__.dryrun_multichip``.

    python -c "from ecad_tpu_torch.parallel import dryrun_multichip; dryrun_multichip(2)"

dp over the (candidate × prompt) batch, tp=2 over heads and MLP width
(where n is even), at the tiny PixArt shapes: one candidate evaluated
cooperatively by `genetic.evaluate.CandidateEvaluator` on a mesh over the
n ranks (fidelity scorer). It runs on the card by default: with n cards visible
the ranks take one each, over NCCL; with fewer, the n ranks share the
visible cards over gloo (as chip_smoke.py's two ranks share its one card).
With no card it raises; the ranks run on the CPU over gloo only when the
caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

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


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout_s: float = 300.0) -> None:
    """Run `_dryrun_rank` on `n_devices` ranks (module docstring) on
    `device`: ``cuda`` (NCCL where `n_devices` cards are visible, else gloo
    ranks sharing them; RuntimeError before any rank starts when no card is
    visible) or ``cpu`` (gloo). Raises if a rank fails or outlives
    `timeout_s`."""
    if device == "cpu":
        backend = "gloo"
    elif device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards == 0:
            raise RuntimeError("dryrun_multichip: device='cuda' but no card is visible; "
                               "pass device='cpu' to run the ranks on the CPU")
        backend = "nccl" if cards >= n_devices else "gloo"
    else:
        raise ValueError(f"dryrun_multichip: device must be 'cuda' or 'cpu'; got {device!r}")
    spawn(_dryrun_rank, n_devices, (device,), backend=backend, device=device,
          timeout_s=timeout_s)
