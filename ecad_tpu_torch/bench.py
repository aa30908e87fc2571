"""Headline benchmark of the port: PixArt-α 256² under the paper's
``ours_fast`` schedule against the uncached default, batch 32, on one GPU.

    python -m ecad_tpu_torch.bench [--turns 5] [--warmup 2] [--batch 32]
    python -m ecad_tpu_torch.bench --device cpu --tiny   # the tiny model

The counterpart of the JAX package's root ``bench.py`` (the same model,
schedule, batch, seeded bf16 random weights, random-weight VAE and no text
mask): each timed run is the full pipeline, 20 DPM-Solver++ steps with CFG
then the VAE decode to uint8 pixels on the device (the reference times
pipeline.__call__, compute_latency.py:52-85). One resident
`PixArtAlphaImageGenerator` serves both arms, each swapped in through
`set_schedule`; a run is its `generate_images_timed` (CUDA events from an
idle device to a host sync). The arms run in turns (uncached, cached,
uncached, cached, ...) after the warmups, so that both see the same card
and host.

Prints one JSON line: ``metric``, ``value`` (the ratio of the arms' median
ms/img), ``unit``, ``vs_baseline`` (value over the reference's 165.74 /
84.09 ms on an RTX A6000) and ``detail`` (each arm's median ms/img and its
range over the turns, the per-turn ratios, the batch, the card's name and
power limit, peak device memory). ``--tiny`` (CPU tests) runs the tiny
generator with a 2-block cached schedule.
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile
from pathlib import Path

import torch

from . import resolve_device

REF_MS = {"uncached": 165.74, "cached": 84.09}  # the reference, RTX A6000
REF_SPEEDUP = REF_MS["uncached"] / REF_MS["cached"]
OURS_FAST = (
    Path(__file__).resolve().parent.parent
    / "schedules/schedules_in_paper/pixart_alpha_256/ours_fast.json"
)
BATCH = 32
WARMUP = 2
TURNS = 5
ARMS = ("uncached", "cached")


def build(device, tiny: bool = False, batch: int = BATCH, seed: int = 0):
    """(generator, embeddings): one resident generator with the random VAE
    attached (full-width PixArt-α 256², 28 blocks, d=1152, bf16 random
    weights, the random SD VAE; with ``tiny`` the 2-block fp32 model, 4
    steps) and a batch of seeded random prompt embeddings on the device,
    with no text mask, as the reference bench passes none."""
    from .image_generators import PixArtAlphaImageGenerator, TinyPixArtImageGenerator

    cls = TinyPixArtImageGenerator if tiny else PixArtAlphaImageGenerator
    gen = cls(random_weights=True, batch_size=batch, device=device)
    gen.use_random_vae = True
    rng = torch.Generator(device=gen.device).manual_seed(seed)
    shape = (batch, cls.text_len, cls.caption_dim)
    dtype = gen.model_config().dtype
    text, neg = (torch.randn(shape, generator=rng, device=gen.device).to(dtype)
                 for _ in range(2))
    embeddings = [{"prompt_embeds": t, "negative_prompt_embeds": n}
                  for t, n in zip(text, neg)]
    return gen, embeddings


def arms(tiny: bool = False, tmp: Path | str | None = None) -> dict:
    """{arm name: its schedule file, None for the uncached default}. The
    tiny model's cached arm is `recompute_all_every_002`, written into
    `tmp`."""
    if not tiny:
        return {"uncached": None, "cached": OURS_FAST}
    from .schedules.generators.pixart_cache import gen_recompute_all_every_n

    cached = Path(tmp) / "recompute_all_every_002.json"
    next(s for s in gen_recompute_all_every_n(2, 4)
         if s.name == "recompute_all_every_002").to_json(cached)
    return {"uncached": None, "cached": cached}


def run_arm(gen, embeddings, schedule, seed: int = 0) -> float:
    """One full run of an arm on the resident generator, in ms: its
    schedule swapped in (`set_schedule`, outside the timed region), then
    `generate_images_timed`, noise → uint8 images left on the device."""
    gen.set_schedule(schedule)
    return gen.generate_images_timed(embeddings, seed)


def measure(gen, embeddings, schedules: dict, turns: int = TURNS,
            warmup: int = WARMUP) -> dict:
    """The arms in turns on the resident generator: `warmup` untimed runs
    of each, then `turns` timed (uncached, cached) pairs; the bench's JSON
    result."""
    if turns < 1:
        raise ValueError("at least one turn")
    dev, batch = gen.device, len(embeddings)
    for _ in range(warmup):
        for name in ARMS:
            run_arm(gen, embeddings, schedules[name])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ms = {name: [] for name in ARMS}
    for _ in range(turns):
        for name in ARMS:
            ms[name].append(run_arm(gen, embeddings, schedules[name]) / batch)
    med = {name: statistics.median(v) for name, v in ms.items()}
    value = med["uncached"] / med["cached"]
    detail = {
        "batch": batch,
        "turns": turns,
        "warmup_runs_per_arm": warmup,
        "protocol": "full pipeline: the denoise loop with CFG + VAE decode to "
                    "uint8 pixels on the device; CUDA events around "
                    "host-synchronised runs, arms in turns",
        **{f"{name}_ms_per_image": med[name] for name in ARMS},
        **{f"{name}_ms_per_image_range": [min(ms[name]), max(ms[name])] for name in ARMS},
        **{f"{name}_ms_per_image_turns": ms[name] for name in ARMS},
        "ratio_per_turn": [u / c for u, c in zip(ms["uncached"], ms["cached"])],
        "device": str(dev),
    }
    if dev.type == "cuda":
        from .utils.timing import card_name

        detail["card"] = card_name()
        detail["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return {
        "metric": "pixart_alpha_256_ours_fast_wallclock_speedup",
        "value": value,
        "unit": "x_vs_uncached",
        "vs_baseline": value / REF_SPEEDUP,
        "detail": detail,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--turns", type=int, default=TURNS)
    p.add_argument("--warmup", type=int, default=WARMUP)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda must be present")
    p.add_argument("--tiny", action="store_true",
                   help="the tiny 2-block model (CPU tests); cpu only")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.tiny and device.type != "cpu":
        p.error("--tiny is for --device cpu")
    gen, embeddings = build(device, tiny=args.tiny, batch=args.batch)
    with tempfile.TemporaryDirectory() as tmp:
        result = measure(gen, embeddings, arms(args.tiny, tmp), args.turns, args.warmup)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
