"""compute_latency — wall-clock per-image latency written into schedule
JSONs.

Counterpart of ``ecad_tpu/benchmark/compute_latency.py``, plus ``--device``
(default ``cuda``, which must exist; ``--device cpu`` runs the plain
PyTorch path). Parity with ecad/benchmark/compute_latency.py: warmup and
timed sample batches through the full pipeline (denoise and decode to
uint8 on the device, ending at a device sync); the result is recorded as
metrics.latency {avg, batch_size, num_samples, warmup_steps, gpu, warmups,
latencies} (:52-85), ``gpu`` the card's name. ``--random-vae`` decodes
through a random-weight VAE so the timed region carries the real decode's
cost without checkpoints; ``--profile-dir`` writes a ``torch.profiler``
trace (Chrome JSON) of the timed runs.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .. import resolve_device
from ..image_generators import get_image_generator_type


def time_for_schedule(gen_type, schedule_path: Path, args) -> dict:
    gen = gen_type(
        schedule_path=schedule_path,
        weights_root=args.weights_root,
        random_weights=args.random_weights or args.weights_root is None,
        batch_size=args.batch_size,
        device=args.device,
    )
    gen.use_random_vae = args.random_vae
    latency = gen.time_image_generation(
        args.input_embeddings,
        warmup_steps=args.warmup_steps,
        num_samples=args.num_samples,
        batch_size=args.batch_size,
    )
    with schedule_path.open() as f:
        data = json.load(f)
    data.setdefault("metrics", {})["latency"] = latency
    with schedule_path.open("w") as f:
        json.dump(data, f, indent=4)
    print(f"{schedule_path.name}: {latency['avg']:.2f} ms/image")
    return latency


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image_generator")
    p.add_argument("--input-embeddings", type=Path, required=True)
    target = p.add_mutually_exclusive_group(required=True)
    target.add_argument("--schedule", type=Path)
    target.add_argument("--input-dir", type=Path)
    p.add_argument("--warmup-steps", type=int, default=10)
    p.add_argument("--num-samples", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--weights-root", type=Path, default=None)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--random-vae", action="store_true",
                   help="decode through a random-weight VAE so the timed "
                        "region carries the real decode cost without "
                        "checkpoints (the reference's timed __call__ "
                        "includes the VAE)")
    p.add_argument("--profile-dir", type=Path, default=None,
                   help="write a torch.profiler trace (Chrome JSON) of the "
                        "timed runs")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda must be present")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    gen_type = get_image_generator_type(args.image_generator)
    files = (
        [args.schedule]
        if args.schedule is not None
        else sorted(args.input_dir.rglob("*.json"))
    )
    if args.profile_dir is None:
        for f in files:
            time_for_schedule(gen_type, f, args)
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for f in files:
            time_for_schedule(gen_type, f, args)
    args.profile_dir.mkdir(parents=True, exist_ok=True)
    trace = args.profile_dir / "compute_latency_trace.json"
    prof.export_chrome_trace(str(trace))
    print(f"Profiler trace written to {trace}")


if __name__ == "__main__":
    main()
