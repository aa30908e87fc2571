"""Chip smoke test of ecad_tpu_torch on one Hopper GPU (H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. Require CUDA on a compute-capability-9.0 card; print the card's name and
   power limit as nvidia-smi gives them.
2. Build the kernels from the checkout's sources: ``nvcc`` for
   ``ecad_tpu_torch/csrc/*.cu`` (one process per source, started together),
   Triton for the modulated LayerNorm.
3. Kernels: hold each kernel against its plain PyTorch version on the card,
   at the main path's shapes in bf16, at the odd shapes of the reference's
   kernel tests, and in fp32 at a tight tolerance; time kernel, plain
   version and (attention) one ``scaled_dot_product_attention`` call as a
   yardstick the port never calls.
4. Main path: full-width PixArt-α 256 (28 blocks, d=1152) with seeded
   random bf16 weights, batch 8 with CFG 4.5, 20 DPM-Solver++ steps, the
   ECAD ``ours_fast`` schedule and then the all-recompute default, each
   followed by the random bf16 VAE decode to (8, 256, 256, 3) uint8. Checks
   the kernel launch counts of each trajectory against its schedule, and a
   small fp32 trajectory on the card against the plain path on the CPU.
5. Entry point: ``ecad_tpu_torch.inference.cli PixArtAlphaImageGenerator``
   with a prompt file, random weights and ``ours_fast``; checks its PNGs.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. A longer report (every check's error,
device and host times, per-trajectory profiles, the nvcc/ptxas log) goes
to ``--report`` (default ``build/ecad_tpu_torch/chip_smoke_report.json``).
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OURS_FAST = ROOT / "schedules/schedules_in_paper/pixart_alpha_256/ours_fast.json"
BATCH = 8
STEPS = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
BF16_TOL = (2e-2, 2e-2)  # (atol, rtol): about two bf16 ulps of an O(1) output
FP32_TOL = (1e-5, 1e-5)  # fp32 kernels against fp32 plain versions
REPORT: dict = {}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0, got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build_kernels() -> None:
    from ecad_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    REPORT["build_s"] = time.perf_counter() - t0
    REPORT["build_logs"] = dict(_build.BUILD_LOGS)
    log(f"built {sorted(_build.BUILD_LOGS) or 'nothing new'} in {REPORT['build_s']:.1f} s")


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def timed_ms(label: str, fn, reps: int = 7, inner: int = 20) -> float:
    """Device time of one call: median over `reps` of the mean of `inner`
    back-to-back calls between CUDA events. A spin kernel queued first
    keeps the device busy while the host enqueues the calls, so the events
    see device execution, not the host's launch overhead (which is
    reported apart, as host ms per call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_s = (time.perf_counter() - t0) / inner
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(4e9 * host_s * inner) + 100_000)  # ≥ 2× the enqueue time
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    dev_ms = statistics.median(times)
    REPORT.setdefault("timing_ms", {})[label] = {"device": dev_ms, "host": host_s * 1e3}
    return dev_ms


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol) -> float:
    atol, rtol = tol
    got32, want32 = got.float(), want.float()
    if not torch.isfinite(got32).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got32 - want32).abs()
    bad = err > atol + rtol * want32.abs()
    max_err = float(err.max())
    REPORT.setdefault("cases", {})[name] = max_err
    log(f"  {name}: max |kernel - plain| = {max_err:.3g}")
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements beyond atol {atol} + rtol {rtol}"
            f" (max err {max_err:.3g})"
        )
    return max_err


def key_padding_bias(lengths, tk, fill, dtype=torch.float32):
    keep = torch.arange(tk, device="cuda")[None, :] < torch.tensor(
        lengths, device="cuda"
    )[:, None]
    return torch.where(keep, 0.0, fill).to(dtype)[:, None, None, :]


def attention_cases() -> None:
    from ecad_tpu_torch.ops import fused_attention, fused_attention_reference

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"

        def case(name, q, k, v, bias=None):
            compare(f"attention/{tag}/{name}",
                    fused_attention(q, k, v, bias),
                    fused_attention_reference(q, k, v, bias), tol)

        case("unaligned_tq30_tk300_d72",
             rnd(2, 30, 3, 72, dtype=dtype), rnd(2, 300, 3, 72, dtype=dtype),
             rnd(2, 300, 3, 72, dtype=dtype))
        for d in (16, 64):
            case(f"d{d}", rnd(2, 16, 3, d, dtype=dtype),
                 rnd(2, 24, 3, d, dtype=dtype), rnd(2, 24, 3, d, dtype=dtype))
        case("per_batch_key_padding_100_200_256",
             rnd(3, 128, 2, 72, dtype=dtype), rnd(3, 256, 2, 72, dtype=dtype),
             rnd(3, 256, 2, 72, dtype=dtype),
             key_padding_bias([100, 200, 256], 256, -1e9))
        case("batch_broadcast_bias_1_1_1_tk",
             rnd(3, 32, 2, 64, dtype=dtype), rnd(3, 256, 2, 64, dtype=dtype),
             rnd(3, 256, 2, 64, dtype=dtype), key_padding_bias([100], 256, -1e9))
        case("dense_bias",
             rnd(2, 40, 3, 64, dtype=dtype), rnd(2, 70, 3, 64, dtype=dtype),
             rnd(2, 70, 3, 64, dtype=dtype), rnd(2, 3, 40, 70))
        # head dim not a multiple of 8, and rows off 16-byte alignment:
        # the element-wise (non-cp.async) load path
        case("unaligned_tq130_tk300_d36",
             rnd(2, 130, 2, 36, dtype=dtype), rnd(2, 300, 2, 36, dtype=dtype),
             rnd(2, 300, 2, 36, dtype=dtype))
        wide = rnd(2, 64, 3, 80, dtype=dtype)
        case("misaligned_rows_d72", wide[..., 1:73], wide[..., 3:75], wide[..., 5:77])
        case("logits_near_40",
             rnd(1, 16, 1, 64, dtype=dtype, scale=6.0),
             rnd(1, 256, 1, 64, dtype=dtype), rnd(1, 256, 1, 64, dtype=dtype))
        hot = fused_attention(rnd(1, 128, 1, 72, dtype=dtype, scale=1e4),
                              rnd(1, 256, 1, 72, dtype=dtype),
                              rnd(1, 256, 1, 72, dtype=dtype))
        if not torch.isfinite(hot.float()).all():
            raise AssertionError(f"attention/{tag}: q×1e4 gave non-finite output")


def kernel_phase(b2: int) -> dict:
    """Checks every kernel and times it at the main path's shapes (2B = b2
    rows of CFG batch). Returns the per-kernel measurements."""
    import torch.nn.functional as F

    from ecad_tpu_torch.ops import (
        fused_attention,
        fused_attention_reference,
        modulated_layer_norm,
        modulated_layer_norm_reference,
    )

    log("kernel phase")
    attention_cases()
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    h, t, l, d, dim = 16, 256, 120, 72, 1152

    def rnd(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v = rnd(b2, t, h, d), rnd(b2, t, h, d), rnd(b2, t, h, d)
    kc, vc = rnd(b2, l, h, d), rnd(b2, l, h, d)
    lengths = [(7, 60, 120)[i % 3] for i in range(b2)]
    # the main path's text bias: (1 − mask)·−10000 in fp32, cast to bf16
    bias = key_padding_bias(lengths, l, -10000.0, bf)
    x = rnd(b2, t, dim)
    mods = rnd(b2, 6, dim) * 0.1
    scale, shift = mods[:, 1:2], mods[:, 0:1]  # strided views, as in the block

    out = {}
    err1 = compare("attention/bf16/main_self_256x256_d72",
                   fused_attention(q, k, v), fused_attention_reference(q, k, v),
                   BF16_TOL)
    err2 = compare("attention/bf16/main_cross_256x120_d72_key_padding",
                   fused_attention(q, kc, vc, bias),
                   fused_attention_reference(q, kc, vc, bias), BF16_TOL)
    err3 = compare("modlnorm/bf16/main_2Bx256x1152",
                   modulated_layer_norm(x, scale, shift),
                   modulated_layer_norm_reference(x, scale, shift), BF16_TOL)
    x32, s32, h32 = x.float(), scale.float(), shift.float()
    compare("modlnorm/fp32/main_2Bx256x1152",
            modulated_layer_norm(x32, s32, h32),
            modulated_layer_norm_reference(x32, s32, h32), FP32_TOL)
    compare("modlnorm/fp32/d72_ragged",
            modulated_layer_norm(x32[:3, :5, :72], s32[:3, :, :72], h32[:3, :, :72]),
            modulated_layer_norm_reference(x32[:3, :5, :72], s32[:3, :, :72],
                                           h32[:3, :, :72]), FP32_TOL)

    def nbytes(*ts):
        return sum(tt.numel() * tt.element_size() for tt in ts)

    def bound(bytes_, flops):
        tb, tf = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS
        return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"

    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    kct, vct = (a.transpose(1, 2).contiguous() for a in (kc, vc))
    o = torch.empty_like(q)
    b1, by1 = bound(nbytes(q, k, v, o), 4 * b2 * h * t * t * d)
    b2_ms, by2 = bound(nbytes(q, kc, vc, o, bias.float()), 4 * b2 * h * t * l * d)
    b3, by3 = bound(nbytes(x, x, scale, shift), 8 * x.numel())
    rows = [
        dict(name="attention", route="cuda",
             source="ecad_tpu_torch/csrc/attention.cu",
             replaces="ecad_tpu/ops/attention.py:58 (_attn_kernel)",
             max_abs_err=err1,
             ms=timed_ms("attention", lambda: fused_attention(q, k, v)),
             plain_ms=timed_ms("attention/plain",
                               lambda: fused_attention_reference(q, k, v)),
             bound_ms=b1, bound_by=by1,
             library_ms=timed_ms("attention/sdpa",
                                 lambda: F.scaled_dot_product_attention(qt, kt, vt))),
        dict(name="attention_bias", route="cuda",
             source="ecad_tpu_torch/csrc/attention.cu",
             replaces="ecad_tpu/ops/attention.py:75 (_attn_kernel_bias)",
             max_abs_err=err2,
             ms=timed_ms("attention_bias", lambda: fused_attention(q, kc, vc, bias)),
             plain_ms=timed_ms("attention_bias/plain",
                               lambda: fused_attention_reference(q, kc, vc, bias)),
             bound_ms=b2_ms, bound_by=by2,
             library_ms=timed_ms("attention_bias/sdpa",
                                 lambda: F.scaled_dot_product_attention(
                                     qt, kct, vct, attn_mask=bias))),
        dict(name="modlnorm", route="triton",
             source="ecad_tpu_torch/ops/fused.py",
             replaces="ecad_tpu/ops/fused.py:20 (_modlnorm_kernel)",
             max_abs_err=err3,
             ms=timed_ms("modlnorm", lambda: modulated_layer_norm(x, scale, shift)),
             plain_ms=timed_ms("modlnorm/plain",
                               lambda: modulated_layer_norm_reference(x, scale, shift)),
             bound_ms=b3, bound_by=by3, library_ms=None),
    ]
    for r in rows:
        out[r["name"]] = r
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']}, library {r['library_ms']})")
    return out


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def expected_counts(masks) -> dict[str, int]:
    arr = np.array(masks, dtype=bool)  # (steps, blocks, 3), step 0 forced
    return {
        "attention": int(arr[..., 0].sum()),
        "attention_bias": int(arr[..., 1].sum()),
        "modlnorm": int(arr[..., 0].sum() + arr[..., 2].sum()) + arr.shape[0],
    }


def small_reference_check() -> float:
    """A tiny fp32 trajectory through the kernels on the card against the
    same weights and noise through the plain versions on the CPU."""
    from ecad_tpu_torch.models.pixart import PixArtConfig, init_model
    from ecad_tpu_torch.pipelines import PixArtPipeline, PixArtPipelineConfig
    from ecad_tpu_torch.schedules import PixArtCacheSchedule

    cfg = PixArtConfig.tiny(dtype=torch.float32)
    cpu_model = init_model(cfg, 3, "cpu")
    gpu_model = init_model(cfg, 3, "cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    sched = PixArtCacheSchedule.default(STEPS, cfg.num_blocks)
    arr = sched.to_numpy()
    arr[1::2, :, 1:] = False  # reuse attn2 and ff on odd steps
    sched = PixArtCacheSchedule.from_numpy(arr.reshape(STEPS, -1), STEPS, cfg.num_blocks)
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.standard_normal((2, 8, 8, 4), dtype=np.float32))
    text = torch.from_numpy(rng.standard_normal((2, 8, 32), dtype=np.float32))
    neg = torch.from_numpy(rng.standard_normal((2, 8, 32), dtype=np.float32))
    tm = torch.tensor([[1] * 5 + [0] * 3, [1] * 8])
    nm = torch.tensor([[1] + [0] * 7] * 2)
    outs = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
        pipe = PixArtPipeline(PixArtPipelineConfig(cfg, STEPS), model, sched)
        args = [a.to(dev) for a in (noise, text, neg, tm, nm)]
        outs.append(pipe.denoise(*args).cpu())
    err = float((outs[0] - outs[1]).abs().max())
    log(f"  tiny fp32 trajectory, card kernels vs CPU plain: max err {err:.3g}")
    # fp32 throughout (TF32 off); 20 steps of CFG 4.5 amplify per-step
    # rounding differences of ~1e-6 on O(1) latents to ~1e-4
    if not err <= 1e-3:
        raise AssertionError(f"tiny trajectory mismatch {err}")
    return err


def kernel_family(name: str) -> str:
    """Family of a device kernel, from its (mangled or demangled) name."""
    if "attn_bf16_kernel" in name:
        biased = "true>" in name or "ELb1E" in name
        return "attention_bias" if biased else "attention"
    if "_modlnorm_body" in name:
        return "modlnorm"
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "wgmma")):
        return "gemm"
    if any(k in low for k in ("conv", "cudnn", "implicit", "winograd")):
        return "conv"
    return "other"


def profile_trajectory(fn, wall_ms: float) -> dict:
    """Device time of one trajectory (denoise + decode) by kernel family,
    from torch.profiler, and the device's busy share of the unprofiled
    wall time `wall_ms` of the same work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fams = dict.fromkeys(
        ("attention", "attention_bias", "modlnorm", "gemm", "conv", "other"), 0.0
    )
    launches = 0
    host_ops = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            host_ops.append((evt.self_cpu_time_total / 1e3, evt.count, evt.key))
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        launches += evt.count
        fams[kernel_family(evt.key)] += us / 1e3
    busy = sum(fams.values())
    host_ops.sort(reverse=True)
    return {
        "device_ms": fams,
        "busy_ms": busy,
        "wall_ms": wall_ms,
        "idle_share": 1.0 - busy / wall_ms,
        "kernel_launches": launches,
        # host ops by self CPU ms under the profiler (inflated by it), with calls
        "host_ops_top": [
            {"op": k, "calls": n, "self_cpu_ms_profiled": ms}
            for ms, n, k in host_ops[:15]
        ],
    }


def main_path() -> dict:
    from ecad_tpu_torch.models.pixart import PixArtConfig, init_model
    from ecad_tpu_torch.models.vae import random_decoder_pipeline
    from ecad_tpu_torch.ops import launch_counts, reset_launch_counts
    from ecad_tpu_torch.pipelines import PixArtPipeline, PixArtPipelineConfig
    from ecad_tpu_torch.schedules import PixArtCacheSchedule

    log("main path: PixArt-α 256, full width, batch 8, 20 steps")
    REPORT["tiny_trajectory_err"] = small_reference_check()
    config = PixArtConfig()
    t0 = time.perf_counter()
    model = init_model(config, 0, "cuda")
    vae = random_decoder_pipeline(4, "cuda")
    torch.cuda.synchronize()
    REPORT["init_s"] = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape_t = (BATCH, config.text_len, config.caption_dim)
    text = torch.randn(shape_t, generator=gen, device="cuda").to(config.dtype)
    neg = torch.randn(shape_t, generator=gen, device="cuda").to(config.dtype)
    noise = torch.randn(
        (BATCH, config.sample_size, config.sample_size, config.in_channels),
        generator=gen, device="cuda",
    ).to(config.dtype)
    lengths = torch.randint(7, config.text_len + 1, (BATCH,), generator=gen, device="cuda")
    text_mask = (torch.arange(config.text_len, device="cuda")[None] < lengths[:, None]).int()
    neg_mask = torch.zeros_like(text_mask)
    neg_mask[:, 0] = 1  # the empty negative prompt keeps one token

    pcfg = PixArtPipelineConfig(model=config, num_inference_steps=STEPS)
    pipes = {
        "ours_fast": PixArtPipeline(pcfg, model, PixArtCacheSchedule.from_json(OURS_FAST)),
        "default": PixArtPipeline(pcfg, model, PixArtCacheSchedule.default(STEPS)),
    }

    def run(pipe):
        latents = pipe.denoise(noise, text, neg, text_mask, neg_mask)
        return latents, vae.decode_device(latents)

    result = {}
    for name, pipe in pipes.items():
        reset_launch_counts()
        latents, img = run(pipe)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = expected_counts(pipe.masks)
        log(f"  {name}: launches {counts}, schedule says {want}")
        if counts != want:
            raise AssertionError(f"{name}: launches {counts} != schedule {want}")
        if tuple(img.shape) != (BATCH, 256, 256, 3) or img.dtype != torch.uint8:
            raise AssertionError(f"{name}: image {tuple(img.shape)} {img.dtype}")
        if not torch.isfinite(latents.float()).all():
            raise AssertionError(f"{name}: non-finite latents")
        result[name] = {"launches": counts, "latents_std": float(latents.float().std())}

    # timing: alternate the two schedules, host clock around synchronized runs
    times = {name: [] for name in pipes}
    for name in ("default", "ours_fast", "ours_fast", "default") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(pipes[name])
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3 / BATCH)
    for name in pipes:
        result[name]["ms_per_img"] = statistics.median(times[name])
        result[name]["ms_per_img_runs"] = times[name]
    result["speedup"] = result["default"]["ms_per_img"] / result["ours_fast"]["ms_per_img"]
    result["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"  ms/img: ours_fast {result['ours_fast']['ms_per_img']:.3f}, default "
        f"{result['default']['ms_per_img']:.3f}, ratio {result['speedup']:.4f}")
    for name, pipe in pipes.items():
        result[name]["profile"] = profile_trajectory(
            lambda: run(pipe), result[name]["ms_per_img"] * BATCH
        )
        log(f"  {name} device time by kernel family (ms per trajectory): "
            f"{result[name]['profile']}")
    del model, vae, pipes
    torch.cuda.empty_cache()
    return result


def entry_point() -> dict:
    from ecad_tpu_torch.inference.cli import main as cli_main
    from ecad_tpu_torch.ops import launch_counts, reset_launch_counts
    from PIL import Image

    log("entry point: ecad_tpu_torch.inference.cli")
    work = ROOT / "build" / "ecad_tpu_torch" / "smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    prompts = ["a red bicycle leaning on a wall", "a bowl of ramen", "mountains at dawn"]
    (work / "prompts.txt").write_text("\n".join(prompts) + "\n")
    reset_launch_counts()
    cli_main([
        "PixArtAlphaImageGenerator", "--prompt-file", str(work / "prompts.txt"),
        "--random-weights", "--schedule", str(OURS_FAST),
        "--output-dir", str(work / "out"),
    ])
    torch.cuda.synchronize()
    counts = launch_counts()
    pngs = sorted((work / "out" / "images").glob("*.png"))
    names = [p.name for p in pngs]
    want = [f"{i:03d}__prompt_seed:000__image_seed:000.png" for i in range(3)]
    if names != want:
        raise AssertionError(f"CLI wrote {names}, expected {want}")
    for p in pngs:
        arr = np.asarray(Image.open(p))
        if arr.shape != (32, 32, 3) or arr.dtype != np.uint8:
            raise AssertionError(f"{p.name}: {arr.shape} {arr.dtype}")
    if min(counts.values()) == 0:
        raise AssertionError(f"CLI run missed a kernel: {counts}")
    log(f"  CLI wrote {names}; launches {counts}")
    return {"pngs": names, "launches": counts}


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--report", type=Path,
        default=ROOT / "build" / "ecad_tpu_torch" / "chip_smoke_report.json",
    )
    args = parser.parse_args()
    smi = check_card()
    REPORT["card"] = smi
    build_kernels()
    kernels = kernel_phase(b2=2 * BATCH)
    REPORT["main_path"] = main_path()
    REPORT["entry_point"] = entry_point()
    launches = REPORT["main_path"]["ours_fast"]["launches"]
    for name, row in kernels.items():
        row["launches"] = launches[name]
    REPORT["kernels"] = kernels
    args.report.parent.mkdir(parents=True, exist_ok=True)
    args.report.write_text(json.dumps(REPORT, indent=1))
    mp = REPORT["main_path"]
    print(json.dumps({
        "card": smi,
        "ms_per_img_ours_fast": mp["ours_fast"]["ms_per_img"],
        "ms_per_img_default": mp["default"]["ms_per_img"],
        "speedup": mp["speedup"],
        "launches_ours_fast": mp["ours_fast"]["launches"],
        "launches_default": mp["default"]["launches"],
    }), flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels.values()]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
