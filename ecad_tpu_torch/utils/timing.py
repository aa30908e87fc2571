"""Device timing on one CUDA card, and the card's peaks for bounds.

`wall_ms` times one run of a function from an idle device to a host sync
(the latency protocol's timer); `device_ms` times a function's device work
with CUDA events behind a spin kernel; `sampled_device_ms` does the same with the card's SM clock, power
draw and temperature sampled just before and just after (`card_sample`);
`card_name` is the card's name and power limit as ``nvidia-smi`` prints
them, which every kept number carries beside it.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

# NVIDIA H100 SXM, dense, at its full 700 W power limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12  # outside the tensor cores
TF32_FLOPS = 494.7e12
INT8_OPS = 1979e12


def bound_ms(bytes_: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the bf16 operations over the tensor cores' rate, and
    which of the two it is."""
    tb, tf = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def wall_ms(fn, device) -> float:
    """Wall ms of one run of `fn` on `device`: on a GPU, CUDA events around
    a run that starts from an idle device and ends at a host sync of the
    last event; on the CPU, `time.perf_counter` alone."""
    dev = torch.device(device)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(dev)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def device_ms(fn, reps: int = 7, inner: int = 20) -> tuple[float, float]:
    """(device ms, host ms) per call of `fn`: the device time is the median
    over `reps` of the mean of `inner` back-to-back calls between CUDA
    events. A spin kernel queued first keeps the device busy while the host
    enqueues the calls, so the events see device execution, not the host's
    launch overhead (returned apart, from the host clock over one pass of
    `inner` calls). `fn` runs 1 + inner + reps·inner times."""
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
    return statistics.median(times), host_s * 1e3


def card_name() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card_sample() -> dict:
    """The first card's SM clock (MHz), power draw (W) and temperature (°C)
    now, from ``nvidia-smi --query-gpu=clocks.sm,power.draw,temperature.gpu
    --format=csv,noheader,nounits``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sm, power, temp = (v.strip() for v in out.split(","))
    return {"sm_clock_mhz": float(sm), "power_w": float(power), "temp_c": float(temp)}


def sampled_device_ms(fn, reps: int = 7, inner: int = 20) -> tuple[float, float, dict]:
    """`device_ms` with `card_sample` taken just before and just after the
    timing: (device ms, host ms, {"before": ..., "after": ...})."""
    before = card_sample()
    dev, host = device_ms(fn, reps, inner)
    return dev, host, {"before": before, "after": card_sample()}
