"""K5 and K6 at head dim 128: this tree's Hopper body against an older
tree's mma.sync body, in turns, in one process on one card.

    python -m ecad_tpu_torch.scripts.compare_attention_bodies \\
        --old-tree build/pr5 [--out chiprun_out/bodies.json]

The older tree's ``ecad_tpu_torch/csrc/attention.cu`` (its plain C entry
``ecad_attention_fwd``: variant 2 is K5's row-block clamp softmax, 3 K6's
streaming exact softmax) is compiled with nvcc into
``build/ecad_tpu_torch/`` and loaded beside this tree's kernels. At
FLUX-1024's joint attention (1, 4608, 24, 128) for K5 and FLUX-1536's (1,
9728, 24, 128) for K6, bf16 without a bias, both bodies are checked against
this tree's plain version (run per head) and timed in turns — old, new,
new, old — by spin-kernel CUDA events (`sampled_device_ms`, which samples
the SM clock, power and temperature around each timing), beside one
``scaled_dot_product_attention`` call. Prints one JSON line per shape, and
writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ecad_tpu_torch.ops import _build
from ecad_tpu_torch.ops import attention as A
from ecad_tpu_torch.utils.timing import bound_ms, card_name, sampled_device_ms

# counter → (shape, the older body's variant, this tree's wrapper, plain
# version, the share of the output's std in its bf16 tolerance, as
# chip_smoke.py's clamp_bf16_tol and flash_bf16_tol)
CASES = {
    "attention_rowblock": ((1, 4608, 24, 128), 2, A.rowblock_attention,
                           A.rowblock_attention_reference, 0.1),
    "attention_flash": ((1, 9728, 24, 128), 3, A.flash_attention,
                        A.flash_attention_reference, 0.025),
}


def old_entry(tree: Path):
    """The older tree's ``ecad_attention_fwd``, built with this tree's nvcc
    flags and given this tree's argument types (the C interface is the
    same)."""
    src = tree / "ecad_tpu_torch" / "csrc" / "attention.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"libattention_old_{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            [_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", str(out), str(src)],
            check=True,
        )
    fn = ctypes.CDLL(str(out)).ecad_attention_fwd
    fn.argtypes = A._kernel().argtypes
    fn.restype = ctypes.c_int
    return fn


def by_heads(plain, q, k, v) -> torch.Tensor:
    out = torch.empty_like(q)
    for h in range(q.shape[2]):
        sl = (slice(None), slice(None), slice(h, h + 1))
        out[sl] = plain(q[sl], k[sl], v[sl])
    return out


def max_err_and_bad(got, want, share) -> tuple[float, int]:
    err = (got.float() - want.float()).abs()
    limit = share * float(want.float().std()) + 2.0 ** -7 * want.float().abs()
    return float(err.max()), int((err > limit).sum())


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old-tree", type=Path, required=True)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_attention_bodies: needs a CUDA card")
    card = card_name()
    _build.build_all()
    old = old_entry(args.old_tree)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for counter, (shape, variant, new_fn, plain, share) in CASES.items():
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        bodies = {"old": lambda: A._launch(q, k, v, None, variant, entry=old),
                  "new": lambda: new_fn(q, k, v)}
        want = by_heads(plain, q, k, v)
        checks = {name: max_err_and_bad(fn(), want, share) for name, fn in bodies.items()}
        del want
        times = {"old": [], "new": []}
        clocks = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            ms, _, sample = sampled_device_ms(bodies[name], reps=5, inner=10)
            times[name].append(ms)
            clocks[name].append(sample)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        sdpa, _, sdpa_clocks = sampled_device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), 5, 10)
        b, t, h, d = shape
        bound, by = bound_ms(4 * q.numel() * q.element_size(), 4 * b * h * t * t * d)
        row = {
            "counter": counter, "shape": list(shape), "card": card,
            "old_ms": times["old"], "new_ms": times["new"],
            "old_over_new": statistics.median(times["old"]) / statistics.median(times["new"]),
            "sdpa_ms": sdpa, "bound_ms": bound, "bound_by": by,
            "max_err": {n: c[0] for n, c in checks.items()},
            "elements_beyond_tolerance": {n: c[1] for n, c in checks.items()},
            "clocks": {**clocks, "sdpa": sdpa_clocks},
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
        if any(c[1] for c in checks.values()):
            raise SystemExit(f"{counter}: a body is beyond its tolerance: {checks}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
