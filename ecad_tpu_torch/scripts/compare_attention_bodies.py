"""The Hopper body (``csrc/attention_sm90.cu``) against the mma.sync body
it replaced (``csrc/attention.cu``, which still serves fp32, other head
dims and dense biases), kernel by kernel, in turns, in one process on one
card; and the harness's X3 against one library call, in turns.

    python -m ecad_tpu_torch.scripts.compare_attention_bodies [--out bodies.json]
        [--rows attention_d64,attention_bias_d64]

Rows, each bf16 at the shape the main path gives it: K1 (the exact
single-tile softmax, variant 0 of attention.cu's C entry) at FLUX-256's
joint attention (4, 768, 24, 128) and PixArt-256's self-attention (16, 256,
16, 72); K2 (the same with a key-padding bias, variant 0) at PixArt-256's
cross-attention (16, 256, 16, 72) → 120 keys with the text bias in bf16
(−9984 past lengths 7, 60, 120); K4 (the clamp softmax of the transposed
route, variant 1) at PixArt-1024's (4, 4096, 16, 72), and with a
key-padding bias at PixArt-1024's cross-attention (4, 4096, 16, 72) → 120
keys with the text bias in bf16; K5 (row-block clamp, variant 2) at
FLUX-1024's (1, 4608, 24, 128), and with a key-padding bias in bf16 (4508
of the 4608 keys kept) at the same shape; K6 (streaming exact, variant
3) at FLUX-1536's (1, 9728, 24, 128) and PixArt-Σ-2048's (2, 16384, 16,
72), and with a key-padding bias in bf16 at both (lengths 15384 and 9000
at 2048², 9000 of 9728 keys at 1536²); K1 and K2 at head dim 64 (variant
0) at the reference's width-reduced FLUX 256² (8, 768, 24, 64), which its
routing experiment forces onto the single-tile route
(`single_tile_attention`), K2 with 700 of the 768 keys kept; K4 (variant
1) at the same shape as the router sends it, also with 700 keys kept; K6
(variant 3) at the width-reduced FLUX's 1536² (1, 9728, 24, 64), also with
9000 keys kept; K5 (variant 2) at head dim 72 at the kernel shoot-out's
(8, 4096, 16, 72), also with 4000 of the 4096 keys kept, and at head dim
64 at the width-reduced FLUX 256² (8, 768, 24, 64), also with 700 of the
768 keys kept, each through `rowblock_attention`. Both bodies
are checked against the
plain version (run per head) and timed in turns — old, new, new, old — by
spin-kernel CUDA events (`sampled_device_ms`, which samples the SM clock,
power and temperature around each timing), beside one
``scaled_dot_product_attention`` call (with the bias as a float mask).

Then X3 (`max_exp2_attention`, the harness's exp2 softmax with the max on a
pre-scaled q; its old body is gone) against ``scaled_dot_product_attention``
at the harness's three shapes, in turns — X3, SDPA, SDPA, X3 — three times
a shape (`X3_ROUNDS`): one row a shape with both lists of times and the
ratio of their medians.

Prints one JSON line per row, and writes them to ``--out``. ``--rows``
takes a comma-separated subset of the bodies' rows (`CASES`) and skips X3.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

from ecad_tpu_torch.ops import _build
from ecad_tpu_torch.ops import attention as A
from ecad_tpu_torch.ops import max_exp2_attention
from ecad_tpu_torch.scripts.exp_attn_variants import SHAPES
from ecad_tpu_torch.utils.timing import bound_ms, card_name, sampled_device_ms

# row → (q shape, keys, the text lengths of a key-padding bias or None, the
# mma.sync body's variant of attention.cu's C entry, this tree's wrapper,
# plain version, the share of the output's std in its bf16 tolerance, as
# chip_smoke.py's clamp_bf16_tol and flash_bf16_tol)
CASES = {
    "attention_flux256": ((4, 768, 24, 128), 768, None, 0, A.fused_attention,
                          A.fused_attention_reference, 0.1),
    "attention": ((16, 256, 16, 72), 256, None, 0, A.fused_attention,
                  A.fused_attention_reference, 0.1),
    "attention_bias": ((16, 256, 16, 72), 120, (7, 60, 120), 0, A.fused_attention,
                       A.fused_attention_reference, 0.1),
    "attention_long": ((4, 4096, 16, 72), 4096, None, 1, A.fused_attention,
                       A.transposed_attention_reference, 0.1),
    "attention_long_bias": ((4, 4096, 16, 72), 120, (7, 60, 120), 1, A.fused_attention,
                            A.transposed_attention_reference, 0.1),
    "attention_rowblock": ((1, 4608, 24, 128), 4608, None, 2, A.rowblock_attention,
                           A.rowblock_attention_reference, 0.1),
    "attention_rowblock_bias": ((1, 4608, 24, 128), 4608, (4508,), 2, A.rowblock_attention,
                                A.rowblock_attention_reference, 0.1),
    "attention_flash": ((1, 9728, 24, 128), 9728, None, 3, A.flash_attention,
                        A.flash_attention_reference, 0.025),
    "attention_flash_d72": ((2, 16384, 16, 72), 16384, None, 3, A.flash_attention,
                            A.flash_attention_reference, 0.025),
    "attention_flash_bias": ((2, 16384, 16, 72), 16384, (15384, 9000), 3, A.flash_attention,
                             A.flash_attention_reference, 0.025),
    "attention_flash_bias_d128": ((1, 9728, 24, 128), 9728, (9000,), 3, A.flash_attention,
                                  A.flash_attention_reference, 0.025),
    "attention_d64": ((8, 768, 24, 64), 768, None, 0, A.single_tile_attention,
                      A.fused_attention_reference, 0.1),
    "attention_bias_d64": ((8, 768, 24, 64), 768, (700,), 0, A.single_tile_attention,
                           A.fused_attention_reference, 0.1),
    "attention_long_d64": ((8, 768, 24, 64), 768, None, 1, A.fused_attention,
                           A.transposed_attention_reference, 0.1),
    "attention_long_bias_d64": ((8, 768, 24, 64), 768, (700,), 1, A.fused_attention,
                                A.transposed_attention_reference, 0.1),
    "attention_flash_d64": ((1, 9728, 24, 64), 9728, None, 3, A.fused_attention,
                            A.flash_attention_reference, 0.025),
    "attention_flash_bias_d64": ((1, 9728, 24, 64), 9728, (9000,), 3, A.fused_attention,
                                 A.flash_attention_reference, 0.025),
    "attention_rowblock_d72": ((8, 4096, 16, 72), 4096, None, 2, A.rowblock_attention,
                               A.rowblock_attention_reference, 0.1),
    "attention_rowblock_bias_d72": ((8, 4096, 16, 72), 4096, (4000,), 2,
                                    A.rowblock_attention, A.rowblock_attention_reference, 0.1),
    "attention_rowblock_d64": ((8, 768, 24, 64), 768, None, 2, A.rowblock_attention,
                               A.rowblock_attention_reference, 0.1),
    "attention_rowblock_bias_d64": ((8, 768, 24, 64), 768, (700,), 2, A.rowblock_attention,
                                    A.rowblock_attention_reference, 0.1),
}
# attention.cu's variant → its route, for the route's pad keys (`pad_keys`)
ROUTE = {0: "exact", 1: "clamp", 2: "rowblock", 3: "flash"}
X3_ROUNDS = 3


def by_heads(plain, q, k, v, bias=None) -> torch.Tensor:
    out = torch.empty_like(q)
    for h in range(q.shape[2]):
        sl = (slice(None), slice(None), slice(h, h + 1))
        out[sl] = plain(q[sl], k[sl], v[sl], bias)
    return out


def max_err_and_bad(got, want, share) -> tuple[float, int]:
    err = (got.float() - want.float()).abs()
    limit = share * float(want.float().std()) + 2.0 ** -7 * want.float().abs()
    return float(err.max()), int((err > limit).sum())


def x3_against_sdpa(shape: str, s: dict, gen, card: str) -> dict:
    """X3 and one ``scaled_dot_product_attention`` call on the same bf16
    inputs at a harness shape, timed in turns (X3, SDPA, SDPA, X3)
    `X3_ROUNDS` times."""
    q, k, v = (torch.randn((s["b"], s["t"], s["h"], s["d"]), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    fns = {"x3": lambda: max_exp2_attention(q, k, v),
           "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)}
    times = {"x3": [], "sdpa": []}
    for _ in range(X3_ROUNDS):
        for name in ("x3", "sdpa", "sdpa", "x3"):
            times[name].append(sampled_device_ms(fns[name], reps=5, inner=5)[0])
    return {"counter": "xattn_max", "shape": shape, "card": card, "x3_ms": times["x3"],
            "sdpa_ms": times["sdpa"],
            "x3_over_sdpa": statistics.median(times["x3"]) / statistics.median(times["sdpa"])}


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--rows", default=None,
                        help="comma-separated rows of CASES (default: all, then X3)")
    args = parser.parse_args(argv)
    cases = CASES if args.rows is None else {r: CASES[r] for r in args.rows.split(",")}
    if not torch.cuda.is_available():
        raise SystemExit("compare_attention_bodies: needs a CUDA card")
    card = card_name()
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for counter, (shape, tk, lengths, variant, new_fn, plain, share) in cases.items():
        b, t, h, d = shape
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
                   for s in (shape, (b, tk, h, d), (b, tk, h, d)))
        bias = None
        if lengths is not None:  # the models' text bias, (1 − mask)·−10000 in bf16
            keep = torch.arange(tk, device="cuda")[None] < torch.tensor(
                [lengths[i % len(lengths)] for i in range(b)], device="cuda")[:, None]
            bias = torch.where(keep, 0.0, -10000.0).to(torch.bfloat16)[:, None, None, :]
        n_pad = A.pad_keys(ROUTE[variant], tk)
        bodies = {"old": lambda: A._launch(q, k, v, bias, variant, n_pad),
                  "new": lambda: new_fn(q, k, v, bias)}
        want = by_heads(plain, q, k, v, bias)
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
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                     attn_mask=bias), 5, 10)
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
        nbytes += 0 if bias is None else bias.numel() * bias.element_size()
        bound, by = bound_ms(nbytes, 4 * b * h * t * tk * d)
        row = {
            "counter": counter, "shape": list(shape), "keys": tk, "card": card,
            "old_body": f"attention.cu variant {variant}",
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
    for shape, s in SHAPES.items() if args.rows is None else ():
        row = x3_against_sdpa(shape, s, gen, card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
