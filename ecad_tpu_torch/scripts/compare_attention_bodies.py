"""The Hopper bodies (``csrc/attention_sm90.cu`` in bf16,
``csrc/attention_f32_sm90.cu`` in fp32) against the kernels of
``csrc/attention.cu`` they replaced (its mma.sync body in bf16, its SIMT
kernel in fp32; no wrapper reaches it any more), or against an older
tree's wrappers (``--parent DIR``), kernel by kernel, in turns, in one
process on one card; and the harness's X3 against one library call, in
turns.

    python -m ecad_tpu_torch.scripts.compare_attention_bodies [--out bodies.json]
        [--rows attention_d64,attention_bias_d64] [--parent DIR]

With ``--parent DIR`` (the root of an older checkout, unpacked for
instance with ``git archive <commit> ecad_tpu_torch | tar -x -C
build/parent``) the old side of each row is that tree's wrapper of the
same name, its ``ecad_tpu_torch/ops`` package loaded from its files
(`compare_modlnorm_bodies.load_ops`), which builds its own sources: the
way to time this tree's kernels against the parent's where their machine
code differs (`compare_sass`); each row then also says whether the two
trees' outputs are bit-identical.

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

The fp32 rows (`F32_CASES`, at chip_smoke.py's fp32 rows' shapes): K1 at
PixArt-256's (16, 256, 16, 72), K2 with the text bias in fp32 at its
cross-attention → 120 keys, K4 at PixArt-1024's (4, 4096, 16, 72), K5 at
FLUX-1024's (1, 4608, 24, 128) and K6 at PixArt-Σ-2048's (2, 16384, 16,
72): the fp32 body against attention.cu's SIMT kernel, each checked against
the plain version at chip_smoke.py's FP32_TOL and timed in turns — old,
new, SDPA, SDPA, new, old — with SDPA in fp32; their bound is the 3×TF32
one (three TF32 products at 494.7 TFLOP/s, or the bytes), beside the fp32
FMA bound (``fma_bound_ms``).

Then X3 (`max_exp2_attention`, the harness's exp2 softmax with the max on a
pre-scaled q; its old body is gone) against ``scaled_dot_product_attention``
at the harness's three shapes, in turns — X3, SDPA, SDPA, X3 — three times
a shape (`X3_ROUNDS`): one row a shape with both lists of times and the
ratio of their medians.

With ``--parent`` the rows also take the fp32 body at width 192 (head dim
160; `PARENT_CASES`: K1 at (16, 256, 8, 160), K4 and K5 at (2, 2048, 8,
160), K6 at (1, 4608, 8, 160)), at width 256 (K5 at (2, 2048, 8, 256), K6
at (1, 4608, 12, 256)) and at head dims 384 and 512 (K1 and K2 → 120 keys
with the text bias at (16, 256, 8, D), K4 and K5 at (2, 2048, 8, D), K6 at
(1, 4608, 8, D)), against the parent's wrappers alone.

Prints one JSON line per row, and writes them to ``--out``. ``--rows``
takes a comma-separated subset of the bodies' rows (`CASES`, and
`PARENT_CASES` with ``--parent``) and skips X3.
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
from ecad_tpu_torch.utils.timing import (
    FP32_FLOPS,
    HBM_BYTES_PER_S,
    TF32_FLOPS,
    bound_ms,
    card_name,
    sampled_device_ms,
)

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
# fp32: the fp32 body against attention.cu's SIMT kernel (the same layout;
# share None: chip_smoke.py's FP32_TOL, atol 1e-5 and rtol 1e-5)
F32_CASES = {
    "attention_fp32": ((16, 256, 16, 72), 256, None, 0, A.fused_attention,
                       A.fused_attention_reference, None),
    "attention_bias_fp32": ((16, 256, 16, 72), 120, (7, 60, 120), 0, A.fused_attention,
                            A.fused_attention_reference, None),
    "attention_long_fp32": ((4, 4096, 16, 72), 4096, None, 1, A.fused_attention,
                            A.transposed_attention_reference, None),
    "attention_rowblock_fp32": ((1, 4608, 24, 128), 4608, None, 2, A.fused_attention,
                                A.rowblock_attention_reference, None),
    "attention_flash_fp32": ((2, 16384, 16, 72), 16384, None, 3, A.fused_attention,
                             A.flash_attention_reference, None),
}
CASES.update(F32_CASES)
# rows taken only against a parent tree (``--parent``): the fp32 body at
# width 192, which attention.cu never took (its SIMT kernel ends at head dim
# 128) and whose machine code moved beside the parent's (`compare_sass`)
PARENT_CASES = {
    "attention_fp32_d160": ((16, 256, 8, 160), 256, None, 0, A.fused_attention,
                            A.fused_attention_reference, None),
    "attention_long_fp32_d160": ((2, 2048, 8, 160), 2048, None, 1, A.fused_attention,
                                 A.transposed_attention_reference, None),
    "attention_rowblock_fp32_d160": ((2, 2048, 8, 160), 2048, None, 2, A.rowblock_attention,
                                     A.rowblock_attention_reference, None),
    "attention_flash_fp32_d160": ((1, 4608, 8, 160), 4608, None, 3, A.fused_attention,
                                  A.flash_attention_reference, None),
    # width 256, the two-block cluster: its arithmetic kept, bit for bit
    "attention_rowblock_fp32_d256": ((2, 2048, 8, 256), 2048, None, 2, A.rowblock_attention,
                                     A.rowblock_attention_reference, None),
    "attention_flash_fp32_d256": ((1, 4608, 12, 256), 4608, None, 3, A.flash_attention,
                                  A.flash_attention_reference, None),
    # widths 384 and 512: the clusters of three and four blocks against the
    # streamed form the parent runs there
    **{f"{name}_fp32_d{d}": (shape[:3] + (d,), tk, lengths, variant, fn, plain, None)
       for d in (384, 512)
       for name, shape, tk, lengths, variant, fn, plain in (
           ("attention", (16, 256, 8), 256, None, 0, A.single_tile_attention,
            A.fused_attention_reference),
           ("attention_bias", (16, 256, 8), 120, (7, 60, 120), 0, A.single_tile_attention,
            A.fused_attention_reference),
           ("attention_long", (2, 2048, 8), 2048, None, 1, A.transposed_attention,
            A.transposed_attention_reference),
           ("attention_rowblock", (2, 2048, 8), 2048, None, 2, A.rowblock_attention,
            A.rowblock_attention_reference),
           ("attention_flash", (1, 4608, 8), 4608, None, 3, A.flash_attention,
            A.flash_attention_reference))},
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
    """The largest error and the elements beyond the tolerance: `share` of
    the output's std beside 2^-7 relative (bf16), or 1e-5 + 1e-5 relative
    (fp32, share None)."""
    err = (got.float() - want.float()).abs()
    if share is None:
        limit = 1e-5 + 1e-5 * want.float().abs()
    else:
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
    parser.add_argument("--parent", type=Path, default=None,
                        help="an older checkout whose wrappers are the old side")
    args = parser.parse_args(argv)
    every = CASES if args.parent is None else {**CASES, **PARENT_CASES}
    cases = every if args.rows is None else {r: every[r] for r in args.rows.split(",")}
    if not torch.cuda.is_available():
        raise SystemExit("compare_attention_bodies: needs a CUDA card")
    card = card_name()
    _build.build_all()
    parent = None
    if args.parent is not None:
        from ecad_tpu_torch.scripts.compare_modlnorm_bodies import load_ops

        parent = load_ops(args.parent.resolve(), "parent_ecad_tpu_torch_ops").attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for counter, (shape, tk, lengths, variant, new_fn, plain, share) in cases.items():
        b, t, h, d = shape
        dtype = torch.float32 if share is None else torch.bfloat16
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                   for s in (shape, (b, tk, h, d), (b, tk, h, d)))
        bias = None
        if lengths is not None:  # the models' text bias, (1 − mask)·−10000 in q's dtype
            keep = torch.arange(tk, device="cuda")[None] < torch.tensor(
                [lengths[i % len(lengths)] for i in range(b)], device="cuda")[:, None]
            bias = torch.where(keep, 0.0, -10000.0).to(dtype)[:, None, None, :]
        n_pad = A.pad_keys(ROUTE[variant], tk)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        old_fn = None if parent is None else getattr(parent, new_fn.__name__)
        bodies = {"old": (lambda: A._launch(q, k, v, bias, variant, n_pad)) if parent is None
                  else (lambda: old_fn(q, k, v, bias)),
                  "new": lambda: new_fn(q, k, v, bias),
                  "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                      qt, kt, vt, attn_mask=bias)}
        want = by_heads(plain, q, k, v, bias)
        checks = {name: max_err_and_bad(bodies[name](), want, share) for name in ("old", "new")}
        del want
        # bf16: old, new, new, old, then SDPA once; fp32: SDPA in the turns,
        # and fewer calls where the old kernel takes a third of a second
        turns = (("old", "new", "sdpa", "sdpa", "new", "old") if share is None
                 else ("old", "new", "new", "old", "sdpa"))
        reps, inner = ((2, 1) if t * tk >= 16384 * 16384 else (3, 2) if t * tk >= 4096 * 4096
                       else (5, 10)) if share is None else (5, 10)
        times = {"old": [], "new": [], "sdpa": []}
        clocks = {"old": [], "new": [], "sdpa": []}
        for name in turns:
            ms, _, sample = sampled_device_ms(bodies[name], reps=reps, inner=inner)
            times[name].append(ms)
            clocks[name].append(sample)
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
        nbytes += 0 if bias is None else bias.numel() * bias.element_size()
        flops = 4 * b * h * t * tk * d
        if share is None:  # three TF32 products a product
            tb, tf = nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS
            bound, by = max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"
        else:
            bound, by = bound_ms(nbytes, flops)
        sdpa = statistics.median(times["sdpa"])
        row = {
            "counter": counter, "shape": list(shape), "keys": tk, "card": card,
            "dtype": str(dtype).split(".")[-1],
            "old_body": (f"attention.cu variant {variant}" if parent is None
                         else f"{args.parent}'s {new_fn.__name__}"),
            **({} if parent is None else
               {"bit_identical": bool(torch.equal(bodies["old"](), bodies["new"]()))}),
            "old_ms": times["old"], "new_ms": times["new"],
            "old_over_new": statistics.median(times["old"]) / statistics.median(times["new"]),
            "sdpa_ms": sdpa,
            "new_over_sdpa": statistics.median(times["new"]) / sdpa,
            "bound_ms": bound, "bound_by": by,
            **({"fma_bound_ms": flops / FP32_FLOPS * 1e3} if share is None else {}),
            "max_err": {n: c[0] for n, c in checks.items()},
            "elements_beyond_tolerance": {n: c[1] for n, c in checks.items()},
            "clocks": clocks,
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
        if any(c[1] for c in checks.values()):
            raise SystemExit(f"{counter}: a body is beyond its tolerance: {checks}")
    for shape, s in SHAPES.items() if args.rows is None and parent is None else ():
        row = x3_against_sdpa(shape, s, gen, card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
