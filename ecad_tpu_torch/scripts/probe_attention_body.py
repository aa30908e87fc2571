"""What sets the pace of the Hopper attention body (``csrc/attention_sm90.cu``):
copies of the source, each with one piece of a kernel's work taken out or one
design choice undone, built beside it and timed against it in turns, in one
process on one card.

    python -m ecad_tpu_torch.scripts.probe_attention_body [--out probes.json]

Rows, bf16 at the shape the main path gives each kernel:

* K6 at PixArt-Σ-2048's self-attention (2, 16384, 16, 72), with the
  variants ``two_consumers`` (two consumer warpgroups and 128-row items, as
  the other kernels), ``no_softmax`` (p = s: no max, exp2, sum or rescale),
  ``no_exp2``, ``no_kv_loads`` (each stage's k and v loaded once, then
  reused), ``no_pv`` (no p·v products) and ``no_pv_tail`` (no m64n8k16 for
  v's columns 64-71);
* K2 at PixArt-256's cross-attention (16, 256, 16, 72) → 120 keys with the
  text bias in bf16, with ``bias_in_tile`` (each tile's bias loaded when
  the tile starts, not one tile ahead) and ``no_bias_loads`` (the bias read
  as 0).

A variant that only reschedules the same arithmetic (``two_consumers``,
``bias_in_tile``) must give the source's output bit for bit; the others
compute something else and are timed only. Each variant's time is the
median of spin-kernel CUDA-event timings (`device_ms`), taken in turns:
source, variants, variants again in reverse, source. Prints one JSON line
per row and writes them to ``--out``. The edits are text replacements
(every occurrence) checked against the source: one that no longer matches
raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ecad_tpu_torch.ops import _build
from ecad_tpu_torch.ops import attention as A
from ecad_tpu_torch.utils.timing import card_name, card_sample, device_ms

# variant → [(text in the source, its replacement), ...]
K6_VARIANTS = {
    "two_consumers": [("constexpr int kFlashConsumers = D == 72 ? 3 : 2;",
                       "constexpr int kFlashConsumers = 2;")],
    "no_softmax": [(
        "    if (edge) softmax_exact<true>(s, m, l, alpha, qk_scale, k0 + col_t, Tk);\n"
        "    else softmax_exact<false>(s, m, l, alpha, qk_scale, k0 + col_t, Tk);",
        "    (void)edge;")],
    "no_exp2": [("    const float p = ex2(fmaf(s[i], qk_scale, shift[r]));",
                 "    const float p = fmaf(s[i], qk_scale, shift[r]);")],
    "no_kv_loads": [
        (f"          mbar_expect_tx({x}_full(s), kKV.load());\n"
         f"          tma_tile<D>({x}_s(s), kKV, &maps[{i}], &maps[{i + 3}], {x}_full(s), h, "
         "j * kBlockN, b);",
         f"          if (g < kStages) {{ mbar_expect_tx({x}_full(s), kKV.load());\n"
         f"          tma_tile<D>({x}_s(s), kKV, &maps[{i}], &maps[{i + 3}], {x}_full(s), h, "
         f"j * kBlockN, b); }} else mbar_arrive({x}_full(s));")
        for x, i in (("k", 1), ("v", 2))],
    "no_pv": [("      wgmma_fence();\n#pragma unroll\n"
               "      for (int kk = 0; kk < 8; ++kk) pv(o, pf[kk], sp, kk);\n"
               "      wgmma_commit();", "      wgmma_commit();")],
    # the m64n8k16's instruction taken out of its asm (its operands stay)
    "no_pv_tail": [('      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}"\n'
                    '      ", {%4, %5, %6, %7}, %8, p, 1, 1, 1;\\n}\\n"',
                    '      "}\\n"')],
}
K2_VARIANTS = {
    "bias_in_tile": [("  constexpr bool kBiasAhead = D == 72;",
                      "  constexpr bool kBiasAhead = false;")],
    "no_bias_loads": [("      raw[i] = __ldg(row + min(col0 + (i >> 1) * 8 + (i & 1), p.Tk - 1) "
                       "* p.bias_sk);", "      raw[i] = 0u;")],
}
# row → (q shape, keys, text lengths of the bias or None, the wrapper's
# counter, its variants, timing reps and calls per rep)
ROWS = {
    "k6_pixart2048": ((2, 16384, 16, 72), 16384, None, "attention_flash", K6_VARIANTS, 3, 5),
    "k2_pixart256_cross": ((16, 256, 16, 72), 120, (7, 60, 120), "attention", K2_VARIANTS,
                           7, 20),
}
EXACT = ("two_consumers", "bias_in_tile")  # the same arithmetic, rescheduled


def variant_source(src: str, edits: list[tuple[str, str]]) -> str:
    """The source with every occurrence of each edit's text replaced."""
    for old, new in edits:
        if old not in src:
            raise ValueError(f"edit does not match the source: {old[:80]!r}")
        src = src.replace(old, new)
    return src


def build(sources: dict[str, str], out_dir: Path) -> dict[str, ctypes.CDLL]:
    """One nvcc per source, all started together, as `_build` builds."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        so = out_dir / f"lib{name}.so"
        cmd = [_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_attention_body: needs a CUDA card")
    card = card_name()
    src = (_build.CSRC_DIR / "attention_sm90.cu").read_text()
    sources = {"source": src}
    for _, _, _, _, variants, _, _ in ROWS.values():
        sources.update({n: variant_source(src, e) for n, e in variants.items()})
    libs = build(sources, _build.BUILD_DIR / "probe_attention_body")
    fns = {}
    for name, lib in libs.items():
        fn = lib.ecad_attention_sm90_fwd
        fn.argtypes, fn.restype = A._sm90_kernel().argtypes, ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    try:
        for row, (shape, tk, lengths, counter, variants, reps, inner) in ROWS.items():
            b, _, h, d = shape
            q, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
                       for s in (shape, (b, tk, h, d), (b, tk, h, d)))
            bias = None
            if lengths is not None:  # the models' text bias, (1 − mask)·−10000 in bf16
                keep = torch.arange(tk, device="cuda")[None] < torch.tensor(
                    [lengths[i % len(lengths)] for i in range(b)], device="cuda")[:, None]
                bias = torch.where(keep, 0.0, -10000.0).to(torch.bfloat16)[:, None, None, :]

            def call(name):
                def go():
                    A._SM90_FN = fns[name]
                    return A._launch_sm90(q, k, v, counter, bias)
                return go

            names = ["source", *variants]
            want = call("source")()
            same = {}
            for n in variants:
                if n in EXACT:
                    same[n] = bool(torch.equal(call(n)(), want))
            del want
            times = {n: [] for n in names}
            for n in names + names[::-1]:
                times[n].append(device_ms(call(n), reps, inner)[0])
            result = {"row": row, "shape": list(shape), "keys": tk, "card": card,
                      "ms": times, "bit_identical": same,
                      "sm_clock_mhz_after": card_sample()["sm_clock_mhz"]}
            print(json.dumps(result), flush=True)
            rows.append(result)
            if not all(same.values()):
                raise SystemExit(f"{row}: a rescheduled variant changed the output: {same}")
    finally:
        A._SM90_FN = None  # the tree's own library again on the next call
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
