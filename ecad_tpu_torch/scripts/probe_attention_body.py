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
* K6 with a key-padding bias (the text bias's form, in bf16, past lengths
  15384 and 9000) at PixArt-Σ-2048's (2, 16384, 16, 72), with
  ``no_bias_loads`` and ``k6_bias_three_consumers`` (three consumer
  warpgroups, as K6 without a bias, and their spills), and at FLUX-1536's
  (1, 9728, 24, 128) with 9000 keys kept, with ``no_bias_loads``;
* K2 at PixArt-256's cross-attention (16, 256, 16, 72) → 120 keys with the
  text bias in bf16, with ``no_bias_loads`` (the helper warps write 0 for
  the bias);
* K4 with a bias at PixArt-1024's cross-attention (4, 4096, 16, 72) → 120
  keys with the text bias in bf16, with ``one_block_per_item`` (a grid of
  items instead of one persistent block per SM), ``items_in_runs`` (a run
  of consecutive items a block instead of items gridDim.x apart),
  ``bias_after_q`` (the helpers write an item's bias after scaling its q,
  not its first tile's before), ``no_bias_loads``, ``no_kv_loads`` (what
  loading each (batch, head)'s k/v tile once could still save), ``no_q_scale``
  (the helpers leave q unscaled) and ``no_store`` (the staging rows
  written, never stored);
* K5 with a bias at FLUX-1024's joint attention (1, 4608, 24, 128) with a
  key-padding bias in bf16 (4508 keys kept), with ``no_bias_loads``;
* K1 at FLUX-256's joint attention (4, 768, 24, 128), with
  ``items_in_runs``;
* the harness's X3 (max on a pre-scaled q) at its ``pixart1024`` (8, 4096,
  16, 72) and ``pixart512_class_self`` (64, 1024, 16, 72) shapes, with
  ``xmax_two_consumers`` (K6's ``two_consumers`` edit, since X2 and X3
  share its consumer count: two consumer warpgroups and 128-row items
  instead of three and 192) and ``xmax_no_max`` (X3's kernel with X2's
  softmax: no max, no rescale), X2 (no max) at both shapes with
  ``xnomax_two_consumers``, and X4 (the clamp with the denominator from the
  p·v product) at both shapes with ``xfd_three_consumers`` (and their
  spills) and ``xfd_n8`` (the ones column as a second m64n8k16 product
  beside the tail's, instead of one m64n16k16 over both).

A variant that only reschedules the same arithmetic (``two_consumers``,
``k6_bias_three_consumers``, ``one_block_per_item``, ``items_in_runs``,
``bias_after_q``, ``xmax_two_consumers``, ``xnomax_two_consumers``,
``xfd_three_consumers``) must give the source's output bit for bit; the
others compute something else, or the same in another instruction, and
are timed only. Each row also carries the spill bytes ``ptxas -v``
reports for each build's kernel of that row. Each variant's time is the
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
import re
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
    "no_pv_tail": [('        " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}"\n'
                    '        ", {%4, %5, %6, %7}, %8, p, 1, 1, 1;\\n}\\n"',
                    '        "}\\n"')],
}
K2_VARIANTS = {
    "no_bias_loads": [("      x = p.bias_bf16 ? __uint_as_float((uint32_t)__ldg(bf16_bias + at) "
                       "<< 16)\n                      : __ldg(f32_bias + at);", "      x = 0.f;")],
}
K6_BIAS_VARIANTS = {
    **K2_VARIANTS,
    "k6_bias_three_consumers": [("constexpr int kStreamConsumers = BIAS ? 2 : kFlashConsumers<D>;",
                                 "constexpr int kStreamConsumers = kFlashConsumers<D>;")],
}
K4_BIAS_VARIANTS = {
    "one_block_per_item": [("  if (mode == 2 || Tk <= kBlockN) {", "  if (mode == 2) {")],
    "items_in_runs": [
        ("for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++it",
         "for (int item = blockIdx.x * ((p.n_items + gridDim.x - 1) / gridDim.x); "
         "item < min(p.n_items, (blockIdx.x + 1) * ((p.n_items + gridDim.x - 1) / gridDim.x)); "
         "++item, ++it")],
    "bias_after_q": [("        if constexpr (BIAS) bias_tile(b, 0);\n", ""),
                     ("for (int j = 1; j < n_tiles; ++j) bias_tile(b, j);",
                      "for (int j = 0; j < n_tiles; ++j) bias_tile(b, j);")],
    "no_bias_loads": K2_VARIANTS["no_bias_loads"],
    "no_kv_loads": K6_VARIANTS["no_kv_loads"],
    "no_q_scale": [("          for (int i = ht; i < kQ.load() / 16; i += kHelperThreads) {",
                    "          for (int i = ht; i < 0; i += kHelperThreads) {")],
    "no_store": [("    if (t == 0) {\n      // rows past Tq are outside the map",
                  "    if (t < 0) {\n      // rows past Tq are outside the map")],
}
K5_BIAS_VARIANTS = {"no_bias_loads": K2_VARIANTS["no_bias_loads"]}
# X2 and X3 share K6's consumer count, so K6's edit takes each to two
X3_VARIANTS = {
    "xmax_two_consumers": K6_VARIANTS["two_consumers"],
    "xmax_no_max": [("  return mode == kExact || mode == kMaxScaledQ;",
                     "  return mode == kExact;")],
}
X2_VARIANTS = {"xnomax_two_consumers": K6_VARIANTS["two_consumers"]}
X4_VARIANTS = {
    "xfd_three_consumers": [
        ("__global__ void __launch_bounds__(384, 1)\n    attn_xfd_sm90_kernel",
         "__global__ void __launch_bounds__(512, 1)\n    attn_xfd_sm90_kernel"),
        ("attn_sm90_body<D, kClampFD, false, 2>", "attn_sm90_body<D, kClampFD, false, 3>"),
        ("launch_of<D, 2, kClampFD>", "launch_of<D, 3, kClampFD>")],
    # the ones tile (2 KB, 128 in the descriptor's address field, after the
    # tail) in a product of its own
    "xfd_n8": [
        ('        " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16"\n'
         '        " {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\\n}\\n"',
         '        " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}"\n'
         '        ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\\n"\n'
         '        " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%4, %5, %6, %7}"\n'
         '        ", {%8, %9, %10, %11}, %14, p, 1, 1, 1;\\n}\\n"'),
        ('        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db_tail), "r"(1));\n  }\n}',
         '        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db_tail), "r"(1),\n'
         '          "l"(db_tail + 128));\n  }\n}')],
}
# row → (q shape, keys, text lengths of the bias or None, the wrapper's
# counter, its variants, timing reps and calls per rep)
ROWS = {
    "k6_pixart2048": ((2, 16384, 16, 72), 16384, None, "attention_flash", K6_VARIANTS, 3, 5),
    "k6_bias_pixart2048": ((2, 16384, 16, 72), 16384, (15384, 9000), "attention_flash",
                           K6_BIAS_VARIANTS, 3, 5),
    "k6_bias_flux1536": ((1, 9728, 24, 128), 9728, (9000,), "attention_flash", K2_VARIANTS,
                         3, 5),
    "k2_pixart256_cross": ((16, 256, 16, 72), 120, (7, 60, 120), "attention", K2_VARIANTS,
                           7, 20),
    "k4_bias_pixart1024_cross": ((4, 4096, 16, 72), 120, (7, 60, 120), "attention_long",
                                 K4_BIAS_VARIANTS, 7, 20),
    "k5_bias_flux1024": ((1, 4608, 24, 128), 4608, (4508,), "attention_rowblock",
                         K5_BIAS_VARIANTS, 5, 10),
    "k1_flux256": ((4, 768, 24, 128), 768, None, "attention",
                   {"items_in_runs": K4_BIAS_VARIANTS["items_in_runs"]}, 7, 20),
    "x3_pixart1024": ((8, 4096, 16, 72), 4096, None, "xattn_max", X3_VARIANTS, 5, 5),
    "x3_pixart512_class_self": ((64, 1024, 16, 72), 1024, None, "xattn_max", X3_VARIANTS,
                                5, 5),
    "x2_pixart1024": ((8, 4096, 16, 72), 4096, None, "xattn_nomax", X2_VARIANTS, 5, 5),
    "x2_pixart512_class_self": ((64, 1024, 16, 72), 1024, None, "xattn_nomax", X2_VARIANTS,
                                5, 5),
    "x4_pixart1024": ((8, 4096, 16, 72), 4096, None, "xattn_fd", X4_VARIANTS, 5, 5),
    "x4_pixart512_class_self": ((64, 1024, 16, 72), 1024, None, "xattn_fd", X4_VARIANTS, 5, 5),
}
# the same arithmetic, rescheduled
EXACT = ("two_consumers", "k6_bias_three_consumers", "one_block_per_item", "items_in_runs",
         "bias_after_q", "xmax_two_consumers", "xnomax_two_consumers", "xfd_three_consumers")
# the device kernel of each counter (its name, and whether it carries the
# BIAS flag in its template arguments)
KERNELS = {"attention_flash": ("attn_flash_sm90_kernel", True),
           "attention": ("attn_exact_sm90_kernel", True),
           "attention_long": ("attn_clamp_sm90_kernel", True),
           "attention_rowblock": ("attn_rowblock_sm90_kernel", True),
           "xattn_nomax": ("attn_xnomax_sm90_kernel", False),
           "xattn_max": ("attn_xmax_sm90_kernel", False),
           "xattn_fd": ("attn_xfd_sm90_kernel", False)}


def kernel_symbol(counter: str, d: int, bias: bool) -> str:
    """The part of the mangled name that tells a row's kernel apart, e.g.
    ``attn_flash_sm90_kernelILi72ELb1E``."""
    name, flagged = KERNELS[counter]
    return f"{name}ILi{d}E" + (f"Lb{int(bias)}E" if flagged else "")


def spill_bytes(log: str) -> dict[str, int]:
    """The spill stores ``ptxas -v`` reports, by mangled kernel name."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name] = int(m.group(1))
            name = None
    return out


def variant_source(src: str, edits: list[tuple[str, str]]) -> str:
    """The source with every occurrence of each edit's text replaced."""
    for old, new in edits:
        if old not in src:
            raise ValueError(f"edit does not match the source: {old[:80]!r}")
        src = src.replace(old, new)
    return src


def build(sources: dict[str, str], out_dir: Path) -> tuple[dict, dict]:
    """One nvcc per source, all started together, as `_build` builds: the
    loaded libraries and each one's spill bytes by kernel (`spill_bytes`)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        so = out_dir / f"lib{name}.so"
        cmd = [_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs, spills = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
        spills[name] = spill_bytes(log)
    return libs, spills


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
    libs, spills = build(sources, _build.BUILD_DIR / "probe_attention_body")
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
            symbol = kernel_symbol(counter, d, bias is not None)
            spilled = {n: [b for k, b in spills[n].items() if symbol in k] for n in names}
            result = {"row": row, "shape": list(shape), "keys": tk, "card": card,
                      "ms": times, "bit_identical": same, "spill_bytes": spilled,
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
