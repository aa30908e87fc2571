"""What sets the pace of the Hopper attention bodies (``csrc/attention_sm90.cu``,
bf16, and ``csrc/attention_f32_sm90.cu``, fp32): copies of a source, each
with one piece of a kernel's work taken out or one design choice undone,
built beside it and timed against it in turns, in one process on one card.

    python -m ecad_tpu_torch.scripts.probe_attention_body [--out probes.json]
        [--rows k1_dim1536,k2_dim1536] [--rounds N]

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
* K2 with a dense bf16 bias (B, H, Tq, Tk) (``attn_exact_dense_sm90_kernel``)
  at PixArt-256's cross-attention (16, 256, 16, 72) → 120, at FLUX-256's
  width (4, 768, 24, 128) → 768 and past the single tile (2, 4096, 16, 72)
  → 4096, and at the width-reduced FLUX-256's (8, 768, 24, 64) → 768, with
  ``dense_no_prefetch`` (each tile's bias pairs loaded just after its own
  q·kᵀ is issued, D=128's form, at every head dim), ``dense_prefetch``
  (one tile ahead at every head dim, D=128 too), ``dense_scalar_loads`` (the
  form a bias without aligned pairs takes: each value a 2-byte load where
  it is used) and ``no_dense_bias_loads`` (pairs of 0 for the bias);
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
* K5 at head dim 72, at the kernel shoot-out's ``pixart1024`` (8, 4096,
  16, 72), with ``rowblock_two_consumers`` (two consumer warpgroups and
  128-row items instead of three and 192), and with a key-padding bias
  (4000 of the 4096 keys kept) with ``rowblock_three_consumers`` (three
  instead of two, and their spills) and ``no_bias_loads``; K5 at the
  reference's "PixArt-256" self-attention (64, 1024, 16, 72) of
  scripts/exp_attn_pixart256.py, whose last 192-row item of each (batch,
  head) holds 64 rows, with ``rowblock_two_consumers``; K5 at head dim
  64 at the width-reduced FLUX 256² (8, 768, 24, 64), the same variants;
  K4 at PixArt-1024's
  self-attention (4, 4096, 16, 72) with ``clamp_three_consumers`` (three
  consumer warpgroups at D=72 as well), K5-D72's count on the route that
  serves that width;
* K1 at FLUX-256's joint attention (4, 768, 24, 128), with
  ``items_in_runs``;
* K1 at head dims 32 and 16 at PixArt-256's self-attention shape (16, 256,
  16, D), and K2 at 32 to its 120 text keys, with ``exact_narrow_three``
  (three consumer warpgroups, as at 64, instead of two); K4, K5 and K6 at
  32 and 16 ((4, 4096, 8, D); K6 (1, 9728, 8, D)) with ``clamp_narrow_two``,
  ``rowblock_narrow_two`` and ``flash_narrow_two`` (two consumer warpgroups
  instead of D=64's three);
* K1 at head dim 64, the reference's width-reduced FLUX 256² (8, 768, 24,
  64), with ``d64_two_consumers`` (two consumer warpgroups and 128-row
  items instead of three and 192), K6's ``no_softmax``, ``no_exp2``,
  ``no_pv`` and ``no_kv_loads``; K2 at the same shape with 700 of the 768
  keys kept, with ``no_bias_loads`` and ``d64_two_consumers``;
* K4 at head dim 64 at the same shape, as the router sends it, with
  ``clamp_two_consumers`` (two consumer warpgroups instead of three),
  ``one_block_per_item`` (a grid of items instead of the persistent
  launch), ``clamp_no_softmax``, ``clamp_no_exp2``, ``no_pv``,
  ``no_kv_loads`` and ``poly_every_4`` / ``poly_every_8`` (the exp2s of
  every fourth or eighth column block of 8 scores as a polynomial on the
  FMA pipes); K4 with 700 of the 768 keys kept, with
  ``clamp_bias_three_consumers`` (three consumer warpgroups instead of
  two, and their spills), ``one_block_per_item``, ``no_bias_loads`` and
  ``poly_every_4``;
* K6 at head dim 64 at the width-reduced FLUX's 1536² (1, 9728, 24, 64),
  with ``two_consumers``, ``no_softmax``, ``no_exp2``, ``no_pv``,
  ``no_kv_loads``, ``poly_every_4`` and ``poly_every_8``; K6 with 9000 of
  the 9728 keys kept, with ``two_consumers``, ``no_bias_loads`` and
  ``poly_every_4``;
* the harness's X3 (max on a pre-scaled q) at its ``pixart1024`` (8, 4096,
  16, 72) and ``pixart512_class_self`` (64, 1024, 16, 72) shapes, with
  ``xmax_two_consumers`` (K6's ``two_consumers`` edit, since X2 and X3
  share its consumer count: two consumer warpgroups and 128-row items
  instead of three and 192) and ``xmax_no_max`` (X3's kernel with X2's
  softmax: no max, no rescale), X2 (no max) at both shapes with
  ``xnomax_two_consumers``, and X4 (the clamp with the denominator from the
  p·v product) at both shapes with ``xfd_three_consumers`` (and their
  spills) and ``xfd_n8`` (the ones column as a second m64n8k16 product
  beside the tail's, instead of one m64n16k16 over both);
* the harness's X1 (the products alone, no softmax) at both shapes, with
  ``xmatmul_two_consumers`` (K6's ``two_consumers`` edit, as for X2 and
  X3).

Rows of the fp32 body (`F32_ROWS`), fp32 at the shapes of chip_smoke.py's
fp32 rows — K4 at PixArt-1024's (4, 4096, 16, 72), K5 at FLUX-1024's (1,
4608, 24, 128), K1 at PixArt-256's (16, 256, 16, 72) and K6 at PixArt-Σ-
2048's (2, 16384, 16, 72) — with ``pv_mma_sync`` (p·v on ``mma.sync``
m16n8k8 .tf32 from v's split rows as stored, instead of wgmma from the
transposed vᵀ the helpers write), ``bn32_three_stages`` (three stages of 32
keys instead of two of 64, at D ≤ 72), ``helpers_three_warps`` (one
producer-side warpgroup: three helper warps instead of seven), ``no_vt``
(the helpers write no vᵀ), ``no_k_split`` (nor split k), ``no_helper_work``
(neither), ``no_softmax`` (clamp: p = s), ``no_pv`` (no p·v products),
``pv_one_pass`` and ``s_one_pass`` (only the big·big TF32 product of p·v,
or of q·kᵀ). At width 256, K6 at (1, 4608, 12, 256) and K5 at (2, 2048, 8,
256), the two-block cluster's form (each block the width-128 form on half
of the head dim, the partial scores summed through the cluster's shared
memory) against ``no_cluster`` (one
block, one 16-key stage: the form before it), ``no_cluster_three_helper_
warps`` (that form with one producer-side warpgroup, a 256-thread block),
the cluster with three helper warps a block (``cluster_three_helper_warps``,
a 256-thread block) and with each product's descriptor made as it is
issued (``cluster_stepped_scores``). At widths 512 and 384, K2 at (16, 256,
8, D) → 120 keys with the text bias and K5 at (2, 2048, 8, D), the clusters
of four and three blocks against ``streamed`` (the streamed form every
width past 256 took before them: the parent's kernels in the same build),
``stores_first`` (every peer's stores before the first arrival: one
release wait a tile, not one a peer)
and ``no_exchange`` (no partial scores summed: wrong, what the exchange
costs).

A variant that only reschedules the same arithmetic (``two_consumers``,
``helpers_three_warps``, ``cluster_three_helper_warps``, ``stores_first``,
``dense_no_prefetch``,
``dense_prefetch``, ``dense_scalar_loads``,
``k6_bias_three_consumers``, ``d64_two_consumers``, ``exact_narrow_three``,
``clamp_narrow_two``, ``rowblock_narrow_two``, ``flash_narrow_two``,
``clamp_two_consumers``,
``clamp_bias_three_consumers``, ``clamp_three_consumers``, ``rowblock_three_consumers``,
``rowblock_two_consumers``, ``one_block_per_item``,
``items_in_runs``, ``bias_after_q``, ``xmax_two_consumers``,
``xnomax_two_consumers``, ``xfd_three_consumers``, ``xmatmul_two_consumers``)
must give the source's output bit for bit; the
others compute something else, or the same in another instruction, and
are timed only. Each row also carries the spill bytes ``ptxas -v``
reports for each build's kernel of that row. Each variant's time is the
median of spin-kernel CUDA-event timings (`device_ms`), taken in turns:
source, variants, variants again in reverse, source, ``--rounds`` times
(one by default). Prints one JSON line
per row and writes them to ``--out``. The edits are text replacements
(every occurrence) checked against the source: one that no longer matches
raises. ``--rows`` takes a comma-separated subset of the rows (`ROWS`),
and builds only their variants.
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
    "two_consumers": [("constexpr int kFlashConsumers = D >= 128 ? 2 : 3;",
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
         "j * kBN, b);",
         f"          if (g < kStages) {{ mbar_expect_tx({x}_full(s), kKV.load());\n"
         f"          tma_tile<D>({x}_s(s), kKV, &maps[{i}], &maps[{i + 3}], {x}_full(s), h, "
         f"j * kBN, b); }} else mbar_arrive({x}_full(s));")
        for x, i in (("k", 1), ("v", 2))],
    "no_pv": [("      wgmma_fence();\n#pragma unroll\n"
               "      for (int kk = 0; kk < kPvSteps; ++kk) pv(o, pf[kk], sp, kk);\n"
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
    "k6_bias_three_consumers": [("constexpr int kStreamConsumers = BIAS && D > 64 ? 2 : "
                                 "kFlashConsumers<D>;",
                                 "constexpr int kStreamConsumers = kFlashConsumers<D>;")],
}
K4_BIAS_VARIANTS = {
    "one_block_per_item": [("  if (mode == 2 || (Tk + kBlockN - 1) / kBlockN <= kPersistentTiles) {",
                            "  if (mode == 2) {")],
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
# K2 with a dense bias: its pairs loaded under their own tile's q·kᵀ or one
# tile ahead at every head dim, its values loaded one by one at their use,
# or not loaded at all
K2_DENSE_VARIANTS = {
    "dense_no_prefetch": [("constexpr bool kDensePrefetch = D < 128;",
                           "constexpr bool kDensePrefetch = false;")],
    "dense_prefetch": [("constexpr bool kDensePrefetch = D < 128;",
                        "constexpr bool kDensePrefetch = true;")],
    "dense_scalar_loads": [("  p.bias_pairs = dense && bias_pairs;", "  p.bias_pairs = 0;")],
    "no_dense_bias_loads": [
        ("? __ldg(reinterpret_cast<const unsigned int*>(bias + off[r] + col + 8 * j))",
         "? 0u")],
}
# K5 at D=72 and 64: the other consumer count of each width and bias form
ROWBLOCK_CONSUMERS = "constexpr int kRowblockConsumers = D < 128 && !BIAS ? 3 : 2;"
K5_VARIANTS = {"rowblock_two_consumers": [
    (ROWBLOCK_CONSUMERS, "constexpr int kRowblockConsumers = 2;")]}
K5_BIAS_NARROW_VARIANTS = {
    "rowblock_three_consumers": [
        (ROWBLOCK_CONSUMERS, "constexpr int kRowblockConsumers = D >= 128 ? 2 : 3;")],
    **K5_BIAS_VARIANTS}
D64_VARIANTS = {"d64_two_consumers": [("constexpr int kExactConsumers = D == 64 ? 3 : 2;",
                                        "constexpr int kExactConsumers = 2;")]}
K1_D64_VARIANTS = {
    **D64_VARIANTS,
    **{n: K6_VARIANTS[n] for n in ("no_softmax", "no_exp2", "no_pv", "no_kv_loads")},
}
K2_D64_VARIANTS = {**K2_VARIANTS, **D64_VARIANTS}
# K1 and K2 at the narrow widths (32 and 16) on three consumer warpgroups,
# as at 64, instead of two
NARROW_VARIANTS = {"exact_narrow_three": [("constexpr int kExactConsumers = D == 64 ? 3 : 2;",
                                           "constexpr int kExactConsumers = D <= 64 ? 3 : 2;")]}
# K4, K5 and K6 at the narrow widths on two consumer warpgroups instead of
# D=64's three
NARROW_CLAMP_VARIANTS = {"clamp_narrow_two": [
    ("constexpr int kClampConsumers = D <= 64 && !BIAS ? 3 : 2;",
     "constexpr int kClampConsumers = D == 64 && !BIAS ? 3 : 2;")]}
NARROW_ROWBLOCK_VARIANTS = {"rowblock_narrow_two": [
    ("constexpr int kRowblockConsumers = D < 128 && !BIAS ? 3 : 2;",
     "constexpr int kRowblockConsumers = D < 128 && D >= 64 && !BIAS ? 3 : 2;")]}
NARROW_FLASH_VARIANTS = {"flash_narrow_two": [
    ("constexpr int kFlashConsumers = D >= 128 ? 2 : 3;",
     "constexpr int kFlashConsumers = D >= 128 || D < 64 ? 2 : 3;")]}
# K4 and K6 at D=64: the exp2s of every fourth or eighth column block of a
# tile's scores from the FMA pipes (`ex2_poly`: x = j + f with j = rint(x)
# by the 1.5·2^23 trick, 2^f by a degree-3 polynomial on [−½, ½], relative
# error below 7.5e-5, j added to the exponent field), K4 on two consumers
# (three with a bias), its launch a grid of items (`one_block_per_item`),
# its softmax or its exp2s taken out
EX2_POLY = """__device__ __forceinline__ float ex2_poly(float x) {
  x = fmaxf(x, -126.f);
  const float t = __fadd_rn(x, 12582912.f);
  const float f = __fsub_rn(x, __fsub_rn(t, 12582912.f));
  const float p = fmaf(fmaf(fmaf(0.0551716685f, f, 0.2426111400f), f, 0.6932609677f), f,
                       0.9999280572f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}
"""


def poly_edits(n: int) -> list[tuple[str, str]]:
    on = f"(i >> 2) % {n} == {n - 1}"
    return [
        ("__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {",
         EX2_POLY + "__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {"),
        ("    const float p = ex2(fmaf(s[i], qk_scale, shift[r]));",
         "    const float x = fmaf(s[i], qk_scale, shift[r]);\n"
         f"    const float p = {on} ? ex2_poly(x) : ex2(x);"),
        ("    const float p = ex2(s[i] - mx[r]);",
         f"    const float p = {on} ? ex2_poly(s[i] - mx[r]) : ex2(s[i] - mx[r]);"),
        ("    float p = ex2(CLIP ? fminf(fmaxf(x, kClampLo), kClampHi) : x);",
         "    const float xc = CLIP ? fminf(fmaxf(x, kClampLo), kClampHi) : x;\n"
         f"    float p = {on} ? ex2_poly(xc) : ex2(xc);")]


POLY_VARIANTS = {f"poly_every_{n}": poly_edits(n) for n in (4, 8)}
K4_D64_VARIANTS = {
    "clamp_two_consumers": [("constexpr int kClampConsumers = D <= 64 && !BIAS ? 3 : 2;",
                             "constexpr int kClampConsumers = 2;")],
    "one_block_per_item": K4_BIAS_VARIANTS["one_block_per_item"],
    **POLY_VARIANTS,
    "clamp_no_softmax": [(
        "    if (edge) softmax_nomax<true, BIAS, kClip, kSum>(s, b2, l, k0 + col_t, Tk);\n"
        "    else softmax_nomax<false, BIAS, kClip, kSum>(s, b2, l, k0 + col_t, Tk);",
        "    (void)edge;")],
    "clamp_no_exp2": [("    float p = ex2(CLIP ? fminf(fmaxf(x, kClampLo), kClampHi) : x);",
                       "    float p = CLIP ? fminf(fmaxf(x, kClampLo), kClampHi) : x;")],
    **{n: K6_VARIANTS[n] for n in ("no_pv", "no_kv_loads")},
}
K4_D72_VARIANTS = {"clamp_three_consumers": [
    ("constexpr int kClampConsumers = D <= 64 && !BIAS ? 3 : 2;",
     "constexpr int kClampConsumers = D < 128 && !BIAS ? 3 : 2;")]}
K4_BIAS_D64_VARIANTS = {
    "clamp_bias_three_consumers": [
        ("constexpr int kClampConsumers = D <= 64 && !BIAS ? 3 : 2;",
         "constexpr int kClampConsumers = D <= 64 ? 3 : 2;")],
    "one_block_per_item": K4_BIAS_VARIANTS["one_block_per_item"],
    **K2_VARIANTS, "poly_every_4": POLY_VARIANTS["poly_every_4"]}
K6_D64_VARIANTS = {
    **{n: K6_VARIANTS[n] for n in ("two_consumers", "no_softmax", "no_exp2", "no_pv",
                                   "no_kv_loads")},
    **POLY_VARIANTS,
}
K6_BIAS_D64_VARIANTS = {"two_consumers": K6_VARIANTS["two_consumers"], **K2_VARIANTS,
                        "poly_every_4": POLY_VARIANTS["poly_every_4"]}
# X1, X2 and X3 share K6's consumer count, so K6's edit takes each to two
X1_VARIANTS = {"xmatmul_two_consumers": K6_VARIANTS["two_consumers"]}
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
# row → (q shape, keys, text lengths of the bias, "dense" for a dense bf16
# (B, H, Tq, Tk) bias, or None, the wrapper's counter, its variants, timing
# reps and calls per rep)
ROWS = {
    "k6_pixart2048": ((2, 16384, 16, 72), 16384, None, "attention_flash", K6_VARIANTS, 3, 5),
    "k6_bias_pixart2048": ((2, 16384, 16, 72), 16384, (15384, 9000), "attention_flash",
                           K6_BIAS_VARIANTS, 3, 5),
    "k6_bias_flux1536": ((1, 9728, 24, 128), 9728, (9000,), "attention_flash", K2_VARIANTS,
                         3, 5),
    "k2_pixart256_cross": ((16, 256, 16, 72), 120, (7, 60, 120), "attention", K2_VARIANTS,
                           7, 20),
    "k2_dense_pixart256_cross": ((16, 256, 16, 72), 120, "dense", "attention",
                                 K2_DENSE_VARIANTS, 7, 20),
    "k2_dense_flux256": ((4, 768, 24, 128), 768, "dense", "attention", K2_DENSE_VARIANTS,
                         7, 20),
    "k2_dense_past_the_tile": ((2, 4096, 16, 72), 4096, "dense", "attention",
                               K2_DENSE_VARIANTS, 3, 5),
    "k2_dense_dim1536": ((8, 768, 24, 64), 768, "dense", "attention", K2_DENSE_VARIANTS,
                         7, 20),
    "k4_bias_pixart1024_cross": ((4, 4096, 16, 72), 120, (7, 60, 120), "attention_long",
                                 K4_BIAS_VARIANTS, 7, 20),
    "k5_bias_flux1024": ((1, 4608, 24, 128), 4608, (4508,), "attention_rowblock",
                         K5_BIAS_VARIANTS, 5, 10),
    "k4_pixart1024": ((4, 4096, 16, 72), 4096, None, "attention_long", K4_D72_VARIANTS, 5, 10),
    "k5_pixart1024": ((8, 4096, 16, 72), 4096, None, "attention_rowblock", K5_VARIANTS, 5, 5),
    "k5_pixart512_class_self": ((64, 1024, 16, 72), 1024, None, "attention_rowblock",
                                K5_VARIANTS, 5, 5),
    "k5_bias_pixart1024": ((8, 4096, 16, 72), 4096, (4000,), "attention_rowblock",
                           K5_BIAS_NARROW_VARIANTS, 5, 5),
    "k5_dim1536": ((8, 768, 24, 64), 768, None, "attention_rowblock", K5_VARIANTS, 7, 20),
    "k5_bias_dim1536": ((8, 768, 24, 64), 768, (700,), "attention_rowblock",
                        K5_BIAS_NARROW_VARIANTS, 7, 20),
    "k1_d32_pixart256": ((16, 256, 16, 32), 256, None, "attention", NARROW_VARIANTS, 7, 20),
    "k1_d16_pixart256": ((16, 256, 16, 16), 256, None, "attention", NARROW_VARIANTS, 7, 20),
    "k2_d32_pixart256_cross": ((16, 256, 16, 32), 120, (7, 60, 120), "attention",
                               NARROW_VARIANTS, 7, 20),
    **{f"k{k}_d{d}": (shape, shape[1], None, counter, variants, 5, 5)
       for d in (32, 16)
       for k, shape, counter, variants in (
           (4, (4, 4096, 8, d), "attention_long", NARROW_CLAMP_VARIANTS),
           (5, (4, 4096, 8, d), "attention_rowblock", NARROW_ROWBLOCK_VARIANTS),
           (6, (1, 9728, 8, d), "attention_flash", NARROW_FLASH_VARIANTS))},
    "k1_flux256": ((4, 768, 24, 128), 768, None, "attention",
                   {"items_in_runs": K4_BIAS_VARIANTS["items_in_runs"]}, 7, 20),
    "k1_dim1536": ((8, 768, 24, 64), 768, None, "attention", K1_D64_VARIANTS, 7, 20),
    "k2_dim1536": ((8, 768, 24, 64), 768, (700,), "attention", K2_D64_VARIANTS, 7, 20),
    "k4_dim1536": ((8, 768, 24, 64), 768, None, "attention_long", K4_D64_VARIANTS, 7, 20),
    "k4_bias_dim1536": ((8, 768, 24, 64), 768, (700,), "attention_long", K4_BIAS_D64_VARIANTS,
                        7, 20),
    "k6_dim1536": ((1, 9728, 24, 64), 9728, None, "attention_flash", K6_D64_VARIANTS, 3, 5),
    "k6_bias_dim1536": ((1, 9728, 24, 64), 9728, (9000,), "attention_flash",
                        K6_BIAS_D64_VARIANTS, 3, 5),
    "x3_pixart1024": ((8, 4096, 16, 72), 4096, None, "xattn_max", X3_VARIANTS, 5, 5),
    "x3_pixart512_class_self": ((64, 1024, 16, 72), 1024, None, "xattn_max", X3_VARIANTS,
                                5, 5),
    "x2_pixart1024": ((8, 4096, 16, 72), 4096, None, "xattn_nomax", X2_VARIANTS, 5, 5),
    "x2_pixart512_class_self": ((64, 1024, 16, 72), 1024, None, "xattn_nomax", X2_VARIANTS,
                                5, 5),
    "x4_pixart1024": ((8, 4096, 16, 72), 4096, None, "xattn_fd", X4_VARIANTS, 5, 5),
    "x4_pixart512_class_self": ((64, 1024, 16, 72), 1024, None, "xattn_fd", X4_VARIANTS, 5, 5),
    "x1_pixart1024": ((8, 4096, 16, 72), 4096, None, "xattn_matmul_only", X1_VARIANTS, 5, 5),
    "x1_pixart512_class_self": ((64, 1024, 16, 72), 1024, None, "xattn_matmul_only",
                                X1_VARIANTS, 5, 5),
}
# the fp32 body's variants (csrc/attention_f32_sm90.cu). `pv_mma_sync`: p·v on
# `mma.sync` m16n8k8 .tf32 for each warp's 16 rows — p's A fragments as for
# wgmma (a warp's slice of them), v's big and small rows ([BN][D], split in
# place of the transpose: the helpers copy v's raw tile into the vᵀ parts)
# read as B fragments in p's key order (logical k = t is key 2t, t + 4 key
# 2t + 1); o's accumulators keep wgmma's layout
F32_PV_MMA_SYNC = """__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int D, int BN>
__device__ __forceinline__ void pv_mma_sync(float (&o)[D / 2], const uint32_t (&pb)[BN / 8][4],
                                            const uint32_t (&ps)[BN / 8][4], const float* vb,
                                            const float* vs, int lane) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk)
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int at = (8 * kk + 2 * (lane % 4)) * D + 8 * nb + lane / 4;
      const uint32_t b0 = __float_as_uint(vb[at]), b1 = __float_as_uint(vb[at + D]);
      mma_tf32(o + 4 * nb, ps[kk], b0, b1);
      mma_tf32(o + 4 * nb, pb[kk], __float_as_uint(vs[at]), __float_as_uint(vs[at + D]));
      mma_tf32(o + 4 * nb, pb[kk], b0, b1);
    }
}

"""
F32_PV = """#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) wgmma_rs<D>(ot, ps[kk], vt_desc(vb, kk));
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) wgmma_rs<D>(ot, pb[kk], vt_desc(vs, kk));
"""
F32_PV_BIG = """#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) wgmma_rs<D>(ot, pb[kk], vt_desc(vb, kk));
"""
F32_S = """#pragma unroll
        for (int kc = 0; kc < D / 8; ++kc) wgmma_ss<BN>(sc, q_desc(q_small, kc), k_desc(kb, kc), kc);
#pragma unroll
        for (int kc = 0; kc < D / 8; ++kc) wgmma_ss<BN>(sc, q_desc(q_big, kc), k_desc(ks, kc), 1);
#pragma unroll
        for (int kc = 0; kc < D / 8; ++kc) wgmma_ss<BN>(sc, q_desc(q_big, kc), k_desc(kb, kc), 1);"""
F32_VT = "          write_vt<D, BN>(kb + 2 * C::kKV, kb + 3 * C::kKV, kb + C::kKV, ht);\n"
F32_NO_VT = [(F32_VT, "")]
F32_NO_K_SPLIT = [("          split_tile(kb, kb + C::kKV, C::kKV, 1.f, ht);\n", "")]
F32_VARIANTS = {
    "pv_mma_sync": [
        ("// The shared body of the four kernels,",
         F32_PV_MMA_SYNC + "// The shared body of the four kernels,"),
        (F32_VT, "          for (int i = ht; i < C::kKV / 16; i += kHelperThreads) {\n"
                 "            const float4 x = reinterpret_cast<float4*>(kb + C::kKV)[i];\n"
                 "            float4 hi, lo;\n"
                 "            split(x.x, hi.x, lo.x);\n            split(x.y, hi.y, lo.y);\n"
                 "            split(x.z, hi.z, lo.z);\n            split(x.w, hi.w, lo.w);\n"
                 "            reinterpret_cast<float4*>(kb + 2 * C::kKV)[i] = hi;\n"
                 "            reinterpret_cast<float4*>(kb + 3 * C::kKV)[i] = lo;\n"
                 "          }\n"),
        ("        wgmma_fence();\n" + F32_PV + F32_PV_BIG + """        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(ot);
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) {
          fence_regs(pb[kk]);
          fence_regs(ps[kk]);
        }""", "        pv_mma_sync<D, BN>(ot, pb, ps, reinterpret_cast<const float*>(gen(vb)),\n"
              "                           reinterpret_cast<const float*>(gen(vs)), lane);")],
    "bn32_three_stages": [("  static constexpr int kBN = D > 128 ? 16 : D > 72 ? 32 : 64;\n"
                           "  static constexpr int kStages = D > 192 ? 1 : 2;",
                           "  static constexpr int kBN = D > 128 ? 16 : 32;\n"
                           "  static constexpr int kStages = D > 192 ? 1 : D > 72 ? 2 : 3;")],
    "helpers_three_warps": [("constexpr int kProducerGroups = 2;",
                             "constexpr int kProducerGroups = 1;")],
    "no_vt": F32_NO_VT,
    "no_k_split": F32_NO_K_SPLIT,
    "no_helper_work": F32_NO_VT + F32_NO_K_SPLIT,
    "no_softmax": [("      const float pe = col < p.Tk ? ex2(fminf(fmaxf(x, kClampLo), "
                    "kClampHi)) : 0.f;", "      const float pe = x;")],
    "no_pv": [(F32_PV + F32_PV_BIG, "")],
    "pv_one_pass": [(F32_PV, "")],
    "s_one_pass": [(F32_S, """#pragma unroll
        for (int kc = 0; kc < D / 8; ++kc) wgmma_ss<BN>(sc, q_desc(q_big, kc), k_desc(kb, kc), kc);""")],
}
# fp32 at width 256: the two-block cluster's form (the source) against the
# one-block form it replaced (`no_cluster`: q's big and small parts for 64
# rows, 128 KB, leave one stage of 16 keys; o's 128 accumulators and a
# chunk's 32 beside the rest under the 168 registers of a 384-thread block),
# that form on one producer-side warpgroup (`no_cluster_three_helper_warps`:
# a 256-thread block, whose consumer ptxas may give 240 registers), and the
# cluster's blocks on one producer-side warpgroup (`cluster_three_helper_
# warps`, three helper warps instead of seven)
F32_NO_CLUSTER = [("constexpr int kSplit = D == 256 ? 2 : ", "constexpr int kSplit = ")]
# the scores' products with each descriptor made as the product is issued
# (`scores_stepped`, as past width 128), not made up front
F32_CLUSTER_STEPPED = [
    ("      if constexpr (D > 128) {\n        // the small products, then the big one",
     "      if constexpr (D > 128 || SPLIT > 1) {\n        // the small products, then the big one")]
F32_D256_VARIANTS = {"no_cluster": F32_NO_CLUSTER,
                     "no_cluster_three_helper_warps":
                         F32_NO_CLUSTER + F32_VARIANTS["helpers_three_warps"],
                     "cluster_three_helper_warps": F32_VARIANTS["helpers_three_warps"],
                     "cluster_stepped_scores": F32_CLUSTER_STEPPED}
# fp32 at widths 384 and 512: the clusters of three and four blocks (the
# source) against the streamed form they replaced there (`streamed`: the C
# entry sends every width past 256 to it, as before), with every peer's
# stores issued before the first arrival (`stores_first`: one release wait
# a tile, not one a peer), and without the exchange
# (`no_exchange`: each block's softmax on its own partial scores — wrong,
# what the exchange costs)
F32_STREAMED = [("constexpr int kMaxWidth = 512;", "constexpr int kMaxWidth = 256;")]
F32_STORES_FIRST = [("""                   : "memory");
    peer_arrive(peer_addr(full, peer));
  }
  mbar_wait_cluster(full, parity);
""", """                   : "memory");
  }
#pragma unroll
  for (int j = 1; j < SPLIT; ++j) peer_arrive(peer_addr(full, (rank + j) % SPLIT));
  mbar_wait_cluster(full, parity);
""")]
F32_NO_EXCHANGE = [("""        exchange_scores<SPLIT>(sc, xchg + x * C::kXchgRound, x_full(x), x_empty(x), parity,
                               threadIdx.x - 128 * kProducerGroups, rank);
""", "        (void)x, (void)parity;\n")]
F32_WIDE_VARIANTS = {"streamed": F32_STREAMED, "stores_first": F32_STORES_FIRST,
                     "no_exchange": F32_NO_EXCHANGE}
F32_ROWS = {
    "f32_k2_d512": ((16, 256, 8, 512), 120, (7, 60, 120), "attention", F32_WIDE_VARIANTS, 5,
                    10),
    "f32_k5_d512": ((2, 2048, 8, 512), 2048, None, "attention_rowblock", F32_WIDE_VARIANTS, 3,
                    2),
    "f32_k2_d384": ((16, 256, 8, 384), 120, (7, 60, 120), "attention", F32_WIDE_VARIANTS, 5,
                    10),
    "f32_k5_d384": ((2, 2048, 8, 384), 2048, None, "attention_rowblock", F32_WIDE_VARIANTS, 3,
                    2),
    "f32_k6_d256": ((1, 4608, 12, 256), 4608, None, "attention_flash", F32_D256_VARIANTS, 3, 2),
    "f32_k5_d256": ((2, 2048, 8, 256), 2048, None, "attention_rowblock", F32_D256_VARIANTS, 3,
                    2),
    "f32_k4_pixart1024": ((4, 4096, 16, 72), 4096, None, "attention_long", F32_VARIANTS, 3, 2),
    "f32_k5_flux1024": ((1, 4608, 24, 128), 4608, None, "attention_rowblock",
                        {n: e for n, e in F32_VARIANTS.items() if n != "bn32_three_stages"},
                        3, 2),
    "f32_k1_pixart256": ((16, 256, 16, 72), 256, None, "attention",
                         {n: e for n, e in F32_VARIANTS.items() if n != "no_softmax"}, 5, 10),
    "f32_k6_pixart2048": ((2, 16384, 16, 72), 16384, None, "attention_flash",
                          {n: F32_VARIANTS[n] for n in ("pv_mma_sync", "bn32_three_stages",
                                                        "helpers_three_warps")}, 3, 1),
}
# each body: its source, C entry, the cached C function in ops/attention.py
# and its loader, and the rows' dtype
BODIES = {"sm90": ("attention_sm90", "ecad_attention_sm90_fwd", "_SM90_FN", A._sm90_kernel,
                   torch.bfloat16),
          "f32": ("attention_f32_sm90", "ecad_attention_f32_sm90_fwd", "_F32_FN",
                  A._f32_kernel, torch.float32)}
ROUTES = {"attention": "exact", "attention_long": "clamp", "attention_rowblock": "rowblock",
          "attention_flash": "flash"}
# the same arithmetic, rescheduled
EXACT = ("two_consumers", "helpers_three_warps", "cluster_three_helper_warps", "stores_first",
         "exact_narrow_three", "clamp_narrow_two",
         "rowblock_narrow_two", "flash_narrow_two", "k6_bias_three_consumers", "d64_two_consumers",
         "clamp_two_consumers", "clamp_bias_three_consumers", "clamp_three_consumers",
         "rowblock_three_consumers",
         "rowblock_two_consumers", "one_block_per_item", "items_in_runs",
         "bias_after_q", "xmax_two_consumers", "xnomax_two_consumers", "xfd_three_consumers",
         "xmatmul_two_consumers", "dense_no_prefetch", "dense_prefetch", "dense_scalar_loads")
# the device kernel of each counter (its name, and whether it carries the
# BIAS flag in its template arguments)
KERNELS = {"attention_flash": ("attn_flash_sm90_kernel", True),
           "attention": ("attn_exact_sm90_kernel", True),
           "attention_long": ("attn_clamp_sm90_kernel", True),
           "attention_rowblock": ("attn_rowblock_sm90_kernel", True),
           "xattn_nomax": ("attn_xnomax_sm90_kernel", False),
           "xattn_max": ("attn_xmax_sm90_kernel", False),
           "xattn_fd": ("attn_xfd_sm90_kernel", False),
           "xattn_matmul_only": ("attn_xmatmul_sm90_kernel", False)}


def kernel_symbol(counter: str, d: int, bias: bool, body: str = "sm90",
                  dense: bool = False) -> str:
    """The part of the mangled name that tells a row's kernel apart, e.g.
    ``attn_flash_sm90_kernelILi72ELb1E`` (``attn_flash_f32_sm90_kernel...``
    on the fp32 body; ``attn_exact_dense_sm90_kernelILi72E`` for K2 with a
    dense bias)."""
    if dense:
        return f"attn_exact_dense_sm90_kernelILi{d}E"
    name, flagged = KERNELS[counter]
    if body == "f32":
        name = name.replace("_sm90_kernel", "_f32_sm90_kernel")
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
    """One nvcc per source, all started together, as `_build` builds (csrc/
    on the include path, for its headers): the loaded libraries and each
    one's spill bytes by kernel (`spill_bytes`)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        so = out_dir / f"lib{name}.so"
        cmd = [_build.nvcc(), *_build.COMPILE_FLAGS, "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(_build.CSRC_DIR),
               "-o", str(so), str(cu)]
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
    parser.add_argument("--rows", default=None,
                        help="comma-separated rows of ROWS and F32_ROWS (default: all)")
    parser.add_argument("--rounds", type=int, default=1,
                        help="times to take the turns (source, variants, reversed)")
    args = parser.parse_args(argv)
    every = {**{r: ("sm90", *v) for r, v in ROWS.items()},
             **{r: ("f32", *v) for r, v in F32_ROWS.items()}}
    rows_run = every if args.rows is None else {r: every[r] for r in args.rows.split(",")}
    if not torch.cuda.is_available():
        raise SystemExit("probe_attention_body: needs a CUDA card")
    card = card_name()
    fns, spills = {}, {}
    for body in sorted({r[0] for r in rows_run.values()}):
        source, entry, _, loader, _ = BODIES[body]
        src = (_build.CSRC_DIR / f"{source}.cu").read_text()
        sources = {"source": src}
        for _, _, _, _, _, variants, _, _ in (r for r in rows_run.values() if r[0] == body):
            sources.update({n: variant_source(src, e) for n, e in variants.items()})
        libs, body_spills = build(sources, _build.BUILD_DIR / "probe_attention_body" / body)
        for name, lib in libs.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = loader().argtypes, ctypes.c_int
            fns[body, name], spills[body, name] = fn, body_spills[name]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    try:
        for row, (body, shape, tk, lengths, counter, variants, reps, inner) in rows_run.items():
            b, _, h, d = shape
            q, k, v = (torch.randn(s, generator=gen, device="cuda").to(BODIES[body][4])
                       for s in (shape, (b, tk, h, d), (b, tk, h, d)))
            bias = None
            if lengths == "dense":
                bias = torch.randn((b, h, shape[1], tk), generator=gen, device="cuda").to(
                    torch.bfloat16)
            elif lengths is not None:  # the models' text bias, (1 − mask)·−10000 in bf16
                keep = torch.arange(tk, device="cuda")[None] < torch.tensor(
                    [lengths[i % len(lengths)] for i in range(b)], device="cuda")[:, None]
                bias = torch.where(keep, 0.0, -10000.0).to(torch.bfloat16)[:, None, None, :]

            def call(name):
                def go():
                    setattr(A, BODIES[body][2], fns[body, name])
                    if body == "f32":
                        return A._launch_f32(q, k, v, counter, bias,
                                             A.pad_keys(ROUTES[counter], tk))
                    return A._launch_sm90(q, k, v, counter, bias,
                                          A.pad_keys(ROUTES[counter], tk)
                                          if counter in ROUTES else 0)
                return go

            names = ["source", *variants]
            want = call("source")()
            same = {}
            for n in variants:
                if n in EXACT:
                    same[n] = bool(torch.equal(call(n)(), want))
            del want
            times = {n: [] for n in names}
            for n in (names + names[::-1]) * args.rounds:
                times[n].append(device_ms(call(n), reps, inner)[0])
            symbol = kernel_symbol(counter, d, bias is not None, body, lengths == "dense")
            spilled = {n: [b for k, b in spills[body, n].items() if symbol in k] for n in names}
            result = {"row": row, "body": body, "shape": list(shape), "keys": tk, "card": card,
                      "ms": times, "bit_identical": same, "spill_bytes": spilled,
                      "sm_clock_mhz_after": card_sample()["sm_clock_mhz"]}
            print(json.dumps(result), flush=True)
            rows.append(result)
            if not all(same.values()):
                raise SystemExit(f"{row}: a rescheduled variant changed the output: {same}")
    finally:
        A._SM90_FN = A._F32_FN = None  # the tree's own libraries again on the next call
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
