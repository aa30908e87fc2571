// Attention forward in float32 for Hopper (sm_90a): the products on the
// tensor cores through a 3×TF32 split, fed by TMA through mbarriers, with two
// producer-side warpgroups (a TMA warp and seven helper warps) and one or two
// consumer warpgroups. fp32 q, k, v of
// shape (B, T, H, d), any d up to 512, run at the built width D (the
// template argument) at or above it — 16, 32, 40, 64, 72, 96, 128, 192,
// 256, 384 or 512 (ops/attention.py's `f32_width`; TF32's k-step is 8, so
// every width is a multiple of 8, and the maps' inner dim d leaves columns
// d..D−1 to TMA's zero fill), and any d past 512 on a streamed form of the
// same routes (see "past D=512" below) — in 16-byte-aligned strides (the wrapper hands other
// layouts over as packed copies, `tma_copy`), in two softmax modes under
// four kernel names, one per route (and a BIAS flag in the name, so that a
// profile files the forms apart):
//
//   * exact: `attn_exact_f32_sm90_kernel<D, BIAS>` (K1; K2 with a bias)
//     replaces the single-tile kernels `_attn_kernel` (ecad_tpu/ops/
//     attention.py:58) and `_attn_kernel_bias` (:75) on fp32 inputs, and
//     computes the XLA route's function for a dense bias past the single
//     tile (:701-707, no pad keys); `attn_flash_f32_sm90_kernel<D, BIAS>`
//     (K6) replaces the streaming kernel `_flash_kernel` (:151). q is
//     multiplied by 1/√D in fp32 (the reference's pre-scaled q, :60), s =
//     q·kᵀ, plus the fp32 bias, which broadcasts from (B|1, H|1, Tq|1, Tk|1)
//     through four strides (0 where it broadcasts: dense biases too), an
//     online max and sum in fp32, p = exp(s − m) kept in fp32 for p·v (fp32's
//     cast to v's dtype is none), one divide. The reference's n_pad pad keys
//     of score −1e9 (rows of v 0) are added in the epilogue, as attention.cu
//     does: m' = max(m, −1e9), the sums rescaled by exp(m − m'),
//     n_pad·exp(−1e9 − m') added to Σp. s − m is taken before the scale to
//     the log2 domain, so a row whose every score is −1e9 gets p = 1 exactly.
//   * clamp: `attn_clamp_f32_sm90_kernel<D, BIAS>` (K4) replaces
//     `_transposed_kernel` (:285) and `_transposed_kernel_nobias` (:344),
//     `attn_rowblock_f32_sm90_kernel<D, BIAS>` (K5) `_rowblock_kernel` (:255)
//     and `_rowblock_kernel_nobias` (:274), on fp32 inputs: q times
//     clamp_scale(D, float32) (scale·log2e in fp32, :318), s = q·kᵀ, with a
//     key-padding bias (B|1, 1, 1, Tk) plus fp32(bias·log2e) in a plain add, p
//     = exp2(clip(s, −100, 80)) with no max, Σp in fp32 plus n_pad·2^-100 (the
//     reference's pad keys up to a multiple of 128), p in fp32 into p·v, one
//     divide.
//
// Keys past Tk weigh 0 (p = 0, or −∞ before the max); TMA zero-fills the
// rows of q and k past Tq and Tk, and the helpers write zeros for v's.
//
// What bounds it on the H100. In fp32 the function has the work of the bf16
// one — 4·B·H·Tq·Tk·D flops — on twice the bytes: 3.09e11 flops on 302 MB at
// PixArt-1024's (4, 4096, 16, 72), 2.61e11 on 226 MB at FLUX-1024's (1,
// 4608, 24, 128). Outside the tensor cores the card does 67e12 fp32 FLOP/s
// (4.6 and 3.9 ms there): csrc/attention.cu's SIMT kernel reaches about a
// ninth of that. A single TF32 product keeps 11 significant bits, about
// three decimal digits, which fp32's tolerance (1e-5) rejects. So each
// operand x is split into big = tf32(x), rounded to nearest
// (`cvt.rna.tf32.f32`), and small = tf32(x − big), and a·b is taken as
// small_a·big_b + big_a·small_b + big_a·big_b in fp32 accumulators (what
// CUTLASS calls OpMultiplyAddFastF32): small_a·small_b, about 2^-22 of a·b,
// is dropped, against fp32's own 2^-24 rounding. Three products at the
// card's dense TF32 rate of 494.7 TFLOP/s: 1.88 ms at PixArt-1024, 1.58 at
// FLUX-1024 — the tensor cores bound every served width, and the split and
// the exp come second.
//
// The design, in what it does about that:
//   * S = q·kᵀ is `wgmma.mma_async` m64nNk8 .tf32 with both operands in
//     shared memory (N = the key tile): for tf32 an operand in shared memory
//     must be K-major, and q's and k's tiles, [rows][D], are. Each TMA box is
//     8 columns (32 bytes) under the 32-byte swizzle, one box per k-step, so
//     any D that is a multiple of 8 is D/8 boxes with no padding (D=72: nine
//     k-steps, no half-empty last one); a tile is D/8 column groups, each
//     `rows` × 32 bytes, 8-row groups 256 bytes apart.
//   * O += P·V is `wgmma.mma_async` m64nDk8 .tf32 with P from registers and
//     vᵀ from shared memory. v as stored, [keys][D], is N-major, which tf32
//     cannot read, and TMA cannot transpose, so TMA lands v's raw rows
//     (whole rows, no swizzle) in the stage's k-small part, and the helper
//     warps write vᵀ — [D][keys] in 8-key groups under the same swizzle —
//     big and small from there, then split k over that raw tile. The
//     accumulator of S gives a thread columns 2t and 2t+1 of each 8-column
//     block where the tf32 A fragment wants columns t and t+4, so each 8-key
//     group of vᵀ is stored in the order 0, 2, 4, 6, 1, 3, 5, 7: p goes from
//     the accumulators to the A fragments with no shuffle.
//   * The split: the helpers split q (after scaling it) and k in place in
//     shared memory once TMA has landed them — big over the raw tile, small
//     in a tile of its own — and v as they write vᵀ; the consumers split p
//     in registers. Each product's small terms are issued before its big
//     one. `fence.proxy.async.shared::cta` and an arrival on the tile's
//     ready barrier order those writes before the first wgmma that reads
//     them.
//   * Accuracy: the tensor cores' fp32 accumulation truncates. A tile's
//     products (S, and p·v) start from zero in the accumulators, and each
//     tile's p·v is added to o in IEEE fp32 (o = o·alpha + tile, one FFMA):
//     carried in the accumulators over PixArt-1024's 64 key tiles, o drifted
//     to 1.5e-5 from the plain version (2 of 18.9M outputs past fp32's
//     tolerance, scripts/compare_attention_bodies.py on the card); a CPU
//     emulation of truncating accumulation put the drift there, not in the
//     split (4e-6 over 128 rows carried, 7e-8 a tile at a time).
//   * Shared memory: fp32 tiles take twice the bytes of bf16 ones and their
//     small parts double them again. D ≤ 72: two consumer warpgroups (128
//     query rows an item) and two stages of 64 keys — q 72 KB, a stage 72
//     KB at D=72, 217 KB in all; D=128: one consumer (64 rows) and two
//     stages of 32 keys, 193 KB (two consumers' q alone would take 128 KB).
//   * The launch is persistent: one block per SM walks the work items
//     (batch·head, query tile) from blockIdx.x in steps of gridDim.x; the
//     ring of stages runs on across items, and the producer loads the next
//     item's q once the consumers have issued their last q·kᵀ of this one.
//   * A consumer takes a tile in turn: q·kᵀ, the softmax on the accumulator
//     layout (row reductions over the quad), the split of p, p·v; with two
//     consumers one's softmax runs under the other's products.
//
// What the card showed (scripts/probe_attention_body.py's fp32 rows, NVIDIA
// H100 80GB HBM3, 700 W, in turns against this source): the helpers' work
// is the largest piece beside the products — taking out their vᵀ writes
// and k split took 27 % off K4 at PixArt-1024 and 27 % off K5 at FLUX-1024
// — so they are seven warps (a second producer-side warpgroup), not three
// (`helpers_three_warps`: 19 % and 29 % slower). Their first form read v
// from device memory for the transpose, 4-byte loads whose latency made K4
// 8.6 ms; TMA's raw tile and an smem-to-smem transpose made it 3.8 (scratch
// builds on the card). p·v on
// `mma.sync` m16n8k8 .tf32 from v's split rows as stored, which needs no
// transpose (`pv_mma_sync`), was slower everywhere: 27 % at K4, 81 % at K5,
// 15 % at K1, 30 % at K6. Three stages of 32 keys in place of two of 64
// (`bn32_three_stages`) were 8–19 % slower; at D=72 shared memory holds no
// third stage of 64. q's fragments in the consumers' registers (RS wgmma
// for S, freeing q's 72 KB for a third stage) spilled and made K4 7 %
// slower (a scratch build, not kept). One TF32 pass of q·kᵀ or of p·v
// (`s_one_pass`, `pv_one_pass`) takes 16–17 % off K4: each pass costs more
// than its share of the products' bound.
//
// Widths. 40 (d=33-40; PixArt-256's shape at d=36 runs there, with
// 144-byte rows TMA maps) and 96 (d=73-96, one consumer and 32-key stages,
// as 128) take the D ≤ 128 form. At 192, q's big and small parts for 64
// rows take 96 KB, so a stage is 16 keys (k big and small, vᵀ big and
// small: 48 KB), two stages, one consumer; o's 96 accumulators and a second
// set for the tile's p·v would not fit beside the rest, so p·v runs in
// 64-column chunks of vᵀ, each into 32 accumulators of its own from zero and
// added to o in IEEE fp32 before the next. The o store writes all D
// columns: below the width the wrapper hands over a wider o and keeps its
// first d.
//
// Width 256: a cluster of two blocks (`kSplit`). In one block, as the
// 192 form, q's parts took 128 KB, leaving one 16-key stage (the tile's
// loads and splits no longer overlapped the products), S came from wgmma at
// N = 16, and o's 128 accumulators beside a chunk's p·v spilled 448-676
// bytes under the 168 registers of a 384-thread block: 9.66 ms for K6 at
// (1, 4608, 12, 256) against SDPA fp32's 6.34 (NVIDIA H100 80GB HBM3, 700 W,
// scripts/probe_attention_body.py's `no_cluster`). So each block of the
// pair takes 128 of the item's columns of q, k, v and o — the width-128
// form: 64 KB of q, two stages of 32 keys, S at N = 32, 64 accumulators of
// o, no spill — and the two partial scores of a tile are summed through
// distributed shared memory: each consumer thread stores its 16 partial
// scores into the peer block's buffer (`st.shared::cluster`, two buffers by
// the tile's parity) and arrives on the peer's barrier with release at
// cluster scope; it waits for the peer's on its own, adds the two in rank
// order (the same fp32 sum in both blocks, so both take the same softmax
// and the same p), and tells the peer its buffer is free. Each block then
// runs the tile's p·v on its 128 columns of v and stores its columns of o.
// K6 there took 6.23 ms against SDPA fp32's 6.43, K5 at (2, 2048, 8, 256)
// 1.55 against 1.64 (the probe's rows `f32_k6_d256`, `f32_k5_d256`). Builds
// that issued the next tile's scores before awaiting the peer's (so that
// the round trip ran under them), which needs a third stage and so 24-key
// tiles, took 7.4 ms, with one producer-side warpgroup 7.1. The blocks
// wait for each other before their first exchange and before they exit
// (`barrier.cluster`); the launch sizes the grid to the clusters that can
// be resident at once (`cudaOccupancyMaxActiveClusters`; a cluster for
// every pair of SMs timed the same), and each cluster walks the items.
//
// Widths 384 and 512: clusters of three and four blocks (d = 257-384 and
// 385-512), each the width-128 form on its 128 columns, as at 256; columns
// past d are TMA's zero fill, which adds exact zeros to the scores, and o's
// rows are padded to the width. The N partial scores of a tile are summed
// in one order in every block, ((s0 + s1) + s2) + s3 in IEEE fp32, so all
// N blocks take bit-equal softmaxes and the same p; each block then runs
// p·v on its columns of v and stores its columns of o. Each product is
// computed once and q read once an item, where the streamed form past 512
// computes the scores again for each 128-column slice of o. What shared
// memory leaves for the exchange decides its form: the width-128 form
// takes 196,608 of the 232,448 bytes a block may have (q's two parts 64 KB,
// two stages 128 KB), the barriers and the alignment 1,128 more, and one
// peer's partial tile is 8 KB (128 threads × 16 scores × 4 B). N = 3: a
// buffer for each of two peers by the tile's parity, 32 KB (230,504 bytes
// in all). N = 4: three peers by two parities, 48 KB, does not fit; all to
// all with one buffer a peer does (24 KB, 222,312 bytes: a block writes a
// tile's scores once every peer has read the last tile's). Its rival,
// reduce-scatter then all-gather by the consumer's four warps (warp w's 16
// rows summed in block w and sent back: 2 KB messages, half the bytes over
// two round trips), gave the same sums bit for bit and was 10 % slower at
// K5 (2, 2048, 8, 512), even at K2 (scripts/probe_attention_body.py's
// rows `f32_k5_d512`, `f32_k2_d512`, NVIDIA H100 80GB HBM3, 700 W), and was
// dropped. The exchange is still most of the time past 256: without it K5
// there took 2.30 ms against 5.68 (the probe's `no_exchange`), about 1.1 µs
// a peer and a key tile. Each peer's stores are followed by their own
// arrival, and the peers' parts loaded one at a time as the sum reaches
// them: every peer's stores before the first arrival, or every part loaded
// before the sum, took K5 there to 6.20-6.65 ms (the probe's
// `stores_first`).
//
// No CUTLASS or CuTe: inline PTX, as in attention_sm90.cu, keeps the build
// to seconds. Every fp32 call runs here, in any layout.

#include <cuda.h>  // CUtensorMap and the types cuTensorMapEncodeTiled takes
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

// warpgroups on the producer's side: warp 0 issues the TMA loads, the
// others (the helpers) split and transpose
constexpr int kProducerGroups = 2;
constexpr int kHelperThreads = 128 * kProducerGroups - 32;
constexpr int kProducerRegs = 40;  // a producer-side thread's registers (`setmaxnreg`)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClampLo = -100.f;
constexpr float kClampHi = 80.f;
constexpr float kTwoPowMinus100 = 7.8886090522101181e-31f;  // 2^-100
constexpr float kPadScore = -1e9f;  // a pad key's score on the exact routes

enum Mode : int { kExact = 0, kClamp = 1 };

// The tiles of a block at head dim D: consumer warpgroups, keys a stage,
// stages, and the bytes of each part. q: 64 rows a consumer, big and small;
// a stage: k's big and small parts ([keys][D] in D/8 column groups) and
// vᵀ's ([D][keys] in keys/8 key groups). Every part is a multiple of 1 KB.
// SPLIT: the blocks of a cluster that share a work item, each with D of
// its columns (see the notes on widths 256, 384 and 512): their partial
// scores' exchange buffers, by rounds (the tile's parity, or one round at
// four blocks), and their four barriers.
template <int D, int SPLIT = 1>
struct Cfg {
  static_assert(D % 8 == 0 && D >= 16 && D <= 256, "widths: multiples of 8 up to 256");
  static constexpr int kNC = D > 72 ? 1 : 2;
  static constexpr int kBN = D > 128 ? 16 : D > 72 ? 32 : 64;
  static constexpr int kStages = D > 192 ? 1 : 2;
  static constexpr int kRowsQ = 64 * kNC;
  static constexpr int kQ = kRowsQ * D * 4;  // one part of q
  static constexpr int kKV = kBN * D * 4;    // one part of k or of vᵀ
  static constexpr int kStage = 4 * kKV;
  static constexpr int kPeer = 128 * kNC * (kBN / 2) * 4;  // a block's partial scores of a tile
  static constexpr int kXchgRounds = SPLIT == 4 ? 1 : 2;
  static constexpr int kXchgRound = (SPLIT - 1) * kPeer;  // a round's buffers: one a peer
  static constexpr int kXchg = SPLIT > 1 ? kXchgRounds * kXchgRound : 0;
  static constexpr int kBarriers = 3 + 3 * kStages + (SPLIT > 1 ? 4 : 0);
  static constexpr int kBytes = 2 * kQ + kStages * kStage + kXchg + kBarriers * 8 + 1024;
  static constexpr int kThreads = 128 * (kProducerGroups + kNC);
  // a consumer thread's registers: what the producer side gives away, at
  // most 240
  static constexpr int kConsumerRegs =
      (65536 - 128 * kProducerGroups * kProducerRegs) / (128 * kNC) / 8 * 8 > 240
          ? 240
          : (65536 - 128 * kProducerGroups * kProducerRegs) / (128 * kNC) / 8 * 8;
};

struct Params {
  float* o;
  long long o_sb, o_st, o_sh;
  const float* bias;  // null, or (B|1, H|1, Tq|1, Tk|1) through its strides
  long long b_sb, b_sh, b_sq, b_sk;
  int H, Tq, Tk;
  int n_items;  // (batch·head, query tile) work items
  int n_pad;    // the reference's pad keys on this route
  float scale;  // exact: 1/√D; clamp: clamp_scale(D, float32)
};

// The bias of row `row`, key `col` (row clamped to the last one: the tile's
// rows past Tq compute what is never stored)
__device__ __forceinline__ float bias_at(const Params& p, int b, int h, int row, int col) {
  return __ldg(p.bias + b * p.b_sb + h * p.b_sh + (long long)min(row, p.Tq - 1) * p.b_sq +
               (long long)col * p.b_sk);
}

// --- the split --------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}
// x = big + small, big = tf32(x) to nearest, small = tf32(x − big); x − big
// is exact in fp32
__device__ __forceinline__ void split(float x, float& big, float& small) {
  big = __uint_as_float(tf32(x));
  small = __uint_as_float(tf32(__fsub_rn(x, big)));
}

// --- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tf32 operand under the
// 32-byte swizzle (layout type 3, bits 62-63): rows of 32 bytes (8 tf32,
// one k-step), 8-row groups 256 bytes apart (the stride byte offset); the
// leading byte offset is not read for a swizzled K-major operand.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) | (16ull << 32) | (3ull << 62);
}

#define F32_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F32_ACC8(i) F32_ACC4(i), F32_ACC4(i + 4)
#define F32_ACC16(i) F32_ACC8(i), F32_ACC8(i + 8)
#define F32_ACC32(i) F32_ACC16(i), F32_ACC16(i + 16)
#define F32_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define F32_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define F32_REGS32                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define F32_REGS20 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}"
#define F32_REGS48                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
#define F32_REGS36                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}"
#define F32_REGS64                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
// d (64 × N) (+)= a · b, a and b K-major in shared memory (descriptors)
#define F32_SS(N, REGS, A, B, S, ...)                                                  \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, " S ", 0;\n"                        \
               " wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " REGS ", " A \
               ", " B ", p, 1, 1;\n}\n"                                                \
               : __VA_ARGS__                                                           \
               : "l"(da), "l"(db), "r"(scale_d))
// d (64 × N) += a · b, a the tf32 A fragment in registers, b K-major in shared memory
#define F32_RS(N, REGS, A, B, S, ...)                                                  \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, " S ", 0;\n"                        \
               " wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " REGS ", " A \
               ", " B ", p, 1, 1;\n}\n"                                                \
               : __VA_ARGS__                                                           \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// The scores: d (64 × N, fp32; N the key tile) (+)= a (64 × 8) · b (8 × N).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "key tiles of 16, 32 or 64");
  if constexpr (N == 16)
    F32_SS(16, F32_REGS8, "%8", "%9", "%10", F32_ACC8(0));
  else if constexpr (N == 32)
    F32_SS(32, F32_REGS16, "%16", "%17", "%18", F32_ACC16(0));
  else
    F32_SS(64, F32_REGS32, "%32", "%33", "%34", F32_ACC32(0));
}

// d (64 × N, fp32) (+)= a (64 × 8, the tf32 A fragment in registers) · b
// (8 × N, K-major in shared memory): o += p·vᵀ (N = D), or the scores q·kᵀ
// (N = the key tile).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d = 1) {
  if constexpr (N == 16)
    F32_RS(16, F32_REGS8, "{%8, %9, %10, %11}", "%12", "%13", F32_ACC8(0));
  else if constexpr (N == 32)
    F32_RS(32, F32_REGS16, "{%16, %17, %18, %19}", "%20", "%21", F32_ACC16(0));
  else if constexpr (N == 40)
    F32_RS(40, F32_REGS20, "{%20, %21, %22, %23}", "%24", "%25", F32_ACC16(0), F32_ACC4(16));
  else if constexpr (N == 64)
    F32_RS(64, F32_REGS32, "{%32, %33, %34, %35}", "%36", "%37", F32_ACC32(0));
  else if constexpr (N == 72)
    F32_RS(72, F32_REGS36, "{%36, %37, %38, %39}", "%40", "%41", F32_ACC32(0), F32_ACC4(32));
  else if constexpr (N == 96)
    F32_RS(96, F32_REGS48, "{%48, %49, %50, %51}", "%52", "%53", F32_ACC32(0), F32_ACC16(32));
  else if constexpr (N == 128)
    F32_RS(128, F32_REGS64, "{%64, %65, %66, %67}", "%68", "%69", F32_ACC32(0), F32_ACC32(32));
  else
    static_assert(N == 16, "p·v's widths: 16, 32, 40, 64, 72, 96 and 128 (64-column chunks past)");
}

// One pass of the scores past D=128: STEPS k-steps of wgmma_ss, each
// operand's descriptor stepped by its bytes a k-step (`da_step`, `db_step`)
// from the first, the next one made only once the product before it is
// issued (the empty asm orders them). Unrolled as below D=128, with the
// descriptors of all 3·D/8 products made up front beside o's 128
// accumulators, they spilled 450-700 bytes. FIRST: the pass's first
// product overwrites the scores.
template <int BN, int STEPS, bool FIRST>
__device__ __forceinline__ void scores_stepped(float (&sc)[BN / 2], uint64_t da, uint64_t db,
                                               uint32_t da_step, uint32_t db_step) {
#pragma unroll
  for (int kc = 0; kc < STEPS; ++kc) {
    wgmma_ss<BN>(sc, da, db, FIRST && kc == 0 ? 0 : 1);
    da += da_step >> 4;
    db += db_step >> 4;
    asm volatile("" : "+l"(da), "+l"(db));
  }
}

// 2^x in one special-function instruction (`exp2f` adds instructions for
// results below 2^-126, which neither mode can use: the clamp's are at
// least 2^-100, and the exact mode's p ≤ 1 beside a running sum of at least 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- the cluster's exchange (widths 256, 384 and 512) ----------------------------

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n barrier.cluster.wait.acquire;\n" ::: "memory");
}
// `addr` in this block's shared memory → the same offset in block `rank`'s
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void peer_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// `mbar_wait` for a phase that another block's arrivals complete
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A consumer thread's partial scores of a tile (its block's columns of
// q·kᵀ) summed with the SPLIT − 1 peer blocks' (all to all): they go
// into each peer's buffer `buf` (this block's part of it at its rank among
// the peer's sources; 16-byte piece i of thread t at (128·i + t)·16: a
// warp's pieces side by side, no bank conflict), with an arrival on the
// peer's `full` barrier; then the peers' parts from this block's own once
// its `full` barrier says they are all there, summed with this block's in
// rank order — the same fp32 sum in every block, so all take the same
// softmax — and an arrival on each peer's `empty` barrier. This block's
// `empty` barrier says every peer has read the buffer's last round.
template <int SPLIT, int N>
__device__ __forceinline__ void exchange_scores(float (&sc)[N], uint32_t buf, uint32_t full,
                                                uint32_t empty, uint32_t parity, int t,
                                                uint32_t rank) {
  constexpr uint32_t kPart = 128 * N * 4;
  mbar_wait_cluster(empty, parity ^ 1);  // the first round finds it free
#pragma unroll
  for (int j = 1; j < SPLIT; ++j) {
    const uint32_t peer = (rank + j) % SPLIT;
    const uint32_t dst = peer_addr(buf + (rank - (rank > peer)) * kPart + t * 16, peer);
#pragma unroll
    for (int i = 0; i < N; i += 4)
      asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + 128 * 4 * i),
                   "f"(sc[i]), "f"(sc[i + 1]), "f"(sc[i + 2]), "f"(sc[i + 3])
                   : "memory");
    peer_arrive(peer_addr(full, peer));
  }
  mbar_wait_cluster(full, parity);
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    float x[4];
    if constexpr (SPLIT == 2) {  // the peer's part, then the two in rank order
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
                   : "r"(buf + t * 16 + 128 * 4 * i)
                   : "memory");
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[i + e] = rank == 0 ? __fadd_rn(sc[i + e], x[e]) : __fadd_rn(x[e], sc[i + e]);
    } else {  // block r's part (this block's own scores at r = rank), in rank order
      float acc[4];
#pragma unroll
      for (int r = 0; r < SPLIT; ++r) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = sc[i + e];
        if (r != rank)
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                       : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
                       : "r"(buf + (r - (r > rank)) * kPart + t * 16 + 128 * 4 * i)
                       : "memory");
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = r == 0 ? x[e] : __fadd_rn(acc[e], x[e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i + e] = acc[e];
    }
  }
#pragma unroll
  for (int j = 1; j < SPLIT; ++j) peer_arrive(peer_addr(empty, (rank + j) % SPLIT));
}

// One key tile's softmax on the accumulator layout (sc[4jb + e] is row
// rows[e / 2], column k0 + 8jb + col_t + e % 2): the clamp's exp2(clip(s + bias·log2e, −100, 80)) or the
// exact mode's online max (alpha: the rescale of the earlier tiles), then
// p's big and small tf32 A fragments, k-step kk's logical column t key
// 8kk + 2t and column t + 4 key 8kk + 2t + 1 (vᵀ's order).
template <int MODE, bool BIAS, int NS>
__device__ __forceinline__ void f32_softmax_tile(float (&sc)[NS], float (&m)[2], float (&l)[2],
                                                 float (&alpha)[2], uint32_t (&pb)[NS / 4][4],
                                                 uint32_t (&ps)[NS / 4][4], const Params& p,
                                                 int b, int h, const int (&rows)[2], int k0,
                                                 int col_t) {
  alpha[0] = alpha[1] = 1.f;
  if constexpr (MODE == kClamp) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int col = k0 + 8 * (i >> 2) + col_t + (i & 1);
      float x = sc[i];
      if constexpr (BIAS)
        if (col < p.Tk)
          x = __fadd_rn(x, __fmul_rn(bias_at(p, b, h, rows[(i >> 1) & 1], col), kLog2e));
      const float pe = col < p.Tk ? ex2(fminf(fmaxf(x, kClampLo), kClampHi)) : 0.f;
      sc[i] = pe;
      l[(i >> 1) & 1] += pe;
    }
  } else {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int col = k0 + 8 * (i >> 2) + col_t + (i & 1), r = (i >> 1) & 1;
      float x = sc[i];
      if constexpr (BIAS)
        if (col < p.Tk) x = __fadd_rn(x, bias_at(p, b, h, rows[r], col));
      if (col >= p.Tk) x = -INFINITY;
      sc[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2(__fmul_rn(__fsub_rn(m[r], mx[r]), kLog2e));  // exp(−∞) = 0 on the first tile
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      const float pe = ex2(__fmul_rn(__fsub_rn(sc[i], m[r]), kLog2e));
      sc[i] = pe;
      l[r] += pe;
    }
  }
#pragma unroll
  for (int kk = 0; kk < NS / 4; ++kk) {
    const float f[4] = {sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1], sc[4 * kk + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pb[kk][e] = tf32(f[e]);
      ps[kk][e] = tf32(__fsub_rn(f[e], __uint_as_float(pb[kk][e])));
    }
  }
}

// The epilogue of a consumer's rows: the row sums over the quad, the
// reference's pad keys, one divide, fp32 stores of two columns at a time of
// o's columns col0 .. col0 + 2·NO − 1 (with END, those below `end` only:
// o's rows are padded to its width, so a pair at a column below `end` fits).
template <int MODE, bool END, int NO>
__device__ __forceinline__ void f32_store_o(const float (&o)[NO], float (&l)[2],
                                            const float (&m)[2], const Params& p, int b, int h,
                                            const int (&rows)[2], int col0, int end, int col_t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    float f = 1.f;
    if constexpr (MODE == kClamp) {
      l[r] += (float)p.n_pad * kTwoPowMinus100;
    } else if (p.n_pad > 0) {
      // n_pad keys of score −1e9: f = 1 and the added term 0 unless every
      // score of the row is near −1e9 or below it
      const float mp = fmaxf(m[r], kPadScore);
      f = ex2(__fmul_rn(__fsub_rn(m[r], mp), kLog2e));
      l[r] = l[r] * f + (float)p.n_pad * ex2(__fmul_rn(kPadScore - mp, kLog2e));
    }
    if (rows[r] >= p.Tq) continue;
    const float inv = f / l[r];
    float* const out =
        p.o + b * p.o_sb + (long long)rows[r] * p.o_st + h * p.o_sh + col0 + col_t;
#pragma unroll
    for (int jb = 0; jb < NO / 4; ++jb)
      if (!END || col0 + 8 * jb + col_t < end)
        *reinterpret_cast<float2*>(out + 8 * jb) =
            make_float2(o[4 * jb + 2 * r] * inv, o[4 * jb + 2 * r + 1] * inv);
  }
}

// The helpers' split of a tile in place, elementwise (the swizzle does not
// matter): x·scale rounded to fp32 (q) or x (k, scale 1), big over x, small
// at the same offset in `small`.
template <int HT = kHelperThreads>
__device__ __forceinline__ void split_tile(unsigned char* big, unsigned char* small, int bytes,
                                           float scale, int ht) {
  float4* const b4 = reinterpret_cast<float4*>(big);
  float4* const s4 = reinterpret_cast<float4*>(small);
  for (int i = ht; i < bytes / 16; i += HT) {
    const float4 x = b4[i];
    float4 hi, lo;
    split(__fmul_rn(x.x, scale), hi.x, lo.x);
    split(__fmul_rn(x.y, scale), hi.y, lo.y);
    split(__fmul_rn(x.z, scale), hi.z, lo.z);
    split(__fmul_rn(x.w, scale), hi.w, lo.w);
    b4[i] = hi;
    s4[i] = lo;
  }
}

// The helpers' vᵀ of a stage's BN keys, big and small, from v's raw tile
// ([BN][D] row-major, as TMA landed it, zeros past Tk): BN/8 key groups of
// D rows × 32 bytes under the 32-byte swizzle (16-byte chunk c of row d at
// chunk c ^ (d / 4 % 2)), the keys of a group in the order 0, 2, 4, 6
// (chunk 0), 1, 3, 5, 7 (chunk 1). A helper thread takes one chunk: four
// keys of one column, so the reads of a warp take 32 neighbouring columns
// of a row.
template <int D, int BN, int HT = kHelperThreads>
__device__ __forceinline__ void write_vt(unsigned char* big, unsigned char* small,
                                         const unsigned char* raw, int ht) {
  const float* const v = reinterpret_cast<const float*>(raw);
  for (int i = ht; i < BN / 8 * 2 * D; i += HT) {
    const int grp = i / (2 * D), half = i / D % 2, d = i % D;
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = v[(8 * grp + 2 * e + half) * D + d];
    float4 hi, lo;
    split(x[0], hi.x, lo.x);
    split(x[1], hi.y, lo.y);
    split(x[2], hi.z, lo.z);
    split(x[3], hi.w, lo.w);
    const int at = grp * D * 32 + d * 32 + ((half ^ (d >> 2 & 1)) << 4);
    *reinterpret_cast<float4*>(big + at) = hi;
    *reinterpret_cast<float4*>(small + at) = lo;
  }
}

// The shared body of the four kernels, one work item (batch·head, query
// tile of 64·kNC rows) after another, from blockIdx.x in steps of
// gridDim.x (from the cluster's index in steps of the clusters' count, with
// SPLIT blocks a cluster: each takes D columns of the item's q, k, v and o,
// from column D·rank, and the partial scores are summed through the
// cluster's shared memory); maps: q's and k's (8-column boxes under the
// 32-byte swizzle) and v's (whole rows of the block's columns, no swizzle).
template <int D, int MODE, bool BIAS, int SPLIT = 1>
__device__ __forceinline__ void attn_f32_body(const CUtensorMap* maps, const Params& p) {
  using C = Cfg<D, SPLIT>;
  constexpr int NC = C::kNC, BN = C::kBN, ST = C::kStages;
  constexpr int kConsumerThreads = 128 * NC;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 1024-byte alignment: every part starts on a swizzle period
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  auto gen = [&](uint32_t a) { return gbase + (a - base); };
  const uint32_t q_big = base, q_small = base + C::kQ;
  // stage s: k big, k small, vᵀ big, vᵀ small; TMA lands k's raw tile in
  // its big part and v's in its small part
  auto k_big = [&](int s) { return base + 2 * C::kQ + s * C::kStage; };
  const uint32_t xchg = base + 2 * C::kQ + ST * C::kStage;  // SPLIT: the score buffers
  const uint32_t bars = xchg + C::kXchg;
  const uint32_t q_full = bars, q_ready = bars + 8, q_empty = bars + 16;
  auto k_full = [&](int s) { return bars + 24 + 8 * s; };
  auto kv_ready = [&](int s) { return bars + 24 + 8 * (ST + s); };
  auto kv_empty = [&](int s) { return bars + 24 + 8 * (2 * ST + s); };
  // SPLIT: score buffer x's full and empty barriers
  auto x_full = [&](int x) { return bars + 24 + 8 * (3 * ST + x); };
  auto x_empty = [&](int x) { return bars + 24 + 8 * (3 * ST + 2 + x); };
  // SPLIT: this block's rank in its cluster and its first column; the
  // cluster's index and the clusters' count
  const uint32_t rank = blockIdx.x % SPLIT;
  const int col0 = D * rank;

  const int n_qt = (p.Tq + C::kRowsQ - 1) / C::kRowsQ;
  const int n_tiles = (p.Tk + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_ready, kHelperThreads);
    mbar_init(q_empty, kConsumerThreads);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(kv_ready(s), kHelperThreads);
      mbar_init(kv_empty(s), kConsumerThreads);
    }
    if constexpr (SPLIT > 1)
      for (int x = 0; x < 2; ++x) {
        mbar_init(x_full(x), (SPLIT - 1) * kConsumerThreads);
        mbar_init(x_empty(x), (SPLIT - 1) * kConsumerThreads);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (SPLIT > 1) cluster_sync();  // the peer's barriers are ready

  if (wg < kProducerGroups) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      // producer: q once per item (when the consumers are done with the
      // last one's), then the ring of k and v tiles; `g` counts the ring's
      // tiles
      int g = 0, it = 0;
      for (int item = blockIdx.x / SPLIT; item < p.n_items; item += gridDim.x / SPLIT, ++it) {
        const int bh = item / n_qt, b = bh / p.H, h = bh % p.H;
        mbar_wait(q_empty, (it & 1) ^ 1);  // the first round finds it free
        mbar_expect_tx(q_full, C::kQ);
        for (int c = 0; c < D / 8; ++c)
          tma_load(q_big + c * C::kRowsQ * 32, &maps[0], q_full, col0 + 8 * c, h,
                   (item % n_qt) * C::kRowsQ, b);
        for (int j = 0; j < n_tiles; ++j, ++g) {
          const int s = g % ST;
          mbar_wait(kv_empty(s), ((g / ST) & 1) ^ 1);
          mbar_expect_tx(k_full(s), 2 * C::kKV);
          for (int c = 0; c < D / 8; ++c)
            tma_load(k_big(s) + c * BN * 32, &maps[1], k_full(s), col0 + 8 * c, h, j * BN, b);
          tma_load(k_big(s) + C::kKV, &maps[2], k_full(s), col0, h, j * BN, b);
        }
      }
    } else if (threadIdx.x >= 32) {
      // helpers: split q, scaled; for each tile write vᵀ from v's raw tile,
      // then (once every helper has read that) split k over it
      const int ht = threadIdx.x - 32;
      int g = 0, it = 0;
      for (int item = blockIdx.x / SPLIT; item < p.n_items; item += gridDim.x / SPLIT, ++it) {
        mbar_wait(q_full, it & 1);
        split_tile(gen(q_big), gen(q_small), C::kQ, p.scale, ht);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(q_ready);
        for (int j = 0; j < n_tiles; ++j, ++g) {
          const int s = g % ST;
          mbar_wait(k_full(s), (g / ST) & 1);
          unsigned char* const kb = gen(k_big(s));
          write_vt<D, BN>(kb + 2 * C::kKV, kb + 3 * C::kKV, kb + C::kKV, ht);
          asm volatile("bar.sync 1, %0;\n" ::"n"(kHelperThreads) : "memory");
          split_tile(kb, kb + C::kKV, C::kKV, 1.f, ht);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(kv_ready(s));
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns query rows 64c .. 64c + 63 of each item's tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  const int c = wg - kProducerGroups;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row_c = 64 * c + 16 * (t / 32) + lane / 4;  // this thread's first row of the item's
  const int col_t = 2 * (lane % 4);  // its first column in each 8-column block
  auto q_desc = [&](uint32_t q, int kc) { return desc_sw32(q + kc * C::kRowsQ * 32 + c * 2048); };
  auto k_desc = [&](uint32_t k, int kc) { return desc_sw32(k + kc * BN * 32); };
  auto vt_desc = [&](uint32_t vt, int kk) { return desc_sw32(vt + kk * D * 32); };

  int g = 0, it = 0;
  for (int item = blockIdx.x / SPLIT; item < p.n_items; item += gridDim.x / SPLIT, ++it) {
    const int bh = item / n_qt, b = bh / p.H, h = bh % p.H;
    const int q0 = (item % n_qt) * C::kRowsQ;
    const int rows[2] = {q0 + row_c, q0 + row_c + 8};
    mbar_wait(q_ready, it & 1);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int j = 0; j < n_tiles; ++j, ++g) {
      const int s = g % ST, k0 = j * BN;
      const uint32_t kb = k_big(s), ks = kb + C::kKV, vb = kb + 2 * C::kKV, vs = kb + 3 * C::kKV;
      mbar_wait(kv_ready(s), (g / ST) & 1);
      // s = q·kᵀ: the small products, then the big one
      float sc[BN / 2];
      wgmma_fence();
      if constexpr (D > 128) {
        // the small products, then the big one, as below
        scores_stepped<BN, D / 8, true>(sc, q_desc(q_small, 0), k_desc(kb, 0), C::kRowsQ * 32,
                                        BN * 32);
        scores_stepped<BN, D / 8, false>(sc, q_desc(q_big, 0), k_desc(ks, 0), C::kRowsQ * 32,
                                         BN * 32);
        scores_stepped<BN, D / 8, false>(sc, q_desc(q_big, 0), k_desc(kb, 0), C::kRowsQ * 32,
                                         BN * 32);
      } else {
#pragma unroll
        for (int kc = 0; kc < D / 8; ++kc) wgmma_ss<BN>(sc, q_desc(q_small, kc), k_desc(kb, kc), kc);
#pragma unroll
        for (int kc = 0; kc < D / 8; ++kc) wgmma_ss<BN>(sc, q_desc(q_big, kc), k_desc(ks, kc), 1);
#pragma unroll
        for (int kc = 0; kc < D / 8; ++kc) wgmma_ss<BN>(sc, q_desc(q_big, kc), k_desc(kb, kc), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (j == n_tiles - 1) mbar_arrive(q_empty);  // the item's last read of q
      if constexpr (SPLIT > 1) {  // the peers' columns of the scores
        // the round's buffers: by the tile's parity, or one
        const int x = C::kXchgRounds == 2 ? g & 1 : 0;
        const uint32_t parity = C::kXchgRounds == 2 ? (g >> 1) & 1 : g & 1;
        exchange_scores<SPLIT>(sc, xchg + x * C::kXchgRound, x_full(x), x_empty(x), parity,
                               threadIdx.x - 128 * kProducerGroups, rank);
      }

      // the softmax on the accumulator layout, p's A fragments (alpha: the
      // exact mode's rescale of the earlier tiles, 1 in the clamp mode)
      float alpha[2];
      uint32_t pb[BN / 8][4], ps[BN / 8][4];
      f32_softmax_tile<MODE, BIAS>(sc, m, l, alpha, pb, ps, p, b, h, rows, k0, col_t);
      // this tile's p·v into accumulators of its own, from zero; then o =
      // o·alpha + that in IEEE fp32 (see the note: the tensor cores'
      // accumulation, carried over every key tile, drifted past fp32's
      // tolerance). Past D=128 o's 64-column chunks one after the other, so
      // that a thread holds o and one chunk's accumulators, not o twice.
      if constexpr (D > 128) {
#pragma unroll
        for (int ch = 0; ch < D / 64; ++ch) {
          float ot[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) ot[i] = 0.f;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BN / 8; ++kk)
            wgmma_rs<64>(ot, ps[kk], vt_desc(vb + 2048 * ch, kk));
#pragma unroll
          for (int kk = 0; kk < BN / 8; ++kk)
            wgmma_rs<64>(ot, pb[kk], vt_desc(vs + 2048 * ch, kk));
#pragma unroll
          for (int kk = 0; kk < BN / 8; ++kk)
            wgmma_rs<64>(ot, pb[kk], vt_desc(vb + 2048 * ch, kk));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(ot);
#pragma unroll
          for (int i = 0; i < 32; ++i) o[32 * ch + i] = fmaf(o[32 * ch + i], alpha[(i >> 1) & 1], ot[i]);
        }
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) {
          fence_regs(pb[kk]);
          fence_regs(ps[kk]);
        }
        mbar_arrive(kv_empty(s));
      } else {
        float ot[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) ot[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) wgmma_rs<D>(ot, ps[kk], vt_desc(vb, kk));
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) wgmma_rs<D>(ot, pb[kk], vt_desc(vs, kk));
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) wgmma_rs<D>(ot, pb[kk], vt_desc(vb, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(ot);
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) {
          fence_regs(pb[kk]);
          fence_regs(ps[kk]);
        }
        mbar_arrive(kv_empty(s));
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], ot[i]);
      }
    }

    f32_store_o<MODE, false>(o, l, m, p, b, h, rows, col0, 0, col_t);
  }
}

struct Maps {
  CUtensorMap m[3];  // q, k, v
};

// The blocks of a cluster at width D: two at 256, three at 384, four at 512
// (see the notes), one below
template <int D>
constexpr int kSplit = D == 256 ? 2 : D > 256 ? D / 128 : 1;
// a block's columns and its tiles
template <int D>
using BlockCfg = Cfg<D / kSplit<D>, kSplit<D>>;
// the body of a kernel at width D, and what its blocks do past it: from 256
// the cluster waits for its peers before it exits (their last exchange
// reads and writes this block's shared memory)
template <int D, int MODE, bool BIAS>
__device__ __forceinline__ void attn_f32_kernel_body(const CUtensorMap* maps, const Params& p) {
  attn_f32_body<D / kSplit<D>, MODE, BIAS, kSplit<D>>(maps, p);
  if constexpr (kSplit<D> > 1) cluster_sync();
}

// Four kernel names, so that a profile tells K1 (K2 with a bias), K6, K4 and
// K5 apart; a thread block is the producer side's warpgroups and kNC
// consumers.
template <int D, bool BIAS>
__global__ void __launch_bounds__(BlockCfg<D>::kThreads, 1)
    attn_exact_f32_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  attn_f32_kernel_body<D, kExact, BIAS>(maps.m, p);
}
template <int D, bool BIAS>
__global__ void __launch_bounds__(BlockCfg<D>::kThreads, 1)
    attn_flash_f32_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  attn_f32_kernel_body<D, kExact, BIAS>(maps.m, p);
}
template <int D, bool BIAS>
__global__ void __launch_bounds__(BlockCfg<D>::kThreads, 1)
    attn_clamp_f32_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  attn_f32_kernel_body<D, kClamp, BIAS>(maps.m, p);
}
template <int D, bool BIAS>
__global__ void __launch_bounds__(BlockCfg<D>::kThreads, 1)
    attn_rowblock_f32_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  attn_f32_kernel_body<D, kClamp, BIAS>(maps.m, p);
}

// --- past D=512: the streamed body ----------------------------------------------
//
// Past 512 no built width takes the head dim (a cluster of more than four
// blocks is not portable, and its exchange would outgrow shared memory), and
// one block holds neither q's big and small parts (128 KB for 64 rows at 256
// already) beside a stage of k and v, nor o's accumulators in its
// registers. So a work item is (batch·head, 64-row query tile, slice of
// kWideSlice columns of o), and q·kᵀ walks the head dim in 64-column chunks
// through a ring of slots, each holding q's 64 rows of the chunk as TMA
// lands them (eight 8-column boxes under the 32-byte swizzle, 16 KB) and
// the chunk of a 32-key tile of k, split in place by the helpers (8 KB big,
// 8 KB small): nothing but that loop grows with d. q is split in the
// consumer's registers instead, from its raw boxes — the tf32 A fragment of
// a k-step is columns t and t + 4 of rows r and r + 8, which the swizzle
// puts in 32 different banks for a warp — so the scores are wgmma with q
// from registers (m64n32k8, three TF32 products: the small terms of the
// chunk, then the big one). Each chunk's scores start from zero in
// accumulators of their own and are added to the tile's in IEEE fp32, as
// each tile's p·v is added to o at the built widths. p·v takes the slice: v's
// 32 × kWideSlice raw tile as TMA lands it (whole rows of the slice, no
// swizzle), whose vᵀ big and small the helpers write as at the built widths. One
// producer-side warpgroup (the TMA thread, three helper warps): a
// 256-thread block, so the consumer's o, scores and fragments fit its
// registers. An item's q chunks are loaded again for each key tile and its
// scores computed again for each slice (ceil(d / 128)): the simple form.
// The bias, the softmax, the pad keys and the store are the main body's,
// o's columns past d never written.
constexpr int kWideSlice = 128;  // o's columns a work item
constexpr int kWideBN = 32;      // keys a tile
constexpr int kWideSlots = 3;    // ring slots of (q chunk, k chunk)
constexpr int kWideQ = 64 * 64 * 4;               // q's 64 rows × 64 columns, raw: 16 KB
constexpr int kWideK = kWideBN * 64 * 4;          // one part of k's chunk: 8 KB
constexpr int kWideSlot = kWideQ + 2 * kWideK;    // 32 KB
constexpr int kWideV = kWideBN * kWideSlice * 4;  // v's raw slice, vᵀ big, vᵀ small: 16 KB each
constexpr int kWideVStages = 2;
constexpr int kWideHelpers = 96;
constexpr int kWideBytes = kWideSlots * kWideSlot + kWideVStages * 3 * kWideV +
                           3 * (kWideSlots + kWideVStages) * 8 + 1024;

struct WideParams {
  Params p;
  int d;         // the head dim
  int n_steps;   // ceil(d / 8): q·kᵀ's k-steps
  int n_slices;  // ceil(d / kWideSlice): o's slices
};

template <int MODE, bool BIAS>
__device__ __forceinline__ void attn_f32_wide_body(const CUtensorMap* maps, const WideParams& w) {
  const Params& p = w.p;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  auto gen = [&](uint32_t a) { return gbase + (a - base); };
  auto slot = [&](int s) { return base + s * kWideSlot; };
  // v stage s: v's raw slice, vᵀ big, vᵀ small
  auto v_raw = [&](int s) { return base + kWideSlots * kWideSlot + s * 3 * kWideV; };
  const uint32_t bars = base + kWideSlots * kWideSlot + kWideVStages * 3 * kWideV;
  auto slot_full = [&](int s) { return bars + 8 * s; };
  auto slot_ready = [&](int s) { return bars + 8 * (kWideSlots + s); };
  auto slot_empty = [&](int s) { return bars + 8 * (2 * kWideSlots + s); };
  auto v_full = [&](int s) { return bars + 8 * (3 * kWideSlots + s); };
  auto v_ready = [&](int s) { return bars + 8 * (3 * kWideSlots + kWideVStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (3 * kWideSlots + 2 * kWideVStages + s); };

  const int n_qt = (p.Tq + 63) / 64;
  const int n_tiles = (p.Tk + kWideBN - 1) / kWideBN;
  const int n_chunks = (w.n_steps + 7) / 8;
  const int wg = threadIdx.x / 128;
  auto decode = [&](int item, int& b, int& h, int& q0, int& sl) {
    sl = item % w.n_slices;
    const int rest = item / w.n_slices;
    q0 = (rest % n_qt) * 64;
    const int bh = rest / n_qt;
    b = bh / p.H;
    h = bh % p.H;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideSlots; ++s) {
      mbar_init(slot_full(s), 1);
      mbar_init(slot_ready(s), kWideHelpers);
      mbar_init(slot_empty(s), 128);
    }
    for (int s = 0; s < kWideVStages; ++s) {
      mbar_init(v_full(s), 1);
      mbar_init(v_ready(s), kWideHelpers);
      mbar_init(v_empty(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      // producer: for each key tile, its chunks of q and k (the boxes below
      // d), then v's slice
      int g = 0, gv = 0;
      for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
        int b, h, q0, sl;
        decode(item, b, h, q0, sl);
        for (int j = 0; j < n_tiles; ++j) {
          for (int ch = 0; ch < n_chunks; ++ch, ++g) {
            const int s = g % kWideSlots;
            const int nb = min(8, w.n_steps - 8 * ch);
            mbar_wait(slot_empty(s), ((g / kWideSlots) & 1) ^ 1);
            mbar_expect_tx(slot_full(s), nb * (64 * 32 + kWideBN * 32));
            for (int bx = 0; bx < nb; ++bx) {
              tma_load(slot(s) + bx * 64 * 32, &maps[0], slot_full(s), 8 * (8 * ch + bx), h, q0, b);
              tma_load(slot(s) + kWideQ + bx * kWideBN * 32, &maps[1], slot_full(s),
                       8 * (8 * ch + bx), h, j * kWideBN, b);
            }
          }
          const int vs = gv % kWideVStages;
          mbar_wait(v_empty(vs), ((gv / kWideVStages) & 1) ^ 1);
          mbar_expect_tx(v_full(vs), kWideV);
          tma_load(v_raw(vs), &maps[2], v_full(vs), sl * kWideSlice, h, j * kWideBN, b);
          ++gv;
        }
      }
    } else if (threadIdx.x >= 32) {
      // helpers: split each slot's k chunk in place, write each v slice's vᵀ
      const int ht = threadIdx.x - 32;
      int g = 0, gv = 0;
      for (int item = blockIdx.x; item < p.n_items; item += gridDim.x)
        for (int j = 0; j < n_tiles; ++j) {
          for (int ch = 0; ch < n_chunks; ++ch, ++g) {
            const int s = g % kWideSlots;
            mbar_wait(slot_full(s), (g / kWideSlots) & 1);
            unsigned char* const kb = gen(slot(s) + kWideQ);
            split_tile<kWideHelpers>(kb, kb + kWideK, kWideK, 1.f, ht);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(slot_ready(s));
          }
          const int vs = gv % kWideVStages;
          mbar_wait(v_full(vs), (gv / kWideVStages) & 1);
          unsigned char* const vr = gen(v_raw(vs));
          write_vt<kWideSlice, kWideBN, kWideHelpers>(vr + kWideV, vr + 2 * kWideV, vr, ht);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(v_ready(vs));
          ++gv;
        }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(240));
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row_c = 16 * (t / 32) + lane / 4;  // this thread's first row of the item's 64
  const int col_t = 2 * (lane % 4);
  // its q fragment's four values in a raw 8-column box (rows 32 bytes,
  // 16-byte halves swapped in rows 4-7 of each 8): a[0] row r column t, a[1]
  // row r + 8, a[2] and a[3] column t + 4
  const int sw = (row_c >> 2) & 1, t4 = lane % 4;
  const int q_at[4] = {row_c * 8 + (sw << 2) + t4, (row_c + 8) * 8 + (sw << 2) + t4,
                       row_c * 8 + ((sw ^ 1) << 2) + t4, (row_c + 8) * 8 + ((sw ^ 1) << 2) + t4};
  auto k_desc = [&](uint32_t k, int bx) { return desc_sw32(k + bx * kWideBN * 32); };
  auto vt_desc = [&](uint32_t vt, int kk) { return desc_sw32(vt + kk * kWideSlice * 32); };
  int g = 0, gv = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    int b, h, q0, sl;
    decode(item, b, h, q0, sl);
    const int rows[2] = {q0 + row_c, q0 + row_c + 8};
    float o[kWideSlice / 2];
#pragma unroll
    for (int i = 0; i < kWideSlice / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = j * kWideBN;
      float sc[kWideBN / 2];
      for (int ch = 0; ch < n_chunks; ++ch, ++g) {
        const int s = g % kWideSlots;
        const int nb = min(8, w.n_steps - 8 * ch);
        mbar_wait(slot_ready(s), (g / kWideSlots) & 1);
        // q's fragments of the chunk, scaled in fp32 and split
        // (all eight boxes, so that the loop unrolls and the fragments stay
        // in registers: a box past d holds stale values its k-step skips)
        const float* const qr = reinterpret_cast<const float*>(gen(slot(s)));
        uint32_t qb[8][4], qs[8][4];
#pragma unroll
        for (int bx = 0; bx < 8; ++bx) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float big, small;
            split(__fmul_rn(qr[bx * 512 + q_at[e]], p.scale), big, small);
            qb[bx][e] = __float_as_uint(big);
            qs[bx][e] = __float_as_uint(small);
          }
        }
        // k's descriptors stepped a box at a time, each made once the
        // product before it is issued (as `scores_stepped`: made up front
        // they would take registers beside q's fragments)
        const uint32_t kb = slot(s) + kWideQ, ks = kb + kWideK;
        float scc[kWideBN / 2];
        wgmma_fence();
        auto pass = [&](const uint32_t (&a)[8][4], uint32_t k, bool first) {
          uint64_t dk = k_desc(k, 0);
#pragma unroll
          for (int bx = 0; bx < 8; ++bx) {
            if (bx < nb) wgmma_rs<kWideBN>(scc, a[bx], dk, first && bx == 0 ? 0 : 1);
            dk += (kWideBN * 32) >> 4;
            asm volatile("" : "+l"(dk));
          }
        };
        pass(qs, kb, true);   // the small terms,
        pass(qb, ks, false);
        pass(qb, kb, false);  // then the big one
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(scc);
#pragma unroll
        for (int bx = 0; bx < 8; ++bx) {
          fence_regs(qb[bx]);
          fence_regs(qs[bx]);
        }
        mbar_arrive(slot_empty(s));
#pragma unroll
        for (int i = 0; i < kWideBN / 2; ++i) sc[i] = ch == 0 ? scc[i] : __fadd_rn(sc[i], scc[i]);
      }

      // the softmax on the accumulator layout, p's fragments
      float alpha[2];
      uint32_t pb[kWideBN / 8][4], ps[kWideBN / 8][4];
      f32_softmax_tile<MODE, BIAS>(sc, m, l, alpha, pb, ps, p, b, h, rows, k0, col_t);
      // the tile's p·v over the slice into accumulators of its own, then o
      const int vs = gv % kWideVStages;
      const uint32_t vb = v_raw(vs) + kWideV, vsm = vb + kWideV;
      mbar_wait(v_ready(vs), (gv / kWideVStages) & 1);
      float ot[kWideSlice / 2];
#pragma unroll
      for (int i = 0; i < kWideSlice / 2; ++i) ot[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWideBN / 8; ++kk) wgmma_rs<kWideSlice>(ot, ps[kk], vt_desc(vb, kk));
#pragma unroll
      for (int kk = 0; kk < kWideBN / 8; ++kk) wgmma_rs<kWideSlice>(ot, pb[kk], vt_desc(vsm, kk));
#pragma unroll
      for (int kk = 0; kk < kWideBN / 8; ++kk) wgmma_rs<kWideSlice>(ot, pb[kk], vt_desc(vb, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(ot);
#pragma unroll
      for (int kk = 0; kk < kWideBN / 8; ++kk) {
        fence_regs(pb[kk]);
        fence_regs(ps[kk]);
      }
      mbar_arrive(v_empty(vs));
      ++gv;
#pragma unroll
      for (int i = 0; i < kWideSlice / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], ot[i]);
    }

    f32_store_o<MODE, true>(o, l, m, p, b, h, rows, sl * kWideSlice, w.d, col_t);
  }
}

// The streamed body's kernels, one name a route as at the built widths (the
// slice width in the name)
template <int W, bool BIAS>
__global__ void __launch_bounds__(256, 1)
    attn_exact_f32_wide_sm90_kernel(const __grid_constant__ Maps maps, const WideParams w) {
  attn_f32_wide_body<kExact, BIAS>(maps.m, w);
}
template <int W, bool BIAS>
__global__ void __launch_bounds__(256, 1)
    attn_flash_f32_wide_sm90_kernel(const __grid_constant__ Maps maps, const WideParams w) {
  attn_f32_wide_body<kExact, BIAS>(maps.m, w);
}
template <int W, bool BIAS>
__global__ void __launch_bounds__(256, 1)
    attn_clamp_f32_wide_sm90_kernel(const __grid_constant__ Maps maps, const WideParams w) {
  attn_f32_wide_body<kClamp, BIAS>(maps.m, w);
}
template <int W, bool BIAS>
__global__ void __launch_bounds__(256, 1)
    attn_rowblock_f32_wide_sm90_kernel(const __grid_constant__ Maps maps, const WideParams w) {
  attn_f32_wide_body<kClamp, BIAS>(maps.m, w);
}

// The streamed body's launch: q and k in 8-column boxes (q's of 64 rows,
// k's of 32 keys) under the 32-byte swizzle, v in rows of the slice's
// columns of 32 keys, one block per SM walking (batch·head, query tile,
// slice) items.
int wide_f32_fwd(const float* q, const float* k, const float* v, float* o,
                 const unsigned long long* maps, const long long* strides, const float* bias,
                 int B, int H, int Tq, int Tk, float scale, int route, int n_pad, void* stream) {
  using WideKernel = void (*)(const Maps, const WideParams);
  const bool has_bias = bias != nullptr;
  const WideKernel kernels[4][2] = {
      {attn_flash_f32_wide_sm90_kernel<kWideSlice, false>,
       attn_flash_f32_wide_sm90_kernel<kWideSlice, true>},
      {attn_rowblock_f32_wide_sm90_kernel<kWideSlice, false>,
       attn_rowblock_f32_wide_sm90_kernel<kWideSlice, true>},
      {attn_exact_f32_wide_sm90_kernel<kWideSlice, false>,
       attn_exact_f32_wide_sm90_kernel<kWideSlice, true>},
      {attn_clamp_f32_wide_sm90_kernel<kWideSlice, false>,
       attn_clamp_f32_wide_sm90_kernel<kWideSlice, true>},
  };
  const WideKernel kernel = kernels[route][has_bias];
  const int d = (int)maps[0];
  const int n_slices = (d + kWideSlice - 1) / kWideSlice;
  const long long n_items = (long long)B * H * ((Tq + 63) / 64) * n_slices;
  if (n_items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  Maps tmaps;
  const void* ptrs[3] = {q, k, v};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    const unsigned long long* a = maps + 7 * i;
    const cuuint64_t dims[4] = {a[0], a[1], a[2], a[3]};
    const cuuint64_t gstrides[3] = {a[4], a[5], a[6]};
    const cuuint32_t box[4] = {i == 2 ? (cuuint32_t)kWideSlice : 8u, 1,
                               i == 0 ? 64u : (cuuint32_t)kWideBN, 1};
    const CUresult r = encode(&tmaps.m[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                              const_cast<void*>(ptrs[i]), dims, gstrides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE,
                              i == 2 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_32B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return 100000 + (int)r;
  }
  WideParams w;
  Params& p = w.p;
  p.o = o;
  p.o_sb = strides[0], p.o_st = strides[1], p.o_sh = strides[2];
  p.bias = bias;
  p.b_sb = strides[3], p.b_sh = strides[4], p.b_sq = strides[5], p.b_sk = strides[6];
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.n_items = (int)n_items;
  p.n_pad = n_pad;
  p.scale = scale;
  w.d = d;
  w.n_steps = (d + 7) / 8;
  w.n_slices = n_slices;
  static bool opted_in[4][2] = {};
  bool& opted = opted_in[route][has_bias];
  if (!opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideBytes);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = n_items < sms ? (int)n_items : sms;
  kernel<<<grid, 256, kWideBytes, static_cast<cudaStream_t>(stream)>>>(tmaps, w);
  return (int)cudaGetLastError();
}

using Kernel = void (*)(const Maps, const Params);

struct Launch {
  Kernel kernel = nullptr;
  int threads = 0, smem = 0, rows = 0, keys = 0, split = 1;
};

// The kernel of `route` (0 streaming K6, 1 row-block K5, 2 single-tile K1 or
// K2, 3 transposed K4) at head dim D, with or without a bias.
template <int D>
Launch f32_launch(int route, bool bias) {
  using C = BlockCfg<D>;
  Kernel kernels[4][2] = {
      {attn_flash_f32_sm90_kernel<D, false>, attn_flash_f32_sm90_kernel<D, true>},
      {attn_rowblock_f32_sm90_kernel<D, false>, attn_rowblock_f32_sm90_kernel<D, true>},
      {attn_exact_f32_sm90_kernel<D, false>, attn_exact_f32_sm90_kernel<D, true>},
      {attn_clamp_f32_sm90_kernel<D, false>, attn_clamp_f32_sm90_kernel<D, true>},
  };
  return {kernels[route][bias], C::kThreads, C::kBytes, C::kRowsQ, C::kBN, kSplit<D>};
}

// The built widths: `f32_launch<kWidths[i]>` below, `opted_in`'s first index
constexpr int kWidths[] = {16, 32, 40, 64, 72, 96, 128, 192, 256, 384, 512};
constexpr int kNumWidths = sizeof(kWidths) / sizeof(kWidths[0]);
// the widest built width: past it the streamed form
constexpr int kMaxWidth = 512;

Launch launch_at(int width, int route, bool bias) {
  return width == 16    ? f32_launch<16>(route, bias)
         : width == 32  ? f32_launch<32>(route, bias)
         : width == 40  ? f32_launch<40>(route, bias)
         : width == 64  ? f32_launch<64>(route, bias)
         : width == 72  ? f32_launch<72>(route, bias)
         : width == 96  ? f32_launch<96>(route, bias)
         : width == 128 ? f32_launch<128>(route, bias)
         : width == 192 ? f32_launch<192>(route, bias)
         : width == 256 ? f32_launch<256>(route, bias)
         : width == 384 ? f32_launch<384>(route, bias)
         : width == 512 ? f32_launch<512>(route, bias)
                        : Launch{};
}

// The kernel's opt-in to its dynamic shared memory (above 48 KB it needs
// one, once per kernel)
cudaError_t opt_in(const Launch& launch, int width, int route, bool bias) {
  static bool opted_in[kNumWidths][4][2] = {};
  int wi = 0;
  while (kWidths[wi] != width) ++wi;
  bool& opted = opted_in[wi][route][bias];
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        launch.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, launch.smem);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  return cudaSuccess;
}

// A launch of clusters of `launch.split` blocks on `sms` SMs: `cfg` (whose
// attribute is `attr`) and the clusters that can be resident at once
// (`cudaOccupancyMaxActiveClusters`)
cudaError_t cluster_config(const Launch& launch, int sms, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int& clusters) {
  cfg = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = launch.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(sms / launch.split * launch.split);
  cfg.blockDim = dim3(launch.threads);
  cfg.dynamicSmemBytes = launch.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(&clusters, launch.kernel, &cfg);
}

cudaError_t sm_count(int& sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

}  // namespace

// q, k, v: fp32 (B, T, H, d), d ≤ `width`, one of the built widths 16, 32,
// 40, 64, 72, 96, 128, 192, 256, 384 and 512 (columns d..width−1
// zero-filled by TMA), or past 512 round_up(d, 64) (the streamed form);
// `maps` holds 7 values for each of q, k and v in turn: the dims {d, H, T,
// B} and the byte strides of H, T and B (each a multiple of 16, the base
// 16-byte aligned), as ops/attention.py's `f32_tma_operand` computes them.
// o: fp32 (B, Tq, H, width), all of its columns written at a built width
// (the wrapper hands a wider o where d < width and keeps its first d
// columns). strides: 7
// int64 — o's element strides (b, t, h), then the bias's (b, h, q, k), 0 where it
// broadcasts. bias: null or fp32; a key-padding one (B|1, 1, 1, Tk)
// on the clamp routes. route: 0 the exact softmax of the streaming route
// (K6), 1 the clamp softmax of the row-block route (K5), 2 the exact
// softmax of the single-tile route (K1; K2 with a bias), 3 the clamp
// softmax of the transposed route (K4). scale: 1/√D on the exact routes,
// clamp_scale(D, float32) on the clamp ones. n_pad: the reference's pad keys
// on the route. Launches one block per SM (or per item, if fewer), which
// walks the work items; from width 256 clusters, as many as can be
// resident. Returns 0, a cudaError_t of the launch, or 100000 + the
// CUresult of a refused tensor map.
extern "C" int ecad_attention_f32_sm90_fwd(const float* q, const float* k, const float* v,
                                           float* o, const unsigned long long* maps,
                                           const long long* strides, const float* bias, int B,
                                           int H, int Tq, int Tk, float scale, int route,
                                           int n_pad, int width, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || route < 0 || route > 3 || n_pad < 0 ||
      maps[7] != maps[0] || maps[14] != maps[0] || maps[0] < 1 || maps[0] > (unsigned)width)
    return (int)cudaErrorInvalidValue;
  if (width > kMaxWidth)
    return width % 64 != 0 || maps[0] <= kMaxWidth
               ? (int)cudaErrorInvalidValue
               : wide_f32_fwd(q, k, v, o, maps, strides, bias, B, H, Tq, Tk, scale, route, n_pad,
                              stream);
  const bool has_bias = bias != nullptr;
  const int D = width;
  const Launch launch = launch_at(D, route, has_bias);
  if (launch.kernel == nullptr) return (int)cudaErrorInvalidValue;
  const long long n_items = (long long)B * H * ((Tq + launch.rows - 1) / launch.rows);
  if (n_items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  Maps tmaps;
  const void* ptrs[3] = {q, k, v};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    const unsigned long long* a = maps + 7 * i;
    const cuuint64_t dims[4] = {a[0], a[1], a[2], a[3]};
    const cuuint64_t gstrides[3] = {a[4], a[5], a[6]};
    // q and k: 8 columns (32 bytes: the swizzle's width) of one head, the
    // item's rows or a stage's keys; v: whole rows of the width (of a
    // cluster's block), of a stage's keys
    const cuuint32_t box[4] = {i == 2 ? (cuuint32_t)(D / launch.split) : 8u, 1,
                               (cuuint32_t)(i == 0 ? launch.rows : launch.keys), 1};
    const CUresult r = encode(&tmaps.m[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                              const_cast<void*>(ptrs[i]), dims, gstrides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE,
                              i == 2 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_32B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return 100000 + (int)r;
  }
  Params p;
  p.o = o;
  p.o_sb = strides[0], p.o_st = strides[1], p.o_sh = strides[2];
  p.bias = bias;
  p.b_sb = strides[3], p.b_sh = strides[4], p.b_sq = strides[5], p.b_sk = strides[6];
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.n_items = (int)n_items;
  p.n_pad = n_pad;
  p.scale = scale;
  cudaError_t err = opt_in(launch, D, route, has_bias);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(sms);
  if (err != cudaSuccess) return (int)err;
  if (launch.split > 1) {
    // clusters of `split` blocks, as many as can be resident at once (each
    // walks the items)
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int clusters = 0;
    err = cluster_config(launch, sms, static_cast<cudaStream_t>(stream), cfg, attr, clusters);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    if (n_items < clusters) clusters = (int)n_items;
    cfg.gridDim = dim3(clusters * launch.split);
    return (int)cudaLaunchKernelEx(&cfg, launch.kernel, tmaps, p);
  }
  const int grid = n_items < sms ? (int)n_items : sms;
  launch.kernel<<<grid, launch.threads, launch.smem, static_cast<cudaStream_t>(stream)>>>(tmaps,
                                                                                         p);
  return (int)cudaGetLastError();
}

// The clusters of the kernel of `route` (as above) at the built `width`,
// with or without a bias, that can be resident on the card at once
// (`cudaOccupancyMaxActiveClusters`; 1 for a width that launches no
// cluster), or −cudaError_t.
extern "C" int ecad_attention_f32_sm90_clusters(int width, int route, int bias) {
  if (route < 0 || route > 3) return -(int)cudaErrorInvalidValue;
  const Launch launch = launch_at(width, route, bias != 0);
  if (launch.kernel == nullptr) return -(int)cudaErrorInvalidValue;
  if (launch.split == 1) return 1;
  cudaError_t err = opt_in(launch, width, route, bias != 0);
  int sms = 0, clusters = 0;
  if (err == cudaSuccess) err = sm_count(sms);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (err == cudaSuccess) err = cluster_config(launch, sms, nullptr, cfg, attr, clusters);
  return err == cudaSuccess ? clusters : -(int)err;
}
