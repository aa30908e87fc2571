// Attention forward for Hopper (sm_90a): wgmma fed by TMA through
// mbarriers, with a producer warpgroup and two consumer warpgroups. bf16 q,
// k, v of shape (B, T, H, D), D = 72 or 128 (a template argument), in any
// 16-byte-aligned strides, in five softmax modes (a template argument, as in
// attention.cu) under seven kernel names, one per route and one per mode of
// the attention-variant harness; every exact and clamp kernel also takes a
// key-padding bias (a template flag in the name, so that a profile files
// the two forms apart):
//
//   * exact:
//     - `attn_flash_sm90_kernel<D, false>` (K6) replaces the streaming
//       kernel `_flash_kernel` (ecad_tpu/ops/attention.py:151-197, launched
//       by `_flash_attention` :638) at D=128 and D=72 — FLUX.1-dev at 1536²,
//       whose 9216 image + 512 text = 9728 joint tokens take the streaming
//       route, and PixArt-Σ's self-attention at 2048² (2B, 16384, 16, 72);
//       `<D, true>` the same with a key-padding bias (B|1, 1, 1, Tk), which
//       the reference streams past 8192×128 key elements (:573-673) and no
//       served path sends;
//     - `attn_exact_sm90_kernel<D, false>` (K1) replaces the single-tile
//       kernel `_attn_kernel` (:58, launched :746) at D=128 and D=72 —
//       FLUX.1-dev's joint attention at 256² (4, 768, 24, 128) and PixArt's
//       self-attention at 256² (2B, 256, 16, 72);
//     - `attn_exact_sm90_kernel<D, true>` (K2) replaces `_attn_kernel_bias`
//       (:75, launched :781) for a key-padding bias (B|1, 1, 1, Tk), bf16 or
//       fp32 — PixArt's text cross-attention at 256² (2B, 256, 16, 72) →
//       120 keys, whose bias is bf16 0 or −9984.
//     s = q·kᵀ in fp32 from bf16 operands, times 1/√D on the fp32 score (q
//     is not pre-scaled), an online max and sum in fp32 in the log2 domain
//     (without a bias the max taken on the raw scores, then p = exp2(s·c −
//     m·c) with c = scale·log2e in one FFMA; with one s₂ = s·c + bias·log2e
//     in one FFMA, the max taken on s₂, p = exp2(s₂ − m₂)), p rounded to
//     bf16 for p·v against the running max of its 128-key tile, Σp over the
//     unrounded fp32 p, one divide, one cast. (The reference K1, K2 keep p
//     in fp32 for p·v; the tolerance of chip_smoke.py's checks covers the
//     rounding; K6 rounds p as this body does, against the max of its
//     1536-key block.) Keys past Tk get −∞ before the max (by bounds; with a
//     bias, through the bias). The Pallas wrappers pad them instead with n_pad
//     keys of score −1e9 whose rows of v are 0 (n_pad the route's:
//     round_up(Tk, 128) − Tk on the single-tile route, round_up(Tk, bk) − Tk
//     with bk = min(1536, round_up(Tk, 128)) on the streaming one); they
//     weigh exactly 0 unless every score of a row is near −1e9 or below it,
//     which needs a caller bias: K2 and K6 with a bias meet it. The
//     epilogue adds them, as
//     attention.cu's exact epilogue does (m' = max(m, −1e9), the sums
//     rescaled by exp(m − m'), n_pad·exp(−1e9 − m') added to Σp): a few
//     instructions a row. In a row whose every key has a bias of −1e9, s₂
//     rounds to fp32(−1e9·log2e) for every real key while |s·c| < 64 (half
//     an ulp there), the same value as the pad keys' −1e9·log2e, as the
//     reference's s·scale − 1e9 rounds to −1e9 while |s·scale| < 32: the
//     output is Σv/(Tk + n_pad) on both sides, and 0 below −1e9.
//   * clamp:
//     - `attn_rowblock_sm90_kernel<128, false>` (K5) replaces the row-block
//       kernel `_rowblock_kernel_nobias` (:274, launched :534) at D=128 —
//       FLUX.1-dev at 1024², 4608 joint tokens; `<128, true>` replaces
//       `_rowblock_kernel` (:255, launched :563), the same with a
//       key-padding bias;
//     - `attn_clamp_sm90_kernel<D, false>` (K4) replaces the transposed
//       kernel `_transposed_kernel_nobias` (:344, launched :420) at D=72
//       (and 128) — PixArt's self-attention at 1024² (2B, 4096, 16, 72) and
//       512²; `<D, true>` replaces `_transposed_kernel` (:285, launched
//       :449) — PixArt's text cross-attention at 1024² (2B, 4096, 16, 72)
//       and PixArt-Σ's at 2048² (2B, 16384, 16, 72), each to 120 keys.
//     q times bf16(scale·log2e), rounded to bf16 before the product
//     (:378-383, :491-492), s = q·kᵀ in fp32, with a bias plus
//     fp32(bias·log2e) in a plain add (the reference's s + b_ref[...]: an
//     FFMA would round the sum differently), p = exp2(clip(s, −100, 80))
//     with no max and no rescale, Σp in fp32, bf16 p into p·v, one divide.
//     Keys past Tk weigh 0 here, with a bias too (its −∞ there would clip
//     to −100); the reference pads them to Tk_pad = round_up(Tk, 128) with
//     a −1e9 bias, which clamps to 2^-100 each (:429-431, :542-546), so
//     (Tk_pad − Tk)·2^-100 is added to Σp once: the two then agree in a row
//     whose every logit is clamped at −100 as well (an all-masked text
//     row: Σv/Tk_pad on both sides).
//   * the attention-variant harness (the port of the JAX package's
//     scripts/exp_attn_variants.py, which takes the body apart), bf16
//     without a bias, at D=72 and 128 (the only head dims the port takes
//     them at):
//     - no max (`kNoMax`): `attn_xnomax_sm90_kernel<D>` (X2) replaces
//       `k_nomax` (scripts/exp_attn_variants.py:115, launched by `_call`
//       :77): the clamp mode without its clip, p = exp2(s) with no max and
//       no rescale (+inf from s = 128 on, so such a row comes out NaN, as
//       the reference's does);
//     - max on a pre-scaled q (`kMaxScaledQ`): `attn_xmax_sm90_kernel<D>`
//       (X3) replaces `k_rowblock` (:129) and `k_chunk2` (:144), which differ
//       only in the order of their sums: the exact mode's online max with a
//       scale of 1 on the pre-scaled scores, p = exp2(s − m) rounded to
//       bf16 against the running max of its 128-key tile, the rescale of
//       the earlier tiles.
//     - the clamp with its denominator from the tensor cores (`kClampFD`):
//       `attn_xfd_sm90_kernel<72>` (X4) replaces `k_transposed_fd` (:288)
//       and `k_transposed_subk_fd` (:349), launched by `_call_transposed_v2`
//       (:442): p = exp2(clip(s, −100, 80)) as in the clamp mode, rounded to
//       bf16, and no fp32 Σp: the product of p with v's 8-column tail
//       widens from m64n8k16 to m64n16k16, its second 8 columns a constant
//       128 × 8 tile whose column 0 is 1 (the 2 KB after each stage's v
//       tail, laid out as the tail box and written once per block, as the
//       reference appends a ones row to vᵀ, :416-418), so column 72 of the
//       64 × 80 product is Σ bf16(p) of the same bf16 p, accumulated in
//       fp32, and one divide by it. Keys past Tk weigh p = 0 by bounds, so
//       their ones count nothing — the reference's ones row is 0 at its
//       pad keys — and X4, alone of the harness's bodies, takes any Tk.
//       D=72 only (the harness runs it at no other head dim).
//     X2, X3 and X4 take q × bf16(scale·log2e) rounded to bf16 before the
//     product, as `_prep` does (:67-68); X2 and X3 keep Σp in fp32 over the
//     unrounded p. The reference zero-pads the keys to a multiple of 128
//     and counts them in X2 and X3 (s = 0), so the C entry refuses Tk % 128
//     ≠ 0 in their modes: no pad keys, no masked tile. X2 and X3 run three
//     consumer warpgroups at D=72 (X4 two: see below), as
//     K6-D72 does (`kFlashConsumers`; below: a D=72 tile's p·v is short,
//     so a third independent chain feeds the tensor cores), and two at
//     D=128, where three fit neither the registers nor the shared memory.
//     On the card (scripts/probe_attention_body.py, NVIDIA H100 80GB HBM3,
//     700 W), two consumers made X3 16–20 % slower at (8, 4096, 16, 72) and 2–4 % at
//     (64, 1024, 16, 72), whose last 192-row item of each (batch, head)
//     holds 64 rows, and X2 10–21 % and 1–2 %; X3 with its max taken out
//     (`xmax_no_max`) took 15–18 % less than X3: the max, its shuffles and
//     the rescale. At D=72 X2 and X3 take 1.7–2.7 times their bound (K4
//     and K6-D72 about twice theirs); at D=128 X2 reaches 78 % of it and
//     X3 64 %, near K5 and K6-D128 (chip_smoke.py's kernel rows).
//
// What bounds it on the H100. K5 at FLUX-1024 (1, 4608, 24, 128): 4·B·H·
// Tq·Tk·D = 2.61e11 flops on the 113 MB of q, k, v and o, 2300 flops per
// byte, far above the ≈295 where bf16 tensor cores become the limit: 0.264
// ms at 989 TFLOP/s. K6 at FLUX-1536 (1, 9728, 24, 128): 1.16e12 flops on
// 239 MB, 1.18 ms. K6 at PixArt-2048 (2, 16384, 16, 72): 2.47e12 flops on
// 302 MB, 2.50 ms. K4 at PixArt-1024 (4, 4096, 16, 72): 3.09e11 flops on
// 151 MB, 0.313 ms. X2 and X3 at the harness's shapes: (2, 4608, 24, 128)
// 5.22e11 flops, 0.528 ms; (8, 4096, 16, 72) 6.18e11, 0.625 ms; (64, 1024,
// 16, 72) 3.09e11, 0.313 ms. K4 with a bias, to 120 text keys: 1.4e10
// flops on the 78 MB of q and o, 0.023 ms by bytes. K1 at FLUX-256 (4,
// 768, 24, 128): 2.9e10 flops on 38 MB, 0.029 ms by operations; at
// PixArt-256 (16, 256, 16, 72): 4.8e9 flops on 38 MB, 0.011 ms by bytes;
// K2 there, 256 → 120 keys: 2.3e9 flops on 28 MB, 0.008 ms by bytes. So
// the tensor cores bound all but the last two, and the exp2s come second:
// one per score, 5.1e8 at FLUX-1024, which at 16 a clock per SM (≈1.75
// GHz, 132 SMs) take ≈0.14 ms of the
// special-function units — half the tensor-core bound at D=128, and nearer
// the whole of it at D=72, where a score costs 0.59 of the products — so
// they must overlap the products, not follow them.
//
// The design, in what it does about that:
//   * Only `wgmma` reaches the full tensor-core rate on Hopper. A block has
//     three warpgroups (384 threads): a producer, which gives its
//     registers away (`setmaxnreg.dec` to 40), issues every TMA load from
//     one thread and has its other three warps (the helpers) scale q and
//     write the bias (below), and two consumers of 64 query rows each
//     (`setmaxnreg.inc` to 232); K6 at D=72 has three consumers (512
//     threads, 24 and 160 registers; see below). A work item is one
//     (batch·head, 64·consumers-row query tile). Each consumer runs s =
//     q·kᵀ as `wgmma.mma_async` m64n128k16 (eight k-steps at D=128, five
//     at D=72) with q and k from shared memory, the softmax in registers
//     on the accumulator layout (row reductions over the quad, as
//     attention.cu does), and o += p·v as eight k-steps of m64n128k16
//     (D=128) or m64n64k16 + m64n8k16 (D=72) with p as the register A
//     operand (bf16, packed from the fp32 scores) and v from shared
//     memory, read MN-major (the transpose bit
//     for 16-bit types), so v stays row-major. Each k or v element is read
//     from shared memory once per consumer warpgroup, where the mma.sync
//     body re-fetched it per 16-row warp through ldmatrix.
//   * Loads cost the consumers nothing: TMA copies whole tiles and
//     reports to an mbarrier. The q tile (128 rows) is loaded once per
//     item; k and v stream through a ring of 128-key stages (two at D=128,
//     three at D=72), each with a full barrier (the producer's expected
//     bytes) and an empty barrier (all 256 consumer threads arrive once
//     they are done with it), so the next tiles' copies run under this
//     tile's products. The o tile leaves the same way: each consumer
//     writes its 64 rows, in bf16, to staging rows in shared memory and
//     one of its threads stores them with TMA (`cp.async.bulk.tensor`,
//     whose completion only the next item's staging waits for), where 32
//     scattered 4-byte stores a thread were K4-with-a-bias's largest cost
//     (scratch probes on the card). 226 KB of shared memory at D=128,
//     181 KB at D=72 (210 KB with three consumers); the registers allow one
//     block per SM either way.
//   * At D=72 the loads are the limit, not the products: with a row
//     loaded as two 64-column boxes (the body's first form at D=72) the
//     second box is 56 columns of zero-fill, and TMA took as long over it
//     as over real data — taking out the exp2s, the softmax or p·v moved
//     K4 hardly at all, taking out those loads moved it most of the way to
//     its target (scratch probes on the card). So a D=72 tile is one
//     64-column swizzled box and an 8-column unswizzled tail, 18 KB of
//     loads instead of 32, with a third ring stage.
//   * The exp2s hide under the products. Each consumer issues tile j's
//     q·kᵀ and tile j−1's p·v together, waits for the first only, and
//     computes tile j's softmax while the second runs on the tensor
//     cores; the two consumer warpgroups drift against each other and
//     fill each other's gaps as well.
//   * At D=72 that is not enough for K6's 128 key tiles an item: a tile's
//     p·v is short (72 columns), so the chain of one consumer's softmax
//     (max, shuffles, exp2s, sums, the bf16 pack) outlasts what the other
//     consumer gives the tensor cores: on two consumers, taking out the
//     softmax moved K6-D72 far more than taking out its k/v loads or its
//     exp2s, or turns of the consumers at the tensor cores (named
//     barriers) did (scripts/probe_attention_body.py times such variants
//     on the card). So K6 at D=72 runs three consumers (192 query
//     rows an item, as FlashAttention-3 does at head dims up to 96): a
//     third independent chain for the tensor cores, and each k/v tile
//     serves 1.5 times the rows. Its registers fit 160 a thread (s, o and
//     p take 132); q's tile is 192 rows (a 24 KB box, a 3 KB tail).
//   * Short key counts (K1: 6 key tiles at FLUX-256, 2 at PixArt-256; K4
//     with a bias: one tile of 120 text keys) leave the q load, the ring's
//     fill and drain and the o store in the open when a block owns one
//     item. So a block walks the items from blockIdx.x in steps of
//     gridDim.x, and the launch is persistent, one block per SM, for K1 and
//     K2 and for any call of one key tile (Tk ≤ 128), which against one
//     block per item takes about two fifths off K4 with a bias
//     (`one_block_per_item`). The ring runs
//     on across items, and q has two buffers with full and empty barriers
//     of their own (the consumers arrive on the empty one after their last
//     q·kᵀ of an item), so the producer loads the next item's q and first
//     k/v tiles while the consumers work on this one. The other calls
//     launch one block per item (a grid of items), as before. At any time
//     the blocks work on neighbouring items, which share their (batch,
//     head) and its k/v tiles in L2. A run of consecutive items a block
//     (`items_in_runs` in scripts/probe_attention_body.py) makes K4 with a
//     bias, whose k/v tiles all fit in L2 (2.2 MB at PixArt-1024's
//     cross-attention), a little faster, but K1 at FLUX-256 much slower:
//     there the blocks then hold ~100 (batch, head)s' k/v at once, 37 MB.
//     For K4 with a bias a variant that loads no k/v tile after the ring's
//     first is only a few per cent faster (`no_kv_loads`): only q and o
//     come from and go to device memory.
//   * The bias (K2; K4, K5 and K6 with a bias) is read once per key, not
//     once per score, and off the consumers' path: for each key tile the
//     helpers write fp32(bias·log2e), −∞ past Tk, into the tile's 512-byte
//     slot beside its ring stage, once the stage is free, and arrive on
//     the stage's k_full (so it completes when k has landed and the bias is
//     there); a consumer thread reads its 32 columns of the slot (the same
//     for both of its rows) as 16 eight-byte shared loads. The exact
//     softmax folds them into the FFMA it does anyway, the clamp softmax
//     adds them to its scores (`__fadd_rn`: a plain add, as the
//     reference's). Read by the consumers from global memory instead (the
//     body's first form), 32 loads a thread a tile were most of K5's loss
//     with a bias at D=128 and a part of K2's at D=72. The helpers' loads
//     are plain ones in the bias's own dtype (bf16 widens exactly): the
//     bias needs no alignment beyond its element's and takes any batch and
//     key stride (0 where it broadcasts), so a bias TMA could not map (an
//     odd Tk with a batch stride) runs on this body all the same.
//   * K6 with a bias and X4 run two consumer warpgroups at D=72 too. On
//     three, a consumer has 160 registers, and K6-D72's scores, o and p
//     take 132 of them: beside them the 32 staged bias values spill (12
//     bytes; folding each pair of them into the scores as it is read
//     spilled as much), and so do X4's four more accumulators (the ones
//     column's block of its 16-column tail product; 48 bytes). On the card
//     (scripts/probe_attention_body.py, NVIDIA H100 80GB HBM3, 700 W) K6
//     with a bias on three consumers, spills and all, took 5.93 ms against
//     6.13 on two at (2, 16384, 16, 72), and X4 on three took 1.68 and 1.00
//     ms against 1.41 and 0.85 on two at (8, 4096, 16, 72) and (64, 1024,
//     16, 72); two keep the body free of spills.
//
// Where trouble was met, and what the code does about it:
//   1. The tensor map comes from the driver API (`cuTensorMapEncodeTiled`);
//     it is fetched through the runtime's `cudaGetDriverEntryPoint*`, so
//     the build links nothing but the runtime. The maps go to the kernel
//     as `const __grid_constant__ CUtensorMap` parameters.
//   2. The port keeps the (B, T, H, D) layout with any strides. Each
//     operand is a 4-D map {D, H, T, B} with byte strides: TMA needs a
//     16-byte-aligned base and strides that are multiples of 16 bytes.
//     The Python wrapper computes the map's arguments (dims, strides,
//     box) and raises where an operand does not meet them; nothing falls
//     back to the mma.sync body.
//   3. With 128-byte swizzle a TMA box is at most 128 bytes (64 bf16)
//     wide, so a row is loaded as boxes of 64 columns, each 128 rows × 128
//     bytes (16 KB): two at D=128, one after the other in shared memory.
//     The wgmma descriptors use the same swizzle: q and k K-major (8-row
//     groups 1024 bytes apart; a 16-column k-step moves the start by 32
//     bytes inside the 128-byte swizzle row, or to the second box), v
//     MN-major (its two 64-column boxes 16 KB apart as the leading offset,
//     8-key groups 1024 bytes apart; a 16-key k-step moves the start by
//     2048 bytes). At D=72 columns 64-71 come from a second tensor map
//     with an 8-column box and no swizzle: 16 bytes a row, so 8 rows are
//     one 128-byte core matrix of the unswizzled wgmma layout. q·kᵀ's fifth
//     k-step reads it K-major (8-row groups 128 bytes apart) with its
//     second core matrix along K — columns 72-79 — in a 2 KB zero region
//     after the tail, stored once when the block starts; p·v's m64n8k16
//     reads it MN-major (8-key groups 128 bytes apart). TMA counts the
//     bytes of rows past T toward the barrier too. q's boxes take the work
//     item's rows (128, or 192 for K6 at D=72), which the C entry sets in
//     q's maps; the wrapper's box arguments are those of k and v.
//   4. K4's and K5's pre-scaled q is rounded to bf16 before the product:
//     the helpers scale the whole q tile in place in shared memory once it
//     has landed (elementwise, so the swizzle does not matter), then a
//     `fence.proxy.async.shared::cta` and their arrival on the buffer's
//     q_ready barrier, which the consumers wait on instead of q_full,
//     order those generic-proxy writes before the first wgmma, and before
//     a later item's TMA write of that q buffer. The consumers scaled their
//     own rows before (the body's first form), on their path: the second
//     largest piece of K4 with a bias. The staging rows of the o store are ordered the same
//     way: the consumer's writes, a proxy fence and a named barrier over
//     its 128 threads before the TMA store; its issuing thread waits for
//     the store to have read them before the next item's writes.
//   5. Ragged edges: TMA zero-fills the rows past Tq and Tk (and counts
//     their bytes toward the barrier), and does not store rows past Tq
//     (outside o's map); keys past Tk get p = 0 (clamp) or −∞ before the
//     max (exact) by bounds, in the last key tile only (with a bias in
//     the exact mode, −∞ through the bias).
//   6. The overlap of exp2 with the products is the intra-warpgroup one
//     above; the registers of the p operand and of the accumulators are
//     fenced (an empty asm that reads and writes them) after each
//     wgmma.wait_group, so the compiler neither reads nor reuses them
//     while an asynchronous wgmma still owns them.
//   7. Tile size changes the rounding: in the exact mode each p is rounded
//     against the running max of its 128-key tile (64 in the mma.sync
//     body). chip_smoke.py measures `least_atol_per_std` against the same
//     tolerance rules as before.
//   8. No CUTLASS or CuTe: inline PTX, as in attention.cu, keeps the
//     build to seconds.
//   9. exp2 itself: `exp2f` compiles to more than the one special-function
//     instruction, for results below 2^-126 that neither mode can use;
//     `ex2.approx.ftz` is that one instruction, and the exact mode folds
//     its scale into an FFMA. A ping-pong of the two consumers' products
//     (named barriers, one warpgroup's turn at a time) was also tried on
//     the card, and added nothing on top of these.

#include <cuda.h>  // CUtensorMap and the driver-API types of its encoder
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockN = 128;  // keys per tile
constexpr int kQBufs = 2;  // q tiles: the next item's loads while this one runs
constexpr int kHelperThreads = 96;  // the producer warpgroup's warps 1-3

// A tile of `rows` rows (128 keys of k or v; 64 query rows per consumer
// warpgroup of q) in shared memory. D=128: two 64-column boxes under the
// 128-byte swizzle, 256 bytes a row. D=72: one such box (columns 0-63), the
// unswizzled tail box (columns 64-71, 16 bytes a row) and as many zeros
// after it, which q·kᵀ's fifth k-step reads as columns 72-79: 160 bytes a
// row, of which TMA writes 144. The ring has kStages stages of k and v: two
// at D=128 (192 KB with the q buffers), three at D=72 (160 KB with two
// consumers, 180 KB with three), where the loads are the larger share of a
// tile's time.
template <int D>
struct TileOf {
  static_assert(D == 72 || D == 128, "the body is built at head dims 72 and 128");
  int rows;
  __host__ __device__ constexpr int box() const { return rows * 128; }  // a 64-column swizzled box
  __host__ __device__ constexpr int tail() const { return rows * 16; }  // D=72's 8-column tail
  __host__ __device__ constexpr int bytes() const {
    return D == 128 ? 2 * box() : box() + 2 * tail();
  }
  __host__ __device__ constexpr int load() const { return D == 128 ? 2 * box() : box() + tail(); }
};

// The shared memory of a block with NC consumer warpgroups (NC·64 query
// rows a work item): the q buffers, the k and v stages, each consumer's
// staging rows for the o store (64 × D bf16), each stage's bias slot (128
// fp32), the barriers (q: full, empty and ready; k, v: full and empty),
// and 1024 bytes to align the base: 226 KB at D=128, 181 KB at D=72 (210
// KB with three consumers).
template <int D, int NC>
struct Smem {
  static constexpr TileOf<D> kQ{64 * NC}, kKV{kBlockN};
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kOut = 64 * D * 2;  // 16 KB at D=128, 9 KB at D=72
  static constexpr int kBarriers = 3 * kQBufs + 4 * kStages;
  static constexpr int kBytes = kQBufs * kQ.bytes() + 2 * kStages * kKV.bytes() + NC * kOut +
                                kStages * kBlockN * 4 + kBarriers * 8 + 1024;
};
constexpr int kBoxBytes = TileOf<72>{kBlockN}.box();    // 16 KB: a k or v tile's 64-column box
constexpr int kTailBytes = TileOf<72>{kBlockN}.tail();  // 2 KB: its 8-column tail at D=72
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClampLo = -100.f;
constexpr float kClampHi = 80.f;
constexpr float kTwoPowMinus100 = 7.8886090522101181e-31f;  // 2^-100
// a pad key's score on the exact routes, −1e9, in the log2 domain
constexpr float kPadScoreLog2 = -1e9f * kLog2e;

// The softmax modes: exact (K1, K2, K6), clamp (K4, K5), and the
// attention-variant harness's no max (X2), max on a pre-scaled q (X3) and
// clamp with the denominator from the tensor cores (X4).
enum Mode : int { kExact = 0, kClamp = 1, kNoMax = 2, kMaxScaledQ = 3, kClampFD = 4 };
// q is multiplied by bf16(scale·log2e) and rounded to bf16 (by the helpers)
__host__ __device__ constexpr bool scaled_q(int mode) { return mode != kExact; }
// a running max of the scores, p against it, and the rescale of earlier tiles
__host__ __device__ constexpr bool online_max(int mode) {
  return mode == kExact || mode == kMaxScaledQ;
}
// Σ bf16(p) from the p·v products through a ones column, no fp32 Σp
__host__ __device__ constexpr bool ones_denominator(int mode) { return mode == kClampFD; }

struct Params {
  // the key-padding bias (B|1, 1, 1, Tk) of a kernel's bias form (exact
  // single-tile or streaming, clamp transposed or row-block), bf16 or fp32
  // (bias_bf16), with its element strides over the batch and the keys (0
  // where it broadcasts); null elsewhere
  const void* bias;
  long long bias_sb, bias_sk;
  int bias_bf16;
  int H, Tq, Tk;
  int n_items;  // (batch·head, query tile of 64 rows a consumer) work items
  int n_pad;    // the reference's pad keys on this route (see the note)
  float scale;  // exact: 1/√D; the other modes: scale·log2e rounded to bf16
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// --- TMA --------------------------------------------------------------------

// One box of a 4-D map out of shared memory, in the thread's bulk group.
__device__ __forceinline__ void tma_store(uint32_t src, const CUtensorMap* map, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 4-D map into shared memory; completion counts its bytes
// on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A bf16 tile (`tile`'s rows) at rows `row` of (batch b, head h): two
// 64-column boxes of `map`, one after the other (D=128), or one and the
// 8-column box of `tail` at column 64 after it (D=72).
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, TileOf<D> tile, const CUtensorMap* map,
                                         const CUtensorMap* tail, uint32_t bar, int h, int row,
                                         int b) {
  tma_load(dst, map, bar, 0, h, row, b);
  tma_load(dst + tile.box(), D == 128 ? map : tail, bar, 64, h, row, b);
}

// --- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (bits 62-63).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The same without swizzle (layout type 0), for D=72's tail: 8×8 core
// matrices of 128 contiguous bytes (8 rows of 16). K-major: `lbo` steps
// to the next core matrix along K, `sbo` to the next 8 rows; MN-major:
// `lbo` to the next 8 rows along K (CUTLASS's canonical GMMA layouts).
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The compiler sees a wgmma's registers as read and written when it is
// issued; this makes it treat them as read and written here too, so that
// it neither reads an accumulator nor reuses an operand's register before
// the asynchronous wgmma that owns it has completed.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WGMMA_D64                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define WGMMA_ACC8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WGMMA_ACC64                                                                              \
  WGMMA_ACC8(0), WGMMA_ACC8(8), WGMMA_ACC8(16), WGMMA_ACC8(24), WGMMA_ACC8(32), WGMMA_ACC8(40), \
      WGMMA_ACC8(48), WGMMA_ACC8(56)

// d (64 × 128, fp32) (+)= a (64 × 16, shared, K-major) · b (16 × 128,
// shared, K-major): the scores s = q·kᵀ. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_ACC64
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 × 128, fp32) += a (64 × 16, bf16 registers) · b (16 × 128, shared,
// MN-major: the transpose bit): o += p·v at D=128.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WGMMA_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define WGMMA_D32                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// D=72's p·v in two products: d[0..31] (64 × 64) += a · b, b the first 64
// columns of v (one 128-byte-swizzled box, MN-major); d[32..35] (64 × 8)
// += a · b, b the 8-column tail (unswizzled, MN-major). The accumulators
// keep the layout of one 64 × 72 product: column block j in d[4j .. 4j+3].
// X4 (N = 40) widens the second product to 16 columns, d[32..39]: the tail
// and, `db_tail`'s stride apart, the ones tile, as one 64 × 80 product.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N], const uint32_t (&a)[4], uint64_t db,
                                         uint64_t db_tail) {
  static_assert(N == 36 || N == 40, "D=72's accumulators, and X4's denominator block");
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_ACC8(0), WGMMA_ACC8(8), WGMMA_ACC8(16), WGMMA_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  if constexpr (N == 36) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}"
        ", {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
        : "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db_tail), "r"(1));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16"
        " {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db_tail), "r"(1));
  }
}

// 2^x in one special-function instruction. `exp2f` also computes results
// below 2^-126 exactly, which costs extra instructions on every score;
// here none can matter: the clamp's results are at least 2^-100, and the
// exact modes' p ≤ 1 loses only values below 2^-126 (flushed to 0) beside
// a running sum of at least 1. Without a max (X2) a score below −126
// weighs 0 where the reference's exp2 gives a denormal, which matters only
// in a row whose every score is below −126 (its sum then 0 here); from
// s = 128 on the result is +inf, as exp2 overflows in fp32.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- the softmax on the accumulator layout ------------------------------------
//
// Thread t of a consumer warpgroup holds, of its 64 × 128 scores, d[4j + e]
// at row 16·(t / 32) + t % 32 / 4 + 8·(e / 2) and column 8j + 2·(t % 4) +
// e % 2 (j < 16): two rows, 32 scores of each.

// Without a max: p = exp2(clip(s, −100, 80)) (clamp and X4, CLIP) or p =
// exp2(s) (X2) in place, 0 past Tk; Σp into l (SUM: not in X4, whose
// denominator the tensor cores take). With a key-padding bias, s + b2
// first (b2 holds fp32(bias·log2e), −∞ past Tk): a plain add, never fused
// with b2's product into an FFMA; a key past Tk still weighs 0, not the
// 2^-100 its −∞ would clip to, since the epilogue adds the reference's pad
// keys.
template <bool MASK, bool BIAS, bool CLIP, bool SUM>
__device__ __forceinline__ void softmax_nomax(float (&s)[64], const float (&b2)[BIAS ? 32 : 1],
                                              float (&l)[2], int col0, int Tk) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = col0 + (i >> 2) * 8 + (i & 1);
    const float x = BIAS ? __fadd_rn(s[i], b2[BIAS ? 2 * (i >> 2) + (i & 1) : 0]) : s[i];
    float p = ex2(CLIP ? fminf(fmaxf(x, kClampLo), kClampHi) : x);
    if (MASK && col >= Tk) p = 0.f;
    s[i] = p;
    if (SUM) l[(i >> 1) & 1] += p;
  }
}

// Exact: −∞ past Tk, the running max m of the raw scores (the scale is
// positive, so it commutes with the max), the rescale factor of the
// earlier tiles (returned in alpha), p = exp2(s·scale·log2e − m·scale·log2e)
// in place with the scale folded into one FFMA, Σp into l after rescaling it.
// X3 takes it with qk_scale = 1 on its pre-scaled scores: p = exp2(s − m).
template <bool MASK>
__device__ __forceinline__ void softmax_exact(float (&s)[64], float (&m)[2], float (&l)[2],
                                              float (&alpha)[2], float qk_scale, int col0, int Tk) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = col0 + (i >> 2) * 8 + (i & 1);
    if (MASK && col >= Tk) s[i] = -INFINITY;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((m[r] - mx[r]) * qk_scale);  // exp2(−∞) = 0 on the first tile
    m[r] = mx[r];
    l[r] *= alpha[r];
    shift[r] = -mx[r] * qk_scale;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2(fmaf(s[i], qk_scale, shift[r]));
    s[i] = p;
    l[r] += p;
  }
}

// Exact with a key-padding bias: s₂ = s·scale·log2e + bias·log2e in one
// FFMA (b2 holds bias·log2e, −∞ past Tk), the running max m of s₂ (log2
// domain), the rescale factor of the earlier tiles (alpha), p = exp2(s₂ −
// m) in place, Σp into l after rescaling it.
__device__ __forceinline__ void softmax_exact_bias(float (&s)[64], const float (&b2)[32],
                                                   float (&m)[2], float (&l)[2],
                                                   float (&alpha)[2], float qk_scale) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = fmaf(s[i], qk_scale, b2[2 * (i >> 2) + (i & 1)]);
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2(m[r] - mx[r]);  // exp2(−∞) = 0 on the first tile
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2(s[i] - mx[r]);
    s[i] = p;
    l[r] += p;
  }
}

// One key tile's bias in the log2 domain, fp32(bias·log2e) for key col0 + i
// (−∞ past Tk), written into the tile's slot by the producer's helper
// thread `ht` (of kHelperThreads): plain loads in the bias's own dtype
// (bf16 widens exactly: its bits are an fp32's upper half), any batch and
// key stride.
__device__ __forceinline__ void write_bias(float* slot, const Params& p, int b, int col0,
                                           int ht) {
  const unsigned short* const bf16_bias = static_cast<const unsigned short*>(p.bias);
  const float* const f32_bias = static_cast<const float*>(p.bias);
  for (int i = ht; i < kBlockN; i += kHelperThreads) {
    const int col = col0 + i;
    float x = -INFINITY;
    if (col < p.Tk) {
      const long long at = b * p.bias_sb + col * p.bias_sk;
      x = p.bias_bf16 ? __uint_as_float((uint32_t)__ldg(bf16_bias + at) << 16)
                      : __ldg(f32_bias + at);
      x *= kLog2e;
    }
    slot[i] = x;
  }
}

// This consumer thread's 32 columns of a key tile's bias slot (b2[2j + e]
// for column col_t + 8j + e): 16 eight-byte loads from shared memory.
__device__ __forceinline__ void read_bias(float (&b2)[32], const float* slot, int col_t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 x = *reinterpret_cast<const float2*>(slot + col_t + 8 * j);
    b2[2 * j] = x.x;
    b2[2 * j + 1] = x.y;
  }
}

// One key tile's softmax, masked only where the tile passes Tk (in the
// exact mode with a bias, through the bias b2; X2 and X3 never pass it).
template <int MODE, bool BIAS>
__device__ __forceinline__ void softmax_tile(float (&s)[64], const float (&b2)[BIAS ? 32 : 1],
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             float qk_scale, int k0, int col_t, int Tk) {
  const bool edge = k0 + kBlockN > Tk;
  if constexpr (!online_max(MODE)) {
    constexpr bool kClip = MODE != kNoMax, kSum = !ones_denominator(MODE);
    if (edge) softmax_nomax<true, BIAS, kClip, kSum>(s, b2, l, k0 + col_t, Tk);
    else softmax_nomax<false, BIAS, kClip, kSum>(s, b2, l, k0 + col_t, Tk);
  } else if constexpr (BIAS) {
    softmax_exact_bias(s, b2, m, l, alpha, qk_scale);
  } else {
    if (edge) softmax_exact<true>(s, m, l, alpha, qk_scale, k0 + col_t, Tk);
    else softmax_exact<false>(s, m, l, alpha, qk_scale, k0 + col_t, Tk);
  }
}

// p (fp32, accumulator layout) → the bf16 A fragments of eight k16 steps:
// k-step kk covers score columns 16kk..16kk+15, i.e. d[8kk .. 8kk + 7].
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// The shared body of every kernel, one work item (batch·head, 64·NC-row
// query tile) after another, from blockIdx.x in steps of gridDim.x; the
// maps are the kernel's __grid_constant__ parameters (TMA reads them in
// parameter space).
template <int D, int MODE, bool BIAS, int NC>
__device__ __forceinline__ void attn_sm90_body(const CUtensorMap* maps, const Params& p) {
  static_assert(NC == 2 || NC == 3, "two or three consumer warpgroups");
  static_assert(!ones_denominator(MODE) || (D == 72 && !BIAS),
                "X4's ones column is D=72's tenth column block, without a bias");
  constexpr int kBlockM = 64 * NC;  // query rows per work item
  constexpr int kConsumerThreads = 128 * NC;
  // registers a thread: the producer gives its own away, the consumers take
  // them (128 × (40 + 2 × 232) and 128 × (24 + 3 × 160) ≤ 65536)
  constexpr int kProducerRegs = NC == 2 ? 40 : 24, kConsumerRegs = NC == 2 ? 232 : 160;
  constexpr int kQkSteps = (D + 15) / 16;  // k16 steps of q·kᵀ: 8 at D=128, 5 at D=72
  // a thread's fp32 accumulators of o (64 × D) and, in X4, of the
  // denominator's column block (64 × 8: column 72 of a 64 × 80 product)
  constexpr int kAcc = D / 2 + (ones_denominator(MODE) ? 4 : 0);
  using S = Smem<D, NC>;
  constexpr TileOf<D> kQ = S::kQ, kKV = S::kKV;
  constexpr int kStages = S::kStages;
  // the producer's helper warps scale q (every mode but the exact one) and
  // write the bias (BIAS)
  constexpr bool kHelpers = scaled_q(MODE) || BIAS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  auto q_s = [&](int qb) { return base + qb * kQ.bytes(); };
  auto k_s = [&](int s) { return base + kQBufs * kQ.bytes() + s * kKV.bytes(); };
  auto v_s = [&](int s) { return k_s(kStages + s); };
  auto out_s = [&](int c) { return k_s(2 * kStages) + c * S::kOut; };
  auto bias_slot = [&](int s) {
    return reinterpret_cast<float*>(gbase + (out_s(NC) - base) + s * kBlockN * 4);
  };
  const uint32_t bars = out_s(NC) + kStages * kBlockN * 4;
  auto q_full = [&](int qb) { return bars + 8 * qb; };
  auto q_empty = [&](int qb) { return bars + 8 * (kQBufs + qb); };
  auto q_ready = [&](int qb) { return bars + 8 * (2 * kQBufs + qb); };
  auto k_full = [&](int s) { return bars + 8 * (3 * kQBufs + s); };
  auto v_full = [&](int s) { return bars + 8 * (3 * kQBufs + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (3 * kQBufs + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (3 * kQBufs + 3 * kStages + s); };

  const int n_qt = (p.Tq + kBlockM - 1) / kBlockM;
  const int n_tiles = (p.Tk + kBlockN - 1) / kBlockN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < kQBufs; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), kConsumerThreads);
      mbar_init(q_ready(qb), kHelperThreads);
    }
    for (int s = 0; s < kStages; ++s) {
      // with a bias, the helpers' arrivals too: the tile's bias is written
      mbar_init(k_full(s), 1 + (BIAS ? kHelperThreads : 0));
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerThreads);
      mbar_init(v_empty(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the q buffers and the ring full; `g` counts
    // the ring's tiles across items, `it` this block's items (item it takes
    // q buffer it % 2)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int g = 0, it = 0;
      for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++it) {
        const int bh = item / n_qt;
        const int b = bh / p.H, h = bh % p.H;
        const int qb = it % kQBufs;
        mbar_wait(q_empty(qb), ((it / kQBufs) & 1) ^ 1);  // the first round finds it free
        mbar_expect_tx(q_full(qb), kQ.load());
        tma_tile<D>(q_s(qb), kQ, &maps[0], &maps[3], q_full(qb), h, (item % n_qt) * kBlockM, b);
        for (int j = 0; j < n_tiles; ++j, ++g) {
          const int s = g % kStages;
          const uint32_t free_parity = ((g / kStages) & 1) ^ 1;  // the first round finds it free
          mbar_wait(k_empty(s), free_parity);
          mbar_expect_tx(k_full(s), kKV.load());
          tma_tile<D>(k_s(s), kKV, &maps[1], &maps[4], k_full(s), h, j * kBlockN, b);
          mbar_wait(v_empty(s), free_parity);
          mbar_expect_tx(v_full(s), kKV.load());
          tma_tile<D>(v_s(s), kKV, &maps[2], &maps[5], v_full(s), h, j * kBlockN, b);
        }
      }
    } else if (kHelpers && threadIdx.x >= 128 - kHelperThreads) {
      // helpers (warps 1-3): per item, the bias of its first key tile, then
      // q × bf16(scale·log2e) rounded to bf16 in place over the whole q
      // tile (elementwise, so the swizzle does not matter), a proxy fence
      // and q_ready, then the bias of its other key tiles. A tile's bias goes
      // into its stage's slot once the stage is free, then the helpers arrive
      // on its k_full. The first tile's stage is freed by earlier tiles (none
      // of which waits for this q), so its bias is written before q comes:
      // the bias loads do not lengthen the wait for a one-tile item.
      const int ht = threadIdx.x - (128 - kHelperThreads);
      int g = 0, it = 0;
      auto bias_tile = [&](int b, int j) {
        const int s = g % kStages;
        mbar_wait(k_empty(s), ((g / kStages) & 1) ^ 1);  // the first round finds it free
        write_bias(bias_slot(s), p, b, j * kBlockN, ht);
        mbar_arrive(k_full(s));
        ++g;
      };
      for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++it) {
        const int qb = it % kQBufs;
        const int b = item / n_qt / p.H;
        if constexpr (BIAS) bias_tile(b, 0);
        if constexpr (scaled_q(MODE)) {
          mbar_wait(q_full(qb), (it / kQBufs) & 1);
          uint4* const q = reinterpret_cast<uint4*>(gbase + (q_s(qb) - base));
          for (int i = ht; i < kQ.load() / 16; i += kHelperThreads) {
            uint4 x = q[i];
            uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
              w[e] = pack_bf16(__low2float(v) * p.scale, __high2float(v) * p.scale);
            }
            q[i] = x;
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(q_ready(qb));
        }
        if constexpr (BIAS) {
          for (int j = 1; j < n_tiles; ++j) bias_tile(b, j);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns query rows 64c .. 64c + 63 of each item's tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row_c = 16 * (t / 32) + lane / 4;  // this thread's first row of the consumer's 64
  const int col_t = 2 * (lane % 4);            // its first column in each 8-column block

  // descriptors: q and k K-major (8-row groups 1024 bytes apart in a
  // swizzled box, this consumer's 64 rows of q 8 KB on per consumer; at D=72
  // the fifth k-step reads the tail, 8-row groups 128 bytes apart, and its
  // columns 72-79 from the zeros one tail on), v MN-major (64-column boxes
  // 16 KB apart, 8-key groups 1024 bytes apart; the tail's 8-key groups 128
  // bytes apart)
  auto q_desc = [&](uint32_t q, int kk) {
    if (D == 72 && kk == 4) return desc_plain(q + kQ.box() + 1024 * c, kQ.tail(), 128);
    return desc_sw128(q + (kk / 4) * kQ.box() + 8192 * c + (kk % 4) * 32, 16, 1024);
  };
  auto k_desc = [&](int s, int kk) {
    if (D == 72 && kk == 4) return desc_plain(k_s(s) + kBoxBytes, kTailBytes, 128);
    return desc_sw128(k_s(s) + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024);
  };
  auto v_desc = [&](int s, int kk) { return desc_sw128(v_s(s) + kk * 2048, kBoxBytes, 1024); };
  // X4's ones tile, 128 keys × 8 columns laid out as v's tail box, column
  // 0 = 1: the 2 KB after each stage's v tail, which TMA never writes, so
  // that the tail and the ones are one 16-column B operand, its two 8-column
  // groups 2 KB apart (the descriptor's stride along N)
  auto ones = [&](int s) { return v_s(s) + kBoxBytes + kTailBytes; };
  auto pv = [&](float (&o)[kAcc], const uint32_t (&a)[4], int s, int kk) {
    if constexpr (D == 72)
      wgmma_rs(o, a, v_desc(s, kk),
               desc_plain(v_s(s) + kBoxBytes + kk * 256, 128,
                          ones_denominator(MODE) ? kTailBytes : 128));
    else
      wgmma_rs(o, a, v_desc(s, kk));
  };
  if constexpr (D == 72) {
    // the zeros after the tails of the q buffers and the k stages (and X4's
    // ones tile), stored once (TMA never writes there), ordered before the
    // first wgmma that reads them
    auto fill = [&](uint32_t at, int bytes, uint4 x) {
      for (int i = 16 * (t + 128 * c); i < bytes; i += 16 * kConsumerThreads)
        *reinterpret_cast<uint4*>(gbase + (at - base) + i) = x;
    };
    const uint4 zeros = make_uint4(0u, 0u, 0u, 0u);
    for (int qb = 0; qb < kQBufs; ++qb) fill(q_s(qb) + kQ.box() + kQ.tail(), kQ.tail(), zeros);
    for (int s = 0; s < kStages; ++s) fill(k_s(s) + kKV.box() + kKV.tail(), kKV.tail(), zeros);
    // bf16 1.0 in each 16-byte row's first half-word
    if constexpr (ones_denominator(MODE))
      for (int s = 0; s < kStages; ++s)
        fill(ones(s), kTailBytes, make_uint4(0x3F80u, 0u, 0u, 0u));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"n"(1 + NC), "n"(kConsumerThreads) : "memory");
  }
  const float qk_scale = MODE == kExact ? p.scale * kLog2e : 1.f;
  // a pre-scaled q is read once the helpers have scaled it
  auto q_in = [&](int qb) { return scaled_q(MODE) ? q_ready(qb) : q_full(qb); };
  // this consumer's staging rows for the o store (64 × D bf16: at D=128 two
  // 64-column boxes under the 128-byte swizzle, at D=72 rows of 144 bytes)
  const uint32_t out_tile = out_s(c);
  auto out_at = [&](int row, int jb) {
    return D == 128 ? (jb / 8) * 8192 + row * 128 + (((jb % 8) ^ (row % 8)) * 16) + 2 * col_t
                    : row * 144 + jb * 16 + 2 * col_t;
  };

  float b2[BIAS ? 32 : 1];
  int g = 0, it = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++it, g += n_tiles) {
    const int bh = item / n_qt;
    const int b = bh / p.H, h = bh % p.H;
    const int q0 = (item % n_qt) * kBlockM;
    const int qb = it % kQBufs;
    const uint32_t q_tile = q_s(qb);
    mbar_wait(q_in(qb), (it / kQBufs) & 1);

    float o[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
    float s[64];
    uint32_t pf[8][4];
    float m[2] = {-INFINITY, -INFINITY};  // with a bias, in the log2 domain
    float l[2] = {0.f, 0.f};  // this thread's partial sums, reduced at the end
    float alpha[2] = {1.f, 1.f};

    // tile 0: scores, softmax
    {
      const int s0 = g % kStages;
      mbar_wait(k_full(s0), (g / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQkSteps; ++kk) wgmma_ss(s, q_desc(q_tile, kk), k_desc(s0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if constexpr (BIAS) read_bias(b2, bias_slot(s0), col_t);
      mbar_arrive(k_empty(s0));
      if (n_tiles == 1) mbar_arrive(q_empty(qb));  // the item's last read of q
      softmax_tile<MODE, BIAS>(s, b2, m, l, alpha, qk_scale, 0, col_t, p.Tk);
      pack_p(s, pf);
    }

    for (int j = 1; j < n_tiles; ++j) {
      const int sj = (g + j) % kStages, sp = (g + j - 1) % kStages;
      // tile j's scores and tile j − 1's p·v, issued together
      mbar_wait(k_full(sj), ((g + j) / kStages) & 1);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQkSteps; ++kk) wgmma_ss(s, q_desc(q_tile, kk), k_desc(sj, kk), kk > 0);
      wgmma_commit();
      mbar_wait(v_full(sp), ((g + j - 1) / kStages) & 1);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) pv(o, pf[kk], sp, kk);
      wgmma_commit();
      // the scores first; their softmax runs under the p·v products
      wgmma_wait<1>();
      fence_regs(s);
      if constexpr (BIAS) read_bias(b2, bias_slot(sj), col_t);
      mbar_arrive(k_empty(sj));
      if (j == n_tiles - 1) mbar_arrive(q_empty(qb));  // the item's last read of q
      softmax_tile<MODE, BIAS>(s, b2, m, l, alpha, qk_scale, j * kBlockN, col_t, p.Tk);
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_regs(pf[kk]);
      mbar_arrive(v_empty(sp));
      if constexpr (online_max(MODE)) {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
      pack_p(s, pf);
    }
    // the last tile's p·v
    {
      const int sl = (g + n_tiles - 1) % kStages;
      mbar_wait(v_full(sl), ((g + n_tiles - 1) / kStages) & 1);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) pv(o, pf[kk], sl, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_regs(pf[kk]);
      mbar_arrive(v_empty(sl));
    }

    // epilogue: the row sums over the quad (X4: its denominator from the
    // quad's first thread, which holds column 72), the reference's pad keys
    // (none in X2-X4), one divide, one cast into the staging rows, one TMA
    // store of them
    float f[2] = {1.f, 1.f};  // the exact mode's rescale for its pad keys
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (ones_denominator(MODE)) {
        l[r] = __shfl_sync(0xffffffffu, o[kAcc - 4 + 2 * r], lane & ~3);
      } else {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      if constexpr (MODE == kClamp) {
        // up to a multiple of 128, 2^-100 each
        l[r] += (float)p.n_pad * kTwoPowMinus100;
      } else if (MODE == kExact && p.n_pad > 0) {
        // n_pad keys of score −1e9: m' = max(m, −1e9), the sums rescaled by
        // exp2(m − m'), n_pad·exp2(−1e9 − m') added (log2 domain); f = 1 and
        // the added term 0 unless every score of the row is near −1e9
        const float m2 = BIAS ? m[r] : m[r] * qk_scale;
        const float mp = fmaxf(m2, kPadScoreLog2);
        f[r] = ex2(m2 - mp);
        l[r] = l[r] * f[r] + (float)p.n_pad * ex2(kPadScoreLog2 - mp);
      }
    }
    // the staging rows are free once the last item's store has read them
    if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = f[r] / l[r];  // one divide a row: o·(f/l) is within an fp32 ulp of o·f/l
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb)
        *reinterpret_cast<uint32_t*>(gbase + (out_tile - base) + out_at(row_c + 8 * r, jb)) =
            pack_bf16(o[4 * jb + 2 * r] * inv, o[4 * jb + 2 * r + 1] * inv);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    if (t == 0) {
      // rows past Tq are outside the map: TMA does not store them
      tma_store(out_tile, &maps[6], 0, h, q0 + 64 * c, b);
      if constexpr (D == 128) tma_store(out_tile + 8192, &maps[6], 64, h, q0 + 64 * c, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  // the staging rows stay until the last store has read them
  if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Seven kernel names, so that a profile tells K6, K5, K1, K4, X2, X3 and X4
// apart, K1's, K4's, K5's and K6's with a BIAS flag (K2, and K4, K5 and K6
// with a bias). The maps: q, k, v, (at D=72) their 8-column tails, and o.
struct Maps {
  CUtensorMap m[7];
};
// K6's, X2's and X3's consumer warpgroups: three at D=72 (see the note),
// two at D=128; K6 with a bias takes two at D=72 too (see the note)
template <int D>
constexpr int kFlashConsumers = D == 72 ? 3 : 2;
template <int D, bool BIAS>
constexpr int kStreamConsumers = BIAS ? 2 : kFlashConsumers<D>;
template <int D, bool BIAS>
__global__ void __launch_bounds__(128 * (kStreamConsumers<D, BIAS> + 1), 1)
    attn_flash_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  attn_sm90_body<D, kExact, BIAS, kStreamConsumers<D, BIAS>>(maps.m, p);
}
template <int D, bool BIAS>
__global__ void __launch_bounds__(384, 1)
    attn_rowblock_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  attn_sm90_body<D, kClamp, BIAS, 2>(maps.m, p);
}
template <int D, bool BIAS>
__global__ void __launch_bounds__(384, 1)
    attn_exact_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  attn_sm90_body<D, kExact, BIAS, 2>(maps.m, p);
}
template <int D, bool BIAS>
__global__ void __launch_bounds__(384, 1)
    attn_clamp_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  attn_sm90_body<D, kClamp, BIAS, 2>(maps.m, p);
}
template <int D>
__global__ void __launch_bounds__(128 * (kFlashConsumers<D> + 1), 1)
    attn_xnomax_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  attn_sm90_body<D, kNoMax, false, kFlashConsumers<D>>(maps.m, p);
}
template <int D>
__global__ void __launch_bounds__(128 * (kFlashConsumers<D> + 1), 1)
    attn_xmax_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  attn_sm90_body<D, kMaxScaledQ, false, kFlashConsumers<D>>(maps.m, p);
}
// X4 on two consumer warpgroups (see the note)
template <int D>
__global__ void __launch_bounds__(384, 1)
    attn_xfd_sm90_kernel(const __grid_constant__ Maps maps, const Params p) {
  attn_sm90_body<D, kClampFD, false, 2>(maps.m, p);
}

using Kernel = void (*)(const Maps, const Params);

// A kernel with its consumer warpgroups, its dynamic shared memory and
// whether its mode takes a pre-scaled q.
struct Launch {
  Kernel kernel = nullptr;
  int consumers = 2;
  int smem = 0;
  bool q_prescaled = false;
};
template <int D, int NC, int MODE>
Launch launch_of(Kernel kernel) {
  return {kernel, NC, Smem<D, NC>::kBytes, scaled_q(MODE)};
}

// The kernel of `mode` at head dim D, with or without a bias, or none where
// it is not built: K5 at D=128 only, X4 (mode 6) at D=72 only, no bias in
// X2-X4 (modes 4-6).
template <int D>
Launch sm90_launch(int mode, bool bias) {
  switch (mode) {
    case 0:
      if (bias)
        return launch_of<D, kStreamConsumers<D, true>, kExact>(attn_flash_sm90_kernel<D, true>);
      return launch_of<D, kStreamConsumers<D, false>, kExact>(attn_flash_sm90_kernel<D, false>);
    case 1:
      if constexpr (D == 128)
        return launch_of<D, 2, kClamp>(bias ? attn_rowblock_sm90_kernel<D, true>
                                            : attn_rowblock_sm90_kernel<D, false>);
      return Launch{};
    case 2:
      return launch_of<D, 2, kExact>(bias ? attn_exact_sm90_kernel<D, true>
                                          : attn_exact_sm90_kernel<D, false>);
    case 3:
      return launch_of<D, 2, kClamp>(bias ? attn_clamp_sm90_kernel<D, true>
                                          : attn_clamp_sm90_kernel<D, false>);
    case 4:
      if (bias) return Launch{};
      return launch_of<D, kFlashConsumers<D>, kNoMax>(attn_xnomax_sm90_kernel<D>);
    case 5:
      if (bias) return Launch{};
      return launch_of<D, kFlashConsumers<D>, kMaxScaledQ>(attn_xmax_sm90_kernel<D>);
    case 6:
      if constexpr (D == 72)
        if (!bias) return launch_of<D, 2, kClampFD>(attn_xfd_sm90_kernel<D>);
      return Launch{};
    default:
      return Launch{};
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that nothing links libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

}  // namespace

// q, k, v: bf16 (B, T, H, D), D = 72 or 128; `maps` holds 11 values for
// each of q, k, v in turn: the dims {D, H, T, B}, the byte strides of H, T
// and B, and the box {64, 1, 128, 1}, as ops/attention.py's `tma_operand`
// computes them. o: bf16 (B, Tq, H, D) with element strides o_strides (b,
// t, h), each a multiple of 8 (TMA stores it). mode 0: the exact softmax
// of the streaming route (K6); 1: the clamp softmax of the row-block route
// (K5, D=128); 2: the exact softmax of the single-tile route (K1, or K2
// with a bias); 3: the clamp softmax of the transposed route (K4); 4: the
// harness's exp2 softmax without a max (X2); 5: its exp2 softmax with the
// max on a pre-scaled q (X3), both only at Tk % 128 == 0 (the reference
// counts its zero pad keys elsewhere); 6: its clamp softmax with the
// denominator from the p·v products (X4, D=72, any Tk). bias: null, or a
// key-padding bias (B|1, 1, 1, Tk) in modes 0-3, bf16 (bias_bf16 = 1) or
// fp32, with element strides bias_strides (batch, key), 0 where it
// broadcasts (`bias_operand`). scale = 1/√D, which the exact modes (0, 2) multiply
// into the fp32 scores; q_scale = scale·log2e rounded to bf16, which the
// helpers of the others multiply into q (`scaled_q`). Mode 2, and any
// mode at Tk ≤ 128, launches one block per SM, which walks the work
// items; the others one block per item. Returns 0, a cudaError_t of the
// launch, or 100000 + the CUresult of a refused tensor map.
extern "C" int ecad_attention_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                       const unsigned long long* maps,
                                       const long long* o_strides, const void* bias,
                                       const long long* bias_strides, int bias_bf16, int B,
                                       int H, int Tq, int Tk, float scale, float q_scale,
                                       int mode, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || mode < 0 || mode > 6 ||
      ((mode == 4 || mode == 5) && Tk % kBlockN != 0))
    return (int)cudaErrorInvalidValue;
  const bool has_bias = bias != nullptr;
  const Launch launch = maps[0] == 128 ? sm90_launch<128>(mode, has_bias)
                        : maps[0] == 72 ? sm90_launch<72>(mode, has_bias)
                                        : Launch{};
  const int block_m = 64 * launch.consumers;  // query rows per work item
  const long long n_items = (long long)B * H * ((Tq + block_m - 1) / block_m);
  if (launch.kernel == nullptr || n_items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  auto encode_map = [&](CUtensorMap* map, const void* ptr, const cuuint64_t* dims,
                        const cuuint64_t* strides, const cuuint32_t* box,
                        CUtensorMapSwizzle swizzle) {
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  // q, k, v under the 128-byte swizzle, then (D=72) their 8-column tails
  // without swizzle; at D=128 the last three are copies, never read
  Maps tmaps;
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 6; ++i) {
    const unsigned long long* a = maps + 11 * (i % 3);
    if (a[0] != maps[0] || a[7] != 64 || a[8] != 1 || a[9] != kBlockN || a[10] != 1)
      return (int)cudaErrorInvalidValue;
    if (i >= 3 && maps[0] == 128) {
      tmaps.m[i] = tmaps.m[i - 3];
      continue;
    }
    const cuuint64_t dims[4] = {a[0], a[1], a[2], a[3]};
    const cuuint64_t strides[3] = {a[4], a[5], a[6]};
    // q's box holds the work item's rows, 64 per consumer warpgroup
    const cuuint32_t rows = i % 3 == 0 ? (cuuint32_t)block_m : (cuuint32_t)a[9];
    const cuuint32_t box[4] = {i < 3 ? (cuuint32_t)a[7] : 8u, (cuuint32_t)a[8], rows,
                               (cuuint32_t)a[10]};
    const CUresult r =
        encode_map(&tmaps.m[i], ptrs[i % 3], dims, strides, box,
                   i < 3 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
    if (r != CUDA_SUCCESS) return 100000 + (int)r;
  }
  {
    // o, stored 64 rows a consumer warpgroup: at D=128 two 64-column boxes
    // under the 128-byte swizzle, at D=72 one 72-column box without it
    const bool d128 = maps[0] == 128;
    const cuuint64_t dims[4] = {maps[0], (cuuint64_t)H, (cuuint64_t)Tq, (cuuint64_t)B};
    const cuuint64_t strides[3] = {2ull * o_strides[2], 2ull * o_strides[1], 2ull * o_strides[0]};
    const cuuint32_t box[4] = {d128 ? 64u : 72u, 1, 64, 1};
    const CUresult r = encode_map(&tmaps.m[6], o, dims, strides, box,
                                  d128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
    if (r != CUDA_SUCCESS) return 100000 + (int)r;
  }
  Params p;
  p.bias = bias;
  p.bias_sb = has_bias ? bias_strides[0] : 0;
  p.bias_sk = has_bias ? bias_strides[1] : 0;
  p.bias_bf16 = bias_bf16;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.n_items = (int)n_items;
  // the reference's pad keys: to a multiple of 128, or of the streaming
  // route's key block min(1536, round_up(Tk, 128)); none in X2 and X3,
  // whose Tk is a multiple of 128, nor in X4, whose reference masks them
  const int tk128 = (Tk + 127) / 128 * 128;
  const int bk = mode == 0 ? (tk128 < 1536 ? tk128 : 1536) : 128;
  p.n_pad = mode == 6 ? 0 : (Tk + bk - 1) / bk * bk - Tk;
  p.scale = launch.q_prescaled ? q_scale : scale;
  // above 48 KB dynamic shared memory needs an opt-in (once per kernel)
  static bool opted_in[2][7][2] = {};
  bool& opted = opted_in[maps[0] == 72][mode][has_bias];
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        launch.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, launch.smem);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  // one block per SM for K1 and K2, and for one-tile items (K4 with PixArt's
  // 120 text keys), whose q load and o store are most of their work
  int grid = (int)n_items;
  if (mode == 2 || Tk <= kBlockN) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (sms < grid) grid = sms;
  }
  launch.kernel<<<grid, 128 * (launch.consumers + 1), launch.smem,
                  static_cast<cudaStream_t>(stream)>>>(tmaps, p);
  return (int)cudaGetLastError();
}
