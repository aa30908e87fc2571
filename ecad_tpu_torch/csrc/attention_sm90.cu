// Attention forward at head dim 128 for Hopper (sm_90a): wgmma fed by TMA
// through mbarriers, with a producer warpgroup and two consumer warpgroups.
// bf16 q, k, v of shape (B, T, H, 128) in any 16-byte-aligned strides, no
// bias, in two softmax modes (a template argument, as in attention.cu):
//
//   * exact (K6, kernel `attn_flash_sm90_kernel`): replaces the streaming
//     kernel `_flash_kernel` (ecad_tpu/ops/attention.py:151-197, launched
//     by `_flash_attention` :638) at D=128 — FLUX.1-dev at 1536², whose
//     9216 image + 512 text = 9728 joint tokens take the streaming route.
//     s = q·kᵀ in fp32 from bf16 operands, times 1/√D on the fp32 score (q
//     is not pre-scaled), an online max and sum in fp32 in the log2 domain
//     (the max taken on the raw scores, then p = exp2(s·c − m·c) with c =
//     scale·log2e in one FFMA), p rounded to bf16 for p·v against the
//     running max of its 128-key tile, Σp over the unrounded fp32 p, one
//     divide, one cast.
//     Keys past Tk get −inf before the max (by bounds). The Pallas wrapper
//     pads them with a −1e9 bias instead: the two differ only in a row
//     whose every real key is at or below −1e9 too, which needs a caller
//     bias, and this kernel takes none.
//   * clamp (K5, kernel `attn_rowblock_sm90_kernel`): replaces the
//     row-block kernel `_rowblock_kernel_nobias` (:274, launched :534) —
//     FLUX.1-dev at 1024², 4608 joint tokens. q times bf16(scale·log2e),
//     rounded to bf16 before the product (:491-492), p = exp2(clip(s,
//     −100, 80)) with no max and no rescale, Σp in fp32, bf16 p into p·v,
//     one divide. Keys past Tk weigh 0 here; the reference pads them to
//     Tk_pad = round_up(Tk, 128) with a −1e9 bias, which clamps to 2^-100
//     each (:542-546), so (Tk_pad − Tk)·2^-100 is added to Σp: the two
//     then agree in a row whose every logit is clamped at −100 as well.
//
// What bounds it on the H100. K5 at FLUX-1024 (1, 4608, 24, 128): 4·B·H·
// Tq·Tk·D = 2.61e11 flops on the 113 MB of q, k, v and o, 2300 flops per
// byte, far above the ≈295 where bf16 tensor cores become the limit: 0.264
// ms at 989 TFLOP/s. K6 at FLUX-1536 (1, 9728, 24, 128): 1.16e12 flops on
// 239 MB, 1.18 ms. So the tensor cores bound both, and the exp2s come
// second: one per score, 5.1e8 at FLUX-1024, which at 16 a clock per SM
// (≈1.75 GHz, 132 SMs) take ≈0.14 ms of the special-function units — half
// the tensor-core bound, so they must overlap the products, not follow
// them.
//
// The design, in what it does about that:
//   * Only `wgmma` reaches the full tensor-core rate on Hopper. One block
//     owns one (batch·head, 128-row query tile) and has three warpgroups
//     (384 threads): a producer, which gives its registers away
//     (`setmaxnreg.dec` to 40) and issues every TMA load from one thread,
//     and two consumers of 64 query rows each (`setmaxnreg.inc` to 232),
//     which run s = q·kᵀ as eight `wgmma.mma_async` m64n128k16 with q and
//     k from shared memory, the softmax in registers on the accumulator
//     layout (row reductions over the quad, as attention.cu does), and o
//     += p·v as eight m64n128k16 with p as the register A operand (bf16,
//     packed from the fp32 scores) and v from shared memory, read
//     MN-major (the transpose bit for 16-bit types), so v stays row-major.
//     Each k or v element is read from shared memory once per consumer
//     warpgroup, where the mma.sync body re-fetched it per 16-row warp
//     through ldmatrix.
//   * Loads cost the consumers nothing: TMA copies whole tiles and
//     reports to an mbarrier. The q tile (128 × 128 bf16, 32 KB) is
//     loaded once; k and v stream through a ring of kStages stages of
//     128 keys (32 KB each), each with a full barrier (the producer's
//     expected bytes) and an empty barrier (all 256 consumer threads
//     arrive once they are done with it), so the next tiles' copies run
//     under this tile's products. 160 KB of shared memory: one block per
//     SM.
//   * The exp2s hide under the products. Each consumer issues tile j's
//     q·kᵀ and tile j−1's p·v together, waits for the first only, and
//     computes tile j's softmax while the second runs on the tensor
//     cores; the two consumer warpgroups drift against each other and
//     fill each other's gaps as well.
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
//     wide, so a 128-wide row is loaded as two boxes of 64 columns, each
//     128 rows × 128 bytes (16 KB), one after the other in shared memory.
//     The wgmma descriptors use the same swizzle: q and k K-major (8-row
//     groups 1024 bytes apart; a 16-column k-step moves the start by 32
//     bytes inside the 128-byte swizzle row, or to the second box), v
//     MN-major (its two 64-column boxes 16 KB apart, 8-key groups 1024
//     bytes apart; a 16-key k-step moves the start by 2048 bytes).
//   4. K5's pre-scaled q is rounded to bf16 before the product: each
//     consumer scales its own 64 rows of the q tile in place in shared
//     memory (elementwise, so the swizzle does not matter), then a
//     `fence.proxy.async.shared::cta` and a named barrier over its 128
//     threads order those generic-proxy writes before the first wgmma.
//   5. Ragged edges: TMA zero-fills the rows past Tq and Tk (and counts
//     their bytes toward the barrier). Rows past Tq are not stored; keys
//     past Tk get p = 0 (clamp) or −∞ before the max (exact) by bounds,
//     in the last key tile only.
//   6. The overlap of exp2 with the products is the intra-warpgroup one
//     above; the registers of the p operand and of the accumulators are
//     fenced (an empty asm that reads and writes them) after each
//     wgmma.wait_group, so the compiler neither reads nor reuses them
//     while an asynchronous wgmma still owns them.
//   7. Tile size changes the rounding: in K6 each p is rounded against
//     the running max of its 128-key tile (64 in the mma.sync body).
//     chip_smoke.py measures `least_atol_per_std` against the same
//     tolerance rule as before.
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

constexpr int kD = 128;
constexpr int kBlockM = 128;  // query rows per block: two consumers of 64
constexpr int kBlockN = 128;  // keys per tile
constexpr int kStages = 2;    // k and v tiles in flight
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kTileBytes = kBlockN * kD * 2;  // 32 KB: one q, k or v tile
constexpr int kBoxBytes = kTileBytes / 2;      // 16 KB: one 64-column TMA box
constexpr int kBarriers = 1 + 4 * kStages;     // q full; k, v full; k, v empty
// q, the k and v stages, the barriers, and 1024 bytes to align the base
constexpr int kSmemBytes = (1 + 2 * kStages) * kTileBytes + kBarriers * 8 + 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClampLo = -100.f;
constexpr float kClampHi = 80.f;
constexpr float kTwoPowMinus100 = 7.8886090522101181e-31f;  // 2^-100

enum Mode : int { kExact = 0, kClamp = 1 };

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_st, o_sh;  // element strides of o (B, T, H, D); D has stride 1
  int H, Tq, Tk;
  float scale;  // exact: 1/√D; clamp: scale·log2e rounded to bf16
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

// A (128-row, 128-column) bf16 tile at rows `row` of (batch b, head h):
// two 64-column boxes, 16 KB apart.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int h, int row, int b) {
  tma_load(dst, map, bar, 0, h, row, b);
  tma_load(dst + kBoxBytes, map, bar, 64, h, row, b);
}

// --- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (bits 62-63).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
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
// MN-major: the transpose bit): o += p·v.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WGMMA_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x in one special-function instruction. `exp2f` also computes results
// below 2^-126 exactly, which costs extra instructions on every score;
// here none can matter: the clamp's results are at least 2^-100, and the
// exact mode's p ≤ 1 loses only values below 2^-126 (flushed to 0) beside
// a running sum of at least 1.
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

// Clamp: p = exp2(clip(s, −100, 80)) in place, 0 past Tk; Σp into l.
template <bool MASK>
__device__ __forceinline__ void softmax_clamp(float (&s)[64], float (&l)[2], int col0, int Tk) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = col0 + (i >> 2) * 8 + (i & 1);
    float p = ex2(fminf(fmaxf(s[i], kClampLo), kClampHi));
    if (MASK && col >= Tk) p = 0.f;
    s[i] = p;
    l[(i >> 1) & 1] += p;
  }
}

// Exact: −∞ past Tk, the running max m of the raw scores (the scale is
// positive, so it commutes with the max), the rescale factor of the
// earlier tiles (returned in alpha), p = exp2(s·scale·log2e − m·scale·log2e)
// in place with the scale folded into one FFMA, Σp into l after rescaling it.
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

// One key tile's softmax, masked only where the tile passes Tk.
template <int MODE>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float qk_scale, int k0, int col_t,
                                             int Tk) {
  const bool edge = k0 + kBlockN > Tk;
  if constexpr (MODE == kClamp) {
    if (edge) softmax_clamp<true>(s, l, k0 + col_t, Tk);
    else softmax_clamp<false>(s, l, k0 + col_t, Tk);
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

// The shared body of both kernels; the maps are the kernel's
// __grid_constant__ parameters (TMA reads them in parameter space).
template <int MODE>
__device__ __forceinline__ void attn_sm90_body(const CUtensorMap* map_q, const CUtensorMap* map_k,
                                               const CUtensorMap* map_v, const Params& p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;
  auto k_s = [&](int s) { return base + (1 + s) * kTileBytes; };
  auto v_s = [&](int s) { return base + (1 + kStages + s) * kTileBytes; };
  const uint32_t bars = base + (1 + 2 * kStages) * kTileBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBlockM;
  const int n_tiles = (p.Tk + kBlockN - 1) / kBlockN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerThreads);
      mbar_init(v_empty(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kTileBytes);
      tma_tile(q_s, map_q, q_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t free_parity = ((j / kStages) & 1) ^ 1;  // the first round finds it free
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), kTileBytes);
        tma_tile(k_s(s), map_k, k_full(s), h, j * kBlockN, b);
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), kTileBytes);
        tma_tile(v_s(s), map_v, v_full(s), h, j * kBlockN, b);
      }
    }
    return;
  }

  // consumers: warpgroup c owns query rows 64c .. 64c + 63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row_t = 64 * c + 16 * (t / 32) + lane / 4;  // this thread's first row in the tile
  const int col_t = 2 * (lane % 4);                     // its first column in each 8-column block

  mbar_wait(q_full, 0);
  if constexpr (MODE == kClamp) {
    // q × bf16(scale·log2e), rounded to bf16, in place: this warpgroup's
    // 64 rows are bytes [8192c, 8192c + 8192) of each 16 KB box
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int chunk = t + 128 * i;  // 16-byte chunk of 1024
      uint4* ptr = reinterpret_cast<uint4*>(gbase + (chunk / 512) * kBoxBytes + 8192 * c +
                                            (chunk % 512) * 16);
      uint4 x = *ptr;
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
        w[e] = pack_bf16(__low2float(v) * p.scale, __high2float(v) * p.scale);
      }
      *ptr = x;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
  }

  // descriptors: q and k K-major (8-row groups 1024 bytes apart), v
  // MN-major (64-column boxes 16 KB apart, 8-key groups 1024 bytes apart)
  auto q_desc = [&](int kk) {
    return desc_sw128(q_s + (kk / 4) * kBoxBytes + 8192 * c + (kk % 4) * 32, 16, 1024);
  };
  auto k_desc = [&](int s, int kk) {
    return desc_sw128(k_s(s) + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024);
  };
  auto v_desc = [&](int s, int kk) { return desc_sw128(v_s(s) + kk * 2048, kBoxBytes, 1024); };

  const float qk_scale = MODE == kExact ? p.scale * kLog2e : 1.f;
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float s[64];
  uint32_t pf[8][4];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's partial sums, reduced at the end
  float alpha[2] = {1.f, 1.f};

  // tile 0: scores, softmax
  mbar_wait(k_full(0), 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_ss(s, q_desc(kk), k_desc(0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  mbar_arrive(k_empty(0));
  softmax_tile<MODE>(s, m, l, alpha, qk_scale, 0, col_t, p.Tk);
  pack_p(s, pf);

  for (int j = 1; j < n_tiles; ++j) {
    const int sj = j % kStages, sp = (j - 1) % kStages;
    // tile j's scores and tile j − 1's p·v, issued together
    mbar_wait(k_full(sj), (j / kStages) & 1);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_ss(s, q_desc(kk), k_desc(sj, kk), kk > 0);
    wgmma_commit();
    mbar_wait(v_full(sp), ((j - 1) / kStages) & 1);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_rs(o, pf[kk], v_desc(sp, kk));
    wgmma_commit();
    // the scores first; their softmax runs under the p·v products
    wgmma_wait<1>();
    fence_regs(s);
    mbar_arrive(k_empty(sj));
    softmax_tile<MODE>(s, m, l, alpha, qk_scale, j * kBlockN, col_t, p.Tk);
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) fence_regs(pf[kk]);
    mbar_arrive(v_empty(sp));
    if constexpr (MODE == kExact) {
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
    pack_p(s, pf);
  }
  // the last tile's p·v
  {
    const int sl = (n_tiles - 1) % kStages;
    mbar_wait(v_full(sl), ((n_tiles - 1) / kStages) & 1);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_rs(o, pf[kk], v_desc(sl, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) fence_regs(pf[kk]);
    mbar_arrive(v_empty(sl));
  }

  // epilogue: the row sums over the quad, one divide, one cast
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    // the reference's pad keys up to a multiple of 128, 2^-100 each
    if constexpr (MODE == kClamp) l[r] += (float)(n_tiles * kBlockN - p.Tk) * kTwoPowMinus100;
  }
  __nv_bfloat16* const ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_t + 8 * r;
    if (row < p.Tq) {
      __nv_bfloat16* orow = ob + (long long)row * p.o_st + col_t;
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
        *reinterpret_cast<uint32_t*>(orow + 8 * jb) =
            pack_bf16(o[4 * jb + 2 * r] / l[r], o[4 * jb + 2 * r + 1] / l[r]);
    }
  }
}

// Two kernel names, so that a profile tells K6 and K5 apart.
__global__ void __launch_bounds__(kThreads, 1)
    attn_flash_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv, const Params p) {
  attn_sm90_body<kExact>(&mq, &mk, &mv, p);
}
__global__ void __launch_bounds__(kThreads, 1)
    attn_rowblock_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                              const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv, const Params p) {
  attn_sm90_body<kClamp>(&mq, &mk, &mv, p);
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

// q, k, v: bf16 (B, T, H, 128); `maps` holds 11 values for each of q, k, v
// in turn: the dims {D, H, T, B}, the byte strides of H, T and B, and the
// box {64, 1, 128, 1}, as ops/attention.py's `tma_operand` computes them.
// o: bf16 (B, Tq, H, 128) with element strides o_strides (b, t, h). mode 0:
// the exact softmax (K6, scale = 1/√D); 1: the clamp softmax (K5, scale =
// scale·log2e rounded to bf16). Returns 0, a cudaError_t of the launch, or
// 100000 + the CUresult of a refused tensor map.
extern "C" int ecad_attention_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                       const unsigned long long* maps,
                                       const long long* o_strides, int B, int H, int Tq, int Tk,
                                       float scale, int mode, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || (long long)B * H > 65535 || mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tmaps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const unsigned long long* a = maps + 11 * i;
    if (a[0] != kD || a[7] != 64 || a[8] != 1 || a[9] != kBlockN || a[10] != 1)
      return (int)cudaErrorInvalidValue;
    const cuuint64_t dims[4] = {a[0], a[1], a[2], a[3]};
    const cuuint64_t strides[3] = {a[4], a[5], a[6]};
    const cuuint32_t box[4] = {(cuuint32_t)a[7], (cuuint32_t)a[8], (cuuint32_t)a[9],
                               (cuuint32_t)a[10]};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult r =
        encode(&tmaps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptrs[i]), dims,
               strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return 100000 + (int)r;
  }
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_strides[0], p.o_st = o_strides[1], p.o_sh = o_strides[2];
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.scale = scale;
  void (*const kernels[2])(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                           const Params) = {attn_flash_sm90_kernel, attn_rowblock_sm90_kernel};
  static bool opted_in[2] = {};
  if (!opted_in[mode]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernels[mode], cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[mode] = true;
  }
  const dim3 grid((Tq + kBlockM - 1) / kBlockM, B * H);
  kernels[mode]<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tmaps[0], tmaps[1], tmaps[2], p);
  return (int)cudaGetLastError();
}
