// Fused attention forward for Hopper (sm_90a), in two softmax variants
// that share one tensor-core body, under four kernel names (and one of
// the harness's variants of the same body, at the end of this note):
//
//   * exact (max-subtract): softmax(q·kᵀ/√d + bias)·v. Replaces the Pallas
//     kernels `_attn_kernel` (ecad_tpu/ops/attention.py:58, no bias) and
//     `_attn_kernel_bias` (:75, fp32 additive bias) that `fused_attention`
//     (:677) launches for every (batch·head) tile. Kernel `attn_bf16_kernel`.
//     The same body, under the name `attn_flash_bf16_kernel` (K6), replaces
//     the streaming kernel `_flash_kernel` (:151-197), which
//     `_flash_attention` (:573-673) launches past 8192×128 key elements —
//     PixArt-2048's 16384-token self-attention: s = q·kᵀ in fp32 from
//     operands in their own dtype, times 1/√D on the fp32 scores (q is not
//     pre-scaled), plus the fp32 key-padding bias, an online softmax with
//     running max and sum in fp32, p cast to v's dtype for p·v, one divide.
//     Here the scores move to the log2 domain (×log2e) and exp is exp2:
//     exp(x − m) to fp32 rounding. Keys past Tk are excluded by bounds. The
//     Pallas wrappers pad them instead with n_pad keys of score −1e9 whose
//     rows of v are 0: round_up(Tk, 128) − Tk on the single-tile route
//     (:755-772), round_up(Tk, bk) − Tk with bk = min(1536, round_up(Tk,
//     128)) on the streaming one (:602-619). They weigh exactly 0 unless
//     every real score of a row is near −1e9 or below it (a caller bias of
//     −1e9 or less); then the reference's output is Σv/Tk_pad, or 0 below
//     −1e9. So the exact epilogue adds them: m' = max(m, −1e9), the sums
//     rescaled by exp(m − m'), n_pad·exp(−1e9 − m') added to Σp, in the
//     bf16 body and the fp32 path alike. The wrapper passes n_pad, the
//     route's: a dense bias past the single tile takes the reference's XLA
//     call (:701-707), which adds no pad keys, so n_pad is 0 there.
//   * clamp (no row max): the function of `_transposed_kernel` (:285) and
//     `_transposed_kernel_nobias` (:344), launched by `_transposed_attention`
//     (:348-455) for lane-padded head dims (PixArt's D=72) at or above a
//     1 MiB fp32 score tile (kernel `attn_clamp_bf16_kernel`, K4), and of
//     `_rowblock_kernel` (:255) and `_rowblock_kernel_nobias` (:274),
//     launched by `_rowblock_attention` (:458-570) for head dims that are a
//     multiple of 128 past an 8 MiB score tile — FLUX-1024's joint attention
//     (kernel `attn_rowblock_bf16_kernel`, K5). Both compute the same
//     function: q pre-scaled by bf16(scale·log2e) and rounded to the input
//     dtype (:378-383, :491-492), s = q·kᵀ in fp32, plus the key-padding
//     bias times log2e, p = exp2(clip(s, −100, 80)), Σp in fp32, p cast to
//     v's dtype for p·v, one divide; the TPU kernels differ only in layout
//     (transposed, or standard with two kv chunks for MXU/VPU dual issue,
//     which changes only the order of the fp32 sums). Two names, so that a
//     profile and the launch counters tell the two routes apart. With the
//     clamp there is no running max and no rescale of the accumulator: p ≤
//     2^80, so the fp32 sums cannot overflow, and p ≥ 2^-100, so the sum is
//     never 0. Keys past Tk get weight 0 here (bounds); the Pallas kernels
//     pad them to Tk_pad = round_up(Tk, 128) and give each of the n_pad =
//     Tk_pad − Tk pad keys 2^-100 through a −1e9 bias (their pad rows of v
//     are 0, so only Σp grows). So the epilogue adds n_pad·2^-100 to Σp: in
//     a row whose every logit is clamped at −100 (an all-masked text row)
//     the weights are then 1/Tk_pad, as the reference's. The bf16 calls
//     at D=72 and 128 run on the Hopper body of attention_sm90.cu instead —
//     K1, K4 and K6 (and K5 at 128), each also with a key-padding bias (K2
//     for K1). Here remain dense biases, fp32, the other head dims, and the
//     harness's X1.
//
// What bounds it on the H100. Exact path, at PixArt-256's shapes
// (self-attention 256×256 and cross-attention 256→120, D=72, bf16): a
// (batch·head) does 4·Tq·Tk·D flops on (2·Tq + 2·Tk)·D·2 bytes of q, k, v
// and o, 80 to 130 flops per byte, below the ~295 flops per byte where the
// bf16 tensor cores become the limit: bytes bound it. Clamp path, at
// PixArt-1024's self-attention (2B=4, 16 heads, 4096×4096, D=72) it is
// 4·B·H·Tq·Tk·D = 3.09e11 flops on 151 MB, 2048 flops per byte: the
// tensor cores bound it (0.313 ms at 989 TFLOP/s); its cross-attention
// (4096 → 120 keys) moves ≈78 MB for 9e9 flops and is bound by bytes
// (0.023 ms at 3.35 TB/s). Row-block path, at FLUX-1024's joint attention
// (B=1, 24 heads, 4608×4608, D=128): 2.61e11 flops on 113 MB, the tensor
// cores bound it (0.264 ms). Streaming path (K6), at PixArt-2048's
// self-attention (2B=2, 16 heads, 16384×16384, D=72): 2.47e12 flops on
// 302 MB, the tensor cores bound it (2.50 ms); at FLUX.1-dev-1536²'s joint
// attention (1, 9728, 24, 128): 1.16e12 flops on 239 MB (1.18 ms). Both
// keep every score in registers: a key tile of 64 at a time, 256 tiles per
// query tile at 16384 keys. At D=128 a thread holds its q fragments (32
// registers), its share of the 16×128 fp32 accumulator (64) and of a 16×64
// score tile (32): ptxas gives 165 registers (168 with the bias) and no
// spills; a block takes 69.6 KB of shared memory (opt-in above 48 KB), so
// registers and shared memory each allow three blocks per SM. The design
// therefore reads each operand once per query tile, keeps scores and
// probabilities in registers (never in device memory), and accumulates in
// fp32:
//
//   * one block owns one (batch·head, 64-row query tile); four warps own
//     16 query rows each;
//   * it walks the keys in tiles of 64 — exact: with an online softmax
//     (running max and sum in fp32, exp2 in the log2 domain); clamp: with
//     a plain running sum, since the clamp needs no max — so any Tk works
//     and the ragged key edge is handled by bounds, not by a padding bias;
//   * k/v tiles stream into two shared-memory stages with cp.async, the
//     next tile's copy overlapping this tile's math;
//   * bf16 products run on the tensor cores through `mma.sync` m16n8k16
//     with fp32 accumulation, operands fetched with `ldmatrix` (v through
//     its transposing form, so v stays row-major in shared memory); D is
//     zero-filled to a multiple of 16 in shared memory (72 → 80) for the
//     q·kᵀ reduction, and the p·v product runs ceil(D/8) output tiles (9
//     at D=72), so no padded column is computed or written;
//   * the bias is a pointer plus four strides (batch, head, query, key),
//     stride 0 on a broadcast dimension: one path serves key-padding
//     (B,1,1,Tk), batch-broadcast (1,1,1,Tk) and dense (B,H,Tq,Tk) biases
//     without materialising the broadcast;
//   * fp32 inputs take a plain SIMT path (one warp per query row, fp32
//     FMAs), in both variants, so that fp32 results stay exact to fp32
//     rounding.
//
// q, k, v and o are read and written in the (B, T, H, D) layout through
// their strides; only the head dimension must be contiguous (16-byte
// aligned rows take the cp.async path, others element-wise loads).
//
// The attention-variant harness (X1–X4). `scripts/exp_attn_variants.py`
// times the TPU's attention body with parts of its work taken out, through
// eight Pallas bodies launched by `_call` (:77), `_call_transposed` (:261)
// and `_call_transposed_v2` (:442). The same body here, with the softmax
// mode a template argument, computes one of their functions (bf16, no
// bias); the others run on attention_sm90.cu:
//   * `attn_xmatmul_bf16_kernel` (X1) replaces `k_matmul_only` (:103):
//     o = bf16(q·kᵀ)·v with unscaled scores, no exp, no sum, no divide.
// `k_transposed` (:190) and `k_transposed_subk` (:317) compute K4's
// no-bias function and run on the Hopper body, as do `k_nomax` (:115, X2),
// `k_rowblock` (:129) / `k_chunk2` (:144, X3) and `k_transposed_fd` (:288)
// / `k_transposed_subk_fd` (:349, X4): attention_sm90.cu's
// `attn_xnomax_sm90_kernel`, `attn_xmax_sm90_kernel` and
// `attn_xfd_sm90_kernel`. X1 is built at DP = 80 and 128 (D = 72 and 128,
// the harness's head dims). At the harness's shapes, counting 4·B·H·T²·D
// flops on the q, k, v, o bytes, the tensor cores bound it: (2, 4608, 24,
// 128) 5.22e11 flops on 226 MB, 0.528 ms; (8, 4096, 16, 72) 6.19e11 on 302
// MB, 0.625 ms; (64, 1024, 16, 72) 3.09e11 on 604 MB, 0.313 ms (its bytes
// alone take 0.180 ms). Its design is the shared body's; what it leaves
// out is the measurement.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // query rows per block (bf16 path)
constexpr int kBlockK = 64;           // keys per shared-memory tile (bf16 path)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClampLo = -100.f;  // clamp variant: log2-domain window of s
constexpr float kClampHi = 80.f;
constexpr float kTwoPowMinus100 = 7.8886090522101181e-31f;  // a clamped pad key's weight
constexpr float kPadScore = -1e9f;  // a pad key's score on the exact routes

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const float* bias;
  // element strides of the (B, T, H, D) operands; D has stride 1
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  // bias strides over (B, H, Tq, Tk); 0 on a broadcast dimension
  long long b_sb, b_sh, b_sq, b_sk;
  int H, Tq, Tk, D;
  // the reference's pad keys on this route (the wrapper's count): 2^-100
  // each in Σp on the clamp routes, score −1e9 on the exact ones
  int n_pad;
  float scale;  // exact: 1/√D; clamp: scale·log2e, rounded to q's dtype
  int vec_ok;  // every row start is 16-byte aligned and D % 8 == 0
};

__device__ __forceinline__ float bias_at(const Params& p, int b, int h, int row, int col) {
  return p.bias[b * p.b_sb + h * p.b_sh + (long long)row * p.b_sq + (long long)col * p.b_sk];
}

// ---------------------------------------------------------------------------
// bf16: tensor-core path
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8×8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two 8×8 matrices (lanes 0-15 give the row addresses), as stored or transposed.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r0), "=r"(r1)
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r0), "=r"(r1)
                 : "r"(smem_addr(p)));
}

// 16-byte global → shared copy that does not stall the thread; zero-fills
// the destination when `pred` is false (nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Eight consecutive elements of one row (columns col..col+7), zero where
// the column is at or past D or the row is out of range.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* row_ptr, bool row_ok, int col, int D) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (!row_ok || col >= D) return out;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (col + i < D) e[i] = row_ptr[col + i];
  return out;
}

// Rows [r0, r0 + 64) of a (T, D) slice into smem[row][DP] (row stride
// `stride` elements), zero-filled past T and past D. With `vec_ok` the
// copies are asynchronous 16-byte cp.async (the caller commits and waits);
// otherwise they are element-wise loads and stores.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, int stride, const __nv_bfloat16* base,
                                          long long row_stride, int r0, int T, int D, bool vec_ok) {
  constexpr int kChunks = DP / 8;
  for (int c = threadIdx.x; c < kBlockK * kChunks; c += kThreads) {
    const int row = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int t = r0 + row;
    __nv_bfloat16* dst = smem + row * stride + col;
    const bool ok = t < T && col < D;
    if (vec_ok) {
      cp_async16(dst, ok ? base + (long long)t * row_stride + col : base, ok);
    } else {
      *reinterpret_cast<uint4*>(dst) = load8(base + (long long)t * row_stride, t < T, col, D);
    }
  }
}

template <int DP>
constexpr int bf16_smem_bytes() {
  // two stages of (k, v) tiles, 64 rows of DP + 8 columns each
  return 2 * 2 * kBlockK * (DP + 8) * 2;
}

// q fragment × a bf16-exact factor, rounded back to bf16 (round to nearest
// even): the clamp variant's pre-scaled q, as the Pallas wrapper multiplies
// q by the scale in q's dtype.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float f) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  return pack_bf16(__low2float(v) * f, __high2float(v) * f);
}

// Softmax modes of the shared bf16 body.
enum Mode : int {
  kExact = 0,  // K1, K6: ×scale on the fp32 score, online max
  kClamp = 1,  // K4, K5: q pre-scaled, exp2(clip(s, −100, 80))
  kNone = 2,   // X1: p = s unscaled; no sum, no divide
};

template <int DP, bool HAS_BIAS, int MODE>
__device__ __forceinline__ void attn_bf16_body(const Params& p) {
  constexpr bool kScaledQ = MODE == kClamp;
  constexpr int kSteps = DP / 16;       // k-steps of the q·kᵀ reduction over D
  constexpr int kSTiles = kBlockK / 8;  // 8-key score tiles per key tile
  constexpr int kOTiles = DP / 8;       // 8-column output tiles (ceil(D/8) used)
  constexpr int kStride = DP + 8;       // smem row stride: conflict-free ldmatrix rows
  constexpr int kTile = kBlockK * kStride;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* const smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // stage s: k at smem + (2s) * kTile, v at smem + (2s + 1) * kTile
  auto k_tile = [&](int s) { return smem + (2 * s) * kTile; };
  auto v_tile = [&](int s) { return smem + (2 * s + 1) * kTile; };

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int tg = lane & 3;  // thread in group
  const bool vec_ok = p.vec_ok != 0;
  const int n_tiles = (p.Tk + kBlockK - 1) / kBlockK;

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;

  // q tile → stage-1 k buffer (free until the first prefetch) → registers,
  // while the first k/v tile streams into stage 0
  load_tile<DP>(k_tile(1), kStride, qb, p.q_st, q0, p.Tq, p.D, vec_ok);
  cp_async_commit();
  load_tile<DP>(k_tile(0), kStride, kb, p.k_st, 0, p.Tk, p.D, vec_ok);
  load_tile<DP>(v_tile(0), kStride, vb, p.v_st, 0, p.Tk, p.D, vec_ok);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kSteps][4];
  {
    // matrix m = lane / 8: rows +8 for odd m, columns +8 for m >= 2
    const int r = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
    const int c = (lane >> 4) * 8;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      ldmatrix_x4(qf[s], k_tile(1) + r * kStride + s * 16 + c);
      if constexpr (kScaledQ) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[s][i] = scale_bf16x2(qf[s][i], p.scale);
      }
    }
  }
  __syncthreads();

  const int o_tiles = (p.D + 7) / 8;
  // this thread's two query rows: g and g + 8 of the warp's 16
  const int row_a = q0 + warp * 16 + g;
  const int rows[2] = {row_a, row_a + 8};
  // scores in the log2 domain (a pre-scaled q carries the scale)
  const float qk_scale = kScaledQ ? 1.f : p.scale * kLog2e;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end
  float acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // ldmatrix row offsets of this lane: k (x2: lanes 0-15 give rows) and vᵀ
  const int kr_row = lane & 7, kr_col = ((lane >> 3) & 1) * 8;
  const int vr_row = ((lane >> 3) & 1) * 8 + (lane & 7);

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    const int k0 = t * kBlockK;
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_tile<DP>(k_tile(stage ^ 1), kStride, kb, p.k_st, k0 + kBlockK, p.Tk, p.D, vec_ok);
      load_tile<DP>(v_tile(stage ^ 1), kStride, vb, p.v_st, k0 + kBlockK, p.Tk, p.D, vec_ok);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = k_tile(stage);
    const __nv_bfloat16* vs = v_tile(stage);

    // scores: (16 rows) × (64 keys) per warp
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = ks + (j * 8 + kr_row) * kStride + kr_col;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        uint32_t b0, b1;
        ldmatrix_x2<false>(b0, b1, kr + st * 16);
        mma_bf16_16816(s[j], qf[st], b0, b1);
      }
    }

    if constexpr (MODE == kClamp) {
      // p = exp2(clip(s + bias·log2e, −100, 80)); keys past Tk weigh 0
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + tg * 2 + (e & 1);
          const int r = e >> 1;
          float pe = 0.f;
          if (col < p.Tk) {
            float x = s[j][e];
            if (HAS_BIAS) x += bias_at(p, b, h, min(rows[r], p.Tq - 1), col) * kLog2e;
            pe = exp2f(fminf(fmaxf(x, kClampLo), kClampHi));
          }
          s[j][e] = pe;
          l_run[r] += pe;
        }
      }
    } else if constexpr (MODE == kNone) {
      // X1: p = s. Keys past Tk weigh 0
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + tg * 2 + (e & 1);
          if (col >= p.Tk) s[j][e] = 0.f;
        }
      }
    } else {
      // scale, bias, ragged key edge (log2 domain); running max
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + tg * 2 + (e & 1);
          const int r = e >> 1;
          float x = s[j][e] * qk_scale;
          if (col >= p.Tk) {
            x = -INFINITY;
          } else if (HAS_BIAS) {
            x += bias_at(p, b, h, min(rows[r], p.Tq - 1), col) * kLog2e;
          }
          s[j][e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[r] = exp2f(m_run[r] - mx[r]);  // exp2(-inf) = 0 on the first tile
        m_run[r] = mx[r];
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float pe = exp2f(s[j][e] - m_run[r]);
          s[j][e] = pe;
          l_run[r] += pe;
        }
      }
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }

    // acc += p · v: the score accumulators are the a-fragments of p; the
    // b-fragments come from the row-major v tile through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const __nv_bfloat16* vr = vs + (kk * 16 + vr_row) * kStride;
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        if (n < o_tiles) {
          uint32_t b0, b1;
          ldmatrix_x2<true>(b0, b1, vr + n * 8);
          mma_bf16_16816(acc[n], a, b0, b1);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the prefetch two tiles on
  }

  float f[2] = {1.f, 1.f};  // the exact mode's rescale for its pad keys
  if constexpr (MODE != kNone) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      if constexpr (MODE == kClamp) {
        l_run[r] += (float)p.n_pad * kTwoPowMinus100;
      } else if (MODE == kExact && p.n_pad > 0) {
        // n_pad keys of score −1e9 (log2 domain): f = 1 and the added term
        // 0 unless every score of the row is near −1e9 or below it
        const float mp = fmaxf(m_run[r], kPadScore * kLog2e);
        f[r] = exp2f(m_run[r] - mp);
        l_run[r] = l_run[r] * f[r] + (float)p.n_pad * exp2f(kPadScore * kLog2e - mp);
      }
    }
  }
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int col = n * 8 + tg * 2 + (e & 1);
      if (rows[r] < p.Tq && col < p.D)
        ob[(long long)rows[r] * p.o_st + col] =
            __float2bfloat16(MODE == kNone ? acc[n][e] : acc[n][e] * f[r] / l_run[r]);
    }
  }
}

// Four kernel names, so that a profile tells the exact softmax, the
// transposed-route clamp softmax (K4), the row-block-route one (K5) and the
// exact softmax of the streaming route (K6) apart.
template <int DP, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads) attn_bf16_kernel(const Params p) {
  attn_bf16_body<DP, HAS_BIAS, kExact>(p);
}
template <int DP, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads) attn_clamp_bf16_kernel(const Params p) {
  attn_bf16_body<DP, HAS_BIAS, kClamp>(p);
}
template <int DP, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads) attn_rowblock_bf16_kernel(const Params p) {
  attn_bf16_body<DP, HAS_BIAS, kClamp>(p);
}
template <int DP, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads) attn_flash_bf16_kernel(const Params p) {
  attn_bf16_body<DP, HAS_BIAS, kExact>(p);
}

// The harness's variant X1, without a bias, under its own name.
template <int DP>
__global__ void __launch_bounds__(kThreads) attn_xmatmul_bf16_kernel(const Params p) {
  attn_bf16_body<DP, false, kNone>(p);
}

// ---------------------------------------------------------------------------
// fp32: SIMT path (exact to fp32 rounding)
// ---------------------------------------------------------------------------

constexpr int kRowsF = 16;  // query rows per block, four per warp
constexpr int kKeysF = 32;  // keys per tile: one per lane
constexpr int kMaxD = 128;

template <bool HAS_BIAS, bool CLAMP>
__global__ void __launch_bounds__(kThreads) attn_f32_kernel(const Params p) {
  __shared__ float q_s[kRowsF][kMaxD];
  __shared__ float k_s[kKeysF][kMaxD + 1];  // +1: lane j reads row j without conflicts
  __shared__ float v_s[kKeysF][kMaxD];

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kRowsF;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int D = p.D;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  // q is pre-scaled, as _attn_kernel (by 1/√D) and _transposed_kernel (by
  // scale·log2e) do
  for (int i = threadIdx.x; i < kRowsF * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int t = q0 + r;
    q_s[r][c] = t < p.Tq ? qb[(long long)t * p.q_st + c] * p.scale : 0.f;
  }

  float m_run[4], l_run[4], acc[4][4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    m_run[rr] = -INFINITY;
    l_run[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[rr][i] = 0.f;
  }

  for (int k0 = 0; k0 < p.Tk; k0 += kKeysF) {
    __syncthreads();  // previous tile fully consumed (and q_s written)
    for (int i = threadIdx.x; i < kKeysF * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int t = k0 + r;
      const bool ok = t < p.Tk;
      k_s[r][c] = ok ? kb[(long long)t * p.k_st + c] : 0.f;
      v_s[r][c] = ok ? vb[(long long)t * p.v_st + c] : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int r = warp * 4 + rr;
      const int row = q0 + r;
      float sc = 0.f;
      for (int d = 0; d < D; ++d) sc = fmaf(q_s[r][d], k_s[lane][d], sc);
      float pj;
      if constexpr (CLAMP) {
        pj = 0.f;  // keys past Tk weigh 0
        if (key < p.Tk) {
          if (HAS_BIAS) sc += bias_at(p, b, h, min(row, p.Tq - 1), key) * kLog2e;
          pj = exp2f(fminf(fmaxf(sc, kClampLo), kClampHi));
        }
        float ps = pj;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
        l_run[rr] += ps;
      } else {
        if (key >= p.Tk) {
          sc = -INFINITY;
        } else if (HAS_BIAS) {
          sc += bias_at(p, b, h, min(row, p.Tq - 1), key);
        }
        float mx = sc;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[rr], mx);
        const float alpha = expf(m_run[rr] - m_new);
        pj = expf(sc - m_new);
        float ps = pj;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
        l_run[rr] = l_run[rr] * alpha + ps;
        m_run[rr] = m_new;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[rr][i] *= alpha;
      }
      for (int j = 0; j < kKeysF; ++j) {
        const float pjj = __shfl_sync(0xffffffffu, pj, j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[rr][i] = fmaf(pjj, v_s[j][d], acc[rr][i]);
        }
      }
    }
  }

  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int row = q0 + warp * 4 + rr;
    if (row >= p.Tq) continue;
    float f = 1.f;  // the exact path's rescale for its pad keys (natural domain)
    if constexpr (CLAMP) {
      l_run[rr] += (float)p.n_pad * kTwoPowMinus100;
    } else if (p.n_pad > 0) {
      const float mp = fmaxf(m_run[rr], kPadScore);
      f = expf(m_run[rr] - mp);
      l_run[rr] = l_run[rr] * f + (float)p.n_pad * expf(kPadScore - mp);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = lane + 32 * i;
      if (d < D) ob[(long long)row * p.o_st + d] = acc[rr][i] * f / l_run[rr];
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const Params& p, dim3 grid, bool has_bias, int variant,
                        cudaStream_t stream) {
  constexpr int kSmem = bf16_smem_bytes<DP>();
  void (*const kernels[4][2])(const Params) = {
      {attn_bf16_kernel<DP, false>, attn_bf16_kernel<DP, true>},
      {attn_clamp_bf16_kernel<DP, false>, attn_clamp_bf16_kernel<DP, true>},
      {attn_rowblock_bf16_kernel<DP, false>, attn_rowblock_bf16_kernel<DP, true>},
      {attn_flash_bf16_kernel<DP, false>, attn_flash_bf16_kernel<DP, true>},
  };
  auto kernel = kernels[variant][has_bias];
  // above 48 KB dynamic shared memory needs an opt-in (once per kernel)
  static bool opted_in[4][2] = {};
  if (kSmem > 48 * 1024 && !opted_in[variant][has_bias]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    opted_in[variant][has_bias] = true;
  }
  kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return cudaSuccess;
}

// The harness's variant 4 (X1), bf16 without a bias, at DP = 80 and 128.
template <int DP>
cudaError_t launch_x(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr int kSmem = bf16_smem_bytes<DP>();
  void (*const kernel)(const Params) = attn_xmatmul_bf16_kernel<DP>;
  static bool opted_in = false;
  if (kSmem > 48 * 1024 && !opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. strides: 16 int64 — q, k, v, o as
// (b, t, h) each, then the bias as (b, h, q, k). bias may be null.
// variant: 0 = exact softmax; 1 = clamp softmax on the transposed route
// (K4), 2 = the same on the row-block route (K5); 3 = the exact softmax on
// the streaming route (K6). fp32 inputs take the SIMT kernel in the exact
// (0, 3) or the clamp (1, 2) variant. The harness's variant, bf16 only and
// without a bias: 4 = matmul only (X1, no scale); X2-X4 run on
// attention_sm90.cu. n_pad: the reference's pad keys on the route (see the
// note; X1 ignores it). scale = 1/√D, which the exact variants multiply
// into the fp32 scores; q_scale = scale·log2e rounded to q's dtype, which
// the others multiply into q. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int ecad_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                                  const float* bias, const long long* strides, int B, int H, int Tq,
                                  int Tk, int D, float scale, float q_scale, int vec_ok,
                                  int variant, int n_pad, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || D > kMaxD || (long long)B * H > 65535 ||
      variant < 0 || variant > 4 || n_pad < 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.bias = bias;
  p.q_sb = strides[0], p.q_st = strides[1], p.q_sh = strides[2];
  p.k_sb = strides[3], p.k_st = strides[4], p.k_sh = strides[5];
  p.v_sb = strides[6], p.v_st = strides[7], p.v_sh = strides[8];
  p.o_sb = strides[9], p.o_st = strides[10], p.o_sh = strides[11];
  p.b_sb = strides[12], p.b_sh = strides[13], p.b_sq = strides[14], p.b_sk = strides[15];
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.n_pad = n_pad;
  p.scale = variant == 0 || variant == 3 ? scale : q_scale;
  p.vec_ok = vec_ok;
  const bool has_bias = bias != nullptr;
  const bool cl = variant == 1 || variant == 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (variant == 4) {
    if (dtype != 0 || has_bias) return (int)cudaErrorInvalidValue;
    const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, B * H);
    const int dp = (D + 15) / 16 * 16;
    cudaError_t err;
    if (dp == 80) err = launch_x<80>(p, grid, st);
    else if (dp == 128) err = launch_x<128>(p, grid, st);
    else err = cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
  } else if (dtype == 0) {
    const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, B * H);
    cudaError_t err;
    switch ((D + 15) / 16) {
      case 1: err = launch_bf16<16>(p, grid, has_bias, variant, st); break;
      case 2: err = launch_bf16<32>(p, grid, has_bias, variant, st); break;
      case 3: err = launch_bf16<48>(p, grid, has_bias, variant, st); break;
      case 4: err = launch_bf16<64>(p, grid, has_bias, variant, st); break;
      case 5: err = launch_bf16<80>(p, grid, has_bias, variant, st); break;
      case 6: err = launch_bf16<96>(p, grid, has_bias, variant, st); break;
      case 7: err = launch_bf16<112>(p, grid, has_bias, variant, st); break;
      default: err = launch_bf16<128>(p, grid, has_bias, variant, st); break;
    }
    if (err != cudaSuccess) return (int)err;
  } else if (dtype == 1) {
    const dim3 grid((Tq + kRowsF - 1) / kRowsF, B * H);
    void (*const kernels[2][2])(const Params) = {
        {attn_f32_kernel<false, false>, attn_f32_kernel<true, false>},
        {attn_f32_kernel<false, true>, attn_f32_kernel<true, true>},
    };
    const auto kernel = kernels[cl][has_bias];
    kernel<<<grid, kThreads, 0, st>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
