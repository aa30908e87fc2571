// Modulated LayerNorm, LN(x)·(1+scale)+shift, for Hopper (sm_90a).
//
// `modlnorm_sm90_kernel<T, VB, NV, G>` (K3) replaces the Pallas kernel
// `_modlnorm_kernel` (ecad_tpu/ops/fused.py:20, launched at :46): per row of
// x (B, T, d), an affine-free LayerNorm with fp32 mean and variance (two
// passes: the mean, then Σ(x − mean)²) and eps, then ·(1 + scale) + shift
// with a per-sample (B, 1, d) scale and shift, in fp32, and one cast to x's
// dtype T (bf16 or fp32). The port calls it at PixArt's two modulated norms
// a block and its final norm, and at FLUX's dual-block, single-block and
// final norms.
//
// What bounds it on the H100: one read of x and one write of the output
// (the modulation is a d-vector a sample), a few operations a byte, so
// device-memory bytes. The design keeps as many bytes in flight as the
// card needs and does nothing else on the way:
//   * G warps a row (1 for d = 1152 in bf16, 2 for 3072; more when a launch
//     has too few rows to give the card warps enough): the row sits in
//     registers as packed vectors of VB bytes (16 wherever the widths and
//     addresses allow: 1152 bf16 is 144 vectors, lanes 0-15 take five and
//     the others four; 3072 on two warps is six a lane), NV vectors a lane
//     at most, beside its sample's scale and shift, all loaded before the
//     reductions. Both reductions are __shfl_xor_sync butterflies, with one
//     word a warp through shared memory and the row's own named barrier
//     when G > 1; each pass converts the packed row to fp32 again, so no
//     fp32 copy lives;
//   * blocks of eight warps in a persistent grid: as many blocks as the SMs
//     hold at the kernel's occupancy, each row group striding over the rows;
//   * a segment table of one or two (x, scale, shift, out) segments that
//     share d and the dtype: rows are numbered across the segments, so
//     FLUX's image and text norms of one site go out as one launch.
// x is read with evict-first loads (the norm reads it once; the block's
// residual add reads it again only after its large products), the output
// stored plainly (the next product reads it at once). A d or an address
// that 16-byte vectors do not tile takes 8-byte vectors or single elements
// (VB), in the same kernel. The launch plan (VB, NV, G, the segments' first
// rows) comes from the Python wrapper (`ops/fused.py` `launch_plan`), which
// the CPU tests walk; this entry refuses a plan that does not fit its
// arguments. Why these choices and not a register double buffer of the
// next row: `scripts/probe_modlnorm.py` and `PERF.md`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSegments = 2;

struct Segment {
  const void* x;
  const void* scale;
  const void* shift;
  void* out;                      // contiguous (B, T, d)
  long long x_sb, x_st;           // x's element strides (sample, token); d is contiguous
  long long scale_sb, shift_sb;   // the modulation's sample strides
  int T;                          // tokens a sample
  int row0;                       // the segment's first row in the launch's numbering
};

struct Params {
  Segment seg[kMaxSegments];
  int n_seg;
  int n_rows;  // rows of all segments
  int d;
  int n_vec;   // vectors a row: d · sizeof(T) / VB
  float eps;
};

template <int BYTES> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The vectors of one row: its x, its sample's scale and shift, its output.
template <typename Raw>
struct RowPtrs {
  const Raw* x;
  const Raw* scale;
  const Raw* shift;
  Raw* out;
};

template <typename T, typename Raw>
__device__ __forceinline__ RowPtrs<Raw> row_ptrs(const Params& p, int row) {
  const bool second = p.n_seg > 1 && row >= p.seg[1].row0;
  const Segment& s0 = p.seg[0];
  const Segment& s1 = p.seg[1];
  const int r = row - (second ? s1.row0 : s0.row0);
  const int T_ = second ? s1.T : s0.T;
  const int b = r / T_;
  const int t = r - b * T_;
  const long long x_off = b * (second ? s1.x_sb : s0.x_sb) + t * (second ? s1.x_st : s0.x_st);
  RowPtrs<Raw> ptrs;
  ptrs.x = reinterpret_cast<const Raw*>(static_cast<const T*>(second ? s1.x : s0.x) + x_off);
  ptrs.scale = reinterpret_cast<const Raw*>(static_cast<const T*>(second ? s1.scale : s0.scale) +
                                            b * (second ? s1.scale_sb : s0.scale_sb));
  ptrs.shift = reinterpret_cast<const Raw*>(static_cast<const T*>(second ? s1.shift : s0.shift) +
                                            b * (second ? s1.shift_sb : s0.shift_sb));
  ptrs.out = reinterpret_cast<Raw*>(static_cast<T*>(second ? s1.out : s0.out) +
                                    (long long)r * p.d);
  return ptrs;
}

// The sum over a row's G warps of each thread's `v`, in every thread of
// them: a __shfl_xor_sync butterfly in each warp, then (G > 1) the warps'
// sums through `partial`, in warp order, behind the group's own named
// barrier (0 is __syncthreads).
template <int G>
__device__ __forceinline__ float row_sum(float v, float* partial, int group, int warp) {
  v = warp_sum(v);
  if constexpr (G > 1) {
    if ((threadIdx.x & 31) == 0) partial[warp] = v;
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(32 * G) : "memory");
    v = 0.f;
#pragma unroll
    for (int w = 0; w < G; ++w) v += partial[group * G + w];
  }
  return v;
}

// G warps a row (kWarps / G rows a block at a time); lane l of a row's
// 32·G holds its vectors l, l + 32·G, ... (NV at most), with the matching
// vectors of its sample's scale and shift, all loaded before the
// reductions.
template <typename T, int VB, int NV, int G>
__global__ void __launch_bounds__(kThreads) modlnorm_sm90_kernel(const __grid_constant__ Params p) {
  using Raw = typename RawOf<VB>::type;
  constexpr int E = VB / (int)sizeof(T);  // elements a vector
  constexpr int kLanes = 32 * G;          // lanes a row
  constexpr int kGroups = kWarps / G;     // rows a block at a time
  static_assert(kWarps % G == 0, "a block holds whole rows");
  // each warp's partial sums of the mean and of Σ(x − mean)² (G > 1)
  __shared__ float partial[2][kWarps];
  const int warp = threadIdx.x >> 5;
  const int group = warp / G;
  const int lane = (warp % G) * 32 + (threadIdx.x & 31);
  const float d = (float)p.d;
  for (int row = blockIdx.x * kGroups + group; row < p.n_rows; row += gridDim.x * kGroups) {
    const RowPtrs<Raw> at = row_ptrs<T, Raw>(p, row);
    Raw v[NV], sc[NV], sh[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = i * kLanes + lane;
      if (k < p.n_vec) {
        v[i] = __ldcs(at.x + k);  // x is read once: evict first
        sc[i] = __ldg(at.scale + k);
        sh[i] = __ldg(at.shift + k);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * kLanes + lane < p.n_vec) {
        const T* e = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
        for (int j = 0; j < E; ++j) sum += to_f32(e[j]);
      }
    }
    const float mean = row_sum<G>(sum, partial[0], group, warp) / d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * kLanes + lane < p.n_vec) {
        const T* e = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float c = to_f32(e[j]) - mean;
          sq += c * c;
        }
      }
    }
    const float rstd = rsqrtf(row_sum<G>(sq, partial[1], group, warp) / d + p.eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = i * kLanes + lane;
      if (k < p.n_vec) {
        const T* e = reinterpret_cast<const T*>(&v[i]);
        const T* se = reinterpret_cast<const T*>(&sc[i]);
        const T* he = reinterpret_cast<const T*>(&sh[i]);
        Raw o;
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float normed = (to_f32(e[j]) - mean) * rstd;
          oe[j] = from_f32<T>(normed * (1.0f + to_f32(se[j])) + to_f32(he[j]));
        }
        at.out[k] = o;
      }
    }
  }
}

using Kernel = void (*)(const Params);

// The kernels the entry offers: NV (vectors a lane) 1 to the wrapper's
// `MAX_NV`, G (warps a row) one of its `GROUPS`.
template <typename T, int VB, int G>
Kernel kernel_of(int nv) {
  switch (nv) {
    case 1: return modlnorm_sm90_kernel<T, VB, 1, G>;
    case 2: return modlnorm_sm90_kernel<T, VB, 2, G>;
    case 3: return modlnorm_sm90_kernel<T, VB, 3, G>;
    case 4: return modlnorm_sm90_kernel<T, VB, 4, G>;
    case 5: return modlnorm_sm90_kernel<T, VB, 5, G>;
    default: return nullptr;
  }
}

template <typename T, int VB>
Kernel kernel_of(int nv, int group) {
  switch (group) {
    case 1: return kernel_of<T, VB, 1>(nv);
    case 2: return kernel_of<T, VB, 2>(nv);
    case 4: return kernel_of<T, VB, 4>(nv);
    case 8: return kernel_of<T, VB, 8>(nv);
    default: return nullptr;
  }
}

// dtype 1: bf16 (vectors of 16, 8 or 2 bytes); 0: fp32 (16, 8 or 4)
Kernel kernel_of(int dtype, int vec_bytes, int nv, int group) {
  if (dtype == 1) {
    switch (vec_bytes) {
      case 16: return kernel_of<__nv_bfloat16, 16>(nv, group);
      case 8: return kernel_of<__nv_bfloat16, 8>(nv, group);
      case 2: return kernel_of<__nv_bfloat16, 2>(nv, group);
      default: return nullptr;
    }
  }
  if (dtype == 0) {
    switch (vec_bytes) {
      case 16: return kernel_of<float, 16>(nv, group);
      case 8: return kernel_of<float, 8>(nv, group);
      case 4: return kernel_of<float, 4>(nv, group);
      default: return nullptr;
    }
  }
  return nullptr;
}

}  // namespace

// One launch over n_seg (1 or 2) segments. ptrs: per segment x, scale,
// shift, out; ints: per segment B, T and the element strides x_sb, x_st,
// scale_sb, shift_sb (d contiguous in each; out contiguous (B, T, d)).
// dtype 1 bf16, 0 fp32, for all four tensors of both segments; vec_bytes,
// nv and group (warps a row) from the wrapper's launch plan. Every pointer
// and every stride in bytes must be a multiple of vec_bytes, and d · size a
// multiple of it with at most 32 · group · nv vectors a row. Returns 0 or a
// cudaError_t (of the arguments, the occupancy query or the launch).
extern "C" int ecad_modlnorm_sm90_fwd(int dtype, int vec_bytes, int nv, int group, int n_seg,
                                      void* const* ptrs, const long long* ints, int d,
                                      float eps, void* stream) {
  const Kernel kernel = kernel_of(dtype, vec_bytes, nv, group);
  const long long size = dtype == 1 ? 2 : 4;
  if (kernel == nullptr || kWarps % group != 0 || n_seg < 1 || n_seg > kMaxSegments || d < 1 ||
      (d * size) % vec_bytes != 0)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.n_seg = n_seg;
  p.d = d;
  p.n_vec = (int)(d * size / vec_bytes);
  p.eps = eps;
  if (p.n_vec > 32 * group * nv) return (int)cudaErrorInvalidValue;
  long long rows = 0;
  for (int s = 0; s < n_seg; ++s) {
    const long long* a = ints + 6 * s;
    Segment& g = p.seg[s];
    g.x = ptrs[4 * s];
    g.scale = ptrs[4 * s + 1];
    g.shift = ptrs[4 * s + 2];
    g.out = ptrs[4 * s + 3];
    if (a[0] < 1 || a[1] < 1 || a[1] > 0x7fffffff) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < 4; ++i)
      if (reinterpret_cast<unsigned long long>(ptrs[4 * s + i]) % vec_bytes != 0)
        return (int)cudaErrorInvalidValue;
    for (int i = 2; i < 6; ++i)
      if ((a[i] * size) % vec_bytes != 0) return (int)cudaErrorInvalidValue;
    g.T = (int)a[1];
    g.x_sb = a[2];
    g.x_st = a[3];
    g.scale_sb = a[4];
    g.shift_sb = a[5];
    g.row0 = (int)rows;
    rows += a[0] * a[1];
    if (rows > 0x7fffffff) return (int)cudaErrorInvalidValue;
  }
  p.n_rows = (int)rows;
  // persistent: the blocks the SMs hold at the kernel's occupancy, or fewer
  // when the rows run out first (the SM count and the occupancy are queried
  // once a device and kernel: a host-bound loop would pay for them on every
  // call)
  static int sms_of[16] = {};
  static int per_sm_of[16][2][17][6][9] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 16) return (int)cudaErrorInvalidDevice;
  int& sms = sms_of[dev];
  int& per_sm = per_sm_of[dev][dtype][vec_bytes][nv][group];
  if (sms == 0) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int groups = kWarps / group;  // rows a block at a time
  const long long need = (rows + groups - 1) / groups;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(need < most ? need : most);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
