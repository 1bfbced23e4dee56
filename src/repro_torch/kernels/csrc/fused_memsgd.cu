// Fused Mem-SGD memory update + per-row top-|.|-k selection for Hopper.
//
// Replaces the Pallas TPU kernel fused_memsgd_pallas
// (src/repro/kernels/fused_memsgd.py, body _fused_kernel). For each row
// of the (R, C) bucket:
//
//     u     = m + eta * g                 (rounded as two ops, no FMA)
//     v, i  = the k entries of u with the largest |u|, in decreasing |u|,
//             ties to the lowest column index
//     m'    = u with those k entries set to +0.0
//
// m is float32 (g float32) or bf16 (g float32 or bf16): the reference's
// m + eta.astype(m.dtype) * g.astype(m.dtype) in m's dtype. At bf16, eta
// and g are rounded to bf16, and the product and the sum are each taken in
// float32 and rounded once to bf16 (__float2bfloat16_rn, no FMA), as the
// reference's bf16 ops (and torch's) round them; new_m and vals are bf16
// and the selection runs on the bf16 u (topk_common.cuh's bf16 keys).
//
// Bound: device-memory bandwidth. The function must read m and g and write
// m' (3 * R * C * 4 bytes; R * C * 8 with bf16 m and float32 g, R * C * 6
// with both bf16) plus vals and idx (R * k * 8 bytes, 6 at bf16); its
// arithmetic is 2 flops per element. The kernel reads m and g once, keeps
// the row's u in shared memory for the selection, and writes m', vals and
// idx once, so no intermediate touches device memory. What kept its first
// form (one warp per row, four rows per block, the lanes' loads) at half
// the bound on the loop branch was the select: k passes over the row,
// O(k * C) key builds and compares, which at k = 10 took as long as the
// bytes.
//
// Design:
//   * the selection: topk::loop_row (loop) or topk::threshold_row
//     (threshold), the selects of row_topk_loop and row_topk_threshold:
//     two passes over the row, then the k rounds of a warp max, or the
//     radix select, on a candidate list of at most 256 keys. Either
//     returns the k-th selected key; keys are unique, so the selected set
//     is exactly the keys >= it;
//   * a warp for every row, each with a row buffer in shared memory and
//     its scratch after it (the candidate list, the threshold branch's
//     256-bin histogram, an mbarrier); the warps per block are the fewest
//     that let the most warps reside on an SM (row_buffer.cuh plan_grid);
//   * lane 0 brings the row's m in by one bulk copy
//     (cp.async.bulk ... mbarrier::complete_tx::bytes) while the lanes
//     issue 16-byte loads of the whole of g (8 float4 a lane at C = 1024)
//     before they wait on it, then add g into the staged m in place
//     (u = m + eta*g): both rows are in flight at once;
//   * m' = u with the keys >= kth zeroed, written by the lanes' 16-byte
//     stores.
// Rows that are not a multiple of 16 bytes (C % 4 != 0, or C % 8 != 0
// with bf16 m), or m, g or m' not 16-byte aligned, take the lanes' plain
// loads and stores instead. The widest row is what one warp's buffer
// and scratch leave of a block's 227 KB: u is never in device memory, so a
// wider row is refused.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3;
// PERF.md): 70 registers (loop) and 56 (threshold) in every form, no
// spills, 28 and 30 warps per SM at float32. At qwen3-4b's (1154560,
// 1024) bucket, k = 10, the median of 4 runs: the loop branch 4.656 ms,
// the threshold branch 4.644 ms, against a 4.263 ms bytes bound (1.09x);
// the first form took 8.42-8.61 ms (loop) and 4.79 ms (threshold). The
// bf16 form at the pod sync's (496345, 1024) bucket with float32 g, k =
// 10: loop 1.462 ms, threshold 1.555, against a 1.223 ms bound.
// Alternatives that lost on the same card (PERF.md): a persistent
// grid walking rows with a stride of its warps (~10% slower), g
// bulk-copied into a second buffer (up to 6% slower, half the widest
// row), m' zeroed in place and bulk-stored (no faster).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "row_buffer.cuh"
#include "topk_common.cuh"

namespace {

using row_buffer::row_stride;
using topk::bf16;

// a warp's scratch after its row buffer: the candidate list (64-bit keys),
// the threshold branch's radix histogram, the mbarrier (padded so that the
// next warp's row buffer stays 16-byte aligned)
constexpr size_t kListBytes = topk::kListCap * 8;
constexpr size_t kHistBytes = topk::kHistBins * 4;
constexpr size_t kBarBytes = 16;

__host__ __device__ constexpr size_t scratch_bytes(bool threshold) {
  return kListBytes + (threshold ? kHistBytes : 0) + kBarBytes;
}
static_assert(scratch_bytes(false) % 16 == 0 &&
                  scratch_bytes(true) % 16 == 0,
              "row buffers stay 16-byte aligned");

__device__ __forceinline__ float fused_u(float m, float g, float eta) {
  return __fadd_rn(m, __fmul_rn(eta, g));
}

__device__ __forceinline__ float4 fused_u4(float4 m, float4 g, float eta) {
  return make_float4(fused_u(m.x, g.x, eta), fused_u(m.y, g.y, eta),
                     fused_u(m.z, g.z, eta), fused_u(m.w, g.w, eta));
}

// bf16 bits <-> float32: widening is exact; narrowing rounds to nearest
// even
__device__ __forceinline__ float bf_float(unsigned int bits) {
  return __uint_as_float(bits << 16);
}
__device__ __forceinline__ unsigned int bf_round(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// u = m + eta * g at bf16 m (bits), g as float32 (exact for a bf16 g), e
// = eta rounded to bf16: g rounded to bf16, the product and the sum each
// in float32 rounded once to bf16. Returns u's bits.
__device__ __forceinline__ unsigned int fused_u_bf(unsigned int m, float g,
                                                   float e) {
  const float p = bf_float(bf_round(__fmul_rn(e, bf_float(bf_round(g)))));
  return bf_round(__fadd_rn(bf_float(m), p));
}

// The same on the two bf16 halves of a 32-bit word of m, whose g are g0
// (the low half's) and g1
__device__ __forceinline__ unsigned int fused_u_bf2(unsigned int m, float g0,
                                                    float g1, float e) {
  return fused_u_bf(m & 0xffffu, g0, e) | (fused_u_bf(m >> 16, g1, e) << 16);
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(bf16 v) { return bf_float(v); }

// eta as the kernel multiplies it: in m's dtype
template <class TM>
__device__ __forceinline__ float eta_in(float eta) {
  return std::is_same<TM, float>::value ? eta : bf_float(bf_round(eta));
}

// One entry of u from m's and g's entries (the lanes' plain loads)
__device__ __forceinline__ float u_entry(float m, float g, float e) {
  return fused_u(m, g, e);
}
template <class TG>
__device__ __forceinline__ bf16 u_entry(bf16 m, TG g, float e) {
  return static_cast<bf16>(fused_u_bf(m, as_float(g), e));
}

// u += eta * g on the columns of g's 16-byte word q (w), in the row
// buffer u: 4 float32 g over 16 bytes of float32 u or 8 of bf16 u, or 8
// bf16 g over 16 bytes of bf16 u
template <class TM, class TG>
__device__ __forceinline__ void add_g(TM* u, int q, uint4 w, float e) {
  if constexpr (std::is_same<TM, float>::value) {
    float4* u4 = reinterpret_cast<float4*>(u);
    u4[q] = fused_u4(u4[q], make_float4(__uint_as_float(w.x),
                                        __uint_as_float(w.y),
                                        __uint_as_float(w.z),
                                        __uint_as_float(w.w)),
                     e);
  } else if constexpr (std::is_same<TG, float>::value) {
    uint2* u2 = reinterpret_cast<uint2*>(u);
    const uint2 mw = u2[q];
    u2[q] = make_uint2(
        fused_u_bf2(mw.x, __uint_as_float(w.x), __uint_as_float(w.y), e),
        fused_u_bf2(mw.y, __uint_as_float(w.z), __uint_as_float(w.w), e));
  } else {
    uint4* u4 = reinterpret_cast<uint4*>(u);
    const uint4 mw = u4[q];
    auto two = [e](unsigned int m, unsigned int g) {
      return fused_u_bf2(m, bf_float(g & 0xffffu), bf_float(g >> 16), e);
    };
    u4[q] = make_uint4(two(mw.x, w.x), two(mw.y, w.y), two(mw.z, w.z),
                       two(mw.w, w.w));
  }
}

// u's four entries from column c with the selected ones (keys >= kth) set
// to +0.0
__device__ __forceinline__ float4 residual4(float4 v, int c,
                                            unsigned long long kth) {
  if (topk::sel_key(v.x, c) >= kth) v.x = 0.0f;
  if (topk::sel_key(v.y, c + 1) >= kth) v.y = 0.0f;
  if (topk::sel_key(v.z, c + 2) >= kth) v.z = 0.0f;
  if (topk::sel_key(v.w, c + 3) >= kth) v.w = 0.0f;
  return v;
}

// The same for the two bf16 halves of a word of u from column c
__device__ __forceinline__ unsigned int residual_bf2(unsigned int w, int c,
                                                     unsigned long long kth) {
  if (topk::sel_key(static_cast<bf16>(w & 0xffffu), c) >= kth) {
    w &= 0xffff0000u;
  }
  if (topk::sel_key(static_cast<bf16>(w >> 16), c + 1) >= kth) {
    w &= 0xffffu;
  }
  return w;
}

// `bulk`: every row of m, g and m' is 16-byte aligned (a row of m a
// multiple of 16 bytes, and the three tensors aligned), so rows move by a
// bulk copy and 16-byte accesses; otherwise the lanes copy each row with
// plain loads and stores.
template <bool kThreshold, class TM, class TG>
__global__ void fused_memsgd_kernel(const TM* __restrict__ m,
                                    const TG* __restrict__ g, float eta,
                                    int rows, int cols, int k, bool bulk,
                                    TM* __restrict__ new_m,
                                    TM* __restrict__ vals,
                                    int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // the last block's spare warps
  const size_t stride = row_stride<TM>(cols);
  unsigned char* own = smem + warp * (stride + scratch_bytes(kThreshold));
  TM* u = reinterpret_cast<TM*>(own);
  unsigned char* scratch = own + stride;
  auto* list = reinterpret_cast<unsigned long long*>(scratch);
  auto* hist = reinterpret_cast<unsigned int*>(scratch + kListBytes);
  auto* bar = reinterpret_cast<uint64_t*>(
      scratch + kListBytes + (kThreshold ? kHistBytes : 0));
  const size_t base = static_cast<size_t>(row) * cols;
  const float e = eta_in<TM>(eta);

  // u = m + eta * g, in the row buffer
  if (bulk) {
    if (lane == 0) {
      row_buffer::bar_init(bar);
      row_buffer::bulk_load(u, m + base,
                            static_cast<uint32_t>(cols) * sizeof(TM), bar);
    }
    __syncwarp();
    // 8 16-byte words of g per lane in flight before the wait on m
    constexpr int kAhead = 8;
    const int ng = cols / topk::kVec<TG>;
    const uint4* g4 = reinterpret_cast<const uint4*>(g + base);
    for (int q0 = 0; q0 < ng; q0 += 32 * kAhead) {
      uint4 gr[kAhead];
#pragma unroll
      for (int t = 0; t < kAhead; ++t) {
        const int q = q0 + lane + 32 * t;
        if (q < ng) gr[t] = g4[q];
      }
      if (q0 == 0) row_buffer::bar_wait(bar, 0);
#pragma unroll
      for (int t = 0; t < kAhead; ++t) {
        const int q = q0 + lane + 32 * t;
        if (q < ng) add_g<TM, TG>(u, q, gr[t], e);
      }
    }
  } else {
    for (int j = lane; j < cols; j += 32) {
      u[j] = u_entry(m[base + j], g[base + j], e);
    }
  }
  __syncwarp();

  // the selection; kth is the k-th selected key
  const size_t out = static_cast<size_t>(row) * k;
  unsigned long long kth;
  if constexpr (kThreshold) {
    kth = topk::threshold_row(u, cols, k, true, lane, list, hist, vals + out,
                              idx + out);
  } else {
    kth = topk::loop_row(u, cols, k, true, lane, list, vals + out,
                         idx + out);
  }

  // m' = u with the selected entries (keys >= kth) zeroed
  if (bulk) {
    const uint4* u4 = reinterpret_cast<const uint4*>(u);
    uint4* out4 = reinterpret_cast<uint4*>(new_m + base);
    constexpr int n = topk::kVec<TM>;
    for (int q = lane; q < cols / n; q += 32) {
      const uint4 w = u4[q];
      if constexpr (std::is_same<TM, float>::value) {
        const float4 r = residual4(
            make_float4(__uint_as_float(w.x), __uint_as_float(w.y),
                        __uint_as_float(w.z), __uint_as_float(w.w)),
            q * n, kth);
        out4[q] = make_uint4(__float_as_uint(r.x), __float_as_uint(r.y),
                             __float_as_uint(r.z), __float_as_uint(r.w));
      } else {
        const int c = q * n;
        out4[q] = make_uint4(residual_bf2(w.x, c, kth),
                             residual_bf2(w.y, c + 2, kth),
                             residual_bf2(w.z, c + 4, kth),
                             residual_bf2(w.w, c + 6, kth));
      }
    }
  } else {
    for (int j = lane; j < cols; j += 32) {
      const TM v = u[j];
      new_m[base + j] = topk::sel_key(v, j) >= kth ? TM{} : v;
    }
  }
}

template <class TM, class TG>
using KernelFn = void (*)(const TM*, const TG*, float, int, int, int, bool,
                          TM*, TM*, int*);

template <class TM, class TG>
KernelFn<TM, TG> kernel_of(bool threshold) {
  return threshold ? fused_memsgd_kernel<true, TM, TG>
                   : fused_memsgd_kernel<false, TM, TG>;
}

// How one branch's kernel is launched on (rows, cols).
template <class TM, class TG>
cudaError_t make_plan(bool threshold, int rows, int cols,
                      row_buffer::Grid* grid) {
  return row_buffer::plan_grid(
      reinterpret_cast<const void*>(kernel_of<TM, TG>(threshold)),
      row_stride<TM>(cols) + scratch_bytes(threshold), rows, grid);
}

// Plans and launches one branch on `stream`. Returns 0 (cudaSuccess) or
// the CUDA error code of the refused launch; it does not synchronise.
template <class TM, class TG>
int launch(bool threshold, const void* m, const void* g, float eta,
           int rows, int cols, int k, void* new_m, void* vals, int* idx,
           cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  if (cols <= 0 || k < 1 || k > cols) return cudaErrorInvalidValue;
  row_buffer::Grid grid;
  const cudaError_t e = make_plan<TM, TG>(threshold, rows, cols, &grid);
  if (e != cudaSuccess) return e;
  const bool bulk = cols % topk::kVec<TM> == 0 &&
                    ((reinterpret_cast<uintptr_t>(m) |
                      reinterpret_cast<uintptr_t>(g) |
                      reinterpret_cast<uintptr_t>(new_m)) & 15) == 0;
  const KernelFn<TM, TG> fn = kernel_of<TM, TG>(threshold);
  fn<<<grid.blocks, 32 * grid.warps_per_block, grid.smem_bytes, stream>>>(
      static_cast<const TM*>(m), static_cast<const TG*>(g), eta, rows, cols,
      k, bulk, static_cast<TM*>(new_m), static_cast<TM*>(vals), idx);
  return cudaGetLastError();
}

int launch_bf16(bool threshold, const void* m, const void* g, int g_bf16,
                float eta, int rows, int cols, int k, void* new_m,
                void* vals, int* idx, cudaStream_t stream) {
  return g_bf16 ? launch<bf16, bf16>(threshold, m, g, eta, rows, cols, k,
                                     new_m, vals, idx, stream)
                : launch<bf16, float>(threshold, m, g, eta, rows, cols, k,
                                      new_m, vals, idx, stream);
}

template <class TM, class TG>
int plan_of(bool threshold, int rows, int cols, int* out) {
  row_buffer::Grid grid;
  const cudaError_t e = make_plan<TM, TG>(threshold, rows, cols, &grid);
  if (e != cudaSuccess) return e;
  out[0] = grid.warps_per_block;
  out[1] = 1;
  out[2] = grid.blocks;
  out[3] = grid.smem_bytes;
  out[4] = grid.warps_per_sm;
  return cudaSuccess;
}

}  // namespace

// The loop branch (selection="loop").
extern "C" int fused_memsgd_f32(const float* m, const float* g, float eta,
                                int rows, int cols, int k, float* new_m,
                                float* vals, int* idx, cudaStream_t stream) {
  return launch<float, float>(false, m, g, eta, rows, cols, k, new_m, vals,
                              idx, stream);
}

// The threshold branch (selection="threshold").
extern "C" int fused_memsgd_threshold_f32(const float* m, const float* g,
                                          float eta, int rows, int cols,
                                          int k, float* new_m, float* vals,
                                          int* idx, cudaStream_t stream) {
  return launch<float, float>(true, m, g, eta, rows, cols, k, new_m, vals,
                              idx, stream);
}

// The bf16 forms of both branches: m, new_m and vals hold bf16 values, g
// float32 values or (g_bf16 != 0) bf16 ones.
extern "C" int fused_memsgd_bf16(const void* m, const void* g, int g_bf16,
                                 float eta, int rows, int cols, int k,
                                 void* new_m, void* vals, int* idx,
                                 cudaStream_t stream) {
  return launch_bf16(false, m, g, g_bf16, eta, rows, cols, k, new_m, vals,
                     idx, stream);
}

extern "C" int fused_memsgd_threshold_bf16(const void* m, const void* g,
                                           int g_bf16, float eta, int rows,
                                           int cols, int k, void* new_m,
                                           void* vals, int* idx,
                                           cudaStream_t stream) {
  return launch_bf16(true, m, g, g_bf16, eta, rows, cols, k, new_m, vals,
                     idx, stream);
}

// Writes the launch plan of a branch (the loop's when threshold == 0) for
// an (rows, cols) input on the current device into out, at float32 m and g
// or bf16 m (m_bf16 != 0) with float32 or (g_bf16 != 0) bf16 g: warps per
// block, 1 (the row is always in shared memory), blocks, shared-memory
// bytes per block, warps resident per SM.
extern "C" int fused_memsgd_plan(int threshold, int m_bf16, int g_bf16,
                                 int rows, int cols, int* out) {
  if (rows <= 0 || cols <= 0) return cudaErrorInvalidValue;
  if (!m_bf16) return plan_of<float, float>(threshold != 0, rows, cols, out);
  return g_bf16 ? plan_of<bf16, bf16>(threshold != 0, rows, cols, out)
                : plan_of<bf16, float>(threshold != 0, rows, cols, out);
}
