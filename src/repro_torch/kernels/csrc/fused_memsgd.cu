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
// Bound: device-memory bandwidth. The function must read m and g and write
// m' (3 * R * C * 4 bytes) plus vals and idx (R * k * 8 bytes); its
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
// Rows with C % 4 != 0, or m, g or m' not 16-byte aligned, take the lanes'
// plain loads and stores instead. The widest row is what one warp's buffer
// and scratch leave of a block's 227 KB: u is never in device memory, so a
// wider row is refused.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3;
// PERF.md): 62 registers (loop) and 56 (threshold), no
// spills, 32 and 30 warps per SM. At qwen3-4b's (1154560, 1024) bucket,
// k = 10, the median of 8 runs: the loop branch 4.636 ms, the threshold
// branch 4.623 ms, against a 4.263 ms bytes bound (1.09x and 1.08x); the
// first form took 8.42-8.61 ms (loop) and 4.79 ms (threshold).
// Alternatives that lost on the same card (PERF.md): a persistent
// grid walking rows with a stride of its warps (~10% slower), g
// bulk-copied into a second buffer (up to 6% slower, half the widest
// row), m' zeroed in place and bulk-stored (no faster).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_buffer.cuh"
#include "topk_common.cuh"

namespace {

using row_buffer::row_stride;

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

// `bulk`: every row of m, g and m' is 16-byte aligned (C % 4 == 0 and the
// three tensors aligned), so rows move by a bulk copy and 16-byte
// accesses; otherwise the lanes copy each row with plain loads and stores.
template <bool kThreshold>
__global__ void fused_memsgd_kernel(const float* __restrict__ m,
                                    const float* __restrict__ g, float eta,
                                    int rows, int cols, int k, bool bulk,
                                    float* __restrict__ new_m,
                                    float* __restrict__ vals,
                                    int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // the last block's spare warps
  const size_t stride = row_stride(cols);
  unsigned char* own = smem + warp * (stride + scratch_bytes(kThreshold));
  float* u = reinterpret_cast<float*>(own);
  unsigned char* scratch = own + stride;
  auto* list = reinterpret_cast<unsigned long long*>(scratch);
  auto* hist = reinterpret_cast<unsigned int*>(scratch + kListBytes);
  auto* bar = reinterpret_cast<uint64_t*>(
      scratch + kListBytes + (kThreshold ? kHistBytes : 0));
  const size_t base = static_cast<size_t>(row) * cols;

  // u = m + eta * g, in the row buffer
  if (bulk) {
    if (lane == 0) {
      row_buffer::bar_init(bar);
      row_buffer::bulk_load(u, m + base, static_cast<uint32_t>(cols) * 4u,
                            bar);
    }
    __syncwarp();
    // 8 float4 of g per lane in flight before the wait on m
    constexpr int kAhead = 8;
    const int n4 = cols >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(g + base);
    float4* u4 = reinterpret_cast<float4*>(u);
    for (int q0 = 0; q0 < n4; q0 += 32 * kAhead) {
      float4 gr[kAhead];
#pragma unroll
      for (int t = 0; t < kAhead; ++t) {
        const int q = q0 + lane + 32 * t;
        if (q < n4) gr[t] = g4[q];
      }
      if (q0 == 0) row_buffer::bar_wait(bar, 0);
#pragma unroll
      for (int t = 0; t < kAhead; ++t) {
        const int q = q0 + lane + 32 * t;
        if (q < n4) u4[q] = fused_u4(u4[q], gr[t], eta);
      }
    }
  } else {
    for (int j = lane; j < cols; j += 32) {
      u[j] = fused_u(m[base + j], g[base + j], eta);
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
    const float4* u4 = reinterpret_cast<const float4*>(u);
    float4* n4p = reinterpret_cast<float4*>(new_m + base);
    for (int q = lane; q < (cols >> 2); q += 32) {
      n4p[q] = residual4(u4[q], q << 2, kth);
    }
  } else {
    for (int j = lane; j < cols; j += 32) {
      const float v = u[j];
      new_m[base + j] = topk::sel_key(v, j) >= kth ? 0.0f : v;
    }
  }
}

using KernelFn = void (*)(const float*, const float*, float, int, int, int,
                          bool, float*, float*, int*);

// How one branch's kernel is launched on (rows, cols).
struct Plan {
  KernelFn fn;
  row_buffer::Grid grid;
};

cudaError_t make_plan(bool threshold, int rows, int cols, Plan* p) {
  p->fn = threshold ? fused_memsgd_kernel<true> : fused_memsgd_kernel<false>;
  return row_buffer::plan_grid(reinterpret_cast<const void*>(p->fn),
                               row_stride(cols) + scratch_bytes(threshold),
                               rows, &p->grid);
}

// Plans and launches one branch on `stream`. Returns 0 (cudaSuccess) or
// the CUDA error code of the refused launch; it does not synchronise.
int launch(bool threshold, const float* m, const float* g, float eta,
           int rows, int cols, int k, float* new_m, float* vals, int* idx,
           cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  if (cols <= 0 || k < 1 || k > cols) return cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = make_plan(threshold, rows, cols, &p);
  if (e != cudaSuccess) return e;
  const bool bulk = (cols & 3) == 0 &&
                    ((reinterpret_cast<uintptr_t>(m) |
                      reinterpret_cast<uintptr_t>(g) |
                      reinterpret_cast<uintptr_t>(new_m)) & 15) == 0;
  p.fn<<<p.grid.blocks, 32 * p.grid.warps_per_block, p.grid.smem_bytes,
         stream>>>(m, g, eta, rows, cols, k, bulk, new_m, vals, idx);
  return cudaGetLastError();
}

}  // namespace

// The loop branch (selection="loop").
extern "C" int fused_memsgd_f32(const float* m, const float* g, float eta,
                                int rows, int cols, int k, float* new_m,
                                float* vals, int* idx, cudaStream_t stream) {
  return launch(false, m, g, eta, rows, cols, k, new_m, vals, idx, stream);
}

// The threshold branch (selection="threshold").
extern "C" int fused_memsgd_threshold_f32(const float* m, const float* g,
                                          float eta, int rows, int cols,
                                          int k, float* new_m, float* vals,
                                          int* idx, cudaStream_t stream) {
  return launch(true, m, g, eta, rows, cols, k, new_m, vals, idx, stream);
}

// Writes the launch plan of a branch (the loop's when threshold == 0) for
// an (rows, cols) input on the current device into out: warps per block,
// 1 (the row is always in shared memory), blocks, shared-memory bytes per
// block, warps resident per SM.
extern "C" int fused_memsgd_plan(int threshold, int rows, int cols,
                                 int* out) {
  if (rows <= 0 || cols <= 0) return cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = make_plan(threshold != 0, rows, cols, &p);
  if (e != cudaSuccess) return e;
  out[0] = p.grid.warps_per_block;
  out[1] = 1;
  out[2] = p.grid.blocks;
  out[3] = p.grid.smem_bytes;
  out[4] = p.grid.warps_per_sm;
  return cudaSuccess;
}
