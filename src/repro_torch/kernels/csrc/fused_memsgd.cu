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
// arithmetic is 2 flops per element. The design reads m and g once, keeps
// the row's u in shared memory for the selection, and writes m', vals and
// idx once, so no intermediate touches device memory.
//
// Design: one warp per row, up to four rows per block, each row's u in
// its warp's shared-memory buffer. Two selections, one kernel template
// each, as the reference's kernel takes selection="loop" or "threshold":
//
//   loop       topk::loop_select (topk_common.cuh): k rounds of a
//              warp-wide max over a 64-bit key (|u| bits << 32 | ~column),
//              where the largest magnitude wins, and on equal magnitude the
//              lowest column (largest ~column) wins. Round r keeps only keys
//              below round r-1's winner, so no entry is marked or
//              rewritten. O(k * C) shared-memory reads per row: the choice
//              for small k.
//   threshold  topk::threshold_row, the select of topk_select.cu's
//              row_topk_threshold: two passes over the row, then a radix
//              select of the k-th largest magnitude on a candidate list
//              (a per-warp list of 256 keys and a 256-bin histogram after
//              the row buffer), the ties in column order and an O(k^2)
//              rank; k > 256 orders through vals and idx in device memory.
//
// Either returns the k-th selected key; keys are unique, so the selected
// set is exactly the keys >= it, and m' zeroes those. The threshold
// branch's scratch (3 KB per warp) lowers its widest row to C = 57344;
// the loop branch's is C = 58112 (227 KB per block).
//
// Rows need no padding: a warp past the last row returns. Each row buffer
// starts 16-byte aligned, so the selects read it as float4s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kMaxRowsPerBlock = 4;
constexpr size_t kSmemLimit = 232448;  // 227 KB, the most a block may use
constexpr size_t kDefaultSmem = 48 * 1024;
// the threshold branch's scratch after each row buffer: the candidate
// list (64-bit keys) and the radix histogram
constexpr size_t kListBytes = topk::kListCap * 8;
constexpr size_t kWarpScratch = kListBytes + topk::kHistBins * 4;
static_assert(kWarpScratch % 16 == 0, "row buffers stay 16-byte aligned");

// A row buffer's size: the row's bytes rounded up to 16.
__host__ __device__ __forceinline__ size_t row_stride(int cols) {
  return (static_cast<size_t>(cols) * sizeof(float) + 15) & ~size_t{15};
}

__device__ __forceinline__ float fused_u(float m, float g, float eta) {
  return __fadd_rn(m, __fmul_rn(eta, g));
}

template <bool kThreshold>
__global__ void fused_memsgd_kernel(const float* __restrict__ m,
                                    const float* __restrict__ g, float eta,
                                    int rows, int cols, int k, bool vec,
                                    float* __restrict__ new_m,
                                    float* __restrict__ vals,
                                    int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;
  const size_t stride = row_stride(cols);
  unsigned char* own = smem + warp * (stride + (kThreshold ? kWarpScratch : 0));
  float* u = reinterpret_cast<float*>(own);
  const size_t base = static_cast<size_t>(row) * cols;

  // u = m + eta * g, read once from device memory (16-byte loads when
  // the host found every row 16-byte aligned)
  if (vec) {
    const float4* m4 = reinterpret_cast<const float4*>(m + base);
    const float4* g4 = reinterpret_cast<const float4*>(g + base);
    float4* u4 = reinterpret_cast<float4*>(u);
    for (int j = lane; j < (cols >> 2); j += 32) {
      const float4 a = m4[j];
      const float4 b = g4[j];
      u4[j] = make_float4(fused_u(a.x, b.x, eta), fused_u(a.y, b.y, eta),
                          fused_u(a.z, b.z, eta), fused_u(a.w, b.w, eta));
    }
  } else {
    for (int j = lane; j < cols; j += 32) {
      u[j] = fused_u(m[base + j], g[base + j], eta);
    }
  }
  __syncwarp();

  // the selection; kth is the k-th selected key (loop: the last winner)
  const size_t out = static_cast<size_t>(row) * k;
  unsigned long long kth;
  if constexpr (kThreshold) {
    auto* list = reinterpret_cast<unsigned long long*>(own + stride);
    auto* hist = reinterpret_cast<unsigned int*>(own + stride + kListBytes);
    kth = topk::threshold_row(u, cols, k, true, lane, list, hist, vals + out,
                              idx + out);
  } else {
    kth = topk::loop_select(u, cols, k, lane, vals + out, idx + out);
  }

  // m' = u with the k selected entries (keys >= kth) zeroed
  if (vec) {
    const float4* u4 = reinterpret_cast<const float4*>(u);
    float4* n4 = reinterpret_cast<float4*>(new_m + base);
    for (int j = lane; j < (cols >> 2); j += 32) {
      float4 v = u4[j];
      const int c = j << 2;
      if (topk::sel_key(v.x, c) >= kth) v.x = 0.0f;
      if (topk::sel_key(v.y, c + 1) >= kth) v.y = 0.0f;
      if (topk::sel_key(v.z, c + 2) >= kth) v.z = 0.0f;
      if (topk::sel_key(v.w, c + 3) >= kth) v.w = 0.0f;
      n4[j] = v;
    }
  } else {
    for (int j = lane; j < cols; j += 32) {
      const float v = u[j];
      new_m[base + j] = topk::sel_key(v, j) >= kth ? 0.0f : v;
    }
  }
}

// Launches one branch's kernel on `stream`: as many rows per block (up
// to four) as their buffers fit in a block's shared memory. Returns 0
// (cudaSuccess) or the CUDA error code of the refused launch; it does not
// synchronise.
template <bool kThreshold>
int launch(const float* m, const float* g, float eta, int rows, int cols,
           int k, float* new_m, float* vals, int* idx, cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  if (cols <= 0 || k < 1 || k > cols) return cudaErrorInvalidValue;
  const size_t per_warp = row_stride(cols) + (kThreshold ? kWarpScratch : 0);
  int rows_per_block = kMaxRowsPerBlock;
  while (rows_per_block > 1 && rows_per_block * per_warp > kSmemLimit) {
    rows_per_block >>= 1;
  }
  const size_t smem = rows_per_block * per_warp;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_memsgd_kernel<kThreshold>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const bool vec = (cols & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(m) |
                     reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(new_m)) & 15) == 0;
  const unsigned int blocks = (rows + rows_per_block - 1) / rows_per_block;
  fused_memsgd_kernel<kThreshold>
      <<<blocks, 32 * rows_per_block, smem, stream>>>(m, g, eta, rows, cols,
                                                      k, vec, new_m, vals, idx);
  return cudaGetLastError();
}

}  // namespace

// The loop branch (selection="loop").
extern "C" int fused_memsgd_f32(const float* m, const float* g, float eta,
                                int rows, int cols, int k, float* new_m,
                                float* vals, int* idx, cudaStream_t stream) {
  return launch<false>(m, g, eta, rows, cols, k, new_m, vals, idx, stream);
}

// The threshold branch (selection="threshold").
extern "C" int fused_memsgd_threshold_f32(const float* m, const float* g,
                                          float eta, int rows, int cols,
                                          int k, float* new_m, float* vals,
                                          int* idx, cudaStream_t stream) {
  return launch<true>(m, g, eta, rows, cols, k, new_m, vals, idx, stream);
}
