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
// Design: one warp per row, up to four rows per block. The selection is
// topk::loop_select (topk_common.cuh): k rounds of a warp-wide max over a
// 64-bit key (|u| bits << 32 | ~column), where the largest magnitude wins,
// and on equal magnitude the lowest column (largest ~column) wins. Round r
// keeps only keys below round r-1's winner, so no entry is marked or
// rewritten, and after k rounds the selected set is exactly the keys >= the
// last winner. This costs O(k * C) shared-memory reads per row: fine at the
// main path's k = 10, not at large k, where the threshold select of
// topk_select.cu is needed. Bringing it into this kernel is later work.
//
// Rows need no padding: a warp past the last row returns. Rows up to
// C = 58112 fit in shared memory (227 KB per block).

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kMaxRowsPerBlock = 4;
constexpr size_t kSmemLimit = 232448;  // 227 KB, the most a block may use
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float fused_u(float m, float g, float eta) {
  return __fadd_rn(m, __fmul_rn(eta, g));
}

__global__ void fused_memsgd_kernel(const float* __restrict__ m,
                                    const float* __restrict__ g, float eta,
                                    int rows, int cols, int k, bool vec,
                                    float* __restrict__ new_m,
                                    float* __restrict__ vals,
                                    int* __restrict__ idx) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;
  float* u = smem + static_cast<size_t>(warp) * cols;
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

  // k rounds of the warp-wide key max; prev is the last winner's key
  const size_t out = static_cast<size_t>(row) * k;
  const unsigned long long prev =
      topk::loop_select(u, cols, k, lane, vals + out, idx + out);

  // m' = u with the k selected entries (keys >= the last winner) zeroed
  if (vec) {
    const float4* u4 = reinterpret_cast<const float4*>(u);
    float4* n4 = reinterpret_cast<float4*>(new_m + base);
    for (int j = lane; j < (cols >> 2); j += 32) {
      float4 v = u4[j];
      const int c = j << 2;
      if (topk::sel_key(v.x, c) >= prev) v.x = 0.0f;
      if (topk::sel_key(v.y, c + 1) >= prev) v.y = 0.0f;
      if (topk::sel_key(v.z, c + 2) >= prev) v.z = 0.0f;
      if (topk::sel_key(v.w, c + 3) >= prev) v.w = 0.0f;
      n4[j] = v;
    }
  } else {
    for (int j = lane; j < cols; j += 32) {
      const float v = u[j];
      new_m[base + j] = topk::sel_key(v, j) >= prev ? 0.0f : v;
    }
  }
}

}  // namespace

// Launches the kernel on `stream`. Returns 0 (cudaSuccess) or the CUDA
// error code of the refused launch; it does not synchronise.
extern "C" int fused_memsgd_f32(const float* m, const float* g, float eta,
                                int rows, int cols, int k, float* new_m,
                                float* vals, int* idx, cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  if (cols <= 0 || k < 1 || k > cols) return cudaErrorInvalidValue;
  const size_t row_bytes = static_cast<size_t>(cols) * sizeof(float);
  int rows_per_block = kMaxRowsPerBlock;
  while (rows_per_block > 1 && rows_per_block * row_bytes > kSmemLimit) {
    rows_per_block >>= 1;
  }
  const size_t smem = rows_per_block * row_bytes;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_memsgd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const bool vec = (cols & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(m) |
                     reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(new_m)) & 15) == 0;
  const unsigned int blocks = (rows + rows_per_block - 1) / rows_per_block;
  fused_memsgd_kernel<<<blocks, 32 * rows_per_block, smem, stream>>>(
      m, g, eta, rows, cols, k, vec, new_m, vals, idx);
  return cudaGetLastError();
}
