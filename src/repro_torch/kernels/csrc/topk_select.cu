// Per-row top-|.|-k selection for Hopper: two kernels behind a plain C
// interface.
//
//   row_topk_loop       replaces row_topk_pallas(selection="loop")
//                       (src/repro/kernels/topk_select.py, body _topk_kernel
//                       -> _topk_loop): k rounds of a warp-wide key max.
//   row_topk_threshold  replaces row_topk_tiled_pallas (body
//                       _topk_tiled_kernel -> _threshold_select) and
//                       row_topk_pallas(selection="threshold") (body
//                       _topk_kernel -> _threshold_topk_tile): the exact
//                       k-th largest magnitude by bisection over its bit
//                       pattern, then one pass that selects and orders.
//
// For each row of x (R, C) float32 both write the k entries of largest |x|
// as (vals (R, k) float32, idx (R, k) int32), in decreasing |x|, ties to
// the lowest column, values keeping their sign. The contract fixes the
// output, so the two kernels agree bit for bit with each other and with the
// plain version (the iterative argmax, kernels/ref.py).
//
// Bound: device-memory bandwidth. The function must read x (R * C * 4
// bytes) and write vals and idx (R * k * 8 bytes); it does about one
// compare per element. Both kernels read each row from device memory once
// into shared memory (16-byte loads where the row is aligned) and run every
// pass of the selection there, so the passes cost shared-memory bandwidth
// and instructions, not device memory: the loop kernel O(k * C) per row,
// the threshold kernel about 35 passes of C (31 bisection halvings, a max,
// a tie count, a tie scan and a compaction) plus O(k^2) to order the k
// pairs, whatever k is.
//
// Design: one warp per row, up to four rows per block (the TPU kernels'
// column-tile grid and running candidate merge are not carried over: a row
// of up to 58112 columns fits in the 227 KB a block may use). A row wider
// than that is read from device memory on every pass instead (correct,
// slower). Rows need no padding: a warp past the last row returns.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kMaxRowsPerBlock = 4;
constexpr size_t kSmemLimit = 232448;  // 227 KB, the most a block may use
constexpr size_t kDefaultSmem = 48 * 1024;

// The row the warp selects from: its copy in shared memory (kSmem), read
// once from device memory, or the row in device memory itself.
template <bool kSmem>
__device__ __forceinline__ const float* stage_row(const float* __restrict__ x,
                                                  size_t base, int cols,
                                                  bool vec, float* smem_row,
                                                  int lane) {
  if (!kSmem) return x + base;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    float4* s4 = reinterpret_cast<float4*>(smem_row);
    for (int j = lane; j < (cols >> 2); j += 32) s4[j] = x4[j];
  } else {
    for (int j = lane; j < cols; j += 32) smem_row[j] = x[base + j];
  }
  __syncwarp();
  return smem_row;
}

template <bool kSmem>
__global__ void row_topk_loop_kernel(const float* __restrict__ x, int rows,
                                     int cols, int k, bool vec, float* vals,
                                     int* idx) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;
  const float* r =
      stage_row<kSmem>(x, static_cast<size_t>(row) * cols, cols, vec,
                       smem + static_cast<size_t>(warp) * cols, lane);
  const size_t out = static_cast<size_t>(row) * k;
  topk::loop_select(r, cols, k, lane, vals + out, idx + out);
}

template <bool kSmem>
__global__ void row_topk_threshold_kernel(const float* __restrict__ x,
                                          int rows, int cols, int k, bool vec,
                                          float* vals, int* idx) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;
  const float* r =
      stage_row<kSmem>(x, static_cast<size_t>(row) * cols, cols, vec,
                       smem + static_cast<size_t>(warp) * cols, lane);
  const unsigned int tau = topk::kth_largest_bits(r, cols, k, lane);
  const unsigned long long kth = topk::threshold_key(r, cols, k, tau, lane);
  const size_t out = static_cast<size_t>(row) * k;
  topk::write_selected(r, cols, k, kth, lane, vals + out, idx + out);
}

using KernelFn = void (*)(const float*, int, int, int, bool, float*, int*);

// Picks the shared-memory or device-memory form, lifts the 48 KB default
// when needed, and launches on `stream`. Returns 0 (cudaSuccess) or the
// CUDA error code of the refused launch; it does not synchronise.
int launch(KernelFn in_smem, KernelFn in_device, const float* x, int rows,
           int cols, int k, float* vals, int* idx, cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  if (cols <= 0 || k < 1 || k > cols) return cudaErrorInvalidValue;
  const size_t row_bytes = static_cast<size_t>(cols) * sizeof(float);
  const bool fits = row_bytes <= kSmemLimit;
  int rows_per_block = kMaxRowsPerBlock;
  while (fits && rows_per_block * row_bytes > kSmemLimit) {
    rows_per_block >>= 1;
  }
  const size_t smem = fits ? rows_per_block * row_bytes : 0;
  KernelFn fn = fits ? in_smem : in_device;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const bool vec =
      (cols & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const unsigned int blocks = static_cast<unsigned int>(
      (static_cast<long long>(rows) + rows_per_block - 1) / rows_per_block);
  fn<<<blocks, 32 * rows_per_block, smem, stream>>>(x, rows, cols, k, vec,
                                                    vals, idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" int row_topk_loop_f32(const float* x, int rows, int cols, int k,
                                 float* vals, int* idx, cudaStream_t stream) {
  return launch(row_topk_loop_kernel<true>, row_topk_loop_kernel<false>, x,
                rows, cols, k, vals, idx, stream);
}

extern "C" int row_topk_threshold_f32(const float* x, int rows, int cols,
                                      int k, float* vals, int* idx,
                                      cudaStream_t stream) {
  return launch(row_topk_threshold_kernel<true>,
                row_topk_threshold_kernel<false>, x, rows, cols, k, vals, idx,
                stream);
}
