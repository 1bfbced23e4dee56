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
//                       k-th largest magnitude bit pattern by a radix
//                       select, the ties taken in column order, then the
//                       selected pairs ordered.
//
// For each row of x (R, C), float32 or bf16, both write the k entries of
// largest |x| as (vals (R, k) in x's type, idx (R, k) int32), in
// decreasing |x|, ties to the lowest column, values keeping their sign.
// The contract fixes the output, so the two kernels agree bit for bit with
// each other and with the plain version (the iterative argmax,
// kernels/ref.py). Each is built for both types (the _f32 and _bf16 entry
// points): a bf16 entry is read as its float32 magnitude bits
// (topk_common.cuh), so the keys, the candidate list and the selection are
// the float32 kernels'; its row is half the bytes, 8 values to a 16-byte
// load, and its radix select stops after two digits.
//
// Bound: device-memory bandwidth. The function must read x (R * C * 4
// bytes, 2 at bf16) and write vals and idx (R * k * 8 bytes, 6 at bf16);
// it does about one compare per element. What held the first form of
// these kernels back was instructions, not bytes: one pass over the row
// per round (loop, k passes) or per bisection step (threshold, ~35
// passes). Now each row
// takes two passes over its copy in shared memory (topk_common.cuh:
// loop_row, threshold_row): every lane's largest key, then, for k <= 32,
// the candidates above the lanes' bound compacted to a per-warp list of
// at most 256 keys; the k rounds (loop) or the four radix digits, the tie
// scan and the O(k^2) rank (threshold) run on that list. A row whose
// magnitudes are all 0 (a vocabulary row no token has touched yet, as in
// the embedding's u early in training) is answered after the first pass.
// For k > 32 the loop kernel repeats the two passes per 32 rounds, and
// the threshold kernel takes the top digit's histogram over the row
// before it compacts. The selection is bound by the latency of its
// warp-wide steps (reductions, ballots), so the more warps reside on an
// SM, the closer the row's bytes come to the bandwidth.
//
// Design: persistent. launch() below sizes the grid to the card: each
// warp walks rows with a stride of the grid's warps and owns one row
// buffer in shared memory, followed by its scratch (the candidate list, a
// 256-bin histogram, an mbarrier). A row is brought in by one asynchronous
// bulk copy (TMA's one-dimensional form,
// cp.async.bulk ... mbarrier::complete_tx::bytes) issued by lane 0, so no
// lane spends registers or instructions on the copy, and the whole row is
// in flight at once (on the H100 at C = 2560 it beats the lanes' plain
// loads by ~13%). The bulk copy needs 16-byte aligned addresses and
// sizes: where a row is not a multiple of 16 bytes (C % 4 != 0 at
// float32, C % 8 != 0 at bf16) or x is not 16-byte aligned, the lanes
// copy each row with plain loads instead. One buffer per warp, not two:
// at C = 2560 one lets 16 warps reside on an SM and two only 9, and the
// other warps' selections hide a warp's copy better than its own second
// buffer (1.5x faster with one). A row wider than a block's shared memory
// is read from device memory on every pass instead (correct, slower). The
// warps per block are the fewest that let the most warps reside on an SM,
// as the occupancy calculator counts them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_buffer.cuh"
#include "topk_common.cuh"

namespace {

using topk::bf16;
using row_buffer::bar_init;
using row_buffer::bar_wait;
using row_buffer::bulk_load;
using row_buffer::row_stride;

// a warp's scratch after its row buffer: the candidate list (64-bit
// keys), the radix histogram, the mbarrier (padded so that the next
// warp's row buffer stays 16-byte aligned)
constexpr size_t kListBytes = topk::kListCap * 8;
constexpr size_t kHistBytes = topk::kHistBins * 4;
constexpr size_t kWarpScratch = kListBytes + kHistBytes + 16;
static_assert(kWarpScratch % 16 == 0, "row buffers stay 16-byte aligned");

// Walks this warp's rows (the global warp index, then every grid's worth
// of warps further) and calls select(r, row, list, hist) on each: r is the
// row's copy in the warp's buffer (kSmem) or the row in device memory.
// With `bulk` the copy of the warp's next row is issued as soon as the
// current one's selection has let go of the buffer.
template <bool kSmem, class T, class Select>
__device__ __forceinline__ void walk_rows(const T* __restrict__ x, int rows,
                                          int cols, bool bulk,
                                          Select&& select) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const size_t stride = kSmem ? row_stride<T>(cols) : 0;
  unsigned char* own = smem + warp * (stride + kWarpScratch);
  T* buf = reinterpret_cast<T*>(own);
  auto* list = reinterpret_cast<unsigned long long*>(own + stride);
  auto* hist = reinterpret_cast<unsigned int*>(own + stride + kListBytes);
  auto* bar = reinterpret_cast<uint64_t*>(own + stride + kListBytes +
                                          kHistBytes);
  const long long first = static_cast<long long>(blockIdx.x) * warps + warp;
  const long long step = static_cast<long long>(gridDim.x) * warps;
  const uint32_t bytes = static_cast<uint32_t>(cols) * sizeof(T);
  if (kSmem && bulk) {
    if (lane == 0) {
      bar_init(bar);
      if (first < rows) bulk_load(buf, x + first * cols, bytes, bar);
    }
    __syncwarp();
  }
  uint32_t parity = 0;
  for (long long row = first; row < rows; row += step) {
    const T* r = x + row * cols;
    if (kSmem) {
      if (bulk) {
        bar_wait(bar, parity);
        parity ^= 1u;
      } else {
        for (int j = lane; j < cols; j += 32) buf[j] = r[j];
        __syncwarp();
      }
      r = buf;
    }
    select(r, row, list, hist);
    if (kSmem) {
      __syncwarp();  // every lane is done with the buffer
      if (bulk && lane == 0 && row + step < rows) {
        bulk_load(buf, x + (row + step) * cols, bytes, bar);
      }
    }
  }
}

// `bulk`: every row is 16-byte aligned (a row a multiple of 16 bytes and
// x aligned), so a row comes by bulk copy (kSmem) or by 16-byte loads
// (device form).
template <bool kSmem, class T>
__global__ void row_topk_loop_kernel(const T* __restrict__ x, int rows,
                                     int cols, int k, bool bulk, T* vals,
                                     int* idx) {
  const int lane = threadIdx.x & 31;
  const bool vec = kSmem || bulk;
  walk_rows<kSmem>(x, rows, cols, bulk,
                   [&](const T* r, long long row, unsigned long long* list,
                       unsigned int*) {
                     const size_t out = static_cast<size_t>(row) * k;
                     topk::loop_row(r, cols, k, vec, lane, list, vals + out,
                                    idx + out);
                   });
}

template <bool kSmem, class T>
__global__ void row_topk_threshold_kernel(const T* __restrict__ x, int rows,
                                          int cols, int k, bool bulk,
                                          T* vals, int* idx) {
  const int lane = threadIdx.x & 31;
  const bool vec = kSmem || bulk;
  walk_rows<kSmem>(x, rows, cols, bulk,
                   [&](const T* r, long long row, unsigned long long* list,
                       unsigned int* hist) {
                     const size_t out = static_cast<size_t>(row) * k;
                     topk::threshold_row(r, cols, k, vec, lane, list, hist,
                                         vals + out, idx + out);
                   });
}

template <class T>
using KernelFn = void (*)(const T*, int, int, int, bool, T*, int*);

// How a kernel is launched on an (rows, cols) input on the current device.
template <class T>
struct Plan {
  KernelFn<T> fn;
  int warps_per_block, in_smem, blocks, smem_bytes, warps_per_sm;
};

// The row buffer in shared memory if a warp's buffer and scratch fit what
// one block may use, else the device-memory form; then the persistent
// grid: the fewest warps per block that let the most warps reside on an
// SM (row_buffer::plan_grid), and enough blocks for every row to have its
// warp, at most what the SMs hold at once.
template <class T>
cudaError_t make_plan(KernelFn<T> in_smem, KernelFn<T> in_device, int rows,
                      int cols, Plan<T>* p) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return e;
  const size_t whole = row_stride<T>(cols) + kWarpScratch;
  p->in_smem = whole <= static_cast<size_t>(optin);
  p->fn = p->in_smem ? in_smem : in_device;
  row_buffer::Grid grid;
  e = row_buffer::plan_grid(reinterpret_cast<const void*>(p->fn),
                            p->in_smem ? whole : kWarpScratch, rows, &grid);
  if (e != cudaSuccess) return e;
  p->warps_per_block = grid.warps_per_block;
  p->blocks = grid.blocks < grid.resident_blocks ? grid.blocks
                                                 : grid.resident_blocks;
  p->smem_bytes = grid.smem_bytes;
  p->warps_per_sm = grid.warps_per_sm;
  return cudaSuccess;
}

// Plans and launches on `stream`. Returns 0 (cudaSuccess) or the CUDA
// error code of the refused launch; it does not synchronise.
template <class T>
int launch(KernelFn<T> in_smem, KernelFn<T> in_device, const void* x,
           int rows, int cols, int k, void* vals, int* idx,
           cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  if (cols <= 0 || k < 1 || k > cols) return cudaErrorInvalidValue;
  Plan<T> p;
  const cudaError_t e = make_plan<T>(in_smem, in_device, rows, cols, &p);
  if (e != cudaSuccess) return e;
  const bool bulk = cols % topk::kVec<T> == 0 &&
                    (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  p.fn<<<p.blocks, 32 * p.warps_per_block, p.smem_bytes, stream>>>(
      static_cast<const T*>(x), rows, cols, k, bulk, static_cast<T*>(vals),
      idx);
  return cudaGetLastError();
}

// Writes the plan of a kernel for an (rows, cols) input on the current
// device into out: warps per block, 1 for the row buffer in shared memory
// (0: the device-memory form), blocks, shared-memory bytes per block,
// warps resident per SM.
template <class T>
int plan_of(KernelFn<T> in_smem, KernelFn<T> in_device, int rows, int cols,
            int* out) {
  if (rows <= 0 || cols <= 0) return cudaErrorInvalidValue;
  Plan<T> p;
  const cudaError_t e = make_plan<T>(in_smem, in_device, rows, cols, &p);
  if (e != cudaSuccess) return e;
  out[0] = p.warps_per_block;
  out[1] = p.in_smem;
  out[2] = p.blocks;
  out[3] = p.smem_bytes;
  out[4] = p.warps_per_sm;
  return cudaSuccess;
}

template <class T>
int plan_any(int threshold, int rows, int cols, int* out) {
  return threshold ? plan_of<T>(row_topk_threshold_kernel<true, T>,
                                row_topk_threshold_kernel<false, T>, rows,
                                cols, out)
                   : plan_of<T>(row_topk_loop_kernel<true, T>,
                                row_topk_loop_kernel<false, T>, rows, cols,
                                out);
}

}  // namespace

extern "C" int row_topk_loop_f32(const float* x, int rows, int cols, int k,
                                 float* vals, int* idx, cudaStream_t stream) {
  return launch<float>(row_topk_loop_kernel<true, float>,
                       row_topk_loop_kernel<false, float>, x, rows, cols, k,
                       vals, idx, stream);
}

extern "C" int row_topk_threshold_f32(const float* x, int rows, int cols,
                                      int k, float* vals, int* idx,
                                      cudaStream_t stream) {
  return launch<float>(row_topk_threshold_kernel<true, float>,
                       row_topk_threshold_kernel<false, float>, x, rows,
                       cols, k, vals, idx, stream);
}

// The bf16 forms: x and vals hold bf16 values (2 bytes each).
extern "C" int row_topk_loop_bf16(const void* x, int rows, int cols, int k,
                                  void* vals, int* idx, cudaStream_t stream) {
  return launch<bf16>(row_topk_loop_kernel<true, bf16>,
                      row_topk_loop_kernel<false, bf16>, x, rows, cols, k,
                      vals, idx, stream);
}

extern "C" int row_topk_threshold_bf16(const void* x, int rows, int cols,
                                       int k, void* vals, int* idx,
                                       cudaStream_t stream) {
  return launch<bf16>(row_topk_threshold_kernel<true, bf16>,
                      row_topk_threshold_kernel<false, bf16>, x, rows, cols,
                      k, vals, idx, stream);
}

// The launch plan of either kernel (the loop's when threshold == 0), at
// float32 or (bf16_rows != 0) bf16, for an (rows, cols) input on the
// current device: see plan_of.
extern "C" int row_topk_plan(int threshold, int bf16_rows, int rows,
                             int cols, int* out) {
  return bf16_rows ? plan_any<bf16>(threshold, rows, cols, out)
                   : plan_any<float>(threshold, rows, cols, out);
}
