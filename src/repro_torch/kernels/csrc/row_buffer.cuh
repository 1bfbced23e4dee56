// What the port's per-row kernels share (fused_memsgd.cu, topk_select.cu):
// a warp owns a row buffer in shared memory, followed by its scratch; lane
// 0 brings a row in by one asynchronous bulk copy (TMA's one-dimensional
// form, cp.async.bulk ... mbarrier::complete_tx::bytes) that an mbarrier
// tracks. The launch plan sizes the blocks to the card from the occupancy
// calculator.
//
// A bulk copy needs 16-byte aligned addresses and a size that is a
// multiple of 16: the callers take it only for rows that are (C a
// multiple of 4 float32 or 8 bf16 values, and the tensor 16-byte
// aligned), and row buffers start 16-byte aligned.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace row_buffer {

// A row buffer's size: the row's bytes (cols values of T) rounded up to
// 16.
template <class T>
__host__ __device__ __forceinline__ size_t row_stride(int cols) {
  return (static_cast<size_t>(cols) * sizeof(T) + 15) & ~size_t{15};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Lane 0 initialises an mbarrier that one arrival (with its bytes)
// completes, and fences the initialisation before first use.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Lane 0 copies `bytes` from src to dst; bar completes when they landed.
// The proxy fence orders the warp's earlier reads of dst (made visible by
// the caller's __syncwarp) before the asynchronous copy overwrites it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Every lane waits until bar's phase `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

constexpr int kMaxWarpsPerBlock = 8;

// How a kernel is launched: warps per block, blocks (a warp for every
// row), dynamic shared memory per block, warps resident per SM, and the
// blocks the SMs hold at once (a persistent kernel launches no more).
struct Grid {
  int warps_per_block, blocks, smem_bytes, warps_per_sm, resident_blocks;
};

// The grid of kernel `fn` whose warps each need `per_warp` bytes of
// shared memory, over `rows` rows: the fewest warps per block (up to
// kMaxWarpsPerBlock) that let the most warps reside on an SM, as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor counts them (shared
// memory, registers, the SM's block and warp limits). Fails if one warp's
// bytes exceed what a block may use.
inline cudaError_t plan_grid(const void* fn, size_t per_warp, int rows,
                             Grid* p) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return e;
  if (per_warp > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin);
  if (e != cudaSuccess) return e;
  int best = 0, best_warps = 0, best_blocks = 0;
  for (int w = 1; w <= kMaxWarpsPerBlock; ++w) {
    const size_t smem = w * per_warp;
    if (smem > static_cast<size_t>(optin)) break;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 32 * w,
                                                      smem);
    if (e != cudaSuccess) return e;
    if (per_sm * w > best) {
      best = per_sm * w;
      best_warps = w;
      best_blocks = per_sm;
    }
  }
  if (best == 0) return cudaErrorInvalidConfiguration;
  p->warps_per_block = best_warps;
  p->smem_bytes = static_cast<int>(best_warps * per_warp);
  p->warps_per_sm = best;
  p->blocks = static_cast<int>((static_cast<long long>(rows) + best_warps -
                                1) / best_warps);
  p->resident_blocks = sms * best_blocks;
  return cudaSuccess;
}

}  // namespace row_buffer
