// Device math shared by the port's per-row top-|.|-k kernels
// (fused_memsgd.cu, topk_select.cu).
//
// Every top-k of the repository has one output contract: for each row, the
// k entries of largest |v|, written in decreasing |v|, magnitude ties to the
// LOWEST column, values keeping their sign. The contract fixes the output
// uniquely, so every exact algorithm below agrees bit for bit with the
// plain version (the iterative argmax) whatever steps it takes.
//
// All helpers are per warp: the 32 lanes of one warp own one row, read it
// with a lane stride of 1 (conflict-free in shared memory, coalesced in
// device memory), and agree on every result through warp intrinsics. A row
// pointer may point into shared or device memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace topk {

constexpr unsigned int kFullMask = 0xffffffffu;

// |v| as its float32 bit pattern: monotone in |v| for every non-NaN v, and
// the same for -0.0 and +0.0.
__device__ __forceinline__ unsigned int mag_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// The 64-bit selection key (|v| bits << 32 | ~column): a larger magnitude
// wins, and on equal magnitude the lower column (larger ~column) wins.
// Every real key is above 0, since ~column >= 2^31 for column < 2^31.
__device__ __forceinline__ unsigned long long sel_key(float v, int j) {
  return (static_cast<unsigned long long>(mag_bits(v)) << 32) |
         static_cast<unsigned int>(~j);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFullMask, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// The loop select (the reference's _topk_loop): k rounds of a warp-wide
// max over the keys, round r taking the largest key below round r-1's
// winner, so no entry is marked or rewritten. Lane 0 writes the pairs in
// contract order. Returns the last winner's key: the selected set is
// exactly the keys >= it. O(k * C) reads of the row.
__device__ __forceinline__ unsigned long long loop_select(
    const float* x, int cols, int k, int lane, float* vals, int* idx) {
  unsigned long long prev = ~0ull;
  for (int r = 0; r < k; ++r) {
    unsigned long long best = 0ull;  // below every real key
    for (int j = lane; j < cols; j += 32) {
      const unsigned long long key = sel_key(x[j], j);
      if (key < prev && key > best) best = key;
    }
    best = warp_max(best);
    if (lane == 0) {
      const int j = static_cast<int>(~static_cast<unsigned int>(best));
      vals[r] = x[j];
      idx[r] = j;
    }
    prev = best;
  }
  return prev;
}

// The k-th largest |x| bit pattern of the row (the reference's
// _kth_largest_bits): the largest t with count(mag_bits >= t) >= k, for
// 1 <= k <= cols. Bisection over [0, max bits]; count(bits >= 0) = cols
// >= k holds from the start, and the loop stops once the interval closes
// (at most 31 halvings, as the magnitude bits are below 2^31).
__device__ __forceinline__ unsigned int kth_largest_bits(const float* x,
                                                         int cols, int k,
                                                         int lane) {
  unsigned int hi = 0;
  for (int j = lane; j < cols; j += 32) hi = max(hi, mag_bits(x[j]));
  hi = __reduce_max_sync(kFullMask, hi);
  unsigned int lo = 0;
  while (lo < hi) {
    const unsigned int mid = lo + ((hi - lo + 1) >> 1);
    int cnt = 0;
    for (int j = lane; j < cols; j += 32) cnt += mag_bits(x[j]) >= mid;
    cnt = __reduce_add_sync(kFullMask, cnt);
    if (cnt >= k) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The selection mask as one key (the reference's _select_mask): every
// entry with bits > tau is selected, and of the ties (bits == tau) the
// first k - n_gt in COLUMN order. Returns the key of the last selected
// tie, so that the selected set is exactly the keys >= it. The tie is found
// by an ordered prefix count over 32-column chunks (ballot, popc): chunk by
// chunk in column order, not per lane, so the ties are taken in the row's
// order whichever lane holds them.
__device__ __forceinline__ unsigned long long threshold_key(const float* x,
                                                            int cols, int k,
                                                            unsigned int tau,
                                                            int lane) {
  int n_gt = 0;
  for (int j = lane; j < cols; j += 32) n_gt += mag_bits(x[j]) > tau;
  int need = k - __reduce_add_sync(kFullMask, n_gt);  // >= 1 by tau's choice
  for (int base = 0; base < cols; base += 32) {
    const int j = base + lane;
    const bool tie = j < cols && mag_bits(x[j]) == tau;
    unsigned int m = __ballot_sync(kFullMask, tie);
    const int c = __popc(m);
    if (need <= c) {
      for (int t = 1; t < need; ++t) m &= m - 1;  // drop the first need-1
      const int jc = base + __ffs(m) - 1;
      return (static_cast<unsigned long long>(tau) << 32) |
             static_cast<unsigned int>(~jc);
    }
    need -= c;
  }
  return 0ull;  // not reached for 1 <= k <= cols
}

// Writes the k selected entries (keys >= kth) in contract order (the
// reference's _compact_selected + _order_pairs). The selected columns are
// compacted in column order into the row's own `vals` slots (their int
// bits, a scratch the final pass overwrites); each one's rank among the k
// keys (O(k^2) compares) is its slot in `idx`; then `vals` takes the
// values. `vals` and `idx` are this row's k outputs in device memory,
// written and re-read only by this warp (ordered by __syncwarp).
__device__ __forceinline__ void write_selected(const float* x, int cols,
                                               int k, unsigned long long kth,
                                               int lane, float* vals,
                                               int* idx) {
  int filled = 0;
  for (int base = 0; base < cols && filled < k; base += 32) {
    const int j = base + lane;
    const bool sel = j < cols && sel_key(x[j], j) >= kth;
    const unsigned int m = __ballot_sync(kFullMask, sel);
    if (sel) {
      vals[filled + __popc(m & ((1u << lane) - 1u))] = __int_as_float(j);
    }
    filled += __popc(m);
  }
  __syncwarp();
  for (int i = lane; i < k; i += 32) {
    const int ji = __float_as_int(vals[i]);
    const unsigned long long ki = sel_key(x[ji], ji);
    int rank = 0;
    for (int t = 0; t < k; ++t) {
      const int jt = __float_as_int(vals[t]);
      rank += sel_key(x[jt], jt) > ki;
    }
    idx[rank] = ji;
  }
  __syncwarp();
  for (int s = lane; s < k; s += 32) vals[s] = x[idx[s]];
}

}  // namespace topk
