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
// lane by lane (conflict-free in shared memory, coalesced in device
// memory), and agree on every result through warp intrinsics. A row
// pointer may point into shared or device memory.
//
// Rows are float32 (T = float) or bf16 (T = bf16, its 16 bits). Every
// helper orders by the magnitude's float32 bit pattern, as the reference's
// _mag_bits orders abs(v).astype(float32): a bf16 magnitude widens to
// float32 exactly, with its low 16 bits zero, so one key and one contract
// serve both types, and vals keep the row's type.
//
// Both kernels' sources use loop_row and threshold_row below, which read
// the row in two passes and then work on a short candidate list:
//   1. every lane's largest key; if the row's largest magnitude is 0 the
//      answer is columns 0..k-1 (every entry ties), written at once;
//   2. for k <= 32, the k-th largest of the 32 lanes' largest keys is a
//      lower bound on the row's k-th largest key (those k keys belong to
//      k distinct entries), so every key >= it is a candidate: they are
//      compacted, in column order, into a per-warp list of kListCap keys
//      (about 50-100 of a 2560-wide random row at k = 26).
// The loop select then runs its k rounds over the list (each lane holds
// its share sorted in registers, so a round is one warp max of the lanes'
// heads), 32 rounds per batch of the two passes for k > 32. The threshold
// select finds the k-th largest magnitude on the list by a radix select
// (four 8-bit digits) and takes the ties in column order; for k > 32 it
// takes the top digit's histogram over the row, after which the entries
// in the chosen bin usually fit the list. Where a list would overflow
// (rows whose large entries crowd into a few lanes), the rounds, or the
// other digits and the tie scan, read the row instead.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace topk {

constexpr unsigned int kFullMask = 0xffffffffu;

// A bf16 value as its 16 bits (sign, 8 exponent bits, 7 mantissa bits):
// the top half of the float32 it widens to.
using bf16 = uint16_t;

// |v| as its float32 bit pattern: monotone in |v| for every non-NaN v, and
// the same for -0.0 and +0.0.
__device__ __forceinline__ unsigned int mag_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}
__device__ __forceinline__ unsigned int mag_bits(bf16 v) {
  return (static_cast<unsigned int>(v) << 16) & 0x7fffffffu;
}

// Elements of T in one 16-byte load, and the radix digits a magnitude of
// T needs (bf16 magnitudes have no bits below bit 16: the digits at
// shifts 23 and 15 fix every bit).
template <class T>
constexpr int kVec = 16 / sizeof(T);
template <class T>
constexpr int kDigits = sizeof(T) == 4 ? 4 : 2;

// The magnitude bits of the kVec<T> entries of 16-byte word w, in column
// order (little-endian: a word's low half is the lower column).
__device__ __forceinline__ void word_mags(uint4 w, const float*,
                                          unsigned int (&m)[4]) {
  m[0] = w.x & 0x7fffffffu;
  m[1] = w.y & 0x7fffffffu;
  m[2] = w.z & 0x7fffffffu;
  m[3] = w.w & 0x7fffffffu;
}
__device__ __forceinline__ void word_mags(uint4 w, const bf16*,
                                          unsigned int (&m)[8]) {
  const unsigned int h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[2 * i] = (h[i] << 16) & 0x7fffffffu;
    m[2 * i + 1] = h[i] & 0x7fff0000u;
  }
}

// The 64-bit selection key (|v| bits << 32 | ~column): a larger magnitude
// wins, and on equal magnitude the lower column (larger ~column) wins.
// Every real key is above 0, since ~column >= 2^31 for column < 2^31.
__device__ __forceinline__ unsigned long long mag_key(unsigned int mag,
                                                      int j) {
  return (static_cast<unsigned long long>(mag) << 32) |
         static_cast<unsigned int>(~j);
}
template <class T>
__device__ __forceinline__ unsigned long long sel_key(T v, int j) {
  return mag_key(mag_bits(v), j);
}

// Calls f(t, key) on the keys of the kVec<T> columns of 16-byte word q of
// row r (16-byte aligned), t = 0, 1, ... in column order.
template <class T, class F>
__device__ __forceinline__ void vec_keys(const T* r, int q, F&& f) {
  unsigned int m[kVec<T>];
  word_mags(reinterpret_cast<const uint4*>(r)[q], r, m);
  const int j = q * kVec<T>;
#pragma unroll
  for (int t = 0; t < kVec<T>; ++t) f(t, mag_key(m[t], j + t));
}

// Writes the k selected entries (keys >= kth) in contract order (the
// reference's _compact_selected + _order_pairs), for k above the list's
// capacity (threshold_row). The selected columns are
// compacted in column order into the row's own `vals` slots (their int
// bits, a scratch the final pass overwrites); each one's rank among the k
// keys (O(k^2) compares) is its slot in `idx`; then `vals` takes the
// values. `vals` and `idx` are this row's k outputs in device memory,
// written and re-read only by this warp (ordered by __syncwarp).
//
// A bf16 `vals` slot cannot hold a column, so at bf16 the columns are
// compacted into `idx` instead and put in contract order there by an
// odd-even transposition sort on their keys (k phases of disjoint
// compare-exchanges, also O(k^2)), after which `vals` takes the values.
template <class T>
__device__ __forceinline__ void write_selected(const T* x, int cols, int k,
                                               unsigned long long kth,
                                               int lane, T* vals, int* idx) {
  const unsigned int below = (1u << lane) - 1u;
  int filled = 0;
  if constexpr (std::is_same<T, float>::value) {
    for (int base = 0; base < cols && filled < k; base += 32) {
      const int j = base + lane;
      const bool sel = j < cols && sel_key(x[j], j) >= kth;
      const unsigned int m = __ballot_sync(kFullMask, sel);
      if (sel) vals[filled + __popc(m & below)] = __int_as_float(j);
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
  } else {
    for (int base = 0; base < cols && filled < k; base += 32) {
      const int j = base + lane;
      const bool sel = j < cols && sel_key(x[j], j) >= kth;
      const unsigned int m = __ballot_sync(kFullMask, sel);
      if (sel) idx[filled + __popc(m & below)] = j;
      filled += __popc(m);
    }
    __syncwarp();
    for (int phase = 0; phase < k; ++phase) {
      for (int i = (phase & 1) + 2 * lane; i + 1 < k; i += 64) {
        const int a = idx[i], b = idx[i + 1];
        if (sel_key(x[b], b) > sel_key(x[a], a)) {
          idx[i] = b;
          idx[i + 1] = a;
        }
      }
      __syncwarp();
    }
  }
  __syncwarp();
  for (int s = lane; s < k; s += 32) vals[s] = x[idx[s]];
}

// ---------------------------------------------------------------------
// The per-row selects of topk_select.cu. A lane's share of a row is read
// with 16-byte loads when `vec` (the row pointer 16-byte aligned): the
// lane owns columns nq..nq+n-1 (n = kVec<T>: 4 float32 or 8 bf16) for
// every q = lane (mod 32) below cols / n, then column j of the (cols % n)
// tail for j = lane (mod 32). Without `vec` it owns every column j = lane
// (mod 32). Either way the lanes' shares partition the row.

constexpr int kListCap = 256;   // a warp's candidate list, 64-bit keys
constexpr int kHistBins = 256;  // a warp's radix histogram, 8-bit digits

__device__ __forceinline__ unsigned long long max_key(unsigned long long a,
                                                      unsigned long long b) {
  return a > b ? a : b;
}

// The warp-wide max of a key as two 32-bit reductions (one REDUX each):
// the largest magnitude bits, then the largest ~column among the lanes
// that hold them: the same as a max over 64-bit shuffles, in fewer
// instructions.
__device__ __forceinline__ unsigned long long warp_max_redux(
    unsigned long long v) {
  const unsigned int hi = static_cast<unsigned int>(v >> 32);
  const unsigned int top = __reduce_max_sync(kFullMask, hi);
  const unsigned int lo = __reduce_max_sync(
      kFullMask, hi == top ? static_cast<unsigned int>(v) : 0u);
  return (static_cast<unsigned long long>(top) << 32) | lo;
}

__device__ __forceinline__ int key_column(unsigned long long key) {
  return static_cast<int>(~static_cast<unsigned int>(key));
}

// Calls f(key) on the key of each entry of the lane's share, column
// increasing.
template <class T, class F>
__device__ __forceinline__ void for_lane(const T* r, int cols, bool vec,
                                         int lane, F&& f) {
  int tail = 0;
  if (vec) {
    const int nv = cols / kVec<T>;
    for (int q = lane; q < nv; q += 32) {
      vec_keys(r, q, [&](int, unsigned long long key) { f(key); });
    }
    tail = nv * kVec<T>;
  }
  for (int j = tail + lane; j < cols; j += 32) f(sel_key(r[j], j));
}

// The lane's largest key (0, below every real key, if its share is
// empty). Four running maxima, one per float32 of a 16-byte word, so that
// the compares do not wait on each other.
template <class T>
__device__ __forceinline__ unsigned long long lane_max_key(const T* r,
                                                           int cols, bool vec,
                                                           int lane) {
  unsigned long long b[4] = {0, 0, 0, 0};
  int tail = 0;
  if (vec) {
    const int nv = cols / kVec<T>;
    for (int q = lane; q < nv; q += 32) {
      vec_keys(r, q, [&](int t, unsigned long long key) {
        b[t & 3] = max_key(b[t & 3], key);
      });
    }
    tail = nv * kVec<T>;
  }
  for (int j = tail + lane; j < cols; j += 32) {
    b[0] = max_key(b[0], sel_key(r[j], j));
  }
  return max_key(max_key(b[0], b[1]), max_key(b[2], b[3]));
}

// A lower bound on the row's k-th largest key, for k <= 32: the k-th
// largest of the 32 lanes' largest keys. Those k keys belong to k distinct
// entries, so at least k keys of the row are >= it. Returns 0 (no bound)
// when fewer than k lanes hold an entry (a row of fewer than 32 16-byte
// words).
__device__ __forceinline__ unsigned long long lane_bound(
    unsigned long long mine, int k) {
  if (__popc(__ballot_sync(kFullMask, mine != 0ull)) < k) return 0ull;
  int rank = 0;  // lanes whose key is larger; real keys are distinct
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    rank += __shfl_sync(kFullMask, mine, t) > mine;
  }
  const unsigned int at =
      __ballot_sync(kFullMask, mine != 0ull && rank == k - 1);
  return __shfl_sync(kFullMask, mine, __ffs(at) - 1);
}

// Appends the key of every entry for which keep(key) holds to `list`, in
// COLUMN order (ballot and popc per chunk), storing the first `cap`.
// Returns how many entries were kept, which may exceed `cap`.
template <class T, class Keep>
__device__ __forceinline__ int compact_row(const T* r, int cols, bool vec,
                                           int lane, Keep&& keep,
                                           unsigned long long* list,
                                           int cap) {
  constexpr int n_vec = kVec<T>;
  const unsigned int below = (1u << lane) - 1u;
  int filled = 0;
  int tail = 0;
  if (vec) {
    const int nv = cols / n_vec;
    for (int q0 = 0; q0 < nv; q0 += 32) {
      const int q = q0 + lane;
      unsigned long long key[n_vec];
      bool s[n_vec];
      unsigned int n = 0;
#pragma unroll
      for (int t = 0; t < n_vec; ++t) {
        key[t] = 0;
        s[t] = false;
      }
      if (q < nv) {
        vec_keys(r, q, [&](int t, unsigned long long kt) {
          key[t] = kt;
          s[t] = keep(kt);
          n += s[t];
        });
      }
      // the lane's count (0 to n_vec) as one ballot per bit: its prefix
      // over the lower lanes places the lane's entries after theirs
      int at = filled, total = 0;
#pragma unroll
      for (int b = 0; (1 << b) <= n_vec; ++b) {
        const unsigned int m = __ballot_sync(kFullMask, n & (1u << b));
        at += (1 << b) * __popc(m & below);
        total += (1 << b) * __popc(m);
      }
      if (total == 0) continue;
#pragma unroll
      for (int t = 0; t < n_vec; ++t) {
        if (s[t]) {
          if (at < cap) list[at] = key[t];
          ++at;
        }
      }
      filled += total;
    }
    tail = nv * n_vec;
  }
  for (int base = tail; base < cols; base += 32) {
    const int j = base + lane;
    unsigned long long key = 0;
    bool s = false;
    if (j < cols) {
      key = sel_key(r[j], j);
      s = keep(key);
    }
    const unsigned int m = __ballot_sync(kFullMask, s);
    const int at = filled + __popc(m & below);
    if (s && at < cap) list[at] = key;
    filled += __popc(m);
  }
  __syncwarp();
  return filled;
}

// Writes columns 0..k-1 with their own (signed zero) values: the answer
// for a row whose magnitudes are all 0, where every entry ties.
template <class T>
__device__ __forceinline__ void write_leading(const T* r, int k, int lane,
                                              T* vals, int* idx) {
  for (int i = lane; i < k; i += 32) {
    vals[i] = r[i];
    idx[i] = i;
  }
}

// Lane i (< 32) holds the key of output slot r0 + i; lanes below n write
// their pair (the value read back from the row, so it keeps its sign).
template <class T>
__device__ __forceinline__ void write_slots(const T* r, int r0, int n,
                                            unsigned long long mine,
                                            int lane, T* vals, int* idx) {
  if (lane < n) {
    const int j = key_column(mine);
    vals[r0 + lane] = r[j];
    idx[r0 + lane] = j;
  }
}

// kb (<= 32) rounds of the loop select over a candidate list: a
// warp-wide max over the n keys of `list` (all below `prev`, at least kb
// of them), each round taking the largest key below the winner before
// it. Each lane first sorts its keys (list[lane], list[lane + 32], ...,
// at most kSlots of them) in registers, largest first, so that a round is
// one warp max over the lanes' heads, after which the winner's lane drops
// its head. Lane t keeps round t's key; returns the last round's.
template <int kSlots>
__device__ __forceinline__ unsigned long long loop_rounds_slots(
    const unsigned long long* list, int n, int kb, int lane,
    unsigned long long prev, unsigned long long& mine) {
  unsigned long long c[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    c[i] = lane + 32 * i < n ? list[lane + 32 * i] : 0ull;
  }
#pragma unroll
  for (int phase = 0; phase < kSlots; ++phase) {  // odd-even transposition
#pragma unroll
    for (int i = phase & 1; i + 1 < kSlots; i += 2) {
      const unsigned long long hi = max_key(c[i], c[i + 1]);
      c[i + 1] = c[i] ^ c[i + 1] ^ hi;
      c[i] = hi;
    }
  }
  for (int t = 0; t < kb; ++t) {
    prev = warp_max_redux(c[0]);
    if (lane == t) mine = prev;
    if (c[0] == prev) {  // one lane: the keys are distinct and nonzero
#pragma unroll
      for (int i = 0; i + 1 < kSlots; ++i) c[i] = c[i + 1];
      c[kSlots - 1] = 0ull;
    }
  }
  return prev;
}

// loop_rounds_slots with as few slots a lane as the list's n keys need
// (a short list, as at k = 10 of a 1024-wide row, skips most of the sort
// and of each round's shift).
__device__ __forceinline__ unsigned long long loop_rounds_list(
    const unsigned long long* list, int n, int kb, int lane,
    unsigned long long prev, unsigned long long& mine) {
  if (n <= 32) return loop_rounds_slots<1>(list, n, kb, lane, prev, mine);
  if (n <= 64) return loop_rounds_slots<2>(list, n, kb, lane, prev, mine);
  if (n <= 128) return loop_rounds_slots<4>(list, n, kb, lane, prev, mine);
  return loop_rounds_slots<kListCap / 32>(list, n, kb, lane, prev, mine);
}

// The largest key below `prev` in the lane's share (0 if none): four
// running maxima, as lane_max_key.
template <class T>
__device__ __forceinline__ unsigned long long lane_max_below(
    const T* r, int cols, bool vec, int lane, unsigned long long prev) {
  unsigned long long b[4] = {0, 0, 0, 0};
  auto take = [prev](unsigned long long& bt, unsigned long long key) {
    if (key < prev && key > bt) bt = key;
  };
  int tail = 0;
  if (vec) {
    const int nv = cols / kVec<T>;
    for (int q = lane; q < nv; q += 32) {
      vec_keys(r, q,
               [&](int t, unsigned long long key) { take(b[t & 3], key); });
    }
    tail = nv * kVec<T>;
  }
  for (int j = tail + lane; j < cols; j += 32) take(b[0], sel_key(r[j], j));
  return max_key(max_key(b[0], b[1]), max_key(b[2], b[3]));
}

// Rounds r0 .. r0+kb-1 (kb <= 32) of the loop select over the whole row
// (a candidate list too long for its buffer), from `prev`, the winner of
// round r0-1: each round reads the row once. Lane t keeps round r0+t's
// key; returns the last round's.
template <class T>
__device__ __forceinline__ unsigned long long loop_rounds_row(
    const T* r, int cols, int kb, bool vec, int lane,
    unsigned long long prev, unsigned long long& mine) {
  for (int t = 0; t < kb; ++t) {
    prev = warp_max_redux(lane_max_below(r, cols, vec, lane, prev));
    if (lane == t) mine = prev;
  }
  return prev;
}

// Radix select of the k-th largest magnitude bit pattern: 8-bit digits
// of the 31 magnitude bits from the top (shifts 23, 15, 7, 0; the last
// digit's top bit is already fixed by the one before; a bf16 magnitude
// is fixed after the first two, kDigits). `prefix` holds the
// digits found, `mask` their bits, `need` how many entries are still to
// be taken at the prefix, `n_gt` how many lie above it.
struct Radix {
  unsigned int prefix, mask;
  int need, n_gt;
};

// The shift of digit d, top first: 23, 15, 7, 0.
__device__ __forceinline__ int digit_shift(int d) {
  return d < 3 ? 23 - 8 * d : 0;
}

// One digit at `shift`: a histogram, in the warp's 256 shared bins, of the
// digit of every entry that matches the prefix (visit(f) calls f(bits) on
// the lane's entries), then the bin in which the need-th largest entry
// lies. Returns that bin's count.
template <class Visit>
__device__ __forceinline__ int radix_digit(Radix& st, int shift,
                                           unsigned int* hist, int lane,
                                           Visit&& visit) {
  uint4* h4 = reinterpret_cast<uint4*>(hist);
  h4[2 * lane] = make_uint4(0u, 0u, 0u, 0u);
  h4[2 * lane + 1] = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();
  const unsigned int prefix = st.prefix, mask = st.mask;
  visit([&](unsigned int bits) {
    if ((bits & mask) == prefix) {
      atomicAdd(&hist[(bits >> shift) & 0xffu], 1u);
    }
  });
  __syncwarp();
  // lane l reads bins 255-8l down to 248-8l: lane 0 holds the top bins
  const uint4 hi = h4[2 * (31 - lane) + 1];
  const uint4 lo = h4[2 * (31 - lane)];
  const int c[8] = {static_cast<int>(hi.w), static_cast<int>(hi.z),
                    static_cast<int>(hi.y), static_cast<int>(hi.x),
                    static_cast<int>(lo.w), static_cast<int>(lo.z),
                    static_cast<int>(lo.y), static_cast<int>(lo.x)};
  int total = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) total += c[t];
  int upto = total;  // entries in this lane's bins and every higher bin
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFullMask, upto, off);
    if (lane >= off) upto += o;
  }
  const int above = upto - total;
  const unsigned int at =
      __ballot_sync(kFullMask, above < st.need && st.need <= upto);
  const int src = __ffs(at) - 1;
  int bin = 0, over = 0, count = 0;
  if (lane == src) {
    int acc = above;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (count == 0 && acc + c[t] >= st.need) {
        bin = 255 - 8 * lane - t;
        over = acc;
        count = c[t];
      }
      acc += c[t];
    }
  }
  bin = __shfl_sync(kFullMask, bin, src);
  over = __shfl_sync(kFullMask, over, src);
  count = __shfl_sync(kFullMask, count, src);
  st.prefix |= static_cast<unsigned int>(bin) << shift;
  st.mask |= 0xffu << shift;
  st.n_gt += over;
  st.need -= over;
  __syncwarp();  // every lane has read the bins before they are cleared
  return count;
}

// The key of the need-th entry, in column order, among the entries of a
// column-ordered key list whose magnitude bits equal tau (the last tie
// the selection takes): the selection is exactly the keys >= it.
__device__ __forceinline__ unsigned long long tie_key_list(
    const unsigned long long* list, int n, unsigned int tau, int need,
    int lane) {
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const unsigned long long key = i < n ? list[i] : 0ull;
    unsigned int m = __ballot_sync(
        kFullMask, i < n && static_cast<unsigned int>(key >> 32) == tau);
    const int c = __popc(m);
    if (need <= c) {
      for (int t = 1; t < need; ++t) m &= m - 1;  // drop the first need-1
      return __shfl_sync(kFullMask, key, __ffs(m) - 1);
    }
    need -= c;
  }
  return 0ull;  // not reached: the list holds at least need ties
}

// The same over the row itself, 32 columns at a time in column order.
template <class T>
__device__ __forceinline__ unsigned long long tie_key_row(
    const T* r, int cols, unsigned int tau, int need, int lane) {
  for (int base = 0; base < cols; base += 32) {
    const int j = base + lane;
    unsigned int m =
        __ballot_sync(kFullMask, j < cols && mag_bits(r[j]) == tau);
    const int c = __popc(m);
    if (need <= c) {
      for (int t = 1; t < need; ++t) m &= m - 1;
      const int jc = base + __ffs(m) - 1;
      return (static_cast<unsigned long long>(tau) << 32) |
             static_cast<unsigned int>(~jc);
    }
    need -= c;
  }
  return 0ull;  // not reached for 1 <= k <= cols
}

// Keeps the keys >= kth of a column-ordered list at its front, in order.
__device__ __forceinline__ void keep_list(unsigned long long* list, int n,
                                          unsigned long long kth, int lane) {
  const unsigned int below = (1u << lane) - 1u;
  int filled = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const unsigned long long key = i < n ? list[i] : 0ull;
    const bool s = i < n && key >= kth;
    const unsigned int m = __ballot_sync(kFullMask, s);
    __syncwarp();  // the chunk is read before any slot of it is written
    if (s) list[filled + __popc(m & below)] = key;
    filled += __popc(m);
  }
  __syncwarp();
}

// Writes the k keys of `list` (k <= kListCap) in contract order: each
// key's rank among the k (O(k^2) compares of keys in shared memory) is its
// output slot; the value is read back from the row.
template <class T>
__device__ __forceinline__ void write_ranked(const unsigned long long* list,
                                             int k, const T* r, int lane,
                                             T* vals, int* idx) {
  for (int i = lane; i < k; i += 32) {
    const unsigned long long key = list[i];
    int rank = 0;
    for (int t = 0; t < k; ++t) rank += list[t] > key;
    const int j = key_column(key);
    vals[rank] = r[j];
    idx[rank] = j;
  }
}

// True when every magnitude of the row is 0 (the lanes' largest keys
// carry the largest magnitude in their top half).
__device__ __forceinline__ bool all_zero(unsigned long long mine) {
  return __reduce_max_sync(kFullMask,
                           static_cast<unsigned int>(mine >> 32)) == 0u;
}

// The loop select of one row into (vals, idx) (k pairs), 32 rounds at a
// time. Per batch of kb = min(32, rounds left) rounds below `prev` (the
// last winner so far):
//   pass 1: every lane's largest key below prev (for the first batch, an
//     all-zero row is answered here);
//   pass 2: the keys in [the lanes' bound for kb, prev) (lane_bound) go
//     to the candidate list;
//   then kb rounds of the warp max over the list, or, if the list would
//   overflow, over the row (loop_rounds_row).
// Returns the last winner, the k-th selected key (the same in every
// lane), as threshold_row does: the selection is exactly the row's keys
// >= it. For an all-zero row that is column k-1's key at magnitude 0.
template <class T>
__device__ __forceinline__ unsigned long long loop_row(
    const T* r, int cols, int k, bool vec, int lane,
    unsigned long long* list, T* vals, int* idx) {
  unsigned long long prev = ~0ull;
  for (int r0 = 0; r0 < k; r0 += 32) {
    const int kb = min(32, k - r0);
    const unsigned long long top =
        r0 == 0 ? lane_max_key(r, cols, vec, lane)
                : lane_max_below(r, cols, vec, lane, prev);
    if (r0 == 0 && all_zero(top)) {
      write_leading(r, k, lane, vals, idx);
      return static_cast<unsigned int>(~(k - 1));
    }
    const unsigned long long bound = lane_bound(top, kb);
    const int n =
        r0 == 0 ? compact_row(
                      r, cols, vec, lane,
                      [bound](unsigned long long key) { return key >= bound; },
                      list, kListCap)
                : compact_row(
                      r, cols, vec, lane,
                      [bound, prev](unsigned long long key) {
                        return key >= bound && key < prev;
                      },
                      list, kListCap);
    unsigned long long mine = 0ull;
    prev = n <= kListCap
               ? loop_rounds_list(list, n, kb, lane, prev, mine)
               : loop_rounds_row(r, cols, kb, vec, lane, prev, mine);
    write_slots(r, r0, kb, mine, lane, vals, idx);
    __syncwarp();  // the list is read before it is refilled
  }
  return prev;
}

// The threshold select of one row into (vals, idx) (k pairs).
//   pass 1: every lane's largest key; an all-zero row is answered here;
//   k <= 32: pass 2 fills the candidate list (as loop_row), and the radix
//     select (kDigits digits), the tie scan and the ordering run on the
//     list;
//   otherwise, or if the list would overflow: the top digit's histogram
//     over the row, then the entries in its chosen bin compacted to the
//     list if they fit (else the other digits and the tie scan read the
//     row), then one pass compacts the k selected keys to the list.
// k > kListCap orders the k pairs through (vals, idx) in device memory
// (write_selected), as the list cannot hold them.
// Returns the k-th selected key (the same in every lane): the selection is
// exactly the row's keys >= it, as loop_row's last winner is. For an
// all-zero row that is column k-1's key at magnitude 0.
template <class T>
__device__ __forceinline__ unsigned long long threshold_row(
    const T* r, int cols, int k, bool vec, int lane,
    unsigned long long* list, unsigned int* hist, T* vals, int* idx) {
  const unsigned long long mine = lane_max_key(r, cols, vec, lane);
  if (all_zero(mine)) {
    write_leading(r, k, lane, vals, idx);
    return static_cast<unsigned int>(~(k - 1));
  }
  Radix st = {0u, 0u, k, 0};
  int n = 0;
  auto visit_list = [&](auto&& f) {
    for (int i = lane; i < n; i += 32) {
      f(static_cast<unsigned int>(list[i] >> 32));
    }
  };
  if (k <= 32) {
    const unsigned long long bound = lane_bound(mine, k);
    n = compact_row(
        r, cols, vec, lane,
        [bound](unsigned long long key) { return key >= bound; }, list,
        kListCap);
    if (n <= kListCap) {
      for (int d = 0; d < kDigits<T>; ++d) {
        radix_digit(st, digit_shift(d), hist, lane, visit_list);
      }
      const unsigned long long kth =
          tie_key_list(list, n, st.prefix, st.need, lane);
      keep_list(list, n, kth, lane);
      write_ranked(list, k, r, lane, vals, idx);
      __syncwarp();
      return kth;
    }
  }
  auto visit_row = [&](auto&& f) {
    for_lane(r, cols, vec, lane, [&](unsigned long long key) {
      f(static_cast<unsigned int>(key >> 32));
    });
  };
  const int top = radix_digit(st, digit_shift(0), hist, lane, visit_row);
  unsigned long long kth;
  if (top <= kListCap) {
    const unsigned int digit = st.prefix;
    n = compact_row(
        r, cols, vec, lane,
        [digit](unsigned long long key) {
          return (static_cast<unsigned int>(key >> 32) & 0x7f800000u) ==
                 digit;
        },
        list, kListCap);
    for (int d = 1; d < kDigits<T>; ++d) {
      radix_digit(st, digit_shift(d), hist, lane, visit_list);
    }
    kth = tie_key_list(list, n, st.prefix, st.need, lane);
  } else {
    for (int d = 1; d < kDigits<T>; ++d) {
      radix_digit(st, digit_shift(d), hist, lane, visit_row);
    }
    kth = tie_key_row(r, cols, st.prefix, st.need, lane);
  }
  __syncwarp();
  if (k <= kListCap) {
    compact_row(
        r, cols, vec, lane,
        [kth](unsigned long long key) { return key >= kth; }, list,
        kListCap);
    write_ranked(list, k, r, lane, vals, idx);
    __syncwarp();
  } else {
    write_selected(r, cols, k, kth, lane, vals, idx);
  }
  return kth;
}

}  // namespace topk
