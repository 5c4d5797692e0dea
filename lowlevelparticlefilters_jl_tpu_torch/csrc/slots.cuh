// The merge of slot boundaries and output slots that kernel B
// (csrc/resample_route.cu) splits among its blocks and threads.
//
// Systematic resampling gives particle i the output slots [K_{i-1}, K_i)
// of n slots, for non-decreasing boundaries K in [0, n]; slot k's source
// is j_k = #{i : K_i <= k}.  Merge the n boundaries with the n slots
// 0..n-1, boundary i before slot k iff K_i <= k: boundary i then sits at
// merged position i + K_i and slot k at k + j_k, and slot k's source is
// the number of boundaries merged before it.  The first d merged items
// hold split(d) = #{i : i + K_i < d} boundaries and d - split(d) slots;
// i + K_i rises strictly with i, so split(d) is a search.
#pragma once

#include <stdint.h>

// split(d) for the boundaries K[0..n), by one warp: each round the 32
// lanes probe the ends of 32 equal sub-ranges of the candidates and a
// ballot keeps the sub-range that holds the first boundary not merged
// before d, so a search of n candidates takes ceil(log32 n) + 1 rounds of
// loads (4 at n = 1e5, 6 at n = 2^25) where a binary search takes
// log2 n dependent ones.  Every lane of the warp calls it and gets the
// answer.
__device__ __forceinline__ int64_t llpf_split_warp(
    const int32_t* __restrict__ K, int64_t n, int64_t d) {
  const int lane = threadIdx.x & 31;
  int64_t lo = d > n ? d - n : 0;  // the answer lies in [lo, hi]
  int64_t hi = d < n ? d : n;
  while (lo < hi) {
    const int64_t s = (hi - lo + 31) >> 5;
    const int64_t p = lo + lane * s + s - 1;
    const bool merged = p < hi && p + (int64_t)__ldg(K + p) < d;
    const int c = __popc(__ballot_sync(0xffffffffu, merged));
    lo += c * s;
    const int64_t end = lo + s - 1;
    hi = end < hi ? end : hi;
  }
  return lo;
}

// split(d) within a block's share, from its boundaries in shared memory:
// the first local i in [lo, hi] with (Ks[i] - s0) + i >= d (Ks[i] = K_{i0+i},
// s0 the block's first slot, d a local diagonal).
__device__ __forceinline__ int llpf_split_local(const int32_t* Ks, int s0,
                                                int lo, int hi, int d) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((Ks[mid] - s0) + mid < d)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}
