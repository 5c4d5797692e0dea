// The slot search shared by the systematic gathers (kernels B and E).
#pragma once

#include <stdint.h>

// #{i < n : K_i <= k} for non-decreasing slot boundaries K: the source
// particle of output slot k (before the clip to n - 1).
__device__ __forceinline__ int64_t llpf_upper_bound(
    const int32_t* __restrict__ K, int64_t n, int64_t k) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)K[mid] <= k)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}
