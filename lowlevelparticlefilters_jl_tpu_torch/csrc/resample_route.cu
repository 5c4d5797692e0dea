// Systematic resample + gather: out[k] = x[j_k], j_k = #{i : K_i <= k}.
//
// Replaces lowlevelparticlefilters_jl_tpu/ops/pallas/resample_route.py
// (_standalone_kernel, resample_route.py:302, and the route_systematic /
// _route / _forward_fill / hs_cumsum phases it calls).  The TPU kernel has
// no scatter and no per-lane gather, so it moves every particle through
// three log-depth shift phases over an [8, NL] plane layout.  Hopper has
// both, so neither the plane layout nor the shift phases are ported: each
// output slot finds its source by an upper-bound binary search of the
// non-decreasing slot boundaries K (computed outside, by the plain
// ops/resample.py::_systematic_slots, as the JAX package computes them in
// XLA) and copies one row.
//
// Bound on the card: memory.  Each slot reads log2(N) entries of K (17 at
// N = 1e5; the 400 KB of K stays in L2) and copies nx values.  The search
// is balanced whatever the weights, which per-particle run writes are not
// (one heavy particle would own a long run).  Values are copied, never
// recomputed, so the result is bitwise equal to the plain gather.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t upper_bound(const int32_t* __restrict__ K,
                                               int64_t n, int64_t k) {
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

template <typename T>
__global__ void systematic_gather_kernel(const T* __restrict__ x,
                                         const int32_t* __restrict__ K,
                                         T* __restrict__ out, int64_t N,
                                         int nx) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= N) return;
  int64_t j = upper_bound(K, N, k);
  if (j > N - 1) j = N - 1;
  for (int d = 0; d < nx; ++d) out[k * nx + d] = x[j * nx + d];
}

}  // namespace

extern "C" {

int llpf_systematic_gather(const void* x, const int32_t* K, void* out,
                           int64_t N, int nx, int elem_size, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((N + 255) / 256);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_size == 4)
    systematic_gather_kernel<float><<<blocks, 256, 0, s>>>(
        (const float*)x, K, (float*)out, N, nx);
  else if (elem_size == 8)
    systematic_gather_kernel<double><<<blocks, 256, 0, s>>>(
        (const double*)x, K, (double*)out, N, nx);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
