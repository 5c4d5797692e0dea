// Systematic resample index + gather in one launch, kernel E:
//   j_k = min(#{i : K_i <= k}, N - 1),  out[k] = x[j_k].
//
// Replaces lowlevelparticlefilters_jl_tpu/ops/pallas/resample_v2.py
// (_pallas_systematic_index_gather, resample_v2.py:182, its body _kernel
// and the pallas_call at :209).  The TPU kernel has no per-lane gather, so
// it builds both outputs from windowed 0/1 MXU contractions over chunks of
// particles: a count matmul for j, four mutually exclusive indicator
// products for the gather, the f32 values split into three exact bf16
// parts, window bases aligned to 8 sublanes, and a VMEM budget that caps
// N.  None of that is ported.  Hopper gathers a row per thread, so each
// output slot finds its source by the upper-bound binary search that
// kernel B uses (slots.cuh) over the non-decreasing slot boundaries K
// (computed outside, by ops/resample.py::_systematic_slots, as the JAX
// entry computes them in XLA), writes j as int32 and copies one row.
//
// Bound on the card: memory.  Each slot reads log2(N) entries of K (the
// 400 KB of K stays in L2 at N = 1e5), writes 4 bytes of j and copies nx
// values.  Values are copied, never recomputed, so the result is bitwise
// equal to the plain (x[j], j) for f32 and f64 x alike.
#include <cuda_runtime.h>
#include <stdint.h>

#include "slots.cuh"

namespace {

template <typename T>
__global__ void index_gather_kernel(const T* __restrict__ x,
                                    const int32_t* __restrict__ K,
                                    T* __restrict__ out,
                                    int32_t* __restrict__ j_out, int64_t N,
                                    int nx) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= N) return;
  int64_t j = llpf_upper_bound(K, N, k);
  if (j > N - 1) j = N - 1;
  j_out[k] = (int32_t)j;
  for (int d = 0; d < nx; ++d) out[k * nx + d] = x[j * nx + d];
}

}  // namespace

extern "C" {

int llpf_systematic_index_gather(const void* x, const int32_t* K, void* out,
                                 int32_t* j, int64_t N, int nx, int elem_size,
                                 void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  if (N > INT32_MAX) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + 255) / 256);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_size == 4)
    index_gather_kernel<float><<<blocks, 256, 0, s>>>(
        (const float*)x, K, (float*)out, j, N, nx);
  else if (elem_size == 8)
    index_gather_kernel<double><<<blocks, 256, 0, s>>>(
        (const double*)x, K, (double*)out, j, N, nx);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
