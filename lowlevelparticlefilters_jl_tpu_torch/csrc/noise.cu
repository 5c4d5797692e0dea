// Gaussian noise kernels for the particle filter.
//
// Replaces lowlevelparticlefilters_jl_tpu/ops/pallas/noise.py:
//   llpf_normal             <- _normal_kernel (pallas_normal), noise.py:70
//   llpf_add_gaussian_noise <- the propagate_gaussian kernel, noise.py:171,
//                              in its xn form (propagate.cuh): f(x) comes
//                              from PyTorch; the compiled form, with the
//                              dynamics in the kernel, is built per filter
// The TPU kernels draw hardware PRNG bits; these draw Philox4x32-10
// (philox.cuh), so a plain PyTorch twin reproduces every number.
//
// Bound on the card: both are memory-bound streaming passes (normal writes
// 4 bytes a draw; add_gaussian_noise reads and writes 4*nx bytes a
// particle) plus the Philox ALU work.  Design: one thread per group of four
// draws (normal) or per particle (add_gaussian_noise), so every Philox call
// is used whole and each thread's loads and stores are contiguous.
//
// llpf_philox_bits and llpf_curand_philox_bits expose the raw words of this
// generator and of curand's Philox4x32-10, for the known-answer check.
#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

#include "philox.cuh"
#include "propagate.cuh"

namespace {

__global__ void philox_bits_kernel(const uint32_t* __restrict__ ctr,
                                   int64_t n, uint2 key,
                                   uint32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 c = make_uint4(ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2],
                             ctr[4 * i + 3]);
  const uint4 r = llpf_philox4x32_10(c, key);
  out[4 * i] = r.x;
  out[4 * i + 1] = r.y;
  out[4 * i + 2] = r.z;
  out[4 * i + 3] = r.w;
}

__global__ void curand_philox_bits_kernel(const uint32_t* __restrict__ ctr,
                                          int64_t n, uint2 key,
                                          uint32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 c = make_uint4(ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2],
                             ctr[4 * i + 3]);
  const uint4 r = curand_Philox4x32_10(c, key);
  out[4 * i] = r.x;
  out[4 * i + 1] = r.y;
  out[4 * i + 2] = r.z;
  out[4 * i + 3] = r.w;
}

// out[k] = normal number k of the flat stream: group g = k / 4 is the
// Philox row, lane k % 4 the Box-Muller output.
__global__ void normal_kernel(float* __restrict__ out, int64_t n,
                              uint64_t seed, uint32_t tag, uint32_t step) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (4 * g >= n) return;
  float z[4];
  llpf_normals4(seed, tag, step, (uint32_t)g, 0u, z);
#pragma unroll
  for (int l = 0; l < 4; ++l)
    if (4 * g + l < n) out[4 * g + l] = z[l];
}

// f(x) of particle i, computed by PyTorch before the launch
template <int D>
struct XnDyn {
  const float* __restrict__ xn;
  int nx;
  __device__ __forceinline__ void operator()(int64_t i, float (&out)[D]) const {
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < nx) out[d] = xn[i * nx + d];
  }
};

template <int D>
__global__ void __launch_bounds__(LLPF_PROP_THREADS)
    add_gaussian_noise_kernel(XnDyn<D> dyn, const float* __restrict__ cov,
                              const float* __restrict__ mean,
                              const long long* __restrict__ seed,
                              uint32_t step, float* __restrict__ out,
                              int64_t N) {
  llpf_propagate_body<D>(dyn, dyn.nx, cov, mean, seed, step, out, N);
}

template <int D>
void launch_add_gaussian_noise(const float* xn, const float* cov,
                               const float* mean, const long long* seed,
                               float* out, int64_t N, int nx, uint32_t step,
                               cudaStream_t stream) {
  add_gaussian_noise_kernel<D><<<llpf_prop_blocks(N), LLPF_PROP_THREADS, 0,
                                 stream>>>(XnDyn<D>{xn, nx}, cov, mean, seed,
                                           step, out, N);
}

inline unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

int llpf_philox_bits(const uint32_t* ctr, int64_t n, uint32_t k0, uint32_t k1,
                     uint32_t* out, void* stream) {
  if (n > 0)
    philox_bits_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        ctr, n, make_uint2(k0, k1), out);
  return (int)cudaGetLastError();
}

int llpf_curand_philox_bits(const uint32_t* ctr, int64_t n, uint32_t k0,
                            uint32_t k1, uint32_t* out, void* stream) {
  if (n > 0)
    curand_philox_bits_kernel<<<blocks_for(n, 256), 256, 0,
                                (cudaStream_t)stream>>>(
        ctr, n, make_uint2(k0, k1), out);
  return (int)cudaGetLastError();
}

int llpf_normal(float* out, int64_t n, uint64_t seed, uint32_t tag,
                uint32_t step, void* stream) {
  const int64_t groups = (n + 3) / 4;
  if (groups > 0)
    normal_kernel<<<blocks_for(groups, 256), 256, 0, (cudaStream_t)stream>>>(
        out, n, seed, tag, step);
  return (int)cudaGetLastError();
}

// out = xn + L z + mean: xn [N, nx], cov [nx, nx], mean [nx], seed [1] int64
int llpf_add_gaussian_noise(const float* xn, const float* cov,
                            const float* mean, const long long* seed,
                            float* out, int64_t N, int nx, uint32_t step,
                            void* stream) {
  if (nx < 1 || nx > LLPF_PROP_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    if (nx <= 2)
      launch_add_gaussian_noise<2>(xn, cov, mean, seed, out, N, nx, step, st);
    else if (nx <= 4)
      launch_add_gaussian_noise<4>(xn, cov, mean, seed, out, N, nx, step, st);
    else
      launch_add_gaussian_noise<8>(xn, cov, mean, seed, out, N, nx, step, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
