// Kernel D: the bootstrap particle filter's propagate step in one launch.
//
// Replaces lowlevelparticlefilters_jl_tpu/ops/pallas/noise.py
// (propagate_gaussian, noise.py:121; the kernel :171, its pallas_call :188),
// which traces the user dynamics into its body and returns
// dyn(x) + z chol^T.  Here, per particle i at step `step`:
//   out[i] = f(x[i]) + L z_i + mu,   L = chol(sym(R1)),
// z_i the Philox4x32-10 normals of counter (i, step, d / 4, TAG_PROPAGATE)
// (philox.cuh), so a seeded call draws what the plain twin draws
// (kernels/noise.py).  Two forms share this template:
// - compiled: the dynamics f(x, u, p, t) lowered by
//   kernels/callback_codegen.py and printed before this header as
//   `cb_f(x, u, t, consts, out)`, with LLPF_PROP_NX and LLPF_PROP_NU
//   defined; the generated source is built per filter
//   (_lib.build_generated) and exports llpf_propagate;
// - xn: f(x) computed by PyTorch and passed in (a callback that does not
//   lower, or a `p` other than the filter's own); noise.cu instantiates it
//   as llpf_add_gaussian_noise.
// The step's 64-bit seed is read from device memory (an int64 tensor drawn
// from the filter's generator), so the host never waits for it.  R1's
// factor is formed once per block into shared memory by thread 0, with
// ops/linalg.py::chol_lower's formula and roundings (symmetrize, then
// Cholesky-Banachiewicz, no fused multiply-add), NaN where R1 is not
// positive definite, as the twin; the other threads draw meanwhile.
//
// Bound on the card: a streaming pass, 8 nx bytes a particle plus one
// Philox call (four normals) per four states; the factor is a few hundred
// cycles of latency per block.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

#define LLPF_PROP_MAX 8  // states a particle, at most
#define LLPF_PROP_THREADS 256

// L <- chol(sym(cov)) (stride D, zeros above the diagonal), cov [nx, nx]
template <int D>
__device__ __forceinline__ void llpf_prop_factor(const float* __restrict__ cov,
                                                 int nx, float* L) {
  for (int i = 0; i < nx; ++i)
    for (int j = 0; j < nx; ++j) {
      if (j > i) {
        L[i * D + j] = 0.f;
        continue;
      }
      float s = __fmul_rn(0.5f, __fadd_rn(cov[i * nx + j], cov[j * nx + i]));
      for (int k = 0; k < j; ++k)
        s = __fsub_rn(s, __fmul_rn(L[i * D + k], L[j * D + k]));
      L[i * D + j] = i == j ? __fsqrt_rn(s) : __fdiv_rn(s, L[j * D + j]);
    }
}

// out[i, :] = dyn(i) + L z_i + mu for particles i of this thread; `dyn`
// writes f(x_i) into its D-vector argument
template <int D, class Dyn>
__device__ __forceinline__ void llpf_propagate_body(
    const Dyn& dyn, int nx, const float* __restrict__ cov,
    const float* __restrict__ mean, const long long* __restrict__ seed_p,
    uint32_t step, float* __restrict__ out, int64_t N) {
  __shared__ float sL[D * D];
  __shared__ float sMu[D];
  if (threadIdx.x == 0) llpf_prop_factor<D>(cov, nx, sL);
  if (threadIdx.x < nx) sMu[threadIdx.x] = mean[threadIdx.x];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float xn[D], z[D < 4 ? 4 : (D + 3) / 4 * 4];
  if (i < N) {
    const uint64_t seed = (uint64_t)__ldg(seed_p);
    dyn(i, xn);
    const uint2 key = llpf_key(seed);
    if (D <= 2) {
      llpf_box_muller2(llpf_philox4x32_10(
          make_uint4((uint32_t)i, step, 0u, LLPF_TAG_PROPAGATE), key), z);
    } else {
#pragma unroll
      for (int blk = 0; blk < (D + 3) / 4; ++blk)
        if (4 * blk < nx)
          llpf_box_muller4(llpf_philox4x32_10(
              make_uint4((uint32_t)i, step, (uint32_t)blk,
                         LLPF_TAG_PROPAGATE), key), z + 4 * blk);
    }
  }
  __syncthreads();
  if (i >= N) return;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (d < nx) {
      float acc = xn[d];
#pragma unroll
      for (int e = 0; e < D; ++e)
        if (e < nx) acc += sL[d * D + e] * z[e];
      out[i * nx + d] = acc + sMu[d];
    }
  }
}

inline unsigned llpf_prop_blocks(int64_t N) {
  return (unsigned)((N + LLPF_PROP_THREADS - 1) / LLPF_PROP_THREADS);
}

#ifdef LLPF_PROP_NX
// ---- the compiled form: f(x, u, p, t) of one filter, printed above ------

namespace {

struct CompiledDyn {
  const float* __restrict__ x;
  const float* __restrict__ u;
  const float* __restrict__ c;
  float t;
  __device__ __forceinline__ void operator()(int64_t i,
                                             float (&xn)[LLPF_PROP_NX]) const {
    const float tt = t;
    cb_f(x + i * LLPF_PROP_NX, u, &tt, c, xn);
  }
};

__global__ void __launch_bounds__(LLPF_PROP_THREADS)
    propagate_kernel(CompiledDyn dyn, const float* __restrict__ cov,
                     const float* __restrict__ mean,
                     const long long* __restrict__ seed, uint32_t step,
                     float* __restrict__ out, int64_t N) {
  llpf_propagate_body<LLPF_PROP_NX>(dyn, LLPF_PROP_NX, cov, mean, seed, step,
                                    out, N);
}

}  // namespace

extern "C" {

// x [N, nx] (the resampled cloud), u [nu] (the step's input row, null when
// nu = 0), t the step's time, consts the callback's hoisted constants,
// cov [nx, nx] and mean [nx] of the process noise, seed [1] int64; writes
// out [N, nx]
int llpf_propagate(const float* x, const float* u, float t,
                   const float* consts, const float* cov, const float* mean,
                   const long long* seed, uint32_t step, float* out, int64_t N,
                   void* stream) {
  if (N > 0)
    propagate_kernel<<<llpf_prop_blocks(N), LLPF_PROP_THREADS, 0,
                       (cudaStream_t)stream>>>(
        CompiledDyn{x, u, consts, t}, cov, mean, seed, step, out, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // LLPF_PROP_NX
