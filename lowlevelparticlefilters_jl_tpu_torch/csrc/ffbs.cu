// FFBS backward simulation in one launch, kernel J.
//
// Replaces lowlevelparticlefilters_jl_tpu/ops/pallas/ffbs_kernel.py
// (ffbs_backward_pallas, ffbs_kernel.py:190; body _make_kernel, :49).
// Per reversed step t = T-2 .. 0 and trajectory m (the caller whitens and
// centres the predicted particles, kernels/ffbs.py::whiten):
//
//   zb     = L^-1 (xb_m - mu) - c_t                       [nx]
//   w_n    = wfc_t[n] + zb . zpred_t[n] - 0.5 |zb|^2       n < N
//   i      = argmax_n (w_n + g_{t,m,n}), lowest n among equal maxima
//   xb_m   = xf_t[i]
//
// with g Gumbel(0, 1) noise from Philox4x32-10 (philox.cuh) keyed by the
// seed, counter (n / 4, t, m, LLPF_TAG_FFBS), lane n % 4; noise == 0 gives
// the exact MAP selection.
//
// Design.  Trajectory m at step t depends only on its own state at t+1, so
// the M trajectories are independent through the whole pass: one block per
// trajectory loops over t, its threads stride over the N columns keeping a
// (best score, lowest index) pair, and a warp-shuffle plus shared-memory
// reduction picks the block's winner, whose row of xf is copied into xb by
// an indexed load (the TPU kernel's one-hot sum).  No grid-wide sync: the
// per-step slabs zpred_t, wfc_t and xf_t are read by every block and stay
// in L2.  The arithmetic is written with explicit round-to-nearest
// intrinsics in the plain twin's order (no fused multiply-adds), and logf
// is the function torch.log calls on the card, so kernel and twin score
// every column alike.
//
// Gumbel mapping: u = ((b >> 9) * 2 + 1) * 2^-24 is exact in f32 and lies
// in [2^-24, 1 - 2^-24], strictly inside (0, 1).  The TPU kernel's
// (b + 2^31 + 1) / (2^32 + 1) rounds to 1.0 for about 64 of the 2^32
// words, which gives an infinite Gumbel; a 24-bit (b >> 8) + 0.5 grid
// would round to 1.0 at its top too.
//
// A log-weight of -inf (and a NaN score) never wins: the pair starts at
// (-inf, none) and only a strictly larger score replaces it.  A row with no
// finite score takes column 0, as torch.argmax does.
//
// Bound on the card: operations.  Each (t, m, n) costs 2 nx + 2 flops and,
// with noise, a quarter of a Philox call and two logs; the bytes (the
// slabs once, the output) are three orders of magnitude below that at the
// main path's shapes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNone = 0x7fffffff;

__device__ __forceinline__ float gumbel(uint32_t b) {
  const float u = (float)(((b >> 9) << 1) | 1u) * 5.9604644775390625e-08f;
  return -logf(-logf(u));
}

// the larger score, the lower index among equal scores
__device__ __forceinline__ void keep_better(float s, int i, float& bs,
                                            int& bi) {
  if (s > bs || (s == bs && i < bi)) {
    bs = s;
    bi = i;
  }
}

__device__ __forceinline__ void warp_best(float& bs, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, bs, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    keep_better(os, oi, bs, bi);
  }
}

template <int NX>
__global__ void __launch_bounds__(kThreads) ffbs_backward_kernel(
    const float* __restrict__ zpred, const float* __restrict__ wfc,
    const float* __restrict__ cen, const float* __restrict__ xf,
    const float* __restrict__ xb_T, const float* __restrict__ Linv,
    const float* __restrict__ mu, float* __restrict__ out,
    int32_t* __restrict__ idx_out, int Tm1, int N, int M, uint64_t seed,
    int noise) {
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  __shared__ float xb[NX];
  __shared__ float s_Linv[NX * NX];
  __shared__ float s_mu[NX];
  __shared__ float red_s[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int chosen;
  if (tid < NX * NX) s_Linv[tid] = Linv[tid];
  if (tid < NX) {
    s_mu[tid] = mu[tid];
    const float v = xb_T[(int64_t)m * NX + tid];
    xb[tid] = v;
    out[((int64_t)Tm1 * M + m) * NX + tid] = v;
  }
  __syncthreads();
  const uint2 key = llpf_key(seed);
  const int Q = (N + 3) >> 2;
  for (int t = Tm1 - 1; t >= 0; --t) {
    float zb[NX];
    float cm = 0.0f;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j <= k; ++j)
        acc = __fadd_rn(acc, __fmul_rn(__fsub_rn(xb[j], s_mu[j]),
                                       s_Linv[k * NX + j]));
      zb[k] = __fsub_rn(acc, cen[t * NX + k]);
      cm = __fadd_rn(cm, __fmul_rn(zb[k], zb[k]));
    }
    const float half_cm = 0.5f * cm;
    const float* zp = zpred + (int64_t)t * N * NX;
    const float* wt = wfc + (int64_t)t * N;
    float bs = -INFINITY;
    int bi = kNone;
    for (int q = tid; q < Q; q += kThreads) {
      uint4 b = make_uint4(0u, 0u, 0u, 0u);
      if (noise)
        b = llpf_philox4x32_10(
            make_uint4((uint32_t)q, (uint32_t)t, (uint32_t)m, LLPF_TAG_FFBS),
            key);
      const uint32_t words[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int n = 4 * q + l;
        if (n >= N) break;
        float w = wt[n];
        const float* zn = zp + (int64_t)n * NX;
#pragma unroll
        for (int k = 0; k < NX; ++k) w = __fadd_rn(w, __fmul_rn(zb[k], zn[k]));
        w = __fsub_rn(w, half_cm);
        if (noise) w = __fadd_rn(w, gumbel(words[l]));
        if (w > bs) {  // n rises within a thread: the lowest index stays
          bs = w;
          bi = n;
        }
      }
    }
    warp_best(bs, bi);
    if ((tid & 31) == 0) {
      red_s[tid >> 5] = bs;
      red_i[tid >> 5] = bi;
    }
    __syncthreads();
    if (tid < 32) {
      bs = tid < kWarps ? red_s[tid] : -INFINITY;
      bi = tid < kWarps ? red_i[tid] : kNone;
      warp_best(bs, bi);
      if (tid == 0) chosen = bi == kNone ? 0 : bi;
    }
    __syncthreads();
    const int i = chosen;
    if (tid < NX) {
      const float v = xf[((int64_t)t * N + i) * NX + tid];
      xb[tid] = v;
      out[((int64_t)t * M + m) * NX + tid] = v;
    }
    if (tid == 0 && idx_out != nullptr) idx_out[(int64_t)t * M + m] = i;
    __syncthreads();
  }
}

template <int NX>
cudaError_t launch(const float* zpred, const float* wfc, const float* cen,
                   const float* xf, const float* xb_T, const float* Linv,
                   const float* mu, float* out, int32_t* idx, int Tm1, int N,
                   int M, uint64_t seed, int noise, cudaStream_t s) {
  ffbs_backward_kernel<NX><<<M, kThreads, 0, s>>>(
      zpred, wfc, cen, xf, xb_T, Linv, mu, out, idx, Tm1, N, M, seed, noise);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// zpred [Tm1, N, nx], wfc [Tm1, N], cen [Tm1, nx], xf [Tm1, N, nx],
// xb_T [M, nx], Linv [nx, nx], mu [nx] -> out [Tm1 + 1, M, nx] and, when
// idx is not null, the chosen columns idx [Tm1, M].
int llpf_ffbs_backward(const float* zpred, const float* wfc, const float* cen,
                       const float* xf, const float* xb_T, const float* Linv,
                       const float* mu, float* out, int32_t* idx, int Tm1,
                       int N, int M, int nx, uint64_t seed, int noise,
                       void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  if (N <= 0 || Tm1 < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nx) {
#define LLPF_FFBS_CASE(n)                                                    \
  case n:                                                                    \
    return (int)launch<n>(zpred, wfc, cen, xf, xb_T, Linv, mu, out, idx,     \
                          Tm1, N, M, seed, noise, s);
    LLPF_FFBS_CASE(1)
    LLPF_FFBS_CASE(2)
    LLPF_FFBS_CASE(3)
    LLPF_FFBS_CASE(4)
    LLPF_FFBS_CASE(5)
    LLPF_FFBS_CASE(6)
    LLPF_FFBS_CASE(7)
    LLPF_FFBS_CASE(8)
#undef LLPF_FFBS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
