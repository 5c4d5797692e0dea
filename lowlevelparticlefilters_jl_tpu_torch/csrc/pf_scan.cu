// The whole bootstrap particle filter in one launch.
//
// Replaces lowlevelparticlefilters_jl_tpu/ops/pallas/pf_scan.py::_pf_kernel
// (pf_scan.py:747, launched at :700) with affine callbacks, in its modes:
//   loglik   (pf_loglik_fused): ll and the number of resamples;
//   moments  (pf_mean_fused, pf_stats_fused; pf_scan.py:978-1001): also the
//            filtered mean sum we x [T, nx] and, with want_cov, the central
//            second moments sum we (x - m)(x - m)^T [T, nx, nx] of every
//            step, after its normalization and before its resampling;
//   segment  (pf_segment_fused, :428): x0 and log-weights w0 given, no
//            resampling, the final cloud and log-weights written out;
// and with the measurement density Gaussian (whitened) or a product of the
// scalar families of ops/distributions.py (pf_scan.py:297-347, :905-950).
// Per step t, in the JAX kernel's order:
//   1. weight:   w1 = w + logp, logp the whitened Gaussian log-density of
//                y_t - (H_t x + d_t) - mu2, or sum_d logpdf_d(y_d - yhat_d)
//                of the scalar families; a NaN in y_t skips the update
//   2. normalize: m = max w1, weu = exp(w1 - m), ll_t = m + log sum weu
//      moments: the mean from per-block partials of sum weu x
//   3. central second moments of the block's particles about that mean
//      trigger:  Neff = 1 / sum we^2 < thresh * N (always when thresh >= 1;
//                never in segment mode)
//      resample: wi = floor(we * 2^24 + 0.5) as int32, exact int prefix
//                sum C, K = clip(ceil(C * N / tot - r), 0, N); slot k takes
//                particle #{i : K_i <= k}; w = -log N
//      else      w = w1 - ll_t
//   4. predict:  x' = M_t x + c_t + mu1 + L1 z, z from Philox (seed, t)
//
// Bound on the card: synchronisation.  The TPU runs the recursion as one
// sequential program with the cloud in VMEM; Hopper spreads it over 132
// SMs and nothing carries across blocks.  So the kernel is persistent and
// cooperative: a grid sized to be co-resident, each block owning a
// contiguous particle range, the cloud kept SoA as [nx, N] f32 in global
// memory (800 KB at N = 1e5, resident in the 50 MB L2), and the phases of
// a step separated by grid.sync(): two a step, four when it resamples.
// Grid-wide max and sums go through per-block partials that every block
// reduces in the same fixed order, so all blocks take the same trigger
// decision.  The integer prefix sum is exact in any order, so K is
// monotone and reproducible.  Reads of data written by other blocks use
// __ldcg (L2, not the incoherent L1).
//
// The moments need the grid-wide mean before the central pass, and the mean
// is known after the second grid.sync of the step, which the normalization
// needs anyway.  So the central pass runs in phase 3 on each block's own
// particles (before the resample gather, which reads the cloud and writes
// the other buffer), with no grid.sync of its own: block 0 reduces its
// per-block partials in fixed block order after the next step's first
// grid.sync (after one last grid.sync for the final step), when every
// block has written them.  Every per-block partial is reduced in one fixed
// order (a warp a component, lanes strided over the blocks, then a shuffle
// tree), so each run gives the same moments.  Not the raw moments
// E[x x^T] - m m^T, which cancel in f32.
//
// Scalar measurement densities: each measurement dimension carries a
// family code and six constants folded on the host in float64
// (kernels/pf_scan.py::density_constants, StudentT's lgamma terms among
// them); Uniform and Binary give -inf weights, and a step where every
// particle has -inf ends, as the sequential route does, with a NaN ll.
//
// noise == 0 is the JAX kernel's deterministic mode (pf_scan.py:384-390):
// no process noise and r = 0.5, for exact comparison with it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 8;
constexpr int kMaxPairs = kMaxD * (kMaxD + 1) / 2;
constexpr int kDensC = 6;  // constants per scalar density

// family codes of kernels/pf_scan.py::FAMILY
enum Family { kNormal = 1, kUniform, kLaplace, kStudentT, kBinary, kMixture };

struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};

struct PFArgs {
  const float* y;     // [T, ny]
  const float* coef;  // [T, S]: M_t [nx, nx], c_t [nx], H_t [ny, nx], d_t [ny]
  const float* L1;    // [nx, nx] chol of the process noise
  const float* mu1;   // [nx]
  const float* L2i;   // [ny, ny] inverse chol of the measurement noise
  const float* mu2;   // [ny]
  const float* L0;    // [nx, nx] chol of the initial density
  const float* mu0;   // [nx]
  const float* x0;    // [N, nx] initial cloud, or null to draw it
  const float* w0;    // [N] initial log-weights, or null for -log N
  const int32_t* dkind;  // [ny] scalar density families (dens mode)
  const float* dconst;   // [ny, kDensC] their constants
  float* xa;          // [nx, N] cloud
  float* xb;          // [nx, N] cloud after a resample
  float* w;           // [N] log-weights
  float* weu;         // [N] unnormalized exp-weights
  int32_t* kbuf;      // [N] prefix sums, then slot boundaries K
  float* pmax;        // [grid] per-block partials
  float* ps1;
  float* ps2;
  int32_t* pint;
  float* pmom;   // [nx + pairs, grid] per-block moment partials
  float* out;    // [2]: ll, number of resamples
  float* means;  // [T, nx] (moments mode)
  float* covs;   // [T, nx, nx] (moments mode with want_cov)
  float* xfin;   // [N, nx] final cloud (segment mode), or null
  float* wfin;   // [N] final log-weights
  int T, N, nx, ny;
  float cst;        // -ny/2 log 2pi + sum log |diag L2i|
  float thr_n;      // f32(thresh * N)
  float neg_log_n;  // -log f32(N)
  int always;       // thresh >= 1
  int noise;        // 1: Philox noise; 0: no process noise, r = 0.5
  int no_resample;  // segment mode
  int want_cov;
  uint64_t seed;
};

using BlockReduceF = cub::BlockReduce<float, kThreads>;
using BlockReduceI = cub::BlockReduce<int, kThreads>;
using BlockScanI = cub::BlockScan<int, kThreads>;

union TempStorage {
  typename BlockReduceF::TempStorage rf;
  typename BlockReduceI::TempStorage ri;
  typename BlockScanI::TempStorage si;
};

// Grid-wide reductions over the per-block partials: every block reads all
// of them in the same order and gets the same value.
__device__ float grid_max(const float* p, TempStorage& tmp, float* bcast) {
  float v = -INFINITY;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += kThreads)
    v = fmaxf(v, __ldcg(p + k));
  v = BlockReduceF(tmp.rf).Reduce(v, MaxOp());
  if (threadIdx.x == 0) *bcast = v;
  __syncthreads();
  v = *bcast;
  __syncthreads();
  return v;
}

__device__ float grid_sum(const float* p, TempStorage& tmp, float* bcast) {
  float v = 0.f;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += kThreads)
    v += __ldcg(p + k);
  v = BlockReduceF(tmp.rf).Sum(v);
  if (threadIdx.x == 0) *bcast = v;
  __syncthreads();
  v = *bcast;
  __syncthreads();
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0 holds the sum
}

// dst[k * stride] = the block's sum of v[k], k < n, in one fixed order
// (shuffle tree in each warp, then the warps in order).
template <int K>
__device__ void block_sums(const float (&v)[K], int n, float* sred,
                           float* dst, int stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < n) {
      const float s = warp_sum(v[k]);
      if (lane == 0) sred[warp * K + k] = s;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < n) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sred[w * K + threadIdx.x];
    dst[threadIdx.x * stride] = s;
  }
  __syncthreads();
}

// The block's sums of the pair accumulators acc (kMaxD packing, pairs
// with f < nx used), stored in the compact order of nx: (0,0), (0,1), ...,
// (0,nx-1), (1,1), ...; dst[k * stride] for compact index k.
__device__ void block_pair_sums(const float (&acc)[kMaxPairs], int nx,
                                float* sred, float* dst, int stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 0, k = 0; d < kMaxD; ++d) {
#pragma unroll
    for (int f = d; f < kMaxD; ++f, ++k) {
      if (f < nx) {
        const float s = warp_sum(acc[k]);
        if (lane == 0) sred[warp * kMaxPairs + k] = s;
      }
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < kMaxPairs) {
    int d = 0, r = threadIdx.x;  // (d, f) of packed index threadIdx.x
    while (r >= kMaxD - d) {
      r -= kMaxD - d;
      ++d;
    }
    const int f = d + r;
    if (f < nx) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += sred[w * kMaxPairs + threadIdx.x];
      dst[(d * nx - d * (d - 1) / 2 + (f - d)) * stride] = s;
    }
  }
  __syncthreads();
}

// sout[k] = sum over the blocks of the partials p[k * grid + b], k < n, in
// one fixed order: a warp a component, lanes strided over the blocks.
__device__ void grid_sums(const float* p, int n, float* sout) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = (int)gridDim.x;
  for (int k = warp; k < n; k += kWarps) {
    float s = 0.f;
    for (int b = lane; b < G; b += 32) s += __ldcg(p + (size_t)k * G + b);
    s = warp_sum(s);
    if (lane == 0) sout[k] = s;
  }
  __syncthreads();
}

// log-density of one scalar family at e (constants as density_constants
// folds them)
__device__ __forceinline__ float scalar_logpdf(int kind, const float* c,
                                               float e) {
  switch (kind) {
    case kNormal: {
      const float z = (e - c[0]) * c[1];
      return c[2] - 0.5f * (z * z);
    }
    case kUniform:
      return (e >= c[0] && e <= c[1]) ? c[2] : -INFINITY;
    case kLaplace:
      return c[2] - fabsf(e - c[0]) * c[1];
    case kStudentT: {
      const float z = (e - c[0]) * c[1];
      return c[2] - c[3] * log1pf((z * z) * c[4]);
    }
    case kBinary: {
      const bool is_a = e == c[0] || fabsf(e - c[0]) <= 1e-8f + fabsf(1e-5f * c[0]);
      const bool is_b = e == c[1] || fabsf(e - c[1]) <= 1e-8f + fabsf(1e-5f * c[1]);
      return is_a ? c[2] : (is_b ? c[3] : -INFINITY);
    }
    case kMixture: {
      const float z1 = (e - c[0]) * c[1], z2 = (e - c[3]) * c[4];
      const float l1 = c[2] - 0.5f * (z1 * z1), l2 = c[5] - 0.5f * (z2 * z2);
      return fmaxf(l1, l2) + log1pf(expf(-fabsf(l1 - l2)));
    }
  }
  return NAN;
}

__device__ __forceinline__ void draw(const PFArgs& a, uint32_t tag,
                                     uint32_t step, int i, float z[kMaxD]) {
  if (!a.noise) {
#pragma unroll
    for (int e = 0; e < kMaxD; ++e) z[e] = 0.f;
    return;
  }
  llpf_normals4(a.seed, tag, step, (uint32_t)i, 0u, z);
  if (a.nx > 4) llpf_normals4(a.seed, tag, step, (uint32_t)i, 1u, z + 4);
}

// Block 0: the central second moments of step t from their partials,
// divided by the step's sum of weu, written as a symmetric [nx, nx].
__device__ void write_cov(const PFArgs& a, int t, float s1, float* sred) {
  const int nx = a.nx, np = nx * (nx + 1) / 2;
  grid_sums(a.pmom + (size_t)nx * gridDim.x, np, sred);
  for (int k = threadIdx.x; k < np; k += kThreads) {
    int d = 0, r = k;
    while (r >= nx - d) {
      r -= nx - d;
      ++d;
    }
    const int e = d + r;
    const float v = sred[k] / s1;
    a.covs[((size_t)t * nx + d) * nx + e] = v;
    a.covs[((size_t)t * nx + e) * nx + d] = v;
  }
  __syncthreads();
}

template <bool kDens, bool kMom>
__global__ void __launch_bounds__(kThreads) pf_scan_kernel(PFArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ TempStorage tmp;
  __shared__ float sL1[kMaxD * kMaxD], sMu1[kMaxD];
  __shared__ float sL2i[kMaxD * kMaxD], sMu2[kMaxD];
  __shared__ float sCoef[2 * kMaxD * kMaxD + 2 * kMaxD];
  __shared__ float sY[kMaxD];
  __shared__ int sKind[kMaxD];
  __shared__ float sDc[kMaxD * kDensC];
  __shared__ float sRed[kWarps * kMaxPairs];
  __shared__ float sMean[kMaxD];
  __shared__ float sBcast;
  __shared__ int sIBcast[2];

  const int nx = a.nx, ny = a.ny, N = a.N, tid = threadIdx.x;
  const int S = nx * nx + nx + ny * nx + ny;
  const int G = (int)gridDim.x;
  const int per = (N + G - 1) / G;
  const int i0 = min(N, (int)blockIdx.x * per), i1 = min(N, i0 + per);
  const bool lead = blockIdx.x == 0 && tid == 0;
  const bool cov = kMom && a.want_cov;

  for (int k = tid; k < nx * nx; k += kThreads) sL1[k] = a.L1[k];
  for (int k = tid; k < ny * ny; k += kThreads) sL2i[k] = a.L2i[k];
  if (tid < nx) sMu1[tid] = a.mu1[tid];
  if (tid < ny) sMu2[tid] = a.mu2[tid];
  if (kDens) {
    if (tid < ny) sKind[tid] = a.dkind[tid];
    for (int k = tid; k < ny * kDensC; k += kThreads) sDc[k] = a.dconst[k];
  }

  // initial cloud x ~ d0 (or the given x0) and uniform weights (or w0)
  float* xc = a.xa;
  float* xn = a.xb;
  for (int i = i0 + tid; i < i1; i += kThreads) {
    if (a.x0 != nullptr) {
      for (int d = 0; d < nx; ++d) xc[d * N + i] = a.x0[i * nx + d];
    } else {
      float z[kMaxD];
      draw(a, LLPF_TAG_INIT, 0u, i, z);
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (d < nx) {
          float acc = a.mu0[d];
#pragma unroll
          for (int e = 0; e < kMaxD; ++e)
            if (e < nx) acc = acc + a.L0[d * nx + e] * z[e];
          xc[d * N + i] = acc;
        }
      }
    }
    a.w[i] = a.w0 != nullptr ? a.w0[i] : a.neg_log_n;
  }

  float ll = 0.f, nres = 0.f, s1_prev = 0.f;
  for (int t = 0; t < a.T; ++t) {
    __syncthreads();  // the previous step is done with sCoef
    for (int k = tid; k < S; k += kThreads) sCoef[k] = a.coef[(size_t)t * S + k];
    if (tid < ny) sY[tid] = a.y[(size_t)t * ny + tid];
    __syncthreads();
    const float* M = sCoef;
    const float* c = M + nx * nx;
    const float* H = c + nx;
    const float* dv = H + ny * nx;
    bool missing = false;
    for (int e = 0; e < ny; ++e) missing |= isnan(sY[e]);

    // ---- 1. weight --------------------------------------------------
    float lmax = -INFINITY;
    for (int i = i0 + tid; i < i1; i += kThreads) {
      float w1 = a.w[i];
      if (!missing) {
        float xv[kMaxD], ev[kMaxD];
#pragma unroll
        for (int j = 0; j < kMaxD; ++j)
          if (j < nx) xv[j] = xc[j * N + i];
#pragma unroll
        for (int e = 0; e < kMaxD; ++e) {
          if (e < ny) {
            float yh = dv[e];
#pragma unroll
            for (int j = 0; j < kMaxD; ++j)
              if (j < nx) yh = yh + H[e * nx + j] * xv[j];
            ev[e] = kDens ? sY[e] - yh : (sY[e] - sMu2[e]) - yh;
          }
        }
        if (kDens) {
          float lp = 0.f;
#pragma unroll
          for (int e = 0; e < kMaxD; ++e)
            if (e < ny) lp = lp + scalar_logpdf(sKind[e], sDc + e * kDensC, ev[e]);
          w1 = w1 + lp;
        } else {
          float quad = 0.f;
#pragma unroll
          for (int r = 0; r < kMaxD; ++r) {
            if (r < ny) {
              float z = 0.f;
#pragma unroll
              for (int e = 0; e <= r; ++e) z = z + sL2i[r * ny + e] * ev[e];
              quad = quad + z * z;
            }
          }
          w1 = w1 + (a.cst - 0.5f * quad);
        }
      }
      a.w[i] = w1;
      lmax = fmaxf(lmax, w1);
    }
    lmax = BlockReduceF(tmp.rf).Reduce(lmax, MaxOp());
    if (tid == 0) a.pmax[blockIdx.x] = lmax;
    grid.sync();

    // the central moments of the previous step: every block has written
    // its partials by now
    if (cov && t > 0 && blockIdx.x == 0) write_cov(a, t - 1, s1_prev, sRed);

    // ---- 2. normalize -----------------------------------------------
    const float m = grid_max(a.pmax, tmp, &sBcast);
    float s1 = 0.f, s2 = 0.f;
    float sx[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) sx[d] = 0.f;
    for (int i = i0 + tid; i < i1; i += kThreads) {
      const float e = expf(a.w[i] - m);
      a.weu[i] = e;
      s1 += e;
      s2 += e * e;
      if (kMom) {
#pragma unroll
        for (int d = 0; d < kMaxD; ++d)
          if (d < nx) sx[d] += e * xc[d * N + i];
      }
    }
    s1 = BlockReduceF(tmp.rf).Sum(s1);
    __syncthreads();
    s2 = BlockReduceF(tmp.rf).Sum(s2);
    if (tid == 0) {
      a.ps1[blockIdx.x] = s1;
      a.ps2[blockIdx.x] = s2;
    }
    if (kMom) block_sums(sx, nx, sRed, a.pmom + blockIdx.x, G);
    grid.sync();

    // ---- 3. ll, moments, trigger, resample ----------------------------
    const float S1 = grid_sum(a.ps1, tmp, &sBcast);
    const float S2 = grid_sum(a.ps2, tmp, &sBcast);
    const float ll_t = missing ? 0.f : m + logf(S1);
    const float neff = 1.0f / (S2 / (S1 * S1));
    if (lead) ll += ll_t;
    if (kMom) {
      grid_sums(a.pmom, nx, sRed);
      if (tid < nx) sMean[tid] = sRed[tid] / S1;
      __syncthreads();
      if (blockIdx.x == 0 && tid < nx) a.means[(size_t)t * nx + tid] = sMean[tid];
      if (cov) {
        // pairs (d, f), d <= f, in the kMaxD packing: register indices
        // fixed at compile time whatever nx is
        float acc[kMaxPairs];
#pragma unroll
        for (int k = 0; k < kMaxPairs; ++k) acc[k] = 0.f;
        for (int i = i0 + tid; i < i1; i += kThreads) {
          const float e = a.weu[i];
          float dx[kMaxD];
#pragma unroll
          for (int d = 0; d < kMaxD; ++d)
            dx[d] = d < nx ? xc[d * N + i] - sMean[d] : 0.f;
#pragma unroll
          for (int d = 0, k = 0; d < kMaxD; ++d)
#pragma unroll
            for (int f = d; f < kMaxD; ++f, ++k)
              if (f < nx) acc[k] += e * dx[d] * dx[f];
        }
        block_pair_sums(acc, nx, sRed, a.pmom + (size_t)nx * G + blockIdx.x, G);
        s1_prev = S1;
      }
    }
    if (a.no_resample || !(a.always || neff < a.thr_n)) {
      for (int i = i0 + tid; i < i1; i += kThreads) a.w[i] = a.w[i] - ll_t;
    } else {
      const float r =
          a.noise ? llpf_uniform_co(
                        llpf_philox4x32_10(
                            make_uint4(0u, (uint32_t)t, 0u, LLPF_TAG_RESAMPLE),
                            llpf_key(a.seed))
                            .x)
                  : 0.5f;
      // quantized weights and their exact int prefix sum over the block
      int carry = 0;
      for (int base = i0; base < i1; base += kThreads) {
        const int i = base + tid;
        int wi = 0;
        if (i < i1) {
          const float we = a.weu[i] / S1;
          wi = (int)floorf(__fadd_rn(__fmul_rn(we, 16777216.0f), 0.5f));
        }
        int incl, tot;
        BlockScanI(tmp.si).InclusiveSum(wi, incl, tot);
        __syncthreads();
        if (i < i1) a.kbuf[i] = carry + incl;
        carry += tot;
      }
      if (tid == 0) a.pint[blockIdx.x] = carry;
      grid.sync();

      // slot boundaries K from the global prefix sums
      int before = 0, total = 0;
      for (int k = tid; k < G; k += kThreads) {
        const int v = __ldcg(a.pint + k);
        total += v;
        if (k < (int)blockIdx.x) before += v;
      }
      before = BlockReduceI(tmp.ri).Sum(before);
      __syncthreads();
      total = BlockReduceI(tmp.ri).Sum(total);
      if (tid == 0) {
        sIBcast[0] = before;
        sIBcast[1] = total;
      }
      __syncthreads();
      before = sIBcast[0];
      total = sIBcast[1];
      const float scale = __fdiv_rn((float)N, (float)total);
      for (int i = i0 + tid; i < i1; i += kThreads) {
        const float cf = (float)(a.kbuf[i] + before);
        float K = ceilf(__fsub_rn(__fmul_rn(cf, scale), r));
        K = fminf(fmaxf(K, 0.f), (float)N);
        a.kbuf[i] = (int)K;
      }
      grid.sync();

      // gather: slot k takes particle #{i : K_i <= k}
      for (int k = i0 + tid; k < i1; k += kThreads) {
        int lo = 0, hi = N;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (__ldcg(a.kbuf + mid) <= k)
            lo = mid + 1;
          else
            hi = mid;
        }
        const int j = min(lo, N - 1);
        for (int d = 0; d < nx; ++d) xn[d * N + k] = __ldcg(xc + d * N + j);
        a.w[k] = a.neg_log_n;
      }
      float* sw = xc;
      xc = xn;
      xn = sw;
      if (lead) nres += 1.f;
    }

    // ---- 4. predict ---------------------------------------------------
    for (int i = i0 + tid; i < i1; i += kThreads) {
      float xv[kMaxD], z[kMaxD];
#pragma unroll
      for (int j = 0; j < kMaxD; ++j)
        if (j < nx) xv[j] = xc[j * N + i];
      draw(a, LLPF_TAG_PROPAGATE, (uint32_t)t, i, z);
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (d < nx) {
          float acc = c[d] + sMu1[d];
#pragma unroll
          for (int e = 0; e < kMaxD; ++e)
            if (e < nx)
              acc = acc + M[d * nx + e] * xv[e] + sL1[d * nx + e] * z[e];
          xc[d * N + i] = acc;
        }
      }
    }
  }
  if (cov && a.T > 0) {
    grid.sync();
    if (blockIdx.x == 0) write_cov(a, a.T - 1, s1_prev, sRed);
  }
  if (a.xfin != nullptr) {
    for (int i = i0 + tid; i < i1; i += kThreads) {
      for (int d = 0; d < nx; ++d) a.xfin[i * nx + d] = xc[d * N + i];
      a.wfin[i] = a.w[i];
    }
  }
  if (lead) {
    a.out[0] = ll;
    a.out[1] = nres;
  }
}

using KernelFn = void (*)(PFArgs);

// mode bits: 1 moments, 2 scalar densities
KernelFn kernel_of(int mode) {
  switch (mode & 3) {
    case 0: return pf_scan_kernel<false, false>;
    case 1: return pf_scan_kernel<false, true>;
    case 2: return pf_scan_kernel<true, false>;
    default: return pf_scan_kernel<true, true>;
  }
}

}  // namespace

extern "C" {

// Grid size for a cooperative launch of the mode's kernel at N particles:
// as many blocks as are co-resident on the card, but no more than one
// thread per particle.
int llpf_pf_scan_grid(int N, int mode, int* grid) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)kernel_of(mode), kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int g = per_sm * sms;
  const int need = (N + kThreads - 1) / kThreads;
  if (need < g) g = need;
  *grid = g < 1 ? 1 : g;
  return (int)cudaGetLastError();
}

int llpf_pf_scan(const float* y, const float* coef, const float* L1,
                 const float* mu1, const float* L2i, const float* mu2,
                 const float* L0, const float* mu0, const float* x0,
                 const float* w0, const int32_t* dkind, const float* dconst,
                 float* xa, float* xb, float* w, float* weu, int32_t* kbuf,
                 float* pmax, float* ps1, float* ps2, int32_t* pint,
                 float* pmom, float* out, float* means, float* covs,
                 float* xfin, float* wfin, int T, int N, int nx, int ny,
                 float cst, float thr_n, float neg_log_n, int always,
                 int noise, int no_resample, int want_cov, int mode,
                 uint64_t seed, int grid, void* stream) {
  if (nx < 1 || nx > kMaxD || ny < 1 || ny > kMaxD || N < 1 || T < 0)
    return (int)cudaErrorInvalidValue;
  if ((mode & 1) && (means == nullptr || pmom == nullptr ||
                     (want_cov && covs == nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((mode & 2) && (dkind == nullptr || dconst == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((xfin == nullptr) != (wfin == nullptr)) return (int)cudaErrorInvalidValue;
  PFArgs a;
  a.y = y;
  a.coef = coef;
  a.L1 = L1;
  a.mu1 = mu1;
  a.L2i = L2i;
  a.mu2 = mu2;
  a.L0 = L0;
  a.mu0 = mu0;
  a.x0 = x0;
  a.w0 = w0;
  a.dkind = dkind;
  a.dconst = dconst;
  a.xa = xa;
  a.xb = xb;
  a.w = w;
  a.weu = weu;
  a.kbuf = kbuf;
  a.pmax = pmax;
  a.ps1 = ps1;
  a.ps2 = ps2;
  a.pint = pint;
  a.pmom = pmom;
  a.out = out;
  a.means = means;
  a.covs = covs;
  a.xfin = xfin;
  a.wfin = wfin;
  a.T = T;
  a.N = N;
  a.nx = nx;
  a.ny = ny;
  a.cst = cst;
  a.thr_n = thr_n;
  a.neg_log_n = neg_log_n;
  a.always = always;
  a.noise = noise;
  a.no_resample = no_resample;
  a.want_cov = want_cov;
  a.seed = seed;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)kernel_of(mode), dim3(grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
