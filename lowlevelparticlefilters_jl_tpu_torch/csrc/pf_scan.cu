// The whole bootstrap particle-filter log-likelihood in one launch.
//
// Replaces lowlevelparticlefilters_jl_tpu/ops/pallas/pf_scan.py::_pf_kernel
// (pf_scan.py:747, launched at :700) in its loglik mode with affine
// callbacks.  Per step t, in the JAX kernel's order:
//   1. weight:   w1 = w + logp, logp the whitened Gaussian log-density of
//                y_t - (H_t x + d_t) - mu2; a NaN in y_t skips the update
//   2. normalize: m = max w1, weu = exp(w1 - m), ll_t = m + log sum weu
//   3. trigger:  Neff = 1 / sum we^2 < thresh * N (always when thresh >= 1)
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
constexpr int kMaxD = 8;

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
  float* xa;          // [nx, N] cloud
  float* xb;          // [nx, N] cloud after a resample
  float* w;           // [N] log-weights
  float* weu;         // [N] unnormalized exp-weights
  int32_t* kbuf;      // [N] prefix sums, then slot boundaries K
  float* pmax;        // [grid] per-block partials
  float* ps1;
  float* ps2;
  int32_t* pint;
  float* out;  // [2]: ll, number of resamples
  int T, N, nx, ny;
  float cst;        // -ny/2 log 2pi + sum log |diag L2i|
  float thr_n;      // f32(thresh * N)
  float neg_log_n;  // -log f32(N)
  int always;       // thresh >= 1
  int noise;        // 1: Philox noise; 0: no process noise, r = 0.5
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

__global__ void __launch_bounds__(kThreads) pf_scan_kernel(PFArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ TempStorage tmp;
  __shared__ float sL1[kMaxD * kMaxD], sMu1[kMaxD];
  __shared__ float sL2i[kMaxD * kMaxD], sMu2[kMaxD];
  __shared__ float sCoef[2 * kMaxD * kMaxD + 2 * kMaxD];
  __shared__ float sY[kMaxD];
  __shared__ float sBcast;
  __shared__ int sIBcast[2];

  const int nx = a.nx, ny = a.ny, N = a.N, tid = threadIdx.x;
  const int S = nx * nx + nx + ny * nx + ny;
  const int per = (N + (int)gridDim.x - 1) / (int)gridDim.x;
  const int i0 = min(N, (int)blockIdx.x * per), i1 = min(N, i0 + per);
  const bool lead = blockIdx.x == 0 && tid == 0;

  for (int k = tid; k < nx * nx; k += kThreads) sL1[k] = a.L1[k];
  for (int k = tid; k < ny * ny; k += kThreads) sL2i[k] = a.L2i[k];
  if (tid < nx) sMu1[tid] = a.mu1[tid];
  if (tid < ny) sMu2[tid] = a.mu2[tid];

  // initial cloud x ~ d0 (or the given x0) and uniform weights
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
    a.w[i] = a.neg_log_n;
  }

  float ll = 0.f, nres = 0.f;
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
            ev[e] = (sY[e] - sMu2[e]) - yh;
          }
        }
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
      a.w[i] = w1;
      lmax = fmaxf(lmax, w1);
    }
    lmax = BlockReduceF(tmp.rf).Reduce(lmax, MaxOp());
    if (tid == 0) a.pmax[blockIdx.x] = lmax;
    grid.sync();

    // ---- 2. normalize -----------------------------------------------
    const float m = grid_max(a.pmax, tmp, &sBcast);
    float s1 = 0.f, s2 = 0.f;
    for (int i = i0 + tid; i < i1; i += kThreads) {
      const float e = expf(a.w[i] - m);
      a.weu[i] = e;
      s1 += e;
      s2 += e * e;
    }
    s1 = BlockReduceF(tmp.rf).Sum(s1);
    __syncthreads();
    s2 = BlockReduceF(tmp.rf).Sum(s2);
    if (tid == 0) {
      a.ps1[blockIdx.x] = s1;
      a.ps2[blockIdx.x] = s2;
    }
    grid.sync();

    // ---- 3. ll, trigger, resample -----------------------------------
    const float S1 = grid_sum(a.ps1, tmp, &sBcast);
    const float S2 = grid_sum(a.ps2, tmp, &sBcast);
    const float ll_t = missing ? 0.f : m + logf(S1);
    const float neff = 1.0f / (S2 / (S1 * S1));
    if (lead) ll += ll_t;
    if (!(a.always || neff < a.thr_n)) {
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
      for (int k = tid; k < (int)gridDim.x; k += kThreads) {
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
  if (lead) {
    a.out[0] = ll;
    a.out[1] = nres;
  }
}

}  // namespace

extern "C" {

// Grid size for a cooperative launch at N particles: as many blocks as are
// co-resident on the card, but no more than one thread per particle.
int llpf_pf_scan_grid(int N, int* grid) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pf_scan_kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int g = per_sm * sms;
  const int need = (N + kThreads - 1) / kThreads;
  if (need < g) g = need;
  *grid = g < 1 ? 1 : g;
  return (int)cudaGetLastError();
}

int llpf_pf_loglik_scan(const float* y, const float* coef, const float* L1,
                        const float* mu1, const float* L2i, const float* mu2,
                        const float* L0, const float* mu0, const float* x0,
                        float* xa, float* xb, float* w, float* weu,
                        int32_t* kbuf, float* pmax, float* ps1, float* ps2,
                        int32_t* pint, float* out, int T, int N, int nx,
                        int ny, float cst, float thr_n, float neg_log_n,
                        int always, int noise, uint64_t seed, int grid,
                        void* stream) {
  if (nx < 1 || nx > kMaxD || ny < 1 || ny > kMaxD || N < 1 || T < 0)
    return (int)cudaErrorInvalidValue;
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
  a.xa = xa;
  a.xb = xb;
  a.w = w;
  a.weu = weu;
  a.kbuf = kbuf;
  a.pmax = pmax;
  a.ps1 = ps1;
  a.ps2 = ps2;
  a.pint = pint;
  a.out = out;
  a.T = T;
  a.N = N;
  a.nx = nx;
  a.ny = ny;
  a.cst = cst;
  a.thr_n = thr_n;
  a.neg_log_n = neg_log_n;
  a.always = always;
  a.noise = noise;
  a.seed = seed;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)pf_scan_kernel, dim3(grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
