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
//      moments: the mean sum weu x / sum weu
//   3. central second moments about that mean
//      trigger:  Neff = 1 / sum we^2 < thresh * N (always when thresh >= 1;
//                never in segment mode)
//      resample: wi = floor(we * 2^24 + 0.5) as int32, exact int prefix
//                sum C, K = clip(ceil(C * N / tot - r), 0, N); slot k takes
//                particle #{i : K_i <= k}; w = -log N
//      else      w = w1 - ll_t
//   4. predict:  x' = M_t x + c_t + mu1 + L1 z, z from Philox (seed, t)
//
// Bound on the card: synchronisation and the issue rate.  The TPU runs the
// recursion as one sequential program with the cloud in VMEM; Hopper
// spreads it over 132 SMs and nothing carries across blocks.  So the
// kernel is persistent and cooperative: a grid sized to be co-resident
// (blocks of 512 threads, as many an SM as fit), each block
// owning a contiguous particle range, the cloud kept SoA as [nx, N] f32 in
// device memory (800 KB at N = 1e5, resident in the 50 MB L2).  A step's
// particle work (the Philox draw, the predict, the weight) is a few
// hundred instructions a particle, so at N = 1e5 the SMs' issue rate and
// the grid-wide syncs set its time (PERF.md: the phases of a step).
//
// Design: one grid-wide exchange a step.  As a thread makes its particles'
// new weights it keeps their max and the sums of exp(w - max), of its
// square and (moments) of exp(w - max) x, rescaled when the max grows; the
// block reduces them to one record {m_b, sums relative to m_b} and
// publishes it; after one grid.sync every block combines the G records
// in one fixed order, rescaling each by exp(m_b - m) (a block of -inf
// weights adds nothing), so every block holds the same m, sums, ll_t and
// trigger decision.  The records are double-buffered by step parity, so
// the next step's records cannot overwrite a record another block still
// reads.  The predict of step t and the weight of step t + 1 are one pass
// over the block's particles.  A step that does not resample takes one
// grid.sync and one read of the records.
//
// Resample: each block quantizes its weights with the global m and S1 and
// scans them (exact int32) into each particle's exclusive prefix in the
// block, publishes its total; one grid.sync; every block scans the G
// totals into its offset P_b; each particle i then knows its slots
// [K_{i-1}, K_i) (K from P_b and its own prefix, as the twin computes it
// from the global prefix) and writes its state there (scatter); one more
// grid.sync, after which every block reads its new cloud: two syncs a
// resampling step and no search.  The integer prefix is exact in any
// order, so K is monotone and reproducible.  A heavy particle's copies are written by its own thread,
// so a step where one particle takes most of the mass is slow, not wrong.
// Every read of the cloud and of data written by other blocks uses
// __ldcg (L2, not the incoherent L1).
//
// Moments: the mean comes out of the exchange.  The central second moments
// need it, so their pass runs after the exchange on each block's own
// particles with the global weights exp(w1 - m) and publishes its record;
// block 0 reduces the records in fixed block order after the next step's
// grid.sync (after one last grid.sync for the final step).  Every sum is
// taken in one fixed order (a warp's butterfly, then the warps, then the
// blocks, in order), so two seeded calls give the same bits.  Not the raw
// moments E[x x^T] - m m^T, which cancel in f32.
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

#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// a grid of at most kMaxGrid blocks, whose records and totals every
// block's threads read, kMaxGrid / kThreads each
constexpr int kMaxGrid = 1024;
constexpr int kMaxD = 8;
constexpr int kMaxPairs = kMaxD * (kMaxD + 1) / 2;
constexpr int kDensC = 6;  // constants per scalar density
constexpr int kMaxS = 2 * kMaxD * kMaxD + 2 * kMaxD;  // coefficients a step
static_assert(kMaxS <= kThreads, "a thread a coefficient");
// an exchange record: m_b, s1_b, s2_b and the moment sums sx_b [nx]
constexpr int kRec = 3 + kMaxD;
constexpr unsigned kFull = 0xffffffffu;
// phases of a step that block 0's thread 0 times when asked (clock64
// cycles summed over the steps): its record, the exchange's grid.sync,
// the combine, the moments, the resample's quantized scan, its grid.sync,
// its gather, the predict and next weight
constexpr int kPhases = 8;

// family codes of kernels/pf_scan.py::FAMILY
enum Family { kNormal = 1, kUniform, kLaplace, kStudentT, kBinary, kMixture };

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
  int32_t* kbuf;      // [N] the blocks' local prefix sums C_loc
  float* part;        // [2][kRec][G] exchange records, by step parity
  float* pcov;        // [2][pairs][G] central-moment records (want_cov)
  int32_t* ptot;      // [G] the blocks' quantized totals
  float* out;    // [2]: ll, number of resamples
  float* means;  // [T, nx] (moments mode)
  float* covs;   // [T, nx, nx] (moments mode with want_cov)
  float* xfin;   // [N, nx] final cloud (segment mode), or null
  float* wfin;   // [N] final log-weights
  long long* prof;  // [kPhases] block 0's cycles by phase, or null
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// the block's max of v, on every thread (red: kWarps floats)
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) m = fmaxf(m, red[k]);
  __syncthreads();
  return m;
}

// the block's sums of v[k], k < n, on thread 0, in one fixed order (each
// warp's butterfly, then the warps in order); red: kWarps * K floats
template <int K>
__device__ __forceinline__ void block_sums0(float (&v)[K], int n,
                                            float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < n) {
      const float s = warp_sum(v[k]);
      if (lane == 0) red[warp * K + k] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < n) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += red[w * K + k];
        v[k] = s;
      }
    }
  }
}

// inclusive prefix sum of v over the block's threads in order, and the
// block's total (red: kWarps ints); exact in int32
__device__ __forceinline__ int block_scan(int v, int* red, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) red[warp] = v;
  __syncthreads();
  int before = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int r = red[w];
    before += w < warp ? r : 0;
    tot += r;
  }
  __syncthreads();
  total = tot;
  return v + before;
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

// the normals of particle i's draw: for D = 2 the first pair of
// Philox's four (llpf_box_muller2, the same bits)
template <int D>
__device__ __forceinline__ void draw(const PFArgs& a, uint32_t tag,
                                     uint32_t step, int i, float (&z)[D]) {
  if (!a.noise) {
#pragma unroll
    for (int e = 0; e < D; ++e) z[e] = 0.f;
    return;
  }
  if constexpr (D == 2) {
    llpf_box_muller2(llpf_philox4x32_10(
                         make_uint4((uint32_t)i, step, 0u, tag),
                         llpf_key(a.seed)), z);
  } else {
    llpf_normals4(a.seed, tag, step, (uint32_t)i, 0u, z);
    if (a.nx > 4) llpf_normals4(a.seed, tag, step, (uint32_t)i, 1u, z + 4);
  }
}

// one step's constants in shared memory: the affine coefficients, y, and
// whether y has a NaN (the update is skipped)
struct StepC {
  float coef[kMaxS];
  float y[kMaxD];
};

// logp of y against the state xv under step sc's measurement
template <int D, bool kDens>
__device__ __forceinline__ float log_weight(const PFArgs& a, const StepC& sc,
                                            const float (&xv)[D],
                                            const float* sL2i,
                                            const float* sMu2,
                                            const int* sKind,
                                            const float* sDc) {
  const int nx = a.nx, ny = a.ny;
  const float* H = sc.coef + nx * nx + nx;
  const float* dv = H + ny * nx;
  float ev[D];
#pragma unroll
  for (int e = 0; e < D; ++e) {
    if (e < ny) {
      float yh = dv[e];
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (j < nx) yh = yh + H[e * nx + j] * xv[j];
      ev[e] = kDens ? sc.y[e] - yh : (sc.y[e] - sMu2[e]) - yh;
    }
  }
  if (kDens) {
    float lp = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e)
      if (e < ny) lp = lp + scalar_logpdf(sKind[e], sDc + e * kDensC, ev[e]);
    return lp;
  }
  float quad = 0.f;
#pragma unroll
  for (int r = 0; r < D; ++r) {
    if (r < ny) {
      float z = 0.f;
#pragma unroll
      for (int e = 0; e <= r; ++e) z = z + sL2i[r * ny + e] * ev[e];
      quad = quad + z * z;
    }
  }
  return a.cst - 0.5f * quad;
}

__device__ __forceinline__ bool has_nan(const StepC& sc, int ny) {
  bool missing = false;
  for (int e = 0; e < ny; ++e) missing |= isnan(sc.y[e]);
  return missing;
}

// pair (d, f), d <= f, of the compact order of nx: (0,0), (0,1), ...,
// (0,nx-1), (1,1), ...
__device__ __forceinline__ void pair_of(int k, int nx, int& d, int& f) {
  d = 0;
  while (k >= nx - d) {
    k -= nx - d;
    ++d;
  }
  f = d + k;
}

// D: the register arrays' size, 2 when nx, ny <= 2 (no lanes of unused
// dimensions in the step's arithmetic), else D
template <int D, bool kDens, bool kMom>
__global__ void __launch_bounds__(kThreads) pf_scan_kernel(PFArgs a) {
  constexpr int kRm = kMom ? 3 + D : 3;    // a record's fields
  constexpr int kP = D * (D + 1) / 2;      // moment pairs
  constexpr int kRpt = kMaxGrid / kThreads;  // records, totals a thread
  cg::grid_group grid = cg::this_grid();
  __shared__ StepC sStep[2];
  __shared__ float sL1[kMaxD * kMaxD], sMu1[kMaxD];
  __shared__ float sL2i[kMaxD * kMaxD], sMu2[kMaxD];
  __shared__ int sKind[kMaxD];
  __shared__ float sDc[kMaxD * kDensC];
  __shared__ float sRed[kWarps * kMaxPairs];
  __shared__ int sRedI[kWarps];
  __shared__ float sBc[kRec];  // the combined exchange
  __shared__ int sPb;          // the block's offset in the resample

  const int nx = a.nx, ny = a.ny, N = a.N, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int S = nx * nx + nx + ny * nx + ny;
  const int G = (int)gridDim.x;
  const int per = (N + G - 1) / G;
  const int i0 = min(N, (int)blockIdx.x * per), i1 = min(N, i0 + per);
  const bool lead = blockIdx.x == 0 && tid == 0;
  const bool cov = kMom && a.want_cov;
  const int npairs = nx * (nx + 1) / 2;
  const int nrec = 3 + (kMom ? nx : 0);

  for (int k = tid; k < nx * nx; k += kThreads) sL1[k] = a.L1[k];
  for (int k = tid; k < ny * ny; k += kThreads) sL2i[k] = a.L2i[k];
  if (tid < nx) sMu1[tid] = a.mu1[tid];
  if (tid < ny) sMu2[tid] = a.mu2[tid];
  if (kDens) {
    if (tid < ny) sKind[tid] = a.dkind[tid];
    for (int k = tid; k < ny * kDensC; k += kThreads) sDc[k] = a.dconst[k];
  }
  if (a.T > 0) {  // step 0's constants (S <= kMaxS <= kThreads)
    if (tid < S) sStep[0].coef[tid] = a.coef[tid];
    if (tid < ny) sStep[0].y[tid] = a.y[tid];
  }
  __syncthreads();

  // The thread's share of the step's record, kept as its particles' new
  // weights are made: the max mt of its weights and, relative to it,
  // sum exp(w - mt), its square and (moments) sum exp(w - mt) x, rescaled
  // when mt grows.  With one particle a thread, exactly exp(w - w) = 1.
  float mt, st[kRm];
  auto reset = [&]() {
    mt = -INFINITY;
#pragma unroll
    for (int k = 0; k < kRm; ++k) st[k] = 0.f;
  };
  auto take = [&](float w, const float (&xv)[D]) {
    if (w == -INFINITY) return;  // adds nothing
    float c = 1.f, e = 1.f;
    if (w > mt) {
      c = expf(mt - w);  // 0 for the first weight
      mt = w;
    } else {
      e = expf(w - mt);
    }
    st[1] = fmaf(st[1], c, e);
    st[2] = fmaf(st[2], c * c, e * e);
    if (kMom) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (d < nx) st[3 + d] = fmaf(st[3 + d], c, e * xv[d]);
    }
  };

  // The state and weight of the thread's first particle, kept in
  // registers from one step's predict to the next (a resample replaces
  // the cloud, and the next predict reads it from memory)
  float xr[D], wr = 0.f;
  bool kept = false;
  auto keep = [&](const float (&xv)[D], float w) {
#pragma unroll
    for (int d = 0; d < D; ++d) xr[d] = xv[d];
    wr = w;
    kept = true;
  };

  // initial cloud x ~ d0 (or the given x0), weights w0 (or uniform) and
  // step 0's weight update
  float* xc = a.xa;
  float* xn = a.xb;
  reset();
  const bool miss0 = a.T > 0 && has_nan(sStep[0], ny);
  for (int i = i0 + tid; i < i1; i += kThreads) {
    float xv[D];
    if (a.x0 != nullptr) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (d < nx) xv[d] = a.x0[(size_t)i * nx + d];
    } else {
      float z[D];
      draw(a, LLPF_TAG_INIT, 0u, i, z);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (d < nx) {
          float acc = a.mu0[d];
#pragma unroll
          for (int e = 0; e < D; ++e)
            if (e < nx) acc = acc + a.L0[d * nx + e] * z[e];
          xv[d] = acc;
        }
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < nx) xc[(size_t)d * N + i] = xv[d];
    float w = a.w0 != nullptr ? a.w0[i] : a.neg_log_n;
    if (a.T > 0 && !miss0)
      w = w + log_weight<D, kDens>(a, sStep[0], xv, sL2i, sMu2, sKind, sDc);
    a.w[i] = w;
    take(w, xv);
    if (i == i0 + tid) keep(xv, w);
  }

  // block 0's phase clock (a.prof): thread 0 sums the cycles of each
  // phase in shared memory
  __shared__ long long sProf[kPhases];
  const bool timing = a.prof != nullptr && blockIdx.x == 0 && tid == 0;
  long long tmark = 0;
  if (timing) {
    for (int k = 0; k < kPhases; ++k) sProf[k] = 0;
    tmark = clock64();
  }
  auto mark = [&](int k) {
    if (timing) {
      const long long now = clock64();
      sProf[k] += now - tmark;
      tmark = now;
    }
  };

  float ll = 0.f, nres = 0.f, s1_prev = 0.f;
  for (int t = 0; t < a.T; ++t) {
    const int par = t & 1;
    const bool missing = has_nan(sStep[par], ny);
    // step t + 1's constants into registers now, into shared memory after
    // the exchange (their buffer's last reader is step t - 1's predict);
    // the loads' latency hides behind this step's reductions and sync
    float cpre = 0.f, ypre = 0.f;
    if (t + 1 < a.T) {
      if (tid < S) cpre = __ldg(a.coef + (size_t)(t + 1) * S + tid);
      if (tid < ny) ypre = __ldg(a.y + (size_t)(t + 1) * ny + tid);
    }

    // ---- 2. normalize: the block's record from its threads' shares ----
    {
      const float mb = block_max(mt, sRed);
      const float f = mt == -INFINITY ? 0.f : expf(mt - mb);
      st[0] = 0.f;
      st[1] *= f;
      st[2] *= f * f;
#pragma unroll
      for (int k = 3; k < kRm; ++k) st[k] *= f;
      block_sums0(st, nrec, sRed);
      if (tid == 0) {
        float* rec = a.part + (size_t)par * kRec * G + blockIdx.x;
        rec[0] = mb;
        for (int k = 1; k < nrec; ++k) rec[(size_t)k * G] = st[k];
      }
    }
    mark(0);
    grid.sync();
    mark(1);

    // the central moments of the previous step: every block has written
    // its record by now
    if (cov && t > 0 && blockIdx.x == 0 && warp == 0) {
      const float* pc = a.pcov + (size_t)((t - 1) & 1) * kMaxPairs * G;
      for (int k = 0; k < npairs; ++k) {
        float s = 0.f;
        for (int b = lane; b < G; b += 32) s += __ldcg(pc + (size_t)k * G + b);
        s = warp_sum(s) / s1_prev;
        int d, f;
        pair_of(k, nx, d, f);
        if (lane == 0) {
          a.covs[((size_t)(t - 1) * nx + d) * nx + f] = s;
          a.covs[((size_t)(t - 1) * nx + f) * nx + d] = s;
        }
      }
    }

    // ---- the exchange: thread tid takes the records tid + q kThreads (one
    // load latency for all), then block reductions in fixed order -------
    {
      const float* rec = a.part + (size_t)par * kRec * G;
      float rv[kRpt][kRm], m_t = -INFINITY;
#pragma unroll
      for (int q = 0; q < kRpt; ++q) {
        const int b = tid + q * kThreads;
#pragma unroll
        for (int k = 0; k < kRm; ++k)
          rv[q][k] = (b < G && k < nrec) ? __ldcg(rec + (size_t)k * G + b)
                                         : (k == 0 ? -INFINITY : 0.f);
        m_t = fmaxf(m_t, rv[q][0]);
      }
      const float m = block_max(m_t, sRed);
      float c[kRm];
#pragma unroll
      for (int k = 0; k < kRm; ++k) c[k] = 0.f;
#pragma unroll
      for (int q = 0; q < kRpt; ++q) {
        // a block of -inf weights adds nothing
        const float f = rv[q][0] == -INFINITY ? 0.f : expf(rv[q][0] - m);
        c[1] += f * rv[q][1];
        c[2] += (f * f) * rv[q][2];
#pragma unroll
        for (int k = 3; k < kRm; ++k) c[k] += f * rv[q][k];
      }
      block_sums0(c, nrec, sRed);
      if (tid == 0) {
        // every weight -inf: exp(-inf - -inf) is NaN, as the sequential
        // route's normalization gives
        const bool dead = m == -INFINITY;
        sBc[0] = m;
        for (int k = 1; k < nrec; ++k) sBc[k] = dead ? NAN : c[k];
      }
    }
    if (t + 1 < a.T) {  // step t + 1's constants, loaded before the sync
      StepC& sc = sStep[par ^ 1];
      if (tid < S) sc.coef[tid] = cpre;
      if (tid < ny) sc.y[tid] = ypre;
    }
    __syncthreads();
    mark(2);

    // ---- 3. ll, moments, trigger, resample ----------------------------
    const float m = sBc[0], S1 = sBc[1], S2 = sBc[2];
    const float ll_t = missing ? 0.f : m + logf(S1);
    const float neff = 1.0f / (S2 / (S1 * S1));
    if (lead) ll += ll_t;
    if (kMom) {
      if (blockIdx.x == 0 && tid < nx)
        a.means[(size_t)t * nx + tid] = sBc[3 + tid] / S1;
      if (cov) {
        float mean[D];
#pragma unroll
        for (int d = 0; d < D; ++d) mean[d] = d < nx ? sBc[3 + d] / S1 : 0.f;
        // pairs (d, f), d <= f, in the D packing: register indices
        // fixed at compile time whatever nx is
        float acc[kP];
#pragma unroll
        for (int k = 0; k < kP; ++k) acc[k] = 0.f;
        for (int i = i0 + tid; i < i1; i += kThreads) {
          const float e = expf(a.w[i] - m);
          float dx[D];
#pragma unroll
          for (int d = 0; d < D; ++d)
            dx[d] = d < nx ? __ldcg(xc + (size_t)d * N + i) - mean[d] : 0.f;
#pragma unroll
          for (int d = 0, k = 0; d < D; ++d)
#pragma unroll
            for (int f = d; f < D; ++f, ++k)
              if (f < nx) acc[k] += e * dx[d] * dx[f];
        }
        // the D packing's sums, stored in the compact order of nx
#pragma unroll
        for (int d = 0, k = 0; d < D; ++d)
#pragma unroll
          for (int f = d; f < D; ++f, ++k)
            if (f < nx) {
              const float s = warp_sum(acc[k]);
              if (lane == 0) sRed[warp * kMaxPairs + k] = s;
            }
        __syncthreads();
        if (tid < kP) {
          int d = 0, r = tid;  // (d, f) of packed index tid
          while (r >= D - d) {
            r -= D - d;
            ++d;
          }
          const int f = d + r;
          if (f < nx) {
            float s = 0.f;
            for (int w = 0; w < kWarps; ++w) s += sRed[w * kMaxPairs + tid];
            a.pcov[((size_t)par * kMaxPairs + d * nx - d * (d - 1) / 2 + (f - d)) * G +
                   blockIdx.x] = s;
          }
        }
        __syncthreads();  // sRed is read; the next step's block_max writes it
        s1_prev = S1;
      }
    }
    mark(3);
    const bool resample = !a.no_resample && (a.always || neff < a.thr_n);
    if (resample) {
      const float r =
          a.noise ? llpf_uniform_co(
                        llpf_philox4x32_10(
                            make_uint4(0u, (uint32_t)t, 0u, LLPF_TAG_RESAMPLE),
                            llpf_key(a.seed))
                            .x)
                  : 0.5f;
      auto quantum = [&](int i) {  // floor(we 2^24 + 0.5) of particle i
        const float we = expf(a.w[i] - m) / S1;
        return (int)floorf(__fadd_rn(__fmul_rn(we, 16777216.0f), 0.5f));
      };
      // the quantized weights' exclusive prefix over the block (exact)
      int carry = 0;
      for (int base = i0; base < i1; base += kThreads) {
        const int i = base + tid;
        const int wi = i < i1 ? quantum(i) : 0;
        int tot;
        const int incl = block_scan(wi, sRedI, tot);
        if (i < i1) a.kbuf[i] = carry + incl - wi;
        carry += tot;
      }
      if (tid == 0) a.ptot[blockIdx.x] = carry;
      mark(4);
      grid.sync();
      mark(5);

      // the block's offset P_b and the total: thread tid scans blocks
      // tid kRpt .. tid kRpt + kRpt - 1
      int tq[kRpt], mine = 0, total;
#pragma unroll
      for (int q = 0; q < kRpt; ++q) {
        const int b = tid * kRpt + q;
        tq[q] = b < G ? __ldcg(a.ptot + b) : 0;
        mine += tq[q];
      }
      int excl = block_scan(mine, sRedI, total) - mine;
#pragma unroll
      for (int q = 0; q < kRpt; ++q) {
        if (tid * kRpt + q == (int)blockIdx.x) sPb = excl;
        excl += tq[q];
      }
      __syncthreads();
      const int Pb = sPb;
      const float scale = __fdiv_rn((float)N, (float)total);
      auto k_of = [&](int c) {  // K of a global prefix c
        const float K = ceilf(__fsub_rn(__fmul_rn((float)c, scale), r));
        return (int)fminf(fmaxf(K, 0.f), (float)N);
      };
      // scatter: particle i fills slots [K_{i-1}, K_i), so slot k takes
      // particle #{i : K_i <= k} (the last particle up to slot N - 1)
      for (int i = i0 + tid; i < i1; i += kThreads) {
        const int c0 = Pb + a.kbuf[i];
        const int lo = k_of(c0);
        const int hi = i == N - 1 ? N : k_of(c0 + quantum(i));
        if (lo < hi) {
          float xv[D];
#pragma unroll
          for (int d = 0; d < D; ++d)
            if (d < nx) xv[d] = __ldcg(xc + (size_t)d * N + i);
          for (int k = lo; k < hi; ++k) {
#pragma unroll
            for (int d = 0; d < D; ++d)
              if (d < nx) xn[(size_t)d * N + k] = xv[d];
          }
        }
      }
      float* sw = xc;
      xc = xn;
      xn = sw;
      if (lead) nres += 1.f;
      mark(6);
      grid.sync();  // every slot written
    }

    // ---- 4. predict, and step t + 1's weight update -----------------
    const StepC& sc = sStep[par];
    const float* M = sc.coef;
    const float* c = M + nx * nx;
    const bool next = t + 1 < a.T;
    const bool miss1 = next && has_nan(sStep[par ^ 1], ny);
    reset();
    const bool use_kept = kept && !resample;
    for (int i = i0 + tid; i < i1; i += kThreads) {
      const bool first = i == i0 + tid;
      float xv[D], xp[D], z[D];
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (j < nx)
          xv[j] = first && use_kept ? xr[j] : __ldcg(xc + (size_t)j * N + i);
      draw(a, LLPF_TAG_PROPAGATE, (uint32_t)t, i, z);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (d < nx) {
          float acc = c[d] + sMu1[d];
#pragma unroll
          for (int e = 0; e < D; ++e)
            if (e < nx)
              acc = acc + M[d * nx + e] * xv[e] + sL1[d * nx + e] * z[e];
          xp[d] = acc;
          xc[(size_t)d * N + i] = acc;
        }
      }
      float w = resample ? a.neg_log_n
                         : (first && use_kept ? wr : a.w[i]) - ll_t;
      if (next && !miss1)
        w = w + log_weight<D, kDens>(a, sStep[par ^ 1], xp, sL2i, sMu2, sKind,
                                  sDc);
      a.w[i] = w;
      take(w, xp);
      if (first) keep(xp, w);
    }
    mark(7);
  }
  if (timing)
    for (int k = 0; k < kPhases; ++k) a.prof[k] = sProf[k];
  if (cov && a.T > 0) {
    grid.sync();
    if (blockIdx.x == 0 && warp == 0) {
      const float* pc = a.pcov + (size_t)((a.T - 1) & 1) * kMaxPairs * G;
      for (int k = 0; k < npairs; ++k) {
        float s = 0.f;
        for (int b = lane; b < G; b += 32) s += __ldcg(pc + (size_t)k * G + b);
        s = warp_sum(s) / s1_prev;
        int d, f;
        pair_of(k, nx, d, f);
        if (lane == 0) {
          a.covs[((size_t)(a.T - 1) * nx + d) * nx + f] = s;
          a.covs[((size_t)(a.T - 1) * nx + f) * nx + d] = s;
        }
      }
    }
  }
  if (a.xfin != nullptr) {
    for (int i = i0 + tid; i < i1; i += kThreads) {
      for (int d = 0; d < nx; ++d)
        a.xfin[(size_t)i * nx + d] = __ldcg(xc + (size_t)d * N + i);
      a.wfin[i] = a.w[i];
    }
  }
  if (lead) {
    a.out[0] = ll;
    a.out[1] = nres;
  }
}

// A measurement kernel, not on any path (scripts/torch_kernel_probe.py
// `sync`): `iters` rounds of one grid.sync() each; with `reads`, every
// block first publishes one partial and after the sync reduces all
// gridDim.x of them (__ldcg), as kernel A's grid-wide sums do.  Gives the
// cost of a sync, and of a sync with its partial read, at a grid size.
__global__ void grid_sync_probe_kernel(float* part, int iters, int reads) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float sw[32];
  const int G = (int)gridDim.x, lane = threadIdx.x & 31,
            warp = threadIdx.x >> 5, nw = (int)blockDim.x >> 5;
  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    float* p = part + (it & 1) * G;
    if (reads && threadIdx.x == 0) p[blockIdx.x] = acc + (float)it;
    grid.sync();
    if (reads) {
      float v = 0.f;
      for (int k = threadIdx.x; k < G; k += blockDim.x) v += __ldcg(p + k);
      v = warp_sum(v);
      if (lane == 0) sw[warp] = v;
      __syncthreads();
      v = 0.f;
      for (int w = 0; w < nw; ++w) v += sw[w];
      __syncthreads();
      acc += 1e-30f * v;
    }
  }
  if (acc == 12345.f) part[0] = acc;  // keeps the reads
}

using KernelFn = void (*)(PFArgs);

// mode bits: 1 moments, 2 scalar densities
template <int D>
KernelFn kernel_of_d(int mode) {
  switch (mode & 3) {
    case 0: return pf_scan_kernel<D, false, false>;
    case 1: return pf_scan_kernel<D, false, true>;
    case 2: return pf_scan_kernel<D, true, false>;
    default: return pf_scan_kernel<D, true, true>;
  }
}

KernelFn kernel_of(int mode, int nx, int ny) {
  return nx <= 2 && ny <= 2 ? kernel_of_d<2>(mode) : kernel_of_d<kMaxD>(mode);
}

}  // namespace

extern "C" {

// Grid size for a cooperative launch of the kernel for this mode and these
// sizes at N particles: as many blocks as are co-resident on the card, but
// no more than one thread a particle and no more than kMaxGrid.
int llpf_pf_scan_grid(int N, int mode, int nx, int ny, int* grid) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)kernel_of(mode, nx, ny), kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int g = per_sm * sms;
  const int need = (N + kThreads - 1) / kThreads;
  if (need < g) g = need;
  if (g > kMaxGrid) g = kMaxGrid;
  *grid = g < 1 ? 1 : g;
  return (int)cudaGetLastError();
}

// The scratch an llpf_pf_scan call at grid G needs: `part` floats of
// exchange and central-moment records, ints `tot` of block totals.
int llpf_pf_scan_scratch(int G, int* part, int* tot) {
  *part = 2 * kRec * G + 2 * kMaxPairs * G;
  *tot = G;
  return 0;
}

int llpf_pf_scan(const float* y, const float* coef, const float* L1,
                 const float* mu1, const float* L2i, const float* mu2,
                 const float* L0, const float* mu0, const float* x0,
                 const float* w0, const int32_t* dkind, const float* dconst,
                 float* xa, float* xb, float* w, int32_t* kbuf, float* part,
                 int32_t* ptot, float* out, float* means, float* covs,
                 float* xfin, float* wfin, long long* prof, int T, int N,
                 int nx, int ny, float cst, float thr_n, float neg_log_n,
                 int always, int noise, int no_resample, int want_cov,
                 int mode, uint64_t seed, int grid, void* stream) {
  if (nx < 1 || nx > kMaxD || ny < 1 || ny > kMaxD || N < 1 || T < 0 ||
      grid < 1 || grid > kMaxGrid)
    return (int)cudaErrorInvalidValue;
  if ((mode & 1) && (means == nullptr || (want_cov && covs == nullptr)))
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
  a.kbuf = kbuf;
  a.part = part;
  a.pcov = part + 2 * kRec * grid;
  a.ptot = ptot;
  a.out = out;
  a.means = means;
  a.covs = covs;
  a.xfin = xfin;
  a.wfin = wfin;
  a.prof = prof;
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
      (const void*)kernel_of(mode, nx, ny), dim3(grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// grid_sync_probe_kernel at grid x threads (part: 2 * grid floats)
int llpf_grid_sync_probe(float* part, int grid, int threads, int iters,
                         int reads, void* stream) {
  void* args[] = {&part, &iters, &reads};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)grid_sync_probe_kernel, dim3(grid), dim3(threads), args,
      0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
