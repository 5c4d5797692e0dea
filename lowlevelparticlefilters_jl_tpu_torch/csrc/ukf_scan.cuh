// Whole-scan UKF (kernel G) and EKF (kernel I) templates.
//
// Replace lowlevelparticlefilters_jl_tpu/ops/pallas/ukf_scan.py:
//   G  _ukf_kernel_run (ukf_scan.py:353, pallas_call :611): additive-noise
//      UKF, sigma points, UT moments, correct-then-predict, ll, and with
//      the trajectory entry x, R, xt, Rt, e, S, K per step;
//   I  _ekf_kernel_run (ukf_scan.py:1087, pallas_call :1272): EKF with
//      per-step Jacobians, from the user's Ajac/Cjac or by forward mode.
//
// This file is not compiled on its own.  kernels/ukf_scan.py generates one
// source per filter: the sizes (LLPF_NX, LLPF_NY, LLPF_NU), the kind
// (LLPF_UKF or LLPF_EKF), for G the sigma-point layout (LLPF_UKF_LANES)
// and the hook switches, the count of the callbacks' constants (LLPF_NC),
// and the user callbacks as scalar code (kernels/callback_codegen.py: for
// G cb_f, cb_g and, where present, cb_inn, cb_mean, cb_smean; for I cb_fvj
// and cb_gvj, each the value and then the Jacobian in x, differentiated at
// code generation or the user's Ajac/Cjac), then includes this file; nvcc
// builds it for sm_90a at first use.  The callbacks' tensor constants
// arrive in `c`, read on each call.
//
// Bound on the card: latency.  Each step is a serial chain of dependent
// operations (the callbacks, the Cholesky factorizations, the solves) on
// one thread (I, and G with LLPF_UKF_LANES 1) or one warp (G with 32) of
// one SM of 132.  The chain is read from the SASS by kernels/sass.py
// (PERF.md).
//
// Design, both kernels (run_scan): the worker, one thread or the first
// warp, runs the recursion with its state and the callbacks' constants in
// registers (beyond 64 constants, in shared or device memory: below) and
// does only the work the next step depends on: the symmetric products
// built once and mirrored, the Cholesky factors with one rsqrtf a diagonal
// entry and multiplications by the reciprocal diagonal everywhere else.
// Each step it leaves e and L = chol(S) (and, for the trajectory, the
// solution fields) in a shared-memory ring; the second warp, which also
// stages y and u a chunk ahead, reads the previous chunk from the ring,
// sums the ll terms (each lane its steps in order, then a butterfly over
// the lanes) and writes the trajectory with coalesced stores.  The two
// warps meet at one __syncthreads a chunk.  I: see ekf_step; G: ukf_step.
//
// TPU workarounds not ported: the 128-step lane blocks and iota-mask step
// extraction, _meta_acc's static-offset read-modify-writes, the rank-2-only
// _tri_solve_scalar rule, _wcol/_wrow_mean, the 0-D constant (1, 1)
// reshapes, the 64 MiB VMEM solution budget, default_matmul_precision
// ("highest") (all arithmetic here is plain float32).
#pragma once
#include "callback_ops.cuh"
#include "scan_common.cuh"

namespace {

constexpr int NX = LLPF_NX;
constexpr int NY = LLPF_NY;
constexpr int NU = LLPF_NU;
constexpr int NUB = NU > 0 ? NU : 1;
constexpr unsigned kFull = 0xffffffffu;

struct ScanOut {
  float *x, *R, *xt, *Rt, *e, *S, *K;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

constexpr int NTX = NX * (NX + 1) / 2, NTY = NY * (NY + 1) / 2;
// the callbacks' constants (LLPF_NC floats): in registers up to 64, else
// in shared memory while they leave room for the smallest chunk (8 steps),
// else read from c in device memory as the step needs them
constexpr int NC = LLPF_NC > 0 ? LLPF_NC : 1;
constexpr int kSmemBytes = 46 * 1024;
// the ring entry of a step: e [NY] and L [NTY] (lower, packed) for the ll;
// with the trajectory also x, R, xt, Rt, S (packed) and K [NX][NY]
constexpr int kOffL = NY, kOffXp = NY + NTY, kOffRp = kOffXp + NX,
              kOffXt = kOffRp + NTX, kOffRt = kOffXt + NX,
              kOffS = kOffRt + NTX, kOffK = kOffS + NTY,
              kRingLL = kOffXp, kRingTraj = kOffK + NX * NY;

// steps a chunk: 128, halved while the staged inputs, the ring's two
// buffers and `fixed` bytes (the constants' copy) would pass kSmemBytes of
// static shared memory
__host__ __device__ constexpr int scan_chunk(int floats_a_step, int fixed) {
  int ch = 128;
  while (ch > 8 && 2 * ch * floats_a_step * 4 + fixed > kSmemBytes) ch /= 2;
  return ch;
}

// whether the constants go to shared memory beside a ring of this width
__host__ __device__ constexpr bool consts_shared(int floats_a_step) {
  return LLPF_NC > 64 && 2 * 8 * floats_a_step * 4 + NC * 4 <= kSmemBytes;
}

// index of (i, j) in a lower-packed symmetric n x n matrix
__host__ __device__ constexpr int pk(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// the ll term of one ring entry: w = L^{-1} e, -(|w|^2 + 2 log|L| +
// NY log 2 pi) / 2
__device__ __forceinline__ float ring_ll(const float* r) {
  float w[NY], q = 0.f, ld = 0.f;
#pragma unroll
  for (int i = 0; i < NY; ++i) {
    float s = r[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= r[kOffL + pk(i, k)] * w[k];
    const float d = r[kOffL + pk(i, i)];
    w[i] = s / d;
    q += w[i] * w[i];
    ld += logf(d);
  }
  return -0.5f * (q + 2.f * ld + (float)(NY * 1.8378770664093453));
}

// copy the steps of one ring chunk into the [T, ...] solution, lane by
// lane so neighbouring lanes write neighbouring addresses; a packed field
// is mirrored into its full matrix
template <int RW>
__device__ __forceinline__ void ring_field(float* __restrict__ dst,
                                           const float* ring, int64_t t0,
                                           int tc, int off, int w, int n,
                                           bool packed, int lane) {
  for (int k = lane; k < tc * w; k += 32) {
    const int s = k / w, q = k - s * w;
    dst[t0 * w + k] = ring[s * RW + off + (packed ? pk(q / n, q % n) : q)];
  }
}

template <int RW>
__device__ __forceinline__ void ring_solution(const ScanOut& out,
                                              const float* ring, int64_t t0,
                                              int tc, int lane) {
  ring_field<RW>(out.x, ring, t0, tc, kOffXp, NX, NX, false, lane);
  ring_field<RW>(out.R, ring, t0, tc, kOffRp, NX * NX, NX, true, lane);
  ring_field<RW>(out.xt, ring, t0, tc, kOffXt, NX, NX, false, lane);
  ring_field<RW>(out.Rt, ring, t0, tc, kOffRt, NX * NX, NX, true, lane);
  ring_field<RW>(out.e, ring, t0, tc, 0, NY, NY, false, lane);
  ring_field<RW>(out.S, ring, t0, tc, kOffS, NY * NY, NY, true, lane);
  ring_field<RW>(out.K, ring, t0, tc, kOffK, NX * NY, NY, false, lane);
}

// L = chol(S) from the lower triangle of S: one rsqrtf a diagonal entry
// (rd its reciprocal), products elsewhere; L's upper triangle is zero
template <int N>
__device__ __forceinline__ void chol_rsqrt(const float (&S)[N][N],
                                           float (&L)[N][N],
                                           float (&rd)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j > i) {
        L[i][j] = 0.f;
        continue;
      }
      float a = S[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) a -= L[i][k] * L[j][k];
      if (i == j) {
        rd[i] = rsqrtf(a);
        L[i][i] = a * rd[i];
      } else {
        L[i][j] = a * rd[j];
      }
    }
}

// K^T = S^{-1} B for B [NY][NX] (in place): L^{-1}, then L^{-T}, by the
// reciprocal diagonal
__device__ __forceinline__ void gain_solve(const float (&L)[NY][NY],
                                           const float (&rd)[NY],
                                           float (&Kt)[NY][NX]) {
#pragma unroll
  for (int j = 0; j < NY; ++j)
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float a = Kt[j][i];
#pragma unroll
      for (int k = 0; k < j; ++k) a -= L[j][k] * Kt[k][i];
      Kt[j][i] = a * rd[j];
    }
#pragma unroll
  for (int j = NY - 1; j >= 0; --j)
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float a = Kt[j][i];
#pragma unroll
      for (int k = j + 1; k < NY; ++k) a -= L[k][j] * Kt[k][i];
      Kt[j][i] = a * rd[j];
    }
}

// the ring entry's fields before the update: e, L, and with the
// trajectory the prior x, R and S (packed)
template <bool TRAJ>
__device__ __forceinline__ void ring_prior(float* r, const float (&e)[NY],
                                           const float (&L)[NY][NY],
                                           const float (&x)[NX],
                                           const float (&R)[NX][NX],
                                           const float (&S)[NY][NY]) {
#pragma unroll
  for (int j = 0; j < NY; ++j) {
    r[j] = e[j];
#pragma unroll
    for (int k = 0; k <= j; ++k) r[kOffL + pk(j, k)] = L[j][k];
  }
  if (TRAJ) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      r[kOffXp + i] = x[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) r[kOffRp + pk(i, j)] = R[i][j];
    }
#pragma unroll
    for (int i = 0; i < NY; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) r[kOffS + pk(i, j)] = S[i][j];
  }
}

// ... and after it: the posterior x, R and K
__device__ __forceinline__ void ring_post(float* r, const float (&x)[NX],
                                          const float (&R)[NX][NX],
                                          const float (&Kt)[NY][NX]) {
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    r[kOffXt + i] = x[i];
#pragma unroll
    for (int j = 0; j <= i; ++j) r[kOffRt + pk(i, j)] = R[i][j];
#pragma unroll
    for (int j = 0; j < NY; ++j) r[kOffK + i * NY + j] = Kt[j][i];
  }
}

// The frame of both kernels (see the file's design note).  Threads
// [0, WORKERS) run step(y, u, tk, cs, r, write) for every step in order,
// `write` true on thread 0, which alone fills the ring entry r; threads
// [32, 64) stage the inputs and consume the ring.  The constants are
// loaded by every worker thread.
template <bool TRAJ, int WORKERS, class Step>
__device__ __forceinline__ void run_scan(const float* __restrict__ ys,
                                         const float* __restrict__ us,
                                         const float* __restrict__ c, int T,
                                         float* __restrict__ ll_out,
                                         const ScanOut& out, Step&& step) {
  constexpr int RW = TRAJ ? kRingTraj : kRingLL;
  constexpr bool kCsShared = consts_shared(RW + NY + NUB);
  constexpr int CH = scan_chunk(RW + NY + NUB, kCsShared ? NC * 4 : 0);
  __shared__ float sbuf[2][CH * (NY + NUB)];
  __shared__ float ring[2][CH * RW];
  const int tid = threadIdx.x, lane = tid & 31;
  const bool producer = tid >= 32, worker = tid < WORKERS;
  const int nch = (T + CH - 1) / CH;
#if LLPF_NC <= 64
  float cs[NC];
  if (worker) {
#pragma unroll
    for (int k = 0; k < LLPF_NC; ++k) cs[k] = c[k];
  }
#else
  __shared__ float cs_smem[kCsShared ? NC : 1];
  if constexpr (kCsShared)
    for (int k = tid; k < LLPF_NC; k += 64) cs_smem[k] = c[k];
  const float* cs = kCsShared ? cs_smem : c;
#endif
  auto stage = [&](int ch) {
    const int t0 = ch * CH, tc = min(CH, T - t0);
    stage_rows(sbuf[ch & 1], ys, NY, t0, tc, lane, 32);
    stage_rows(sbuf[ch & 1] + CH * NY, us, NU, t0, tc, lane, 32);
  };
  float ll = 0.f;  // the second warp's lane sums
  auto consume = [&](int ch) {
    const int t0 = ch * CH, tc = min(CH, T - t0);
    const float* r = ring[ch & 1];
    for (int s = lane; s < tc; s += 32) ll += ring_ll(r + s * RW);
    if constexpr (TRAJ) ring_solution<RW>(out, r, t0, tc, lane);
  };
  if (producer && nch > 0) stage(0);
  __syncthreads();
  for (int ch = 0; ch < nch; ++ch) {
    if (producer) {
      if (ch + 1 < nch) stage(ch + 1);
      if (ch > 0) consume(ch - 1);
    }
    if (worker) {
      const float* b = sbuf[ch & 1];
      const int t0 = ch * CH, tc = min(CH, T - t0);
      for (int s = 0; s < tc; ++s)
        step(b + s * NY, b + CH * NY + s * NU, t0 + s, cs,
             ring[ch & 1] + s * RW, tid == 0);
    }
    __syncthreads();
  }
  if (producer) {
    if (nch > 0) consume(nch - 1);
    ll = warp_sum(ll);
    if (lane == 0) ll_out[0] = ll;
  }
}

#if defined(LLPF_EKF)
// ---------------------------------------------------------------------------
// kernel I: the EKF (ukf_scan.py:1183-1230)
// ---------------------------------------------------------------------------

// One thread runs the recursion: the value-and-Jacobian callbacks
// (cb_gvj, cb_fvj: the Jacobians differentiated at code generation, or
// the user's) and the algebra of run_scan's design note.
template <bool TRAJ>
__global__ void __launch_bounds__(64)
    ekf_scan_kernel(const float* __restrict__ ys, const float* __restrict__ us,
                    const float* __restrict__ x0, const float* __restrict__ P0,
                    const float* __restrict__ R1, const float* __restrict__ R2,
                    const float* __restrict__ c, float alpha, float Ts, int T,
                    float* __restrict__ ll_out, ScanOut out) {
  float x[NX], R[NX][NX], R1m[NX][NX], R2m[NY][NY];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      x[i] = x0[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        R[i][j] = P0[i * NX + j];
        R1m[i][j] = R1[i * NX + j];
      }
    }
#pragma unroll
    for (int i = 0; i < NY; ++i)
#pragma unroll
      for (int j = 0; j < NY; ++j) R2m[i][j] = R2[i * NY + j];
  }
  run_scan<TRAJ, 1>(ys, us, c, T, ll_out, out, [&](const float* y,
                                                   const float* u, int t,
                                                   const float* cs, float* r,
                                                   bool) {
    const float tk = (float)t * Ts;
    // ---- correct ----------------------------------------------------------
    float gv[NY + NY * NX];
    cb_gvj(x, u, &tk, cs, gv);
    const float* Cj = gv + NY;  // [NY][NX]
    float CR[NY][NX], S[NY][NY], L[NY][NY], rd[NY], Kt[NY][NX], e[NY];
#pragma unroll
    for (int j = 0; j < NY; ++j)
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < NX; ++q) a += Cj[j * NX + q] * R[q][i];
        CR[j][i] = a;
        Kt[j][i] = a;
      }
#pragma unroll
    for (int i = 0; i < NY; ++i)
#pragma unroll
      for (int j = i; j < NY; ++j) {
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < NX; ++q) a += CR[i][q] * Cj[j * NX + q];
        S[i][j] = S[j][i] = a + R2m[i][j];
      }
    chol_rsqrt(S, L, rd);
    gain_solve(L, rd, Kt);  // K^T = S^{-1} C R
#pragma unroll
    for (int j = 0; j < NY; ++j) e[j] = y[j] - gv[j];
    ring_prior<TRAJ>(r, e, L, x, R, S);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float a = x[i];
#pragma unroll
      for (int j = 0; j < NY; ++j) a += e[j] * Kt[j][i];
      x[i] = a;
    }
    // R - K C R, its upper triangle, mirrored
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = i; j < NX; ++j) {
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < NY; ++q) a += Kt[q][i] * CR[q][j];
        R[i][j] = R[j][i] = R[i][j] - a;
      }
    if (TRAJ) ring_post(r, x, R, Kt);
    // ---- predict ----------------------------------------------------------
    float fv[NX + NX * NX], AR[NX][NX];
    cb_fvj(x, u, &tk, cs, fv);
    const float* Aj = fv + NX;  // [NX][NX]
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < NX; ++q) a += Aj[i * NX + q] * R[q][j];
        AR[i][j] = a;
      }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = i; j < NX; ++j) {
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < NX; ++q) a += AR[i][q] * Aj[j * NX + q];
        R[i][j] = R[j][i] = alpha * a + R1m[i][j];
      }
      x[i] = fv[i];
    }
  });
}

template <bool TRAJ>
int launch_ekf(const float* ys, const float* us, const float* x0,
               const float* P0, const float* R1, const float* R2,
               const float* c, float alpha, float Ts, int T, float* ll,
               ScanOut out, cudaStream_t stream) {
  ekf_scan_kernel<TRAJ><<<1, 64, 0, stream>>>(ys, us, x0, P0, R1, R2, c,
                                              alpha, Ts, T, ll, out);
  return (int)cudaGetLastError();
}
#endif  // LLPF_EKF

#if defined(LLPF_UKF)
// ---------------------------------------------------------------------------
// kernel G: the additive-noise UKF (ukf_scan.py:503-567)
// ---------------------------------------------------------------------------

constexpr int NSIG = 2 * NX + 1;
// the sigma-point layout, chosen per filter at code generation
// (kernels/ukf_scan.py::ukf_layout): 1, one thread evaluates every point,
// so the UT moments are register sums; 32, lane k evaluates point k and
// the UT moments are butterfly shuffles over the warp
constexpr int kLanes = LLPF_UKF_LANES;
static_assert(kLanes == 1 || (kLanes == 32 && NSIG <= 32), "UKF layout");
constexpr int kPts = kLanes == 1 ? NSIG : 1;  // points a worker thread

// sigma point k of N(x, L L^T): x; x + column k - 1 of L; x - column
// k - 1 - NX; x for k >= NSIG (a lane past the last point, weight 0)
__device__ __forceinline__ void sigma_point(const float (&x)[NX],
                                            const float (&L)[NX][NX], int k,
                                            float (&s)[NX]) {
  const float sg = k <= NX ? 1.f : -1.f;
  const int col = k <= NX ? k - 1 : k - 1 - NX;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < NX; ++j) d = j == col ? L[i][j] : d;
    s[i] = (k >= 1 && k < NSIG) ? x[i] + sg * d : x[i];
  }
}

// sum of v(0..N-1), pairwise
template <int N, class V>
__device__ __forceinline__ float tree_sum(V v, int lo = 0) {
  if constexpr (N == 1)
    return v(lo);
  else
    return tree_sum<N / 2>(v, lo) + tree_sum<N - N / 2>(v, lo + N / 2);
}

// the UT sum w0 v(point 0) + wi sum_{k >= 1} v(point k), every worker
// thread getting it: v(p) is the value at this thread's p-th point
template <class V>
__device__ __forceinline__ float ut_sum(V v, float w0, float wi, int lane) {
  if constexpr (kLanes == 1) {
    return w0 * v(0) +
           wi * tree_sum<NSIG - 1>([&](int p) { return v(p + 1); });
  } else {
    return warp_sum((lane == 0 ? w0 : lane < NSIG ? wi : 0.f) * v(0));
  }
}

// every point's N-vector, row-major [NSIG][N], for the mean hooks: the
// thread's own array, or gathered from the lanes
template <int N>
__device__ __forceinline__ const float* all_points(const float (&v)[kPts][N],
                                                   float (&buf)[NSIG * N]) {
  if constexpr (kLanes == 1) {
    return &v[0][0];
  } else {
#pragma unroll
    for (int k = 0; k < NSIG; ++k)
#pragma unroll
      for (int j = 0; j < N; ++j) buf[k * N + j] = __shfl_sync(kFull, v[0][j], k);
    return buf;
  }
}

#if !LLPF_HOOK_MEAN
__device__ __forceinline__ void cb_mean(const float*, const float*, float*) {}
#endif
#if !LLPF_HOOK_SMEAN
__device__ __forceinline__ void cb_smean(const float*, const float*,
                                         float*) {}
#endif
#if !LLPF_HOOK_INN
__device__ __forceinline__ void cb_inn(const float*, const float*,
                                       const float*, float*) {}
#endif

// the sigma points of N(x, Wsc R) owned by this thread (point p of lane
// `lane`): Wsc R is symmetric as R is (mirrored everywhere)
__device__ __forceinline__ void sigma_points(const float (&x)[NX],
                                             const float (&R)[NX][NX],
                                             float Wsc, int lane,
                                             float (&sp)[kPts][NX]) {
  float WR[NX][NX], L[NX][NX], rd[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) WR[i][j] = Wsc * R[i][j];
  chol_rsqrt(WR, L, rd);
#pragma unroll
  for (int p = 0; p < kPts; ++p) sigma_point(x, L, kLanes == 1 ? p : lane, sp[p]);
}

// Design: kLanes threads (1 or the warp) run the recursion; each owns
// kPts sigma points and evaluates the callbacks on them as independent
// instruction streams.  The factorizations and solves are computed by
// every worker thread alike (nothing is broadcast).  Semantics of the
// JAX kernel's step: correct (sigma points of N(x, R), UT mean and
// covariances, S symmetrized plus R2, the gain by two triangular solves,
// x + e K^T, R - K S K^T symmetrized), then predict (sigma points of the
// posterior, UT mean, covariance symmetrized plus R1); the weights wm
// (point 0) and wmi (the others) for means, wc and wci for covariances.
template <bool TRAJ>
__global__ void __launch_bounds__(64)
    ukf_scan_kernel(const float* __restrict__ ys, const float* __restrict__ us,
                    const float* __restrict__ x0, const float* __restrict__ P0,
                    const float* __restrict__ R1, const float* __restrict__ R2,
                    const float* __restrict__ c, float wm, float wmi,
                    float wc, float wci, float Wsc, float Ts, int T,
                    float* __restrict__ ll_out, ScanOut out) {
  const int lane = threadIdx.x & 31;
  float x[NX], R[NX][NX], R1m[NX][NX], R2m[NY][NY];
  if ((int)threadIdx.x < kLanes) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      x[i] = x0[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        R[i][j] = P0[i * NX + j];
        R1m[i][j] = R1[i * NX + j];
      }
    }
#pragma unroll
    for (int i = 0; i < NY; ++i)
#pragma unroll
      for (int j = 0; j < NY; ++j) R2m[i][j] = R2[i * NY + j];
  }
  run_scan<TRAJ, kLanes>(ys, us, c, T, ll_out, out, [&](const float* y,
                                                        const float* u, int t,
                                                        const float* cs,
                                                        float* r, bool write) {
    const float tk = (float)t * Ts;
    // ---- correct ----------------------------------------------------------
    float sp[kPts][NX], yv[kPts][NY], ym[NY];
    sigma_points(x, R, Wsc, lane, sp);
#pragma unroll
    for (int p = 0; p < kPts; ++p) cb_g(sp[p], u, &tk, cs, yv[p]);
    if (LLPF_HOOK_MEAN) {
      float buf[NSIG * NY];
      cb_mean(all_points(yv, buf), cs, ym);
    } else {
#pragma unroll
      for (int j = 0; j < NY; ++j)
        ym[j] = ut_sum([&](int p) { return yv[p][j]; }, wm, wmi, lane);
    }
    float dy[kPts][NY], dx[kPts][NX];
#pragma unroll
    for (int p = 0; p < kPts; ++p) {
#pragma unroll
      for (int j = 0; j < NY; ++j) dy[p][j] = yv[p][j] - ym[j];
#pragma unroll
      for (int i = 0; i < NX; ++i) dx[p][i] = sp[p][i] - x[i];
    }
    // S: the UT covariance, symmetric by construction (upper triangle,
    // mirrored), plus R2; K^T's right-hand side, the cross-covariance
    // transposed
    float S[NY][NY], L[NY][NY], rd[NY], Kt[NY][NX], e[NY];
#pragma unroll
    for (int a = 0; a < NY; ++a)
#pragma unroll
      for (int q = a; q < NY; ++q)
        S[a][q] = S[q][a] =
            ut_sum([&](int p) { return dy[p][a] * dy[p][q]; }, wc, wci, lane) +
            R2m[a][q];
#pragma unroll
    for (int j = 0; j < NY; ++j)
#pragma unroll
      for (int i = 0; i < NX; ++i)
        Kt[j][i] = ut_sum([&](int p) { return dx[p][i] * dy[p][j]; }, wc, wci,
                          lane);
    chol_rsqrt(S, L, rd);
    if (LLPF_HOOK_INN) {
      cb_inn(y, ym, cs, e);
    } else {
#pragma unroll
      for (int j = 0; j < NY; ++j) e[j] = y[j] - ym[j];
    }
    if (write) ring_prior<TRAJ>(r, e, L, x, R, S);
    gain_solve(L, rd, Kt);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float a = x[i];
#pragma unroll
      for (int j = 0; j < NY; ++j) a += e[j] * Kt[j][i];
      x[i] = a;
    }
    // R - K S K^T, its upper triangle, mirrored
    {
      float KS[NX][NY];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int q = 0; q < NY; ++q) {
          float a = 0.f;
#pragma unroll
          for (int p = 0; p < NY; ++p) a += Kt[p][i] * S[p][q];
          KS[i][q] = a;
        }
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = i; j < NX; ++j) {
          float a = 0.f;
#pragma unroll
          for (int q = 0; q < NY; ++q) a += KS[i][q] * Kt[q][j];
          R[i][j] = R[j][i] = R[i][j] - a;
        }
    }
    if (TRAJ && write) ring_post(r, x, R, Kt);
    // ---- predict ----------------------------------------------------------
    float pv[kPts][NX], xn[NX];
    sigma_points(x, R, Wsc, lane, sp);
#pragma unroll
    for (int p = 0; p < kPts; ++p) cb_f(sp[p], u, &tk, cs, pv[p]);
    if (LLPF_HOOK_SMEAN) {
      float buf[NSIG * NX];
      cb_smean(all_points(pv, buf), cs, xn);
    } else {
#pragma unroll
      for (int i = 0; i < NX; ++i)
        xn[i] = ut_sum([&](int p) { return pv[p][i]; }, wm, wmi, lane);
    }
#pragma unroll
    for (int p = 0; p < kPts; ++p)
#pragma unroll
      for (int i = 0; i < NX; ++i) pv[p][i] -= xn[i];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = i; j < NX; ++j)
        R[i][j] = R[j][i] =
            ut_sum([&](int p) { return pv[p][i] * pv[p][j]; }, wc, wci, lane) +
            R1m[i][j];
      x[i] = xn[i];
    }
  });
}

template <bool TRAJ>
int launch_ukf(const float* ys, const float* us, const float* x0,
               const float* P0, const float* R1, const float* R2,
               const float* c, float wm, float wmi, float wc, float wci,
               float Wsc, float Ts, int T, float* ll, ScanOut out,
               cudaStream_t stream) {
  ukf_scan_kernel<TRAJ><<<1, 64, 0, stream>>>(
      ys, us, x0, P0, R1, R2, c, wm, wmi, wc, wci, Wsc, Ts, T, ll, out);
  return (int)cudaGetLastError();
}
#endif  // LLPF_UKF

}  // namespace

extern "C" {

#if defined(LLPF_EKF)
// ys [T, NY], us [T, NU] (null when NU = 0), x0 [NX], P0 R1 [NX, NX],
// R2 [NY, NY], c the callbacks' constants; writes ll [1] and, when x is not
// null, the solution (x, xt [T, NX], R, Rt [T, NX, NX], e [T, NY],
// S [T, NY, NY], K [T, NX, NY]).
int llpf_ekf_scan(const float* ys, const float* us, const float* x0,
                  const float* P0, const float* R1, const float* R2,
                  const float* c, float alpha, float Ts, int T, float* ll,
                  float* x, float* R, float* xt, float* Rt, float* e, float* S,
                  float* K, void* stream) {
  if (T < 0) return (int)cudaErrorInvalidValue;
  const ScanOut out{x, R, xt, Rt, e, S, K};
  return x ? launch_ekf<true>(ys, us, x0, P0, R1, R2, c, alpha, Ts, T, ll,
                              out, (cudaStream_t)stream)
           : launch_ekf<false>(ys, us, x0, P0, R1, R2, c, alpha, Ts, T, ll,
                               out, (cudaStream_t)stream);
}
#endif

#if defined(LLPF_UKF)
// as llpf_ekf_scan, with the UT weights (wm, wmi, wc, wci) and the
// Cholesky pre-scaling Wsc in place of alpha
int llpf_ukf_scan(const float* ys, const float* us, const float* x0,
                  const float* P0, const float* R1, const float* R2,
                  const float* c, float wm, float wmi, float wc, float wci,
                  float Wsc, float Ts, int T, float* ll, float* x, float* R,
                  float* xt, float* Rt, float* e, float* S, float* K,
                  void* stream) {
  if (T < 0) return (int)cudaErrorInvalidValue;
  const ScanOut out{x, R, xt, Rt, e, S, K};
  return x ? launch_ukf<true>(ys, us, x0, P0, R1, R2, c, wm, wmi, wc, wci,
                              Wsc, Ts, T, ll, out, (cudaStream_t)stream)
           : launch_ukf<false>(ys, us, x0, P0, R1, R2, c, wm, wmi, wc, wci,
                               Wsc, Ts, T, ll, out, (cudaStream_t)stream);
}
#endif

}  // extern "C"
