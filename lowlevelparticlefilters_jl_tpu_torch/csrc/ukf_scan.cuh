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
// (LLPF_UKF or LLPF_EKF), the hook switches, the count of the callbacks'
// constants (LLPF_NC), and the user callbacks as scalar code
// (kernels/callback_codegen.py: for G cb_f, cb_g and, where present,
// cb_inn, cb_mean, cb_smean; for I cb_fvj and cb_gvj, each the value and
// then the Jacobian in x, differentiated at code generation or the user's
// Ajac/Cjac), then includes this file; nvcc builds it for sm_90a at first
// use.  The callbacks' tensor constants arrive in `c`, read on each call.
//
// Design.  I: see ekf_scan_kernel.  G: one warp; lane i < 2 NX + 1
// evaluates the callback on sigma point i, and the UT sums are butterfly
// shuffles, so every lane holds every sum.  The Cholesky factors and the
// solves are the same on all lanes (each lane computes them; nothing is
// broadcast).  The mean and state-mean hooks see all sigma points, which
// each lane gathers with shuffles.  In both, a second warp stages y and u
// into shared memory a chunk of steps ahead (scan_common.cuh).
//
// Bound on the card: latency.  Each step is a serial chain of dependent
// operations (two callback passes, the Cholesky factorizations, the
// solves; for G the shuffles) on one warp of one SM of 132.  The chain is
// read from the SASS by kernels/sass.py (PERF.md).
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
constexpr int NSIG = 2 * NX + 1;
constexpr unsigned kFull = 0xffffffffu;

struct ScanOut {
  float *x, *R, *xt, *Rt, *e, *S, *K;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// one step's solution: prior (xp, Rp), posterior (x, R), e, S and K^T
__device__ __forceinline__ void write_step(
    const ScanOut& out, int64_t t, const float (&xp)[NX],
    const float (&Rp)[NX][NX], const float (&x)[NX], const float (&R)[NX][NX],
    const float (&e)[NY], const float (&S)[NY][NY],
    const float (&Kt)[NY][NX]) {
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    out.x[t * NX + i] = xp[i];
    out.xt[t * NX + i] = x[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      out.R[(t * NX + i) * NX + j] = Rp[i][j];
      out.Rt[(t * NX + i) * NX + j] = R[i][j];
    }
#pragma unroll
    for (int j = 0; j < NY; ++j) out.K[(t * NX + i) * NY + j] = Kt[j][i];
  }
#pragma unroll
  for (int i = 0; i < NY; ++i) {
    out.e[t * NY + i] = e[i];
#pragma unroll
    for (int j = 0; j < NY; ++j) out.S[(t * NY + i) * NY + j] = S[i][j];
  }
}

// the correct step once L = chol(S), the innovation e and the gain's
// right-hand side (K^T = S^{-1} Kt on entry) are known: K^T, the posterior
// mean x + e K^T, and the step's log-likelihood
__device__ __forceinline__ float gain_and_ll(const float (&L)[NY][NY],
                                             const float (&e)[NY],
                                             float (&Kt)[NY][NX],
                                             float (&x)[NX]) {
  tri_lower(L, Kt, NY, NX);
  tri_upper_t(L, Kt, NY, NX);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < NY; ++j) a += e[j] * Kt[j][i];
    x[i] += a;
  }
  float w[NY][1];
#pragma unroll
  for (int j = 0; j < NY; ++j) w[j][0] = e[j];
  tri_lower(L, w, NY, 1);
  float q = 0.f, ld = 0.f;
#pragma unroll
  for (int j = 0; j < NY; ++j) {
    q += w[j][0] * w[j][0];
    ld += logf(L[j][j]);
  }
  return -0.5f * (q + 2.f * ld + (float)(NY * 1.8378770664093453));
}

// y | u of the steps of chunk ch, by the 32 threads of the staging warp
__device__ __forceinline__ void stage_chunk(float* b, const float* ys,
                                            const float* us, int ch, int T,
                                            int lane) {
  const int t0 = ch * kChunk, tc = min(kChunk, T - t0);
  stage_rows(b, ys, NY, t0, tc, lane, 32);
  stage_rows(b + kChunk * NY, us, NU, t0, tc, lane, 32);
}

template <int N>
__device__ __forceinline__ void copy_mat(const float (&a)[N][N],
                                         float (&b)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) b[i][j] = a[i][j];
}

#if defined(LLPF_EKF)
// ---------------------------------------------------------------------------
// kernel I: the EKF (ukf_scan.py:1183-1230)
// ---------------------------------------------------------------------------

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
__host__ __device__ constexpr int ekf_chunk(int floats_a_step, int fixed) {
  int ch = 128;
  while (ch > 8 && 2 * ch * floats_a_step * 4 + fixed > kSmemBytes) ch /= 2;
  return ch;
}

// whether the constants go to shared memory beside a ring of this width
__host__ __device__ constexpr bool ekf_consts_shared(int floats_a_step) {
  return LLPF_NC > 64 && 2 * 8 * floats_a_step * 4 + NC * 4 <= kSmemBytes;
}

// index of (i, j) in a lower-packed symmetric n x n matrix
__host__ __device__ constexpr int pk(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// the ll term of one ring entry: w = L^{-1} e, -(|w|^2 + 2 log|L| +
// NY log 2 pi) / 2 (gain_and_ll's formulas)
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

// Design.  One thread (the worker) runs the recursion, its state and the
// callbacks' constants in registers (beyond 64 constants, in shared or
// device memory: above), and does only the work the next step
// depends on: the value-and-Jacobian callbacks (cb_gvj, cb_fvj: the
// Jacobians differentiated at code generation, or the user's), the
// symmetric products built once and mirrored, the Cholesky factor with
// one rsqrtf a diagonal entry and multiplications by the reciprocal
// diagonal everywhere else.  Each step it leaves e and L (and, for the
// trajectory, the solution fields) in a shared-memory ring; the second
// warp, which also stages y and u a chunk ahead, reads the previous chunk
// from the ring, sums the ll terms (each lane its steps in order, then a
// butterfly over the lanes) and writes the trajectory with coalesced
// stores.  The two warps meet at one __syncthreads a chunk.
template <bool TRAJ>
__global__ void __launch_bounds__(64)
    ekf_scan_kernel(const float* __restrict__ ys, const float* __restrict__ us,
                    const float* __restrict__ x0, const float* __restrict__ P0,
                    const float* __restrict__ R1, const float* __restrict__ R2,
                    const float* __restrict__ c, float alpha, float Ts, int T,
                    float* __restrict__ ll_out, ScanOut out) {
  constexpr int RW = TRAJ ? kRingTraj : kRingLL;
  constexpr bool kCsShared = ekf_consts_shared(RW + NY + NUB);
  constexpr int CH = ekf_chunk(RW + NY + NUB, kCsShared ? NC * 4 : 0);
  __shared__ float sbuf[2][CH * (NY + NUB)];
  __shared__ float ring[2][CH * RW];
  const int tid = threadIdx.x, lane = tid & 31;
  const bool producer = tid >= 32, worker = tid == 0;
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
  float x[NX], R[NX][NX], R1m[NX][NX], R2m[NY][NY];
  if (worker) {
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
      for (int s = 0; s < tc; ++s) {
        const int64_t t = t0 + s;
        const float* y = b + s * NY;
        const float* u = b + CH * NY + s * NU;
        float* r = ring[ch & 1] + s * RW;
        const float tk = (float)t * Ts;
        // ---- correct ------------------------------------------------------
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
        // L = chol(S): one rsqrtf a diagonal entry, products elsewhere
#pragma unroll
        for (int i = 0; i < NY; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) {
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
        // K^T = S^{-1} C R: L^{-1} then L^{-T}, by the reciprocal diagonal
#pragma unroll
        for (int j = 0; j < NY; ++j)
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            float a = CR[j][i];
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
#pragma unroll
        for (int j = 0; j < NY; ++j) {
          e[j] = y[j] - gv[j];
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
        if (TRAJ) {
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            r[kOffXt + i] = x[i];
#pragma unroll
            for (int j = 0; j <= i; ++j) r[kOffRt + pk(i, j)] = R[i][j];
#pragma unroll
            for (int j = 0; j < NY; ++j) r[kOffK + i * NY + j] = Kt[j][i];
          }
        }
        // ---- predict ------------------------------------------------------
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
      }
    }
    __syncthreads();
  }
  if (producer) {
    if (nch > 0) consume(nch - 1);
    ll = warp_sum(ll);
    if (lane == 0) ll_out[0] = ll;
  }
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

// this lane's sigma point of N(x, R): x, x + col_j of chol(W R), x - col_j
__device__ __forceinline__ void sigma_point(const float (&x)[NX],
                                            const float (&R)[NX][NX],
                                            float Wsc, int lane,
                                            float (&s)[NX]) {
  float WR[NX][NX], L[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j)
      WR[i][j] = 0.5f * (Wsc * R[i][j] + Wsc * R[j][i]);
  chol_lower(WR, L, NX);
  const int k = lane - 1;
  const float sg = k < NX ? 1.f : -1.f;
  const int col = k < NX ? k : k - NX;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < NX; ++j) d = j == col ? L[i][j] : d;
    s[i] = (lane >= 1 && lane < NSIG) ? x[i] + sg * d : x[i];
  }
}

// every lane's copy of the N-vectors v of lanes 0..NSIG-1, row-major
template <int N>
__device__ __forceinline__ void gather(const float (&v)[N],
                                       float (&all)[NSIG * N]) {
#pragma unroll
  for (int k = 0; k < NSIG; ++k)
#pragma unroll
    for (int j = 0; j < N; ++j) all[k * N + j] = __shfl_sync(kFull, v[j], k);
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

template <bool TRAJ>
__global__ void __launch_bounds__(64)
    ukf_scan_kernel(const float* __restrict__ ys, const float* __restrict__ us,
                    const float* __restrict__ x0, const float* __restrict__ P0,
                    const float* __restrict__ R1, const float* __restrict__ R2,
                    const float* __restrict__ c, float wm, float wmi,
                    float wc, float wci, float Wsc, float Ts, int T,
                    float* __restrict__ ll_out, ScanOut out) {
  __shared__ float sbuf[2][kChunk * (NY + NUB)];
  const int tid = threadIdx.x;
  const bool producer = tid >= 32, worker = tid < 32;
  const int lane = tid & 31;
  const bool active = lane < NSIG;
  // weights of this lane's sigma point; 0 for lanes past the last point
  const float wmean = active ? (lane == 0 ? wm : wmi) : 0.f;
  const float wcov = active ? (lane == 0 ? wc : wci) : 0.f;
  const int nch = (T + kChunk - 1) / kChunk;
  float x[NX], R[NX][NX], R1m[NX][NX], R2m[NY][NY];
  float ll = 0.f;
  if (worker) {
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
  if (producer && nch > 0) stage_chunk(sbuf[0], ys, us, 0, T, lane);
  __syncthreads();
  for (int ch = 0; ch < nch; ++ch) {
    if (producer && ch + 1 < nch)
      stage_chunk(sbuf[(ch + 1) & 1], ys, us, ch + 1, T, lane);
    if (worker) {
      const float* b = sbuf[ch & 1];
      const int t0 = ch * kChunk, tc = min(kChunk, T - t0);
      for (int s = 0; s < tc; ++s) {
        const int64_t t = t0 + s;
        const float* y = b + s * NY;
        const float* u = b + kChunk * NY + s * NU;
        const float tk = (float)t * Ts;
        // ---- correct ------------------------------------------------------
        float sp[NX], yv[NY], ym[NY];
        sigma_point(x, R, Wsc, lane, sp);
        cb_g(sp, u, &tk, c, yv);
        if (LLPF_HOOK_MEAN) {
          float all[NSIG * NY];
          gather(yv, all);
          cb_mean(all, c, ym);
        } else {
#pragma unroll
          for (int j = 0; j < NY; ++j) ym[j] = warp_sum(wmean * yv[j]);
        }
        float dy[NY], dx[NX], S[NY][NY], L[NY][NY], Kt[NY][NX], e[NY];
#pragma unroll
        for (int j = 0; j < NY; ++j) dy[j] = yv[j] - ym[j];
#pragma unroll
        for (int i = 0; i < NX; ++i) dx[i] = sp[i] - x[i];
        {
          float C2[NY][NY];
#pragma unroll
          for (int a = 0; a < NY; ++a)
#pragma unroll
            for (int q = 0; q < NY; ++q) C2[a][q] = warp_sum(dy[a] * wcov * dy[q]);
#pragma unroll
          for (int a = 0; a < NY; ++a)
#pragma unroll
            for (int q = 0; q < NY; ++q)
              S[a][q] = 0.5f * (C2[a][q] + C2[q][a]) + R2m[a][q];
        }
        // K^T's right-hand side: the cross-covariance, transposed
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NY; ++j) Kt[j][i] = warp_sum(dx[i] * wcov * dy[j]);
        chol_lower(S, L, NY);
        if (LLPF_HOOK_INN) {
          cb_inn(y, ym, c, e);
        } else {
#pragma unroll
          for (int j = 0; j < NY; ++j) e[j] = y[j] - ym[j];
        }
        float xp[NX], Rp[NX][NX];
        if (TRAJ) {
#pragma unroll
          for (int i = 0; i < NX; ++i) xp[i] = x[i];
          copy_mat(R, Rp);
        }
        ll += gain_and_ll(L, e, Kt, x);
        {
          float KS[NX][NY], KSK[NX][NX];
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
            for (int j = 0; j < NX; ++j) {
              float a = 0.f;
#pragma unroll
              for (int q = 0; q < NY; ++q) a += KS[i][q] * Kt[q][j];
              KSK[i][j] = R[i][j] - a;
            }
#pragma unroll
          for (int i = 0; i < NX; ++i)
#pragma unroll
            for (int j = 0; j < NX; ++j)
              R[i][j] = 0.5f * (KSK[i][j] + KSK[j][i]);
        }
        if (TRAJ && lane == 0) write_step(out, t, xp, Rp, x, R, e, S, Kt);
        // ---- predict ------------------------------------------------------
        float pv[NX], xn[NX];
        sigma_point(x, R, Wsc, lane, sp);
        cb_f(sp, u, &tk, c, pv);
        if (LLPF_HOOK_SMEAN) {
          float all[NSIG * NX];
          gather(pv, all);
          cb_smean(all, c, xn);
        } else {
#pragma unroll
          for (int i = 0; i < NX; ++i) xn[i] = warp_sum(wmean * pv[i]);
        }
        float dp[NX], P2[NX][NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) dp[i] = pv[i] - xn[i];
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) P2[i][j] = warp_sum(dp[i] * wcov * dp[j]);
#pragma unroll
        for (int i = 0; i < NX; ++i) {
#pragma unroll
          for (int j = 0; j < NX; ++j)
            R[i][j] = 0.5f * (P2[i][j] + P2[j][i]) + R1m[i][j];
          x[i] = xn[i];
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) ll_out[0] = ll;
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
