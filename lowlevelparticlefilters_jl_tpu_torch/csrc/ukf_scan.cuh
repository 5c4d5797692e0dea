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
// (LLPF_UKF or LLPF_EKF), the hook and Jacobian switches, and the user
// callbacks as scalar code (kernels/callback_codegen.py: cb_f, cb_g and,
// where present, cb_fjac, cb_gjac, cb_inn, cb_mean, cb_smean), then
// includes this file; nvcc builds it for sm_90a at first use.  The
// callbacks' tensor constants arrive in `c`, read on each call.
//
// Design.  I: one thread runs the recursion, its state in registers; the
// measurement and dynamics are evaluated on Dual<NX> numbers, which gives
// each value and its Jacobian in one pass.  G: one warp; lane i < 2 NX + 1
// evaluates the callback on sigma point i, and the UT sums are butterfly
// shuffles, so every lane holds every sum.  The Cholesky factors and the
// solves are the same on all lanes (each lane computes them; nothing is
// broadcast).  The mean and state-mean hooks see all sigma points, which
// each lane gathers with shuffles.  In both, a second warp stages y and u
// into shared memory a chunk of steps ahead (scan_common.cuh).
//
// Bound on the card: latency.  Each step is a serial chain of a few
// hundred dependent operations (two callback passes, two Cholesky
// factorizations for G, the solves, the shuffles); one SM of 132 works.
// Not fixed here.
//
// TPU workarounds not ported: the 128-step lane blocks and iota-mask step
// extraction, _meta_acc's static-offset read-modify-writes, the rank-2-only
// _tri_solve_scalar rule, _wcol/_wrow_mean, the 0-D constant (1, 1)
// reshapes, the 64 MiB VMEM solution budget, default_matmul_precision
// ("highest") (all arithmetic here is plain float32).
#pragma once
#include "dual.cuh"
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

// value and Jacobian of a callback at x: by Dual<NX> numbers, or from the
// user's Jacobian callback
#define LLPF_VALUE_AND_JAC(CB, CBJAC, USER, NOUT, val, jac)                 \
  if (USER) {                                                               \
    CB<float>(x, u, &tk, c, val);                                           \
    float flat_[NOUT * NX];                                                 \
    CBJAC<float>(x, u, &tk, c, flat_);                                      \
    _Pragma("unroll") for (int r_ = 0; r_ < NOUT; ++r_)                     \
        _Pragma("unroll") for (int q_ = 0; q_ < NX; ++q_)                   \
            jac[r_][q_] = flat_[r_ * NX + q_];                              \
  } else {                                                                  \
    Dual<NX> xd_[NX], od_[NOUT];                                            \
    _Pragma("unroll") for (int q_ = 0; q_ < NX; ++q_) {                     \
      xd_[q_] = Dual<NX>(x[q_]);                                            \
      xd_[q_].d[q_] = 1.f;                                                  \
    }                                                                       \
    CB<Dual<NX>>(xd_, u, &tk, c, od_);                                      \
    _Pragma("unroll") for (int r_ = 0; r_ < NOUT; ++r_) {                   \
      val[r_] = od_[r_].v;                                                  \
      _Pragma("unroll") for (int q_ = 0; q_ < NX; ++q_) jac[r_][q_] =       \
          od_[r_].d[q_];                                                    \
    }                                                                       \
  }

#if !LLPF_USER_CJAC
template <class S>
__device__ __forceinline__ void cb_gjac(const float*, const float*,
                                        const float*, const float*, S*) {}
#endif
#if !LLPF_USER_AJAC
template <class S>
__device__ __forceinline__ void cb_fjac(const float*, const float*,
                                        const float*, const float*, S*) {}
#endif

template <bool TRAJ>
__global__ void __launch_bounds__(64)
    ekf_scan_kernel(const float* __restrict__ ys, const float* __restrict__ us,
                    const float* __restrict__ x0, const float* __restrict__ P0,
                    const float* __restrict__ R1, const float* __restrict__ R2,
                    const float* __restrict__ c, float alpha, float Ts, int T,
                    float* __restrict__ ll_out, ScanOut out) {
  __shared__ float sbuf[2][kChunk * (NY + NUB)];
  const int tid = threadIdx.x;
  const bool producer = tid >= 32, worker = tid == 0;
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
  if (producer && nch > 0) stage_chunk(sbuf[0], ys, us, 0, T, tid - 32);
  __syncthreads();
  for (int ch = 0; ch < nch; ++ch) {
    if (producer && ch + 1 < nch)
      stage_chunk(sbuf[(ch + 1) & 1], ys, us, ch + 1, T, tid - 32);
    if (worker) {
      const float* b = sbuf[ch & 1];
      const int t0 = ch * kChunk, tc = min(kChunk, T - t0);
      for (int s = 0; s < tc; ++s) {
        const int64_t t = t0 + s;
        const float* y = b + s * NY;
        const float* u = b + kChunk * NY + s * NU;
        const float tk = (float)t * Ts;
        // ---- correct ------------------------------------------------------
        float gx[NY], Cj[NY][NX];
        LLPF_VALUE_AND_JAC(cb_g, cb_gjac, LLPF_USER_CJAC, NY, gx, Cj)
        float CR[NY][NX], Kt[NY][NX], CC[NY][NY], S[NY][NY], L[NY][NY], e[NY];
#pragma unroll
        for (int j = 0; j < NY; ++j)
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < NX; ++q) a += Cj[j][q] * R[q][i];
            CR[j][i] = a;
            Kt[j][i] = a;
          }
#pragma unroll
        for (int i = 0; i < NY; ++i)
#pragma unroll
          for (int j = 0; j < NY; ++j) {
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < NX; ++q) a += CR[i][q] * Cj[j][q];
            CC[i][j] = a;
          }
#pragma unroll
        for (int i = 0; i < NY; ++i) {
          e[i] = y[i] - gx[i];
#pragma unroll
          for (int j = 0; j < NY; ++j)
            S[i][j] = 0.5f * (CC[i][j] + CC[j][i]) + R2m[i][j];
        }
        chol_lower(S, L, NY);
        float xp[NX], Rp[NX][NX];
        if (TRAJ) {
#pragma unroll
          for (int i = 0; i < NX; ++i) xp[i] = x[i];
          copy_mat(R, Rp);
        }
        ll += gain_and_ll(L, e, Kt, x);
        float KC[NX][NX];
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < NY; ++q) a += Kt[q][i] * CR[q][j];
            KC[i][j] = R[i][j] - a;
          }
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) R[i][j] = 0.5f * (KC[i][j] + KC[j][i]);
        if (TRAJ) write_step(out, t, xp, Rp, x, R, e, S, Kt);
        // ---- predict ------------------------------------------------------
        float xn[NX], Aj[NX][NX], AR[NX][NX];
        LLPF_VALUE_AND_JAC(cb_f, cb_fjac, LLPF_USER_AJAC, NX, xn, Aj)
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < NX; ++q) a += Aj[i][q] * R[q][j];
            AR[i][j] = a;
          }
#pragma unroll
        for (int i = 0; i < NX; ++i) {
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            float a = 0.f, b2 = 0.f;
#pragma unroll
            for (int q = 0; q < NX; ++q) {
              a += AR[i][q] * Aj[j][q];
              b2 += AR[j][q] * Aj[i][q];
            }
            R[i][j] = alpha * (0.5f * (a + b2)) + R1m[i][j];
          }
          x[i] = xn[i];
        }
      }
    }
    __syncthreads();
  }
  if (worker) ll_out[0] = ll;
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
template <class S>
__device__ __forceinline__ void cb_mean(const float*, const float*, S*) {}
#endif
#if !LLPF_HOOK_SMEAN
template <class S>
__device__ __forceinline__ void cb_smean(const float*, const float*, S*) {}
#endif
#if !LLPF_HOOK_INN
template <class S>
__device__ __forceinline__ void cb_inn(const float*, const float*,
                                       const float*, S*) {}
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
        cb_g<float>(sp, u, &tk, c, yv);
        if (LLPF_HOOK_MEAN) {
          float all[NSIG * NY];
          gather(yv, all);
          cb_mean<float>(all, c, ym);
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
          cb_inn<float>(y, ym, c, e);
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
        cb_f<float>(sp, u, &tk, c, pv);
        if (LLPF_HOOK_SMEAN) {
          float all[NSIG * NX];
          gather(pv, all);
          cb_smean<float>(all, c, xn);
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
