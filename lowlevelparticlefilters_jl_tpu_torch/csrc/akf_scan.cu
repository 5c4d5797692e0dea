// Whole-scan affine Kalman filter with a frozen Riccati recursion (kernel H).
//
// Replaces lowlevelparticlefilters_jl_tpu/ops/pallas/ukf_scan.py
// (_akf_kernel_run, ukf_scan.py:739; its pallas_call :997).  The filter is
// a KalmanFilter or an EKF/UKF whose callbacks are affine in x with constant
// Jacobians A, C; the drives c_t = f(0, u_t, t) and d_t = g(0, u_t, t) come
// in as data (kernels/ukf_scan.py evaluates them in one batched call), and
// a drive that is zero at every step as a null pointer, not read (the JAX
// kernel's has_c / has_d).  Per step, in the JAX kernel's order:
//   Riccati (until frozen): S = sym(C R C^T) + R2, K^T = S^{-1} C R by two
//     triangular solves, S^{-1}, Rpost = sym(R - K^T^T C R),
//     Rn = alpha sym(A Rpost A^T) + R1, G = A^T - C^T (K^T A^T),
//     converged when max|Rn - R| <= 1e-7 (1 + max|Rn|), then frozen;
//   data: e = (y - d) - C x, ll += -1/2 (e S^{-1} e^T + log det S
//     + ny log 2 pi), x <- x G + (y - d) K^T A^T + c   (row-vector form).
// The trajectory entry also writes x(t|t-1), R(t|t-1), x(t|t), R(t|t), e,
// S and K per step; after the freeze R(t|t-1) is the last prior computed,
// as in the JAX kernel.
//
// Design.  One thread runs the recursion with its matrices in registers
// (the capacity M is 4 or 8; nx, ny <= M are runtime sizes under
// unrolled, guarded loops, so 4 instances serve every shape).  A second
// warp stages y, c and d into shared memory one chunk of steps ahead
// (scan_common.cuh), so the thread never waits on device memory.
//
// Bound on the card: latency.  The frozen step is one dependent chain of
// about nx + ny multiply-adds on x (x G + y K^T A^T + c), some 30 cycles
// at nx = 4; the data, 8 bytes a step at ny = 2 without drives (32 with
// both at nx = 4), would take 0.12 us at T = 5e4 from HBM.  One SM of 132
// works.  The frozen loop is unrolled 4 times so that a step's innovation
// and ll overlap the next steps' state chain.  Not fixed here: the padded
// capacity M computes ny = 2 outputs on 4 lanes of work.
//
// TPU workarounds not ported: the 128-step lane blocks and iota-mask step
// extraction, the _meta_acc static-offset read-modify-writes of the
// solution, the _mm_rows/_mtm_rows/_tree_sum MXU avoidance, the SMEM
// scalar pair for logdet and the freeze flag, the 64 MiB VMEM solution
// budget.
#include "scan_common.cuh"

namespace {

constexpr float kFtol = 1e-7f;

struct AkfOut {
  float *x, *R, *xt, *Rt, *e, *S, *K;
};

template <int M, bool TRAJ>
__global__ void __launch_bounds__(64)
    akf_scan_kernel(const float* __restrict__ ys, const float* __restrict__ cs,
                    const float* __restrict__ ds, const float* __restrict__ x0,
                    const float* __restrict__ P0, const float* __restrict__ R1,
                    const float* __restrict__ R2, const float* __restrict__ A,
                    const float* __restrict__ C, float alpha, int T, int nx,
                    int ny, float* __restrict__ ll_out, AkfOut out) {
  extern __shared__ float sbuf[];
  const int W = 2 * ny + nx;  // y | c | d of one step
  const int tid = threadIdx.x;
  const bool producer = tid >= 32;
  const bool worker = tid == 0;
  const int nch = (T + kChunk - 1) / kChunk;

  auto stage = [&](int ch) {
    float* b = sbuf + (ch & 1) * kChunk * W;
    const int t0 = ch * kChunk, tc = min(kChunk, T - t0);
    stage_rows(b, ys, ny, t0, tc, tid - 32, 32);
    stage_rows(b + kChunk * ny, cs, nx, t0, tc, tid - 32, 32);
    stage_rows(b + kChunk * (ny + nx), ds, ny, t0, tc, tid - 32, 32);
  };

  float Am[M][M], Cm[M][M], R1m[M][M], R2m[M][M];
  float Rpri[M][M], Rp[M][M], Rpost[M][M], Sm[M][M];
  float Kt[M][M], KtAt[M][M], G[M][M], Sinv[M][M], x[M];
  float logdet = 0.f, ll = 0.f;
  const float nlog2pi = (float)(ny * 1.8378770664093453);
  bool conv = false;
  if (worker) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      x[i] = i < nx ? x0[i] : 0.f;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const bool xx = i < nx && j < nx, yx = i < ny && j < nx,
                   yy = i < ny && j < ny;
        Am[i][j] = xx ? A[i * nx + j] : 0.f;
        R1m[i][j] = xx ? R1[i * nx + j] : 0.f;
        Rpri[i][j] = xx ? P0[i * nx + j] : 0.f;
        Cm[i][j] = yx ? C[i * nx + j] : 0.f;
        R2m[i][j] = yy ? R2[i * ny + j] : 0.f;
      }
    }
  }
  if (producer) {
    // a drive that is zero comes as a null pointer and is never read
    // (stage_rows skips it); its slots in both buffers hold zeros
    for (int k = tid - 32; k < kChunk * (nx + ny); k += 32) {
      const bool c = k < kChunk * nx;
      if (c ? cs != nullptr : ds != nullptr) continue;
      sbuf[kChunk * ny + k] = 0.f;
      sbuf[kChunk * W + kChunk * ny + k] = 0.f;
    }
    if (nch > 0) stage(0);
  }
  __syncthreads();

  for (int ch = 0; ch < nch; ++ch) {
    if (producer && ch + 1 < nch) stage(ch + 1);
    if (worker) {
      const float* b = sbuf + (ch & 1) * kChunk * W;
      const int t0 = ch * kChunk, tc = min(kChunk, T - t0);
      // The Riccati update and the data step are two inlined pieces, and
      // the steps after the freeze run a loop of the data step alone: with
      // the update inside one loop behind `if (!conv)`, the compiler
      // predicates the whole update and every frozen step pays its issue
      // slots.
      auto riccati = [&]() {
        float CR[M][M], CC[M][M], L[M][M], Si[M][M], KC[M][M], AR[M][M];
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j) {
            if (TRAJ) Rp[i][j] = Rpri[i][j];
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < M; ++q) a += Cm[i][q] * Rpri[q][j];
            CR[i][j] = a;
          }
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j) {
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < M; ++q) a += CR[i][q] * Cm[j][q];
            CC[i][j] = a;
          }
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j) {
            Sm[i][j] = 0.5f * (CC[i][j] + CC[j][i]) + R2m[i][j];
            Kt[i][j] = CR[i][j];
            Si[i][j] = i == j ? 1.f : 0.f;
          }
        chol_lower(Sm, L, ny);
        tri_lower(L, Kt, ny, nx);
        tri_upper_t(L, Kt, ny, nx);
        tri_lower(L, Si, ny, ny);
        tri_upper_t(L, Si, ny, ny);
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j) {
            Sinv[i][j] = i < ny && j < ny ? Si[i][j] : 0.f;
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < M; ++q)
              if (q < ny) a += Kt[q][i] * CR[q][j];
            KC[i][j] = Rpri[i][j] - a;
          }
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j)
            Rpost[i][j] = 0.5f * (KC[i][j] + KC[j][i]);
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j) {
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < M; ++q) a += Am[i][q] * Rpost[q][j];
            AR[i][j] = a;
          }
        float dmax = 0.f, nmax = 0.f;
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j) {
            float a = 0.f, b2 = 0.f;
#pragma unroll
            for (int q = 0; q < M; ++q) {
              a += AR[i][q] * Am[j][q];
              b2 += AR[j][q] * Am[i][q];
            }
            const float rn = alpha * (0.5f * (a + b2)) + R1m[i][j];
            dmax = fmaxf(dmax, fabsf(rn - Rpri[i][j]));
            nmax = fmaxf(nmax, fabsf(rn));
            CC[i][j] = rn;  // the next prior
          }
        conv = dmax <= kFtol * (1.f + nmax);
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j) {
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < M; ++q) a += Kt[i][q] * Am[j][q];
            KtAt[i][j] = a;
            Rpri[i][j] = CC[i][j];
          }
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j) {
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < M; ++q) a += Cm[q][i] * KtAt[q][j];
            G[i][j] = Am[j][i] - a;
          }
        float ld = 0.f;
#pragma unroll
        for (int i = 0; i < M; ++i)
          if (i < ny) ld += logf(L[i][i]);
        logdet = 2.f * ld;
      };
      auto data_step = [&](int s) {
        const float* yb = b + s * ny;
        const float* cb = b + kChunk * ny + s * nx;
        const float* db = b + kChunk * (ny + nx) + s * ny;
        float yeff[M], e[M], xn[M];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          yeff[j] = j < ny ? yb[j] - db[j] : 0.f;
          float a = 0.f;
#pragma unroll
          for (int q = 0; q < M; ++q) a += x[q] * Cm[j][q];
          e[j] = yeff[j] - a;
        }
        float qv = 0.f;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < M; ++i) a += e[i] * Sinv[i][j];
          qv += a * e[j];
        }
        ll += -0.5f * (qv + logdet + nlog2pi);
#pragma unroll
        for (int j = 0; j < M; ++j) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < M; ++i) a += x[i] * G[i][j];
#pragma unroll
          for (int i = 0; i < M; ++i) a += yeff[i] * KtAt[i][j];
          xn[j] = j < nx ? a + cb[j] : 0.f;
        }
        if (TRAJ) {
          const int64_t t = t0 + s;
          const int64_t oxx = t * nx * nx, oyy = t * ny * ny, oxy = t * nx * ny;
#pragma unroll
          for (int j = 0; j < M; ++j) {
            if (j >= nx) break;
            float a = x[j];
#pragma unroll
            for (int i = 0; i < M; ++i)
              if (i < ny) a += e[i] * Kt[i][j];
            out.x[t * nx + j] = x[j];
            out.xt[t * nx + j] = a;
#pragma unroll
            for (int i = 0; i < M; ++i) {
              if (i >= nx) break;
              out.R[oxx + j * nx + i] = Rp[j][i];
              out.Rt[oxx + j * nx + i] = Rpost[j][i];
            }
#pragma unroll
            for (int i = 0; i < M; ++i)
              if (i < ny) out.K[oxy + j * ny + i] = Kt[i][j];
          }
#pragma unroll
          for (int j = 0; j < M; ++j) {
            if (j >= ny) break;
            out.e[t * ny + j] = e[j];
#pragma unroll
            for (int i = 0; i < M; ++i)
              if (i < ny) out.S[oyy + j * ny + i] = Sm[j][i];
          }
        }
#pragma unroll
        for (int j = 0; j < M; ++j) x[j] = xn[j];
      };
      int s = 0;
      for (; s < tc && !conv; ++s) {
        riccati();
        data_step(s);
      }
#pragma unroll 4
      for (; s < tc; ++s) data_step(s);
    }
    __syncthreads();
  }
  if (worker) ll_out[0] = ll;
}

template <int M>
int launch(const float* ys, const float* cs, const float* ds, const float* x0,
           const float* P0, const float* R1, const float* R2, const float* A,
           const float* C, float alpha, int T, int nx, int ny, float* ll,
           AkfOut out, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)kChunk * (2 * ny + nx) * sizeof(float);
  if (out.x)
    akf_scan_kernel<M, true><<<1, 64, smem, stream>>>(
        ys, cs, ds, x0, P0, R1, R2, A, C, alpha, T, nx, ny, ll, out);
  else
    akf_scan_kernel<M, false><<<1, 64, smem, stream>>>(
        ys, cs, ds, x0, P0, R1, R2, A, C, alpha, T, nx, ny, ll, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ys [T, ny], cs [T, nx], ds [T, ny], x0 [nx], P0 R1 A [nx, nx], R2 [ny, ny],
// C [ny, nx]; writes ll [1] and, when x is not null, the solution
// x, xt [T, nx], R, Rt [T, nx, nx], e [T, ny], S [T, ny, ny], K [T, nx, ny].
int llpf_akf_scan(const float* ys, const float* cs, const float* ds,
                  const float* x0, const float* P0, const float* R1,
                  const float* R2, const float* A, const float* C, float alpha,
                  int T, int nx, int ny, float* ll, float* x, float* R,
                  float* xt, float* Rt, float* e, float* S, float* K,
                  void* stream) {
  if (nx < 1 || nx > 8 || ny < 1 || ny > 8 || T < 0)
    return (int)cudaErrorInvalidValue;
  const AkfOut out{x, R, xt, Rt, e, S, K};
  const cudaStream_t st = (cudaStream_t)stream;
  if (nx <= 4 && ny <= 4)
    return launch<4>(ys, cs, ds, x0, P0, R1, R2, A, C, alpha, T, nx, ny, ll,
                     out, st);
  return launch<8>(ys, cs, ds, x0, P0, R1, R2, A, C, alpha, T, nx, ny, ll,
                   out, st);
}

}  // extern "C"
