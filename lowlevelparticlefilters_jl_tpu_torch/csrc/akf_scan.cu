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
// Design: a serial prefix and a parallel tail, in one launch of one block
// of 256 threads.
// - The prefix, up to the freeze at step t_f (step 74 on the CV model):
//   thread 0 runs the Riccati update and the data step with its matrices
//   in registers, while a second warp stages y, c and d into shared memory
//   one chunk of steps ahead (scan_common.cuh).  The capacity M is 4 or 8
//   with nx, ny <= M runtime sizes under guarded loops; the whole-scan
//   cell's CV model (4 x 2) has an exact instance, in which every guard
//   folds and the padding is not computed (5263 against 7977 cycles a
//   Riccati step, before the reciprocals below).  S^{-1} is
//   applied with the reciprocals of its factor's diagonal (one division a
//   row, not one an entry).
// - The tail, steps t_f..T-1, is the linear recursion x_{t+1} = x_t G + b_t
//   with constant G and b_t = (y_t - d_t) K^T A^T + c_t: a chunked scan
//   over the block's threads, exact in real arithmetic.  Thread k runs its
//   chunk of L steps from zero (chunk 0 from x(t_f)), reading its rows
//   straight from device memory; the chunk ends are combined by a
//   Kogge-Stone scan in shared memory whose level d multiplies by
//   G^{L 2^d} (warp 0 forms G^L by squaring); then each thread runs its
//   chunk again from its true start state, computing e_t, the ll terms and,
//   in trajectory mode, x(t|t-1), x(t|t) and e_t.  The ll is summed in a
//   fixed tree order, so two calls give equal bits.  The frozen fields (R,
//   Rt, S, K) are the same every step and are written flat, coalesced.
// Reassociating the recursion changes the last bits: the error of a chunk's
// carried start is multiplied by powers of G, damped for the steady-state
// filter of a detectable model (spectral radius of G below 1).
//
// Bound on the card: the prefix is a serial chain on one thread (about
// 1300 cycles a Riccati step at 4 x 2); the tail is two passes of about
// nx (nx + 2 ny) multiply-adds a step over 8 warps of one SM, against its
// bytes (8 a step at ny = 2 without drives, 0.12 us at T = 5e4 from HBM).
// One SM works: a grid would need its carries exchanged across blocks.  In
// trajectory mode the stores of one SM bound the call (PERF.md).
//
// TPU workarounds not ported: the 128-step lane blocks and iota-mask step
// extraction, the _meta_acc static-offset read-modify-writes of the
// solution, the _mm_rows/_mtm_rows/_tree_sum MXU avoidance, the SMEM
// scalar pair for logdet and the freeze flag, the 64 MiB VMEM solution
// budget.
#include <algorithm>
#include <type_traits>

#include "scan_common.cuh"

namespace {

constexpr float kFtol = 1e-7f;
constexpr int kThreads = 256;  // the block; the tail's chunks
constexpr int kLevels = 8;     // log2(kThreads): the scan's levels

struct AkfOut {
  float *x, *R, *xt, *Rt, *e, *S, *K;
};

// what the prefix hands the tail: the frozen filter and the state at t_f
template <int M>
struct Frozen {
  float G[M][M], KtAt[M][M], C[M][M], Sinv[M][M], Kt[M][M];
  float Rp[M][M], Rpost[M][M], S[M][M];
  float x[M];
  float logdet, ll;
  int tf;
};

// C <- A B for nx x nx matrices (stride M) in shared memory, by one warp;
// C may alias A or B.  The whole M x M tile of C is written, zeros outside
// nx x nx, so the scan's products over M read no stale padding.
template <int M>
__device__ __forceinline__ void warp_matmul(const float* A, const float* B,
                                            float* C, int nx, int lane) {
  float r[(M * M + 31) / 32];
#pragma unroll
  for (int q = 0; q < (M * M + 31) / 32; ++q) {
    const int e = lane + 32 * q, i = e / M, j = e % M;
    r[q] = 0.f;
    if (e < M * M && i < nx && j < nx)
      for (int k = 0; k < nx; ++k) r[q] += A[i * M + k] * B[k * M + j];
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < (M * M + 31) / 32; ++q) {
    const int e = lane + 32 * q;
    if (e < M * M) C[e] = r[q];
  }
  __syncwarp();
}

// dst[0:n] <- v[0:n], one 16- or 8-byte store where the exact size N is 4
// or 2 (a row of a [T, N] array is then that aligned), else floats
template <int N, int M>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[M],
                                          int n) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < M; ++j)
      if (j < n) dst[j] = v[j];
  }
}

// B <- S^{-1} B for the first n rows and c columns of B, S = L L^T: the
// forward and back substitutions of scan_common.cuh's tri_lower and
// tri_upper_t, multiplying by Li, the reciprocals of L's diagonal
template <int M>
__device__ __forceinline__ void solve_rcp(const float (&L)[M][M],
                                          const float (&Li)[M],
                                          float (&B)[M][M], int n, int c) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i >= n) break;
#pragma unroll
    for (int q = 0; q < M; ++q) {
      if (q >= c) break;
      float s = B[i][q];
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (k < i) s -= L[i][k] * B[k][q];
      B[i][q] = s * Li[i];
    }
  }
#pragma unroll
  for (int ii = M - 1; ii >= 0; --ii) {
    if (ii >= n) continue;
#pragma unroll
    for (int q = 0; q < M; ++q) {
      if (q >= c) break;
      float s = B[ii][q];
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (k > ii && k < n) s -= L[k][ii] * B[k][q];
      B[ii][q] = s * Li[ii];
    }
  }
}

// NX, NY > 0: an instance for that exact shape (every guard on nx, ny
// folds at compile time); 0: the sizes are the runtime nx_, ny_ <= M
template <int M, int NX, int NY, bool TRAJ>
__global__ void __launch_bounds__(kThreads)
    akf_scan_kernel(const float* __restrict__ ys, const float* __restrict__ cs,
                    const float* __restrict__ ds, const float* __restrict__ x0,
                    const float* __restrict__ P0, const float* __restrict__ R1,
                    const float* __restrict__ R2, const float* __restrict__ A,
                    const float* __restrict__ C, float alpha, int T, int nx_,
                    int ny_, float* __restrict__ ll_out, AkfOut out,
                    long long* __restrict__ stats) {
  extern __shared__ float sbuf[];
  const int nx = NX > 0 ? NX : nx_, ny = NY > 0 ? NY : ny_;
  __shared__ Frozen<M> fz;
  __shared__ float sR[kThreads][M];      // chunk ends, then scanned
  __shared__ float sH[kLevels][M * M];   // G^{L 2^d}
  __shared__ float sB[M * M];            // the squared base of G^L
  __shared__ float sLL[kThreads];
  __shared__ __align__(16) float sF[4][M * M];  // the frozen fields' steps
  const int W = 2 * ny + nx;  // y | c | d of one step
  const int tid = threadIdx.x;
  // block 0 filters; in trajectory mode the other blocks run the same
  // data-independent Riccati recursion (the same instructions, so the same
  // bits and the same t_f) and write their share of the frozen fields
  const bool main_block = blockIdx.x == 0;
  const bool producer = main_block && tid >= 32 && tid < 64;
  const bool worker = tid == 0;
  const int nch = (T + kChunk - 1) / kChunk;
  const long long clk0 = stats && worker ? clock64() : 0;

  auto stage = [&](int ch) {
    float* b = sbuf + (ch & 1) * kChunk * W;
    const int t0 = ch * kChunk, tc = min(kChunk, T - t0);
    stage_rows(b, ys, ny, t0, tc, tid - 32, 32);
    stage_rows(b + kChunk * ny, cs, nx, t0, tc, tid - 32, 32);
    stage_rows(b + kChunk * (ny + nx), ds, ny, t0, tc, tid - 32, 32);
  };

  // ---- the prefix: one thread, until the freeze ---------------------------
  // in an exact-shape instance the padding rows beyond ny are skipped
  // (their entries stay zero); a generic instance computes them (zeros)
  auto yrow = [](int i) { return NY == 0 || i < NY; };
  float Am[M][M], Cm[M][M], R1m[M][M], R2m[M][M];
  float Rpri[M][M], Rp[M][M], Rpost[M][M], Sm[M][M] = {};
  float Kt[M][M] = {}, KtAt[M][M] = {}, G[M][M], Sinv[M][M], x[M];
  float logdet = 0.f, ll = 0.f;
  const float nlog2pi = (float)(ny * 1.8378770664093453);
  bool conv = false;
  int tf = T;
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
      // The Riccati update and the data step are two inlined pieces.
      auto riccati = [&]() {
        float CR[M][M] = {}, CC[M][M] = {}, L[M][M], Si[M][M], KC[M][M],
              AR[M][M], Li[M];
        if (TRAJ) {
#pragma unroll
          for (int i = 0; i < M; ++i)
#pragma unroll
            for (int j = 0; j < M; ++j) Rp[i][j] = Rpri[i][j];
        }
#pragma unroll
        for (int i = 0; i < M; ++i) {
          if (!yrow(i)) continue;
#pragma unroll
          for (int j = 0; j < M; ++j) {
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < M; ++q) a += Cm[i][q] * Rpri[q][j];
            CR[i][j] = a;
          }
        }
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j) {
            if (!yrow(i) || !yrow(j)) continue;
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < M; ++q) a += CR[i][q] * Cm[j][q];
            CC[i][j] = a;
          }
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j) {
            if (yrow(i) && yrow(j))
              Sm[i][j] = 0.5f * (CC[i][j] + CC[j][i]) + R2m[i][j];
            Kt[i][j] = CR[i][j];
            Si[i][j] = i == j ? 1.f : 0.f;
          }
        // S^{-1} applied by two triangular solves with the reciprocals of
        // L's diagonal (one division a row, not one an entry)
        chol_lower(Sm, L, ny);
#pragma unroll
        for (int i = 0; i < M; ++i) Li[i] = i < ny ? 1.f / L[i][i] : 0.f;
        solve_rcp(L, Li, Kt, ny, nx);
        solve_rcp(L, Li, Si, ny, ny);
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
            Rpri[i][j] = rn;  // the next prior
          }
        conv = dmax <= kFtol * (1.f + nmax);
#pragma unroll
        for (int i = 0; i < M; ++i) {
          if (!yrow(i)) continue;
#pragma unroll
          for (int j = 0; j < M; ++j) {
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < M; ++q) a += Kt[i][q] * Am[j][q];
            KtAt[i][j] = a;
          }
        }
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j) {
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < M; ++q)
              if (yrow(q)) a += Cm[q][i] * KtAt[q][j];
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
          for (int q = 0; q < M; ++q)
            if (yrow(j)) a += x[q] * Cm[j][q];
          e[j] = yeff[j] - a;
        }
        float qv = 0.f;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          if (!yrow(j)) continue;
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < M; ++i)
            if (yrow(i)) a += e[i] * Sinv[i][j];
          qv += a * e[j];
        }
        ll += -0.5f * (qv + logdet + nlog2pi);
#pragma unroll
        for (int j = 0; j < M; ++j) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < M; ++i) a += x[i] * G[i][j];
#pragma unroll
          for (int i = 0; i < M; ++i)
            if (yrow(i)) a += yeff[i] * KtAt[i][j];
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
        if (main_block) data_step(s);
      }
      if (conv) tf = t0 + s;  // the first step of the tail
    }
    // every thread leaves together once the worker has frozen
    if (__syncthreads_or(worker && conv)) break;
  }
  if (worker) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      fz.x[i] = x[i];
#pragma unroll
      for (int j = 0; j < M; ++j) {
        fz.G[i][j] = G[i][j];
        fz.KtAt[i][j] = KtAt[i][j];
        fz.C[i][j] = Cm[i][j];
        fz.Sinv[i][j] = Sinv[i][j];
        fz.Kt[i][j] = Kt[i][j];
        if (TRAJ) {
          fz.Rp[i][j] = Rp[i][j];
          fz.Rpost[i][j] = Rpost[i][j];
          fz.S[i][j] = Sm[i][j];
        }
      }
    }
    fz.logdet = logdet;
    fz.ll = ll;
    fz.tf = tf;
  }
  __syncthreads();
  const long long clk1 = stats && worker ? clock64() : 0;

  tf = fz.tf;
  const int n = T - tf;
  // the frozen fields R, Rt, S and K of steps [s0, s1), the same every
  // step, written flat so that a warp's stores are contiguous: each
  // field's step (row-major, as the solution stores it) in a compact
  // table, copied out by 16-byte stores where the field's size is a
  // multiple of 4 (its rows then start 16-byte aligned), else by floats
  auto frozen_fields = [&](int64_t s0, int64_t s1) {
    for (int e = tid; e < M * M; e += kThreads) {
      const int i = e / M, j = e % M;
      if (i < nx && j < nx) {
        sF[0][i * nx + j] = fz.Rp[i][j];
        sF[1][i * nx + j] = fz.Rpost[i][j];
      }
      if (i < ny && j < ny) sF[2][i * ny + j] = fz.S[i][j];
      if (i < nx && j < ny) sF[3][i * ny + j] = fz.Kt[j][i];
    }
    __syncthreads();
    float* dsts[4] = {out.R, out.Rt, out.S, out.K};
    const int sizes[4] = {nx * nx, nx * nx, ny * ny, nx * ny};
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int sz = sizes[f];
      const float* tab = sF[f];
      float* base = dsts[f] + s0 * sz;
      const int64_t total = max((int64_t)0, s1 - s0) * sz;
      if (sz % 4 == 0) {
        // element 4 k starts at table entry (4 k) mod sz, tracked in r
        int r = (4 * tid) % sz;
        const int step = (4 * kThreads) % sz;
        for (int64_t k = tid; 4 * k < total; k += kThreads) {
          reinterpret_cast<float4*>(base)[k] =
              *reinterpret_cast<const float4*>(tab + r);
          r += step;
          if (r >= sz) r -= sz;
        }
      } else {
        int r = tid % sz;
        const int step = kThreads % sz;
        for (int64_t k = tid; k < total; k += kThreads) {
          base[k] = tab[r];
          r += step;
          if (r >= sz) r -= sz;
        }
      }
    }
  };
  if (!main_block) {
    if (TRAJ) {
      const int64_t share = (n + gridDim.x - 2) / (gridDim.x - 1);
      const int64_t s0 = tf + (blockIdx.x - 1) * share;
      frozen_fields(s0, min((int64_t)T, s0 + share));
    }
    return;
  }

  // ---- the tail: a chunked scan of x_{t+1} = x_t G + b_t ------------------
  float tail = 0.f;
  long long clk_p1 = clk1, clk_scan = clk1, clk_p2 = clk1;
  if (n > 0) {
    const int L = (n + kThreads - 1) / kThreads;  // steps a chunk
    const int nc = (n + L - 1) / L;                // chunks, <= kThreads
    int levels = 0;
    while ((1 << levels) < nc) ++levels;
    float Gr[M][M], KA[M][M];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        Gr[i][j] = fz.G[i][j];
        KA[i][j] = fz.KtAt[i][j];
      }
    // Thread k's chunk is contiguous in time, so it reads its rows of y,
    // c and d straight from device memory, a stream that L1 serves 128
    // bytes at a time (staging every chunk's rows through shared memory
    // in rounds measured slower, PERF.md).  The drives' presence is a
    // compile-time flag of each loop, so a step's loads carry no branch.
    const int64_t a = tf + (int64_t)tid * L;
    const int64_t b = min((int64_t)T, a + L);
    auto with_drives = [&](auto&& body) {
      if (cs && ds) body(std::true_type{}, std::true_type{});
      else if (cs) body(std::true_type{}, std::false_type{});
      else if (ds) body(std::false_type{}, std::true_type{});
      else body(std::false_type{}, std::false_type{});
    };
    // x <- x G + (y_t - d_t) K^T A^T + c_t, as the prefix's data step
    auto advance = [&](auto hc, auto hd, float (&xs)[M], int64_t t,
                       float (&yeff)[M]) {
      constexpr bool HC = decltype(hc)::value, HD = decltype(hd)::value;
      float xn[M];
#pragma unroll
      for (int j = 0; j < M; ++j)
        yeff[j] = j < ny ? __ldg(ys + t * ny + j) -
                               (HD ? __ldg(ds + t * ny + j) : 0.f)
                         : 0.f;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < M; ++i) acc += xs[i] * Gr[i][j];
#pragma unroll
        for (int i = 0; i < M; ++i)
          if (yrow(i)) acc += yeff[i] * KA[i][j];
        xn[j] = j < nx ? acc + (HC ? __ldg(cs + t * nx + j) : 0.f) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < M; ++j) xs[j] = xn[j];
    };
    // G^L and its squarings G^{L 2^d}, on warp 0
    if (tid < 32 && levels > 0) {
      for (int e = tid; e < M * M; e += 32) {
        const int i = e / M, j = e % M;
        sB[e] = fz.G[i][j];
        sH[0][e] = i == j && i < nx ? 1.f : 0.f;
      }
      __syncwarp();
      for (int e = L;;) {
        if (e & 1) warp_matmul<M>(sH[0], sB, sH[0], nx, tid);
        e >>= 1;
        if (!e) break;
        warp_matmul<M>(sB, sB, sB, nx, tid);
      }
      for (int d = 1; d < levels; ++d)
        warp_matmul<M>(sH[d - 1], sH[d - 1], sH[d], nx, tid);
    }
    // pass 1: each chunk from zero, chunk 0 from x(t_f)
    float xs[M], yeff[M];
#pragma unroll
    for (int i = 0; i < M; ++i) xs[i] = tid == 0 ? fz.x[i] : 0.f;
    with_drives([&](auto hc, auto hd) {
#pragma unroll 4
      for (int64_t t = a; t < b; ++t) advance(hc, hd, xs, t, yeff);
    });
    if (tid < nc) {
#pragma unroll
      for (int i = 0; i < M; ++i) sR[tid][i] = xs[i];
    }
    __syncthreads();
    if (stats && worker) clk_p1 = clock64();
    // Kogge-Stone over the chunk ends: after level d, sR[k] is the state
    // at the end of chunk k from the chunks k - 2^{d+1} + 1 .. k
    for (int d = 0; d < levels; ++d) {
      const int o = 1 << d;
      const bool act = tid >= o && tid < nc;
      float v[M];
      if (act) {
#pragma unroll
        for (int j = 0; j < M; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < M; ++i) acc += sR[tid - o][i] * sH[d][i * M + j];
          v[j] = acc;
        }
      }
      __syncthreads();
      if (act) {
#pragma unroll
        for (int j = 0; j < M; ++j) sR[tid][j] += v[j];
      }
      __syncthreads();
    }
    if (stats && worker) clk_scan = clock64();
    // pass 2: each chunk again from its true start state
    float part = 0.f;
    float Cr[M][M], Si[M][M], Kr[M][M];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        Cr[i][j] = fz.C[i][j];
        Si[i][j] = fz.Sinv[i][j];
        if (TRAJ) Kr[i][j] = fz.Kt[i][j];
      }
    const float logdet_f = fz.logdet;
#pragma unroll
    for (int i = 0; i < M; ++i)
      xs[i] = tid == 0 ? fz.x[i] : tid < nc ? sR[tid - 1][i] : 0.f;
    with_drives([&](auto hc, auto hd) {
#pragma unroll 2
      for (int64_t t = a; t < b; ++t) {
        float x_t[M], e[M];
#pragma unroll
        for (int i = 0; i < M; ++i) x_t[i] = xs[i];
        advance(hc, hd, xs, t, yeff);
#pragma unroll
        for (int j = 0; j < M; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int q = 0; q < M; ++q)
            if (yrow(j)) acc += x_t[q] * Cr[j][q];
          e[j] = yeff[j] - acc;
        }
        float qv = 0.f;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          if (!yrow(j)) continue;
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < M; ++i)
            if (yrow(i)) acc += e[i] * Si[i][j];
          qv += acc * e[j];
        }
        part += -0.5f * (qv + logdet_f + nlog2pi);
        if (TRAJ) {
          float xt[M];
#pragma unroll
          for (int j = 0; j < M; ++j) {
            float acc = x_t[j];
#pragma unroll
            for (int i = 0; i < M; ++i)
              if (i < ny) acc += e[i] * Kr[i][j];
            xt[j] = acc;
          }
          store_row<NX>(out.x + t * nx, x_t, nx);
          store_row<NX>(out.xt + t * nx, xt, nx);
          store_row<NY>(out.e + t * ny, e, ny);
        }
      }
    });
    if (stats && worker) clk_p2 = clock64();
    // the ll terms in a fixed tree order
    sLL[tid] = part;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (tid < w) sLL[tid] += sLL[tid + w];
      __syncthreads();
    }
    tail = sLL[0];
    if (TRAJ && gridDim.x == 1) frozen_fields(tf, T);
  }
  if (worker) {
    ll_out[0] = fz.ll + tail;
    if (stats) {
      stats[0] = tf;
      stats[1] = clk1 - clk0;
      stats[2] = clock64() - clk1;
      stats[3] = clk_p1 - clk1;
      stats[4] = clk_scan - clk_p1;
      stats[5] = clk_p2 - clk_scan;
    }
  }
}

template <int M, int NX, int NY>
int launch(const float* ys, const float* cs, const float* ds, const float* x0,
           const float* P0, const float* R1, const float* R2, const float* A,
           const float* C, float alpha, int T, int nx, int ny, float* ll,
           const AkfOut& out, long long* stats, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)kChunk * (2 * ny + nx) * sizeof(float);
  // trajectory mode: block 0 filters, one more block per 1024 steps (at
  // most 127) writes the frozen fields, spreading the stores over SMs
  const int grid = 1 + std::min(127, (T + 1023) / 1024);
  if (out.x)
    akf_scan_kernel<M, NX, NY, true><<<grid, kThreads, smem, stream>>>(
        ys, cs, ds, x0, P0, R1, R2, A, C, alpha, T, nx, ny, ll, out, stats);
  else
    akf_scan_kernel<M, NX, NY, false><<<1, kThreads, smem, stream>>>(
        ys, cs, ds, x0, P0, R1, R2, A, C, alpha, T, nx, ny, ll, out, stats);
  return (int)cudaGetLastError();
}

int akf_scan(const float* ys, const float* cs, const float* ds,
             const float* x0, const float* P0, const float* R1,
             const float* R2, const float* A, const float* C, float alpha,
             int T, int nx, int ny, float* ll, const AkfOut& out,
             long long* stats, cudaStream_t st) {
  if (nx < 1 || nx > 8 || ny < 1 || ny > 8 || T < 0)
    return (int)cudaErrorInvalidValue;
#define LLPF_AKF_ARGS \
  ys, cs, ds, x0, P0, R1, R2, A, C, alpha, T, nx, ny, ll, out, stats, st
  // an exact instance for the whole-scan cell's CV model (4 x 2)
  if (nx == 4 && ny == 2) return launch<4, 4, 2>(LLPF_AKF_ARGS);
  if (nx <= 4 && ny <= 4) return launch<4, 0, 0>(LLPF_AKF_ARGS);
  return launch<8, 0, 0>(LLPF_AKF_ARGS);
#undef LLPF_AKF_ARGS
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
  return akf_scan(ys, cs, ds, x0, P0, R1, R2, A, C, alpha, T, nx, ny, ll,
                  AkfOut{x, R, xt, Rt, e, S, K}, nullptr,
                  (cudaStream_t)stream);
}

// llpf_akf_scan that also writes stats [6] (int64): the freeze step t_f,
// and thread 0's clock64 cycles in the prefix and in the tail, and of the
// tail in its first pass (with G^L), the scan of the chunk ends and its
// second pass
int llpf_akf_scan_stats(const float* ys, const float* cs, const float* ds,
                        const float* x0, const float* P0, const float* R1,
                        const float* R2, const float* A, const float* C,
                        float alpha, int T, int nx, int ny, float* ll,
                        float* x, float* R, float* xt, float* Rt, float* e,
                        float* S, float* K, long long* stats, void* stream) {
  return akf_scan(ys, cs, ds, x0, P0, R1, R2, A, C, alpha, T, nx, ny, ll,
                  AkfOut{x, R, xt, Rt, e, S, K}, stats, (cudaStream_t)stream);
}

}  // extern "C"
