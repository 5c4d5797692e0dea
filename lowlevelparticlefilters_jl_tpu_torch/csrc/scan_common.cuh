// Shared pieces of the whole-scan Kalman kernels G, H and I
// (csrc/akf_scan.cu, csrc/ukf_scan.cuh).
//
// Small dense algebra on register arrays: float a[M][M] row-major with a
// compile-time capacity M and a used size n <= M (a compile-time constant
// in G and I, a runtime value in H).  The formulas and their order are
// those of ops/linalg.py's unrolled Cholesky and triangular solves, which
// the plain twins call.
//
// Staging: a whole-scan kernel walks T steps on one thread (H, I) or one
// warp (G), and a load from device memory in the step would cost the
// whole step's latency again.  So a second warp copies the per-step inputs
// kChunk steps at a time into a shared-memory double buffer, one chunk
// ahead of the computing warp; the two meet at one __syncthreads a chunk.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kChunk = 128;       // steps staged per pass

// lower Cholesky factor L of the symmetric S (lower triangle read)
template <int M>
__device__ __forceinline__ void chol_lower(const float (&S)[M][M],
                                           float (&L)[M][M], int n) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (j > i || i >= n) {
        L[i][j] = 0.f;
        continue;
      }
      float s = S[i][j];
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (k < j) s -= L[i][k] * L[j][k];
      L[i][j] = i == j ? sqrtf(s) : s / L[j][j];
    }
  }
}

// B <- L^{-1} B for the first n rows and c columns of B [M][C]
template <int M, int C>
__device__ __forceinline__ void tri_lower(const float (&L)[M][M],
                                          float (&B)[M][C], int n, int c) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i >= n) break;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (q >= c) break;
      float s = B[i][q];
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (k < i) s -= L[i][k] * B[k][q];
      B[i][q] = s / L[i][i];
    }
  }
}

// B <- L^{-T} B (back substitution with the transposed factor)
template <int M, int C>
__device__ __forceinline__ void tri_upper_t(const float (&L)[M][M],
                                            float (&B)[M][C], int n, int c) {
#pragma unroll
  for (int ii = M - 1; ii >= 0; --ii) {
    if (ii >= n) continue;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (q >= c) break;
      float s = B[ii][q];
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (k > ii && k < n) s -= L[k][ii] * B[k][q];
      B[ii][q] = s / L[ii][ii];
    }
  }
}

// copy rows [t0, t0 + tc) of a [T, w] array into dst, threads tid..nth
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int w, int t0, int tc, int tid,
                                           int nth) {
  if (w == 0 || src == nullptr) return;
  const float* s = src + (int64_t)t0 * w;
  for (int k = tid; k < tc * w; k += nth) dst[k] = __ldg(s + k);
}
