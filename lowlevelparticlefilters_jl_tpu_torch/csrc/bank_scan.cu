// Shared-Riccati Kalman-filter bank log-likelihood (kernel F).
//
// Replaces lowlevelparticlefilters_jl_tpu/ops/pallas/bank_scan.py
// (_bank_kernel_call, bank_scan.py:200; body _bank_kernel_body :108;
// entry bank_loglik_kernel :225).  B datasets run through one Kalman
// filter whose covariance recursion does not see the data, so it is
// computed once (filters/bank.py::_shared_recursion) and each step folds
// into per-step matrices shared by the whole bank.  Per step t and member:
//   Z  = Linv_t y - LD_t u - W2_t^T x          (whitened innovation)
//   ll -= 0.5 |Z|^2
//   x  <- M_t x + AK_t y + BmAKD_t u
// The per-step scalars are packed [T, S] as M | AK | Linv | W2 | BmAKD |
// LD (row-major blocks), S = nx^2 + 2 nx ny + ny^2 + nx nu + ny nu; the
// constant sum_t (log|det Linv_t| - ny/2 log 2 pi) is added outside.
//
// Design.  One thread per member, looping over T with its state in
// registers.  The scalars are read by every thread, so a block stages
// them in shared memory, kSteps steps at a time, and the threads read
// them as broadcasts.  y and u are read in place from [B, T, ny] and
// [B, T, nu] (member stride 0 for an input shared by the bank): a thread
// walks its own contiguous row, and the sectors it touched serve its next
// steps from L1.  nx, ny, nu <= 4 are runtime values under unrolled,
// guarded loops, so one kernel serves every shape.
//
// Bound on the card: latency.  The state chain is serial in T (two
// dependent multiply-adds a step at nx = 2) and B = 1024 threads fill 8
// blocks of 128, so most of the 132 SMs idle.  The data, 2.5 MB at
// B = 1024, T = 200, would take 0.7 us at 3.35 TB/s.  Not fixed here.
//
// TPU workarounds not ported: the [8, L] sublane/lane member packing
// (_pack_channels), the _CHUNK_BYTES bank chunking and _TSEG time
// segments with their _MAX_CALLS cap, the _UNROLL / _FULL_UNROLL loop
// split, the [S, T] SMEM row-padding layout, and the VMEM limit pin.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMax = 4;      // nx, ny, nu <= 4
constexpr int kThreads = 128;
constexpr int kSteps = 64;   // steps of scalars staged per pass

__global__ void __launch_bounds__(kThreads)
    bank_loglik_kernel(const float* __restrict__ sc, int S,
                       const float* __restrict__ ys,
                       const float* __restrict__ us, int64_t us_b,
                       const float* __restrict__ x0, float* __restrict__ ll,
                       int64_t B, int T, int nx, int ny, int nu) {
  extern __shared__ float ssc[];
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = b < B;
  const int oM = 0;
  const int oAK = oM + nx * nx;
  const int oLi = oAK + nx * ny;
  const int oW2 = oLi + ny * ny;
  const int oBD = oW2 + nx * ny;
  const int oLD = oBD + nx * nu;
  const float* yb = ys + (live ? b : 0) * (int64_t)T * ny;
  const float* ub = nu > 0 ? us + (live ? b : 0) * us_b : nullptr;

  float x[kMax];
#pragma unroll
  for (int i = 0; i < kMax; ++i) x[i] = i < nx ? x0[i] : 0.f;
  float acc = 0.f;

  for (int t0 = 0; t0 < T; t0 += kSteps) {
    const int tc = T - t0 < kSteps ? T - t0 : kSteps;
    __syncthreads();
    for (int k = threadIdx.x; k < tc * S; k += blockDim.x)
      ssc[k] = sc[(int64_t)t0 * S + k];
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < tc; ++tt) {
      const float* s = ssc + tt * S;
      const int64_t t = t0 + tt;
      float y[kMax], u[kMax];
#pragma unroll
      for (int j = 0; j < kMax; ++j) {
        y[j] = j < ny ? yb[t * ny + j] : 0.f;
        u[j] = j < nu ? ub[t * nu + j] : 0.f;
      }
      float dll = 0.f;
#pragma unroll
      for (int z = 0; z < kMax; ++z) {
        if (z >= ny) break;
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < kMax; ++j)
          if (j < ny) a += s[oLi + z * ny + j] * y[j];
#pragma unroll
        for (int j = 0; j < kMax; ++j)
          if (j < nu) a -= s[oLD + z * nu + j] * u[j];
#pragma unroll
        for (int i = 0; i < kMax; ++i)
          if (i < nx) a -= s[oW2 + i * ny + z] * x[i];
        dll -= 0.5f * a * a;
      }
      acc += dll;
      float xn[kMax];
#pragma unroll
      for (int i = 0; i < kMax; ++i) {
        float a = 0.f;
        if (i < nx) {
#pragma unroll
          for (int j = 0; j < kMax; ++j)
            if (j < nx) a += s[oM + i * nx + j] * x[j];
#pragma unroll
          for (int j = 0; j < kMax; ++j)
            if (j < ny) a += s[oAK + i * ny + j] * y[j];
#pragma unroll
          for (int j = 0; j < kMax; ++j)
            if (j < nu) a += s[oBD + i * nu + j] * u[j];
        }
        xn[i] = a;
      }
#pragma unroll
      for (int i = 0; i < kMax; ++i) x[i] = xn[i];
    }
  }
  if (live) ll[b] = acc;
}

}  // namespace

extern "C" {

// sc [T, S], ys [B, T, ny], us [B, T, nu] with member stride us_b (0 for a
// shared [T, nu] input), x0 [nx]; writes ll [B] without the constant.
int llpf_bank_loglik(const float* sc, int S, const float* ys, const float* us,
                     int64_t us_b, const float* x0, float* ll, int64_t B,
                     int T, int nx, int ny, int nu, void* stream) {
  if (nx < 1 || nx > kMax || ny < 1 || ny > kMax || nu < 0 || nu > kMax ||
      T < 0 || S != nx * nx + 2 * nx * ny + ny * ny + nx * nu + ny * nu)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  const size_t smem = (size_t)kSteps * S * sizeof(float);
  bank_loglik_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      sc, S, ys, us, us_b, x0, ll, B, T, nx, ny, nu);
  return (int)cudaGetLastError();
}

}  // extern "C"
