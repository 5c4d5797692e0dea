// Systematic resample from the weights to the resampled cloud in one
// launch, kernel E:
//   cdf = the weights' prefix sum (fixed order, below), total = cdf[N-1],
//   K_i = clamp(cummax_i(ceil(cdf_i * M / total - r)), 0, M),
//   j_k = min(#{i : K_i <= k}, N - 1),  out[k] = x[j_k].
//
// Replaces lowlevelparticlefilters_jl_tpu/ops/pallas/resample_v2.py
// (_pallas_systematic_index_gather, resample_v2.py:182, its body _kernel
// and the pallas_call at :209).  The TPU kernel has no per-lane gather, so
// it builds both outputs from windowed 0/1 MXU contractions over chunks of
// particles: a count matmul for j, four mutually exclusive indicator
// products for the gather, the f32 values split into three exact bf16
// parts, window bases aligned to 8 sublanes, and a VMEM budget that caps
// N; the slot boundaries K come from XLA outside it.  None of that is
// ported.  Here one cooperative launch does the whole resample, K
// included, and a second entry (llpf_systematic_slots) stops after K for
// kernel B's gather, so both routes resample from the same K.
//
// The prefix's order.  A parallel scan that takes whatever partial sums
// are ready (PyTorch's 1-D CUDA cumsum) rounds differently from call to
// call, and a changed last bit can move a slot boundary.  This kernel sums
// in one fixed order, which the plain twin
// (kernels/resample_v2.py::runs_prefix) writes out in PyTorch ops: in
// float64, runs of 32 consecutive values are summed left to right; the
// runs' totals are scanned by the same rule, recursively, and each value's
// partial sum in its run gets the inclusive prefix of the runs before it
// added (one add); the result is rounded once to the weights' type.  Then
// K takes separate IEEE roundings for the product, the quotient and the
// difference (__fmul_rn, __fdiv_rn, __fsub_rn or their double forms, no
// fused multiply-add), as the twin's separate PyTorch ops do, so K is
// bitwise the twin's; the running max is exact in any order.
//
// Design.  Blocks of 256 threads; a lane owns a run of 32 weights and a
// warp a "warp run" of 32 lane runs (1024 weights).  Warp runs are dealt
// round-robin over the blocks' warps, first warp 0 of every block, so the
// N / 1024 warp runs spread over as many SMs as there are (98 at
// N = 1e5, one warp each).
//   1. Each lane sums its run; each warp forms its lanes' partials (a
//      left-to-right chain over the shuffled run totals) and publishes
//      them.  grid.sync.
//   2. Every block scans the warp runs' totals in shared memory by the
//      fixed order and forms the total; each lane re-reads its run (from
//      L2), forms its cdf values and raw slot boundaries, and the running
//      max within its warp run (a shuffle scan of the lanes' maxes); each
//      warp run publishes its max.  grid.sync.
//   3. Every block forms the warp runs' exclusive running maxes; K_i is
//      its warp run's partial max raised to that and clamped.  The slot
//      stage writes K; the full resample binary-searches K for each slot
//      (j_k = #{i : K_i <= k}, clipped to N - 1) and copies one row.
//      (The search's first levels kept in shared memory, K at the ends of
//      4096 slices loaded by every block, measured slower: 15k against
//      12k cycles, the blocks' redundant loads; PERF.md.)
// Two grid syncs, no atomics: two calls give the same bits.
//
// Bound on the card: memory and latency.  The work reads the weights and
// the rows and writes j and the rows (2.4 MB at N = 1e5, nx = 2, f32:
// 0.7 us at 3.35 TB/s); the launch, two grid syncs and the dependent
// loads of three phases dominate.  The weights are read twice (the
// second time from L2), K's 400 KB stays in L2 for the search.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "coop.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRun = 32;                 // values a run of the sum order
constexpr int kThreads = 256;            // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRun = 32 * kRun;      // weights a warp run (1024)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 1 << 24;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ void round_to(double v, float* o) {
  *o = __double2float_rn(v);
}
__device__ __forceinline__ void round_to(double v, double* o) { *o = v; }
__device__ __forceinline__ float ceil_of(float v) { return ceilf(v); }
__device__ __forceinline__ double ceil_of(double v) { return ceil(v); }

template <typename W>
struct SysArgs {
  const W* we;          // [N] weights (16-byte aligned)
  const W* r;           // the offset, a device scalar
  const uint32_t* x;    // [N, row] rows as 32-bit words; null: slots only
  uint32_t* xo;         // [N, row] resampled rows
  int32_t* j;           // [N] source of each slot
  int32_t* K;           // [N] slot boundaries; null: not written
  double* p1;           // [n1] each lane run's partial in its warp run
  double* t1;           // [n1] each lane run's total
  int32_t* Kt;          // [N] raw K, running max within its warp run
  int32_t* wmax;        // [nw] each warp run's max
  long long* prof;      // [kStamps] block 0's clock64 stamps, or null
  int N, M, row, n1, nw;   // n1 lane runs, nw warp runs
};

// Block 0, thread 0 stamps clock64 at the phase boundaries when asked:
// start, lane sums done, grid sync 1, the warp runs' prefix done, raw K
// done, grid sync 2, the warp runs' maxes done, end.
constexpr int kStamps = 8;

template <typename W>
__device__ __forceinline__ void stamp(const SysArgs<W>& a, int i) {
  if (a.prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    a.prof[i] = clock64();
}

// The run of 32 weights from i0 (zeros past N), 16-byte loads when whole.
__device__ __forceinline__ void load_run(const float* we, int i0, int N,
                                         float (&w)[kRun]) {
  if (i0 + kRun <= N) {
    const float4* v = reinterpret_cast<const float4*>(we + i0);
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      const float4 f = v[q];
      w[4 * q] = f.x;
      w[4 * q + 1] = f.y;
      w[4 * q + 2] = f.z;
      w[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) w[k] = i0 + k < N ? we[i0 + k] : 0.f;
  }
}

__device__ __forceinline__ void load_run(const double* we, int i0, int N,
                                         double (&w)[kRun]) {
  if (i0 + kRun <= N) {
    const double2* v = reinterpret_cast<const double2*>(we + i0);
#pragma unroll
    for (int q = 0; q < kRun / 2; ++q) {
      const double2 f = v[q];
      w[2 * q] = f.x;
      w[2 * q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) w[k] = i0 + k < N ? we[i0 + k] : 0.0;
  }
}

// Doubles of shared memory a block_prefix of n values takes (n included).
__host__ __device__ inline int prefix_space(int n) {
  int s = n;
  while (n > kRun) {
    n = (n + kRun - 1) / kRun;
    s += n;
  }
  return s;
}

// In-place inclusive prefix of v[0..n) in shared memory, in the fixed
// order: runs of 32 summed left to right (partials in place, totals one
// level up), the top level (at most 32 values) left to right on one
// thread, then each partial gets the inclusive prefix of the runs before
// it added, level by level downward.  Called by the whole block.
__device__ void block_prefix(double* v, int n) {
  double* base[8];
  int size[8];
  int top = 0;
  base[0] = v;
  size[0] = n;
  while (size[top] > kRun) {
    base[top + 1] = base[top] + size[top];
    size[top + 1] = (size[top] + kRun - 1) / kRun;
    ++top;
  }
  for (int l = 0; l <= top; ++l) {   // the top level is one run
    const int runs = l < top ? size[l + 1] : 1;
    for (int r = threadIdx.x; r < runs; r += blockDim.x) {
      const int i0 = r * kRun;
      double v[kRun];   // loaded ahead of the chain, zeros past the end
#pragma unroll
      for (int k = 0; k < kRun; ++k)
        v[k] = i0 + k < size[l] ? base[l][i0 + k] : 0.0;
      double a = 0.0;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        a = __dadd_rn(a, v[k]);
        if (i0 + k < size[l]) base[l][i0 + k] = a;
      }
      if (l < top) base[l + 1][r] = a;
    }
    __syncthreads();
  }
  for (int l = top - 1; l >= 0; --l) {
    for (int i = threadIdx.x; i < size[l]; i += blockDim.x) {
      const int r = i / kRun;
      base[l][i] = __dadd_rn(r > 0 ? base[l + 1][r - 1] : 0.0, base[l][i]);
    }
    __syncthreads();
  }
}

// The exclusive prefix of lane run r (the inclusive prefix of the lane
// runs before it), from the warp runs' prefixes sv.
// p1j is the partial of lane run r - 1 (a.p1[r - 1]; any value at r = 0).
__device__ __forceinline__ double run_offset(const double* sv, int r,
                                             double p1j) {
  if (r == 0) return 0.0;
  const int q = (r - 1) / kRun;
  return __dadd_rn(q > 0 ? sv[q - 1] : 0.0, p1j);
}

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int clamp_k(int k, int M) {
  return k < 0 ? 0 : (k > M ? M : k);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
    systematic_kernel(const SysArgs<W> a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this warp's first warp run and the stride between its warp runs
  const int q0 = blockIdx.x + gridDim.x * warp, dq = gridDim.x * kWarps;
  stamp(a, 0);

  // 1. lane run totals and their partials within the warp run
  for (int q = q0; q < a.nw; q += dq) {
    const int r1 = q * 32 + lane;
    W w[kRun];
    load_run(a.we, r1 * kRun, a.N, w);
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < kRun; ++k) s = __dadd_rn(s, (double)w[k]);
    double p = 0.0;
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      const double v = __shfl_sync(kFull, s, l);
      if (l <= lane) p = __dadd_rn(p, v);
    }
    if (r1 < a.n1) {
      a.t1[r1] = s;
      a.p1[r1] = p;
    }
  }
  stamp(a, 1);
  grid.sync();
  stamp(a, 2);

  // 2. the warp runs' prefixes, the total, raw K and its running max
  double* sv = llpf_smem<double>();
  int* mb = reinterpret_cast<int*>(sv + prefix_space(a.nw));   // [nw]
  for (int q = threadIdx.x; q < a.nw; q += blockDim.x) {
    const int last = q * kRun + kRun - 1;
    sv[q] = a.p1[last < a.n1 ? last : a.n1 - 1];
  }
  // the last run's pieces of the total, loaded while the prefix runs
  const int rl = (a.N - 1) / kRun;
  const double p1l = a.p1[rl > 0 ? rl - 1 : 0], t1l = a.t1[rl];
  __syncthreads();
  block_prefix(sv, a.nw);
  stamp(a, 3);
  W total;
  round_to(__dadd_rn(run_offset(sv, rl, p1l), t1l), &total);
  const W Mw = (W)a.M, rw = *a.r;
  for (int q = q0; q < a.nw; q += dq) {
    const int r1 = q * 32 + lane, i0 = r1 * kRun;
    int kr[kRun];
    int lmax = INT_MIN;
    if (r1 < a.n1) {
      const double e = run_offset(sv, r1, a.p1[r1 > 0 ? r1 - 1 : 0]);
      W w[kRun];
      load_run(a.we, i0, a.N, w);
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        s = __dadd_rn(s, (double)w[k]);
        W b;
        round_to(__dadd_rn(e, s), &b);
        kr[k] = (int)ceil_of(sub_rn(div_rn(mul_rn(b, Mw), total), rw));
        if (i0 + k < a.N) lmax = imax(lmax, kr[k]);
      }
    }
    int incl = lmax;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = imax(incl, v);
    }
    int m = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) m = INT_MIN;
    if (lane == 31) a.wmax[q] = incl;
    if (r1 < a.n1) {
      if (i0 + kRun <= a.N) {
        int4* dst = reinterpret_cast<int4*>(a.Kt + i0);
#pragma unroll
        for (int u = 0; u < kRun / 4; ++u) {
          int4 o;
          o.x = m = imax(m, kr[4 * u]);
          o.y = m = imax(m, kr[4 * u + 1]);
          o.z = m = imax(m, kr[4 * u + 2]);
          o.w = m = imax(m, kr[4 * u + 3]);
          dst[u] = o;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kRun; ++k)
          if (i0 + k < a.N) a.Kt[i0 + k] = m = imax(m, kr[k]);
      }
    }
  }
  stamp(a, 4);
  grid.sync();
  stamp(a, 5);

  // 3. the warp runs' exclusive running maxes, then K, or the search and
  // the copy
  for (int q = threadIdx.x; q < a.nw; q += blockDim.x) mb[q] = a.wmax[q];
  __syncthreads();
  if (warp == 0) {   // in place: lanes scan consecutive groups
    const int per = (a.nw + 31) / 32;
    const int t0 = lane * per;
    const int t1 = t0 + per < a.nw ? t0 + per : a.nw;
    int m = INT_MIN;
    for (int t = t0; t < t1; ++t) m = imax(m, mb[t]);
    int incl = m;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = imax(incl, v);
    }
    int run = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) run = INT_MIN;
    for (int t = t0; t < t1; ++t) {
      const int v = mb[t];
      mb[t] = run;
      run = imax(run, v);
    }
  }
  __syncthreads();
  stamp(a, 6);
  if (a.K != nullptr) {   // each lane its run: 16-byte loads and stores
    for (int q = q0; q < a.nw; q += dq) {
      const int i0 = (q * 32 + lane) * kRun, lo = mb[q];
      if (i0 + kRun <= a.N) {
        const int4* src = reinterpret_cast<const int4*>(a.Kt + i0);
        int4* dst = reinterpret_cast<int4*>(a.K + i0);
        int4 v[kRun / 4];
#pragma unroll
        for (int u = 0; u < kRun / 4; ++u) v[u] = src[u];
#pragma unroll
        for (int u = 0; u < kRun / 4; ++u) {
          v[u].x = clamp_k(imax(v[u].x, lo), a.M);
          v[u].y = clamp_k(imax(v[u].y, lo), a.M);
          v[u].z = clamp_k(imax(v[u].z, lo), a.M);
          v[u].w = clamp_k(imax(v[u].w, lo), a.M);
          dst[u] = v[u];
        }
      } else {
        for (int i = i0; i < a.N && i < i0 + kRun; ++i)
          a.K[i] = clamp_k(imax(a.Kt[i], lo), a.M);
      }
    }
  }
  if (a.x != nullptr) {
    const int N = a.N;
    for (int k = blockIdx.x * kThreads + threadIdx.x; k < N;
         k += gridDim.x * kThreads) {
      int lo = 0, hi = N;
      while (lo < hi) {   // #{i : K_i <= k} on the final K
        const int mid = (lo + hi) >> 1;
        if (clamp_k(imax(a.Kt[mid], mb[mid / kWarpRun]), a.M) <= k)
          lo = mid + 1;
        else
          hi = mid;
      }
      const int src = lo < N - 1 ? lo : N - 1;
      a.j[k] = src;
      const uint32_t* s = a.x + (int64_t)src * a.row;
      uint32_t* d = a.xo + (int64_t)k * a.row;
      for (int u = 0; u < a.row; ++u) d[u] = s[u];
    }
  }
  stamp(a, 7);
}

// Sizes of one call (kernels/resample_v2.py::scratch_bytes computes the
// same scratch).
struct Sizes {
  int n1, nw;
  long long scratch;   // bytes
  size_t smem;
};

Sizes sizes_of(int N) {
  Sizes s;
  s.n1 = (N + kRun - 1) / kRun;
  s.nw = (s.n1 + 31) / 32;
  // p1, t1 (doubles), then Kt (padded to 4 ints) and wmax
  s.scratch = 16LL * s.n1 + 4LL * ((N + 3) / 4 * 4 + s.nw);
  s.smem = 8 * (size_t)prefix_space(s.nw) + 4 * (size_t)s.nw;
  return s;
}

template <typename W>
int launch(const W* we, const W* r, const uint32_t* x, uint32_t* xo,
           int32_t* j, int32_t* K, void* scratch, long long scratch_bytes,
           long long* prof, int N, int M, int row, cudaStream_t stream) {
  const Sizes s = sizes_of(N);
  if (scratch_bytes < s.scratch) return (int)cudaErrorInvalidValue;
  SysArgs<W> a;
  a.we = we;
  a.r = r;
  a.x = x;
  a.xo = xo;
  a.j = j;
  a.K = K;
  a.p1 = static_cast<double*>(scratch);
  a.t1 = a.p1 + s.n1;
  a.Kt = reinterpret_cast<int32_t*>(a.t1 + s.n1);
  a.wmax = a.Kt + (N + 3) / 4 * 4;
  a.prof = prof;
  a.N = N;
  a.M = M;
  a.row = row;
  a.n1 = s.n1;
  a.nw = s.nw;
  const void* fn = (const void*)systematic_kernel<W>;
  int grid = 0;
  // a block a warp run at least; the search a thread a slot
  const long long want =
      x != nullptr && (N + kThreads - 1) / kThreads > s.nw
          ? (N + kThreads - 1) / kThreads
          : s.nw;
  cudaError_t e = llpf_coop_grid(fn, kThreads, s.smem, want, &grid);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args,
                                  s.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename W>
int dispatch(const void* we, const void* r, const void* x, void* xo,
             int32_t* j, int32_t* K, void* scratch, long long scratch_bytes,
             long long* prof, int N, int M, int row, void* stream) {
  if (N < 1 || N > kMaxN || M < 0 || ((uintptr_t)we & 15) != 0 ||
      ((uintptr_t)scratch & 15) != 0)
    return (int)cudaErrorInvalidValue;
  return launch<W>(static_cast<const W*>(we), static_cast<const W*>(r),
                   static_cast<const uint32_t*>(x),
                   static_cast<uint32_t*>(xo), j, K, scratch, scratch_bytes,
                   prof, N, M, row, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// The slot stage: K [N] (int32) of the weights we [N] (f32 or f64 by
// w_size, 16-byte aligned) at offset *r (a device scalar of the same
// type) for M slots.  prof: null, or kStamps int64 of block 0's clock64.
int llpf_systematic_slots(const void* we, const void* r, int32_t* K,
                          void* scratch, long long scratch_bytes,
                          long long* prof, int N, int M, int w_size,
                          void* stream) {
  if (w_size == 4)
    return dispatch<float>(we, r, nullptr, nullptr, nullptr, K, scratch,
                           scratch_bytes, prof, N, M, 0, stream);
  if (w_size == 8)
    return dispatch<double>(we, r, nullptr, nullptr, nullptr, K, scratch,
                            scratch_bytes, prof, N, M, 0, stream);
  return (int)cudaErrorInvalidValue;
}

// The whole resample, M = N slots: xo [N, row words] = x[j], j [N].
int llpf_systematic_resample(const void* we, const void* r, const void* x,
                             void* xo, int32_t* j, void* scratch,
                             long long scratch_bytes, long long* prof, int N,
                             int row, int w_size, void* stream) {
  if (x == nullptr || row < 1) return (int)cudaErrorInvalidValue;
  if (w_size == 4)
    return dispatch<float>(we, r, x, xo, j, nullptr, scratch, scratch_bytes,
                           prof, N, N, row, stream);
  if (w_size == 8)
    return dispatch<double>(we, r, x, xo, j, nullptr, scratch,
                            scratch_bytes, prof, N, N, row, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
