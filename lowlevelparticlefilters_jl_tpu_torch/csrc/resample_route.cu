// Systematic gather by slot boundaries, kernel B: out[k] = x[j_k] with
// j_k = #{i : K_i <= k} clipped to N - 1.
//
// Replaces lowlevelparticlefilters_jl_tpu/ops/pallas/resample_route.py
// (fused_systematic_gather_route, resample_route.py:337; its kernel
// _standalone_kernel, :302, and the route_systematic / _route /
// _forward_fill / hs_cumsum phases it calls).  The TPU kernel has no
// scatter and no per-lane gather, so it moves every particle through
// three log-depth shift phases over an [8, NL] plane layout.  Hopper has
// both, so neither the plane layout nor the shift phases are ported.
//
// K comes from ops/resample.py::_systematic_slots: kernel E's slot stage
// (csrc/resample_v2.cu) for the weights E takes, the fixed-order _cumsum
// arithmetic for the rest (N above 2^24, float16 weights).
//
// Design: a load-balanced (merge-path) search, csrc/slots.cuh.  The N
// boundaries and the N slots merge into 2N items; block b owns the items
// [b T, (b + 1) T), T = 256 threads x 8, whatever the weights: a heavy
// particle (a long run of slots) and long stretches of particles with no
// offspring (runs of equal K) cost a block the same.  Two warps find the
// block's two ends, each by one warp-wide 32-ary search of K (4 rounds of
// loads at N = 1e5, 6 at 2^25, against the log2 N dependent loads a
// binary search per slot took).  The block loads its boundaries, at most
// T, coalesced into shared memory; each thread takes 8 merged items,
// finds its start there by a binary search of shared memory and walks
// them, writing each slot's source; then the block copies its slots' rows
// with coalesced stores (8- or 16-byte rows as one vector where they are
// aligned).  K is read once.  Values are copied as 32-bit words, never
// recomputed, so the result is bitwise equal to the plain gather for
// float32 and float64 rows alike.
//
// Bound on the card: memory.  K read once, the rows read once and
// written once: N (4 + 2 row) bytes (20 B a particle at nx = 2, float32:
// 0.2 ms at N = 2^25 at 3.35 TB/s).
#include <cuda_runtime.h>
#include <stdint.h>

#include "slots.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                    // merged items a thread
constexpr int kTile = kThreads * kItems;     // merged items a block

template <int W>
struct Row {};
template <>
struct Row<2> {
  using type = uint2;
};
template <>
struct Row<4> {
  using type = uint4;
};

// W > 0: rows of W 32-bit words, copied as one vector; W = 0: `words`
// words a row, copied one by one.
template <int W>
__global__ void __launch_bounds__(kThreads) systematic_gather_kernel(
    const uint32_t* __restrict__ x, const int32_t* __restrict__ K,
    uint32_t* __restrict__ out, int64_t N, int words) {
  __shared__ int32_t Ks[kTile];   // the block's boundaries
  __shared__ int32_t js[kTile];   // its slots' sources
  __shared__ int64_t ends[2];
  const int tid = threadIdx.x;
  const int64_t d0 = (int64_t)blockIdx.x * kTile;
  const int64_t d1 = d0 + kTile < 2 * N ? d0 + kTile : 2 * N;
  if (tid < 64) {
    const int64_t i = llpf_split_warp(K, N, tid < 32 ? d0 : d1);
    if ((tid & 31) == 0) ends[tid >> 5] = i;
  }
  __syncthreads();
  const int64_t i0 = ends[0];
  const int nK = (int)(ends[1] - i0);          // boundaries [i0, i0 + nK)
  const int64_t s0 = d0 - i0;                  // slots [s0, s0 + nS)
  const int nS = (int)(d1 - ends[1] - s0);
#pragma unroll
  for (int r = 0; r < kItems; ++r) {  // unrolled: the loads all in flight
    const int i = tid + r * kThreads;
    if (i < nK) Ks[i] = __ldg(K + i0 + i);
  }
  __syncthreads();
  // this thread's merged items [dt, dt + kItems) of the block's nK + nS
  const int dt = tid * kItems;
  if (dt < nK + nS) {
    const int lo = dt > nS ? dt - nS : 0;
    int bi = llpf_split_local(Ks, (int)s0, lo, dt < nK ? dt : nK, dt);
    int sk = dt - bi;
    const int end = dt + kItems < nK + nS ? dt + kItems : nK + nS;
    for (int p = dt; p < end; ++p) {
      if (bi < nK && (sk >= nS || Ks[bi] <= s0 + sk)) {
        ++bi;  // boundary i0 + bi comes before slot s0 + sk
      } else {
        const int64_t j = i0 + bi;
        js[sk++] = (int32_t)(j < N - 1 ? j : N - 1);
      }
    }
  }
  __syncthreads();
  if constexpr (W > 0) {
    using V = typename Row<W>::type;
    const V* xv = reinterpret_cast<const V*>(x);
    V* ov = reinterpret_cast<V*>(out) + s0;
#pragma unroll
    for (int r = 0; r < kItems; ++r) {  // unrolled: the loads all in flight
      const int k = tid + r * kThreads;
      if (k < nS) ov[k] = __ldg(xv + js[k]);
    }
  } else {
    uint32_t* o = out + s0 * words;
    const int n = nS * words;
    for (int e0 = 0; e0 < n; e0 += 4 * kThreads) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = e0 + tid + r * kThreads;
        if (e < n) {
          const int k = e / words;
          o[e] = __ldg(x + (int64_t)js[k] * words + (e - k * words));
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x [N, row] and out [N, row] (row = elem_size * nx bytes), K [N] int32
// non-decreasing in [0, N]; elem_size 4 or 8.
int llpf_systematic_gather(const void* x, const int32_t* K, void* out,
                           int64_t N, int nx, int elem_size, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  if ((elem_size != 4 && elem_size != 8) || nx < 1 || nx > (1 << 16) ||
      N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int words = nx * elem_size / 4;
  const unsigned blocks = (unsigned)((2 * N + kTile - 1) / kTile);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xw = (const uint32_t*)x;
  auto* ow = (uint32_t*)out;
  // a row as one vector where it is 8 or 16 aligned bytes: on an H100
  // 0.32 against 0.42 ms word by word at N = 2^25, nx = 2, float32 (0.43
  // against 0.60 float64; scripts/torch_kernel_probe.py gather)
  const uintptr_t align = (uintptr_t)x | (uintptr_t)out;
  if (words == 2 && align % 8 == 0)
    systematic_gather_kernel<2><<<blocks, kThreads, 0, s>>>(xw, K, ow, N,
                                                            words);
  else if (words == 4 && align % 16 == 0)
    systematic_gather_kernel<4><<<blocks, kThreads, 0, s>>>(xw, K, ow, N,
                                                            words);
  else
    systematic_gather_kernel<0><<<blocks, kThreads, 0, s>>>(xw, K, ow, N,
                                                            words);
  return (int)cudaGetLastError();
}

}  // extern "C"
