// FFBS backward simulation in one launch, kernel J.
//
// Replaces lowlevelparticlefilters_jl_tpu/ops/pallas/ffbs_kernel.py
// (ffbs_backward_pallas, ffbs_kernel.py:190; body _make_kernel, :49).
// Per reversed step t = T-2 .. 0 and trajectory m (the caller whitens and
// centres the predicted particles, kernels/ffbs.py::whiten):
//
//   zb     = L^-1 (xb_m - mu) - c_t                       [nx]
//   w_n    = wfc_t[n] + zb . zpred_t[n] - 0.5 |zb|^2       n < N
//   i      = a draw of n with probability exp(w_n) / sum exp(w)
//   xb_m   = xf_t[i]
//
// The draw.  The TPU kernel adds Gumbel noise to every column and takes
// the argmax, the draw that suits a machine without a cheap scan; it costs
// a random word and two logs a column.  Here one uniform u a (t, m), from
// Philox4x32-10 (philox.cuh) keyed by the seed, counter (t, m, 0,
// LLPF_TAG_FFBS), mapped to ((b >> 9) * 2 + 1) 2^-24, strictly inside
// (0, 1), picks a column by inverse CDF; noise == 0 takes the exact MAP
// column (the lowest index among equal maxima).  The columns fall into
// chunks of 1024; lane l of a warp holds a chunk's columns l + 32 i,
// i < 32:
//
//   m_c    = the chunk's max score (NaN counts as -inf)
//   e_n    = ex(w_n, m_c): 0 for -inf or NaN, 1 where w_n == m_c, else
//            expf(w_n - m_c) (the function torch.exp calls on the card)
//   Q_li   = e_l0 + e_l1 + ... + e_li, left to right
//   E_l    = lane l's exclusive prefix of the lanes' totals, by a
//            Kogge-Stone scan (shuffle-up by 1, 2, 4, 8, 16); s_c = the
//            scan's last lane
//
// Over the chunks: mx = max m_c, f_c = ex(m_c, mx), a_c = s_c f_c,
// acc_c = a_0 + ... + a_{c-1} left to right, thr = u acc_{nC}.  The chunk
// is the first c with a_c > 0 and acc_c + a_c > thr (else the last with
// a_c > 0), and in it the column is the first (l, i), lanes first, with
// e > 0 and acc_c + (E_l + Q_li) f_c > thr (else its last column with e >
// 0).  A row with no finite score takes column 0.  Every operation is a
// round-to-nearest intrinsic in a fixed order, which
// kernels/ffbs.py::ffbs_backward_plain repeats op for op.  It draws from
// the categorical law of exp(w), as Gumbel-max does; a -inf or NaN score
// has e = 0 and is never drawn.
//
// Design.  A block runs W trajectories, a warp each (W = ceil(M / SMs),
// at most 8: 8 warps on each of 125 SMs at M = 1000).  Each step's chunks
// (zpred_t and wfc_t, and xf_t when the step is one chunk) are staged
// once for the block's W trajectories by cp.async into a ring of two
// stages, so the next chunk loads while this one is scored; the one
// block-wide barrier a chunk is the staging barrier.  A lane keeps its 32
// scores, then its prefixes, in registers; the max is a shuffle
// reduction; the search counts a lane's prefixes below the threshold (they
// rise with i) and a ballot picks the lane.  When the step is one chunk
// (N <= 1024) the chosen row is read from shared memory.  Otherwise each
// chunk's (m_c, s_c) goes to a scratch row of the trajectory, the chunk
// rule reads them back, and only the chosen chunk is scored again (from
// L2), as is the chosen row read.  (Four warps a trajectory, 256 columns
// each, measured slower: 2.37 against 1.64 ms at M = N = 1000, T = 500;
// the trajectory's barriers and its chunk rule, run by every warp,
// outweighed the latency the extra warps hid.)
//
// Bound on the card: operations, counted for the draw and not for this
// kernel's way of making it.  Each (t, m, n) needs the score (2 nx + 1
// flops), the max, one expf and its subtraction, and the add of the sum;
// each (t, m) one Philox call, a search of ceil(log2 N) compares and the
// whitened state.  (The kernel's search is a compare a column, cheaper
// here than the dependent loads of a binary search.)  The bytes (every
// input once, the output) are two orders of magnitude below that at the
// main path's shapes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "coop.cuh"
#include "philox.cuh"

namespace {

constexpr int kChunk = 1024;          // columns a chunk: one warp, one slab
constexpr int kPer = kChunk / 32;     // columns a lane holds in a chunk
constexpr int kMaxWarps = 8;          // trajectories a block
constexpr int kNone = 0x7fffffff;
constexpr int kClocks = 6;            // stats: stage, score, prefix, search,
                                      // row, whole loop

__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

struct Args {
  const float *zpred, *wfc, *cen, *xf, *xb_T, *Linv, *mu;
  float* out;
  int32_t* idx;
  float2* chunks;       // [M, nC] (m_c, s_c) when nC > 1
  long long* stats;     // [kClocks] or null
  int Tm1, N, M, nC, noise;
  int units;            // units a slab: the staging barrier's period
  uint64_t seed;
};

// A unit is a step's chunk: the step itself when it is one chunk (nC ==
// 1), else 1024 of its columns.  Floats of a unit's region in a ring
// stage: zpred, wfc and, when nC == 1, xf, each padded to 16 bytes.
template <int NX>
__host__ __device__ __forceinline__ int unit_floats(int N, int nC) {
  const int cs = nC == 1 ? N : kChunk;
  return pad4(cs * NX) + pad4(cs) + (nC == 1 ? pad4(cs * NX) : 0);
}

// Floats the ring takes besides its two stages: the loads of a chunk's
// last lanes past N stay in the allocation.
template <int NX>
__host__ __device__ __forceinline__ int ring_slack() {
  return kChunk * (2 * NX + 1);
}

// exp(a - m) for the scores a of a chunk (NaN already -inf) of max m:
// 0 for a = -inf, 1 where a == m; a warp-uniform branch on m, so the
// common path is one subtraction and expf
__device__ __forceinline__ float ex(float a, float m) {
  if (isfinite(m)) return expf(__fsub_rn(a, m));
  return a == m && m > 0.0f ? 1.0f : 0.0f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the larger score, the lower index among equal scores
__device__ __forceinline__ void keep_better(float s, int i, float& bs,
                                            int& bi) {
  if (s > bs || (s == bs && i < bi)) {
    bs = s;
    bi = i;
  }
}

__device__ __forceinline__ void warp_best(float& bs, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, bs, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    keep_better(os, oi, bs, bi);
  }
}

// n floats from src to dst by the whole block, as cp.async copies: 16
// bytes where src is 16-byte aligned (dst always is), else 4.
__device__ __forceinline__ void stage_copy(float* dst, const float* src,
                                           int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      llpf_async_copy<16>(dst + 4 * i, src + 4 * i);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x)
    llpf_async_copy<4>(dst + i, src + i);
}

// Slab s: units s K .. s K + K - 1 (unit u: step Tm1 - 1 - u / nC, chunk
// u % nC), into the stage st, region by region.
template <int NX>
__device__ __forceinline__ void issue_slab(const Args& a, float* st, int s) {
  const int cs = a.nC == 1 ? a.N : kChunk;
  const int rf = unit_floats<NX>(a.N, a.nC);
  const int U = a.Tm1 * a.nC;
  int u = s * a.units, t = a.Tm1 - 1 - u / a.nC, c = u % a.nC;
  for (int k = 0; k < a.units && u < U; ++k, ++u, st += rf) {
    const int c0 = c * kChunk;
    const int n = min(kChunk, a.N - c0);
    const int64_t row = (int64_t)t * a.N + c0;
    stage_copy(st, a.zpred + row * NX, n * NX);
    stage_copy(st + pad4(cs * NX), a.wfc + row, n);
    if (a.nC == 1)
      stage_copy(st + pad4(cs * NX) + pad4(cs), a.xf + row * NX, n * NX);
    if (++c == a.nC) {
      c = 0;
      --t;
    }
  }
  llpf_async_commit();
}

template <int NX>
__device__ __forceinline__ void load_row(const float* p, float (&r)[NX]) {
  if constexpr (NX % 4 == 0) {
#pragma unroll
    for (int k = 0; k < NX; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      r[k] = q.x;
      r[k + 1] = q.y;
      r[k + 2] = q.z;
      r[k + 3] = q.w;
    }
  } else if constexpr (NX % 2 == 0) {
#pragma unroll
    for (int k = 0; k < NX; k += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + k);
      r[k] = q.x;
      r[k + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NX; ++k) r[k] = p[k];
  }
}

// The lane's scores of a chunk of cn columns (zpred z [cn, NX], wfc w
// [cn]); -inf past the chunk's end and for NaN.  In shared memory a
// stage holds a whole chunk, so the loads past the end stay in it; from
// device memory (kClamp) they are clamped into the chunk.
template <int NX, bool kClamp, bool kFull = false>
__device__ __forceinline__ void chunk_scores(const float* z, const float* w,
                                             int cn, const float (&zb)[NX],
                                             float half_cm,
                                             float (&v)[kPer]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int n = lane + 32 * i;
    const int nn = kClamp && n >= cn ? cn - 1 : n;
    float r[NX];
    load_row<NX>(z + (int64_t)nn * NX, r);
    float s = w[nn];
#pragma unroll
    for (int k = 0; k < NX; ++k) s = __fadd_rn(s, __fmul_rn(zb[k], r[k]));
    s = __fsub_rn(s, half_cm);
    v[i] = (kFull || n < cn) && s == s ? s : -INFINITY;
  }
}

// fmaxf drops NaN and is exact in any order: four chains, then the warp
__device__ __forceinline__ float chunk_max(const float (&v)[kPer]) {
  float m0 = v[0], m1 = v[1 % kPer], m2 = v[2 % kPer], m3 = v[3 % kPer];
#pragma unroll
  for (int i = 4; i < kPer; i += 4) {
    m0 = fmaxf(m0, v[i]);
    m1 = fmaxf(m1, v[i + 1]);
    m2 = fmaxf(m2, v[i + 2]);
    m3 = fmaxf(m3, v[i + 3]);
  }
  return warp_max(fmaxf(fmaxf(m0, m1), fmaxf(m2, m3)));
}

// v becomes the lane's inclusive prefixes Q; mask its columns of nonzero
// weight (kMask: a pass whose chunk is searched); E its lanes' exclusive
// prefix; returns the chunk's total s_c.
template <bool kMask = true>
__device__ __forceinline__ float chunk_prefix(float (&v)[kPer], float m,
                                              unsigned& mask, float& E) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  mask = 0u;
  if (isfinite(m)) {  // warp-uniform: the loop holds no branch
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float e = expf(__fsub_rn(v[i], m));
      if (kMask && e > 0.0f) mask |= 1u << i;
      acc = __fadd_rn(acc, e);
      v[i] = acc;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float e = ex(v[i], m);
      if (kMask && e > 0.0f) mask |= 1u << i;
      acc = __fadd_rn(acc, e);
      v[i] = acc;
    }
  }
  float incl = acc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl = __fadd_rn(incl, o);
  }
  E = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) E = 0.0f;
  return __shfl_sync(0xffffffffu, incl, 31);
}

// The chunk's column (l + 32 i): the first, lanes first, with e > 0 and
// P = acc + (E + Q) f > thr, else the last with e > 0.  P rises with i in
// a lane, so the lane's first i with P > thr is the count c of P <= thr,
// and has e > 0 unless it is 0 (then the first i with e > 0 holds).
// kOne: a step of one chunk, acc = 0 and f = 1, where P is E + Q exactly.
template <bool kOne>
__device__ __forceinline__ int chunk_search(const float (&q)[kPer],
                                            unsigned mask, float E,
                                            float acc, float f, float thr) {
  int c = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    c += (kOne ? __fadd_rn(E, q[i])
               : __fadd_rn(acc, __fmul_rn(__fadd_rn(E, q[i]), f))) <= thr;
  const int hit = c == kPer ? -1 : (c > 0 ? c : __ffs(mask) - 1);
  const unsigned b = __ballot_sync(0xffffffffu, hit >= 0);
  if (b) {
    const int l = __ffs(b) - 1;
    return l + 32 * __shfl_sync(0xffffffffu, hit, l);
  }
  const unsigned nz = __ballot_sync(0xffffffffu, mask != 0u);
  const int top = 31 - __clz(mask);
  if (nz == 0u) return 0;
  const int l = 31 - __clz(nz);
  return l + 32 * __shfl_sync(0xffffffffu, top, l);
}

// The chunk rule over the nC chunks' (m_c, s_c) at ch (every lane of the
// warp gets the answer): returns c*, or -1 when no score is finite, with
// acc_{c*}, f_{c*} and thr.  f_c = ex(m_c, mx) takes mx finite.
__device__ __forceinline__ int pick_chunk(const float2* ch, int nC, float u,
                                          float& a_star, float& f_star,
                                          float& thr) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
  for (int c = lane; c < nC; c += 32) mx = fmaxf(mx, ch[c].x);
  mx = warp_max(mx);
  if (mx == -INFINITY) return -1;
  float acc = 0.0f;
  for (int g = 0; g < nC; g += 32) {
    float ac = 0.0f;
    if (g + lane < nC) {
      const float2 p = ch[g + lane];
      ac = __fmul_rn(p.y, ex(p.x, mx));
    }
    const int n = min(32, nC - g);
    for (int j = 0; j < n; ++j)
      acc = __fadd_rn(acc, __shfl_sync(0xffffffffu, ac, j));
  }
  thr = __fmul_rn(u, acc);
  int cs = -1, last = -1;
  float a_last = 0.0f;
  acc = 0.0f;
  for (int g = 0; g < nC && cs < 0; g += 32) {
    float ac = 0.0f;
    if (g + lane < nC) {
      const float2 p = ch[g + lane];
      ac = __fmul_rn(p.y, ex(p.x, mx));
    }
    const int n = min(32, nC - g);
    for (int j = 0; j < n; ++j) {
      const float aj = __shfl_sync(0xffffffffu, ac, j);
      if (aj > 0.0f) {
        last = g + j;
        a_last = acc;
        if (cs < 0 && __fadd_rn(acc, aj) > thr) {
          cs = g + j;
          a_star = acc;
        }
      }
      acc = __fadd_rn(acc, aj);
    }
  }
  if (cs < 0) {
    cs = last;
    a_star = a_last;
  }
  f_star = ex(ch[cs].x, mx);
  return cs;
}

// block 0's first warp: clock64 laps into the stats' slots; the instance
// without stats carries no timing code
template <bool kStats>
struct Clock {
  bool on;
  long long last, acc[kClocks];
  __device__ void start() {
    if (kStats && on) last = clock64();
  }
  __device__ void lap(int k) {
    if (kStats && on) {
      const long long n = clock64();
      acc[k] += n - last;
      last = n;
    }
  }
};

template <int NX, bool kStats>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) ffbs_backward_kernel(
    const Args a) {
  __shared__ float s_Linv[NX * NX];
  __shared__ float s_mu[NX];
  float* ring = llpf_smem<float>();
  const int tid = threadIdx.x, lane = tid & 31;
  const int m = blockIdx.x * (blockDim.x >> 5) + (tid >> 5);
  const bool live = m < a.M;
  const int nC = a.nC, K = a.units;
  const int cs = nC == 1 ? a.N : kChunk;
  const int rf = unit_floats<NX>(a.N, nC);
  const int sf = K * rf;
  const int U = a.Tm1 * nC;
  Clock<kStats> clk{kStats && blockIdx.x == 0 && tid < 32, 0, {}};
  for (int i = tid; i < NX * NX; i += blockDim.x) s_Linv[i] = a.Linv[i];
  if (tid < NX) s_mu[tid] = a.mu[tid];
  float xb[NX];
  if (live) {
#pragma unroll
    for (int k = 0; k < NX; ++k) xb[k] = a.xb_T[(int64_t)m * NX + k];
    if (lane < NX)
      a.out[((int64_t)a.Tm1 * a.M + m) * NX + lane] =
          a.xb_T[(int64_t)m * NX + lane];
  }
  if (U > 0) issue_slab<NX>(a, ring, 0);
  __syncthreads();
  const uint2 key = llpf_key(a.seed);
  float2* ch = a.chunks + (int64_t)(live ? m : 0) * nC;
  clk.start();
  const long long t_loop = clk.on ? clk.last : 0;
  int un = 0, sl = 0, kk = 0;  // the unit, its slab and place in it
  const float* st = ring;
  float u32 = 0.0f;
  for (int t = a.Tm1 - 1; t >= 0; --t) {
    float zb[NX];
    float cm = 0.0f;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j <= k; ++j)
        acc = __fadd_rn(acc, __fmul_rn(__fsub_rn(xb[j], s_mu[j]),
                                       s_Linv[k * NX + j]));
      zb[k] = __fsub_rn(acc, a.cen[t * NX + k]);
      cm = __fadd_rn(cm, __fmul_rn(zb[k], zb[k]));
    }
    const float half_cm = 0.5f * cm;
    // the uniforms of 32 steps at once, lane j's for step t0 - j, so the
    // Philox chain leaves the step's critical path
    const int back = a.Tm1 - 1 - t;
    if (a.noise && (back & 31) == 0) {
      const int tj = t - lane;
      const uint32_t b = llpf_philox4x32_10(
          make_uint4((uint32_t)tj, (uint32_t)m, 0u, LLPF_TAG_FFBS), key).x;
      u32 = (float)(((b >> 9) << 1) | 1u) * 5.9604644775390625e-08f;
    }
    const float u = __shfl_sync(0xffffffffu, u32, back & 31);
    float bs = -INFINITY, mc = -INFINITY, E = 0.0f, tot = 0.0f;
    int bi = kNone;
    unsigned mask = 0u;
    float v[kPer];
    for (int c = 0; c < nC; ++c, ++un) {
      if (kk == K) {  // the next slab
        kk = 0;
        ++sl;
      }
      if (kk == 0) {
        llpf_async_wait<0>();
        __syncthreads();
        if ((sl + 1) * K < U)
          issue_slab<NX>(a, ring + ((sl + 1) & 1) * sf, sl + 1);
      }
      st = ring + (sl & 1) * sf + kk++ * rf;
      clk.lap(0);
      if (!live) continue;
      const int c0 = c * kChunk;
      const int cn = min(kChunk, a.N - c0);
      if (cn == kChunk)  // warp-uniform
        chunk_scores<NX, false, true>(st, st + pad4(cs * NX), cn, zb,
                                      half_cm, v);
      else
        chunk_scores<NX, false>(st, st + pad4(cs * NX), cn, zb, half_cm, v);
      if (!a.noise) {
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          if (v[i] > bs) {  // n rises within a lane: the lowest stays
            bs = v[i];
            bi = c0 + lane + 32 * i;
          }
        clk.lap(1);
        continue;
      }
      mc = chunk_max(v);
      clk.lap(1);
      // a step of several chunks searches only the chosen one, scored
      // again, and needs no mask here
      tot = nC == 1 ? chunk_prefix(v, mc, mask, E)
                    : chunk_prefix<false>(v, mc, mask, E);
      // chunk c's (m_c, s_c), written by lane c % 32, which reads it back
      if (nC > 1 && lane == (c & 31)) ch[c] = make_float2(mc, tot);
      clk.lap(2);
    }
    if (!live) continue;
    int pick;
    if (!a.noise) {
      warp_best(bs, bi);
      pick = bi == kNone ? 0 : bi;
    } else if (nC == 1) {
      pick = mc == -INFINITY ? 0
                             : chunk_search<true>(v, mask, E, 0.0f, 1.0f,
                                                  __fmul_rn(u, tot));
    } else {
      __syncwarp();
      float a_star = 0.0f, f_star = 1.0f, thr = 0.0f;
      const int cs = pick_chunk(ch, nC, u, a_star, f_star, thr);
      pick = 0;
      if (cs >= 0) {
        const int c0 = cs * kChunk;
        const int64_t row = (int64_t)t * a.N + c0;
        chunk_scores<NX, true>(a.zpred + row * NX, a.wfc + row,
                               min(kChunk, a.N - c0), zb, half_cm, v);
        chunk_prefix(v, ch[cs].x, mask, E);
        pick = c0 + chunk_search<false>(v, mask, E, a_star, f_star, thr);
      }
    }
    clk.lap(3);
    const float* xr =
        nC == 1 ? st + pad4(cs * NX) + pad4(cs) + pick * NX
                : a.xf + ((int64_t)t * a.N + pick) * NX;
#pragma unroll
    for (int k = 0; k < NX; ++k) xb[k] = xr[k];
    if (lane < NX) a.out[((int64_t)t * a.M + m) * NX + lane] = xr[lane];
    if (lane == 0 && a.idx != nullptr) a.idx[(int64_t)t * a.M + m] = pick;
    clk.lap(4);
  }
  if (kStats && clk.on && lane == 0) {
    clk.acc[5] = clock64() - t_loop;
    for (int k = 0; k < kClocks; ++k) a.stats[k] = clk.acc[k];
  }
}

int g_sms[64];

template <int NX, bool kStats>
cudaError_t launch(const Args& a, cudaStream_t s) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  // trajectories a block: all SMs busy, each with as few as it takes
  // (two blocks of 4 an SM do not fit beside the ring: 2.10 against 1.25
  // ms at M = N = 1000, T = 500)
  int W = (a.M + g_sms[dev] - 1) / g_sms[dev];
  W = W > kMaxWarps ? kMaxWarps : W;
  // units a slab: as many as two stages hold in 200 KB, at most 8
  Args b = a;
  const size_t rf = sizeof(float) * unit_floats<NX>(a.N, a.nC);
  const size_t slack = sizeof(float) * ring_slack<NX>();
  b.units = (int)((200 * 1024 - slack) / (2 * rf));
  b.units = b.units < 1 ? 1 : (b.units > 8 ? 8 : b.units);
  const size_t smem = 2 * rf * b.units + slack;
  static size_t opted[64];  // per instance: the bytes opted in, by device
  if (smem > 48 * 1024 && smem > opted[dev]) {
    e = cudaFuncSetAttribute(ffbs_backward_kernel<NX, kStats>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    opted[dev] = smem;
  }
  const unsigned blocks = (unsigned)((a.M + W - 1) / W);
  ffbs_backward_kernel<NX, kStats><<<blocks, W * 32, smem, s>>>(b);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// zpred [Tm1, N, nx], wfc [Tm1, N], cen [Tm1, nx], xf [Tm1, N, nx],
// xb_T [M, nx], Linv [nx, nx], mu [nx] -> out [Tm1 + 1, M, nx] and, when
// idx is not null, the chosen columns idx [Tm1, M].  chunks: [M, nC, 2]
// float scratch, nC = ceil(N / 1024), when nC > 1; stats: null or int64
// [6], block 0's first warp's clock64 cycles in staging, scores and max,
// prefix, search, row, and the whole step loop.
int llpf_ffbs_backward(const float* zpred, const float* wfc, const float* cen,
                       const float* xf, const float* xb_T, const float* Linv,
                       const float* mu, float* out, int32_t* idx,
                       float* chunks, long long* stats, int Tm1, int N, int M,
                       int nx, uint64_t seed, int noise, void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  if (N <= 0 || N >= (1 << 30) || Tm1 < 0) return (int)cudaErrorInvalidValue;
  const int nC = (N + kChunk - 1) / kChunk;
  if (nC > 1 && chunks == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{zpred, wfc, cen, xf, xb_T, Linv, mu, out, idx,
               reinterpret_cast<float2*>(chunks), stats, Tm1, N, M, nC,
               noise, 1, seed};
  cudaStream_t s = (cudaStream_t)stream;
  switch (nx) {
#define LLPF_FFBS_CASE(n) \
  case n:                 \
    return (int)(stats ? launch<n, true>(a, s) : launch<n, false>(a, s));
    LLPF_FFBS_CASE(1)
    LLPF_FFBS_CASE(2)
    LLPF_FFBS_CASE(3)
    LLPF_FFBS_CASE(4)
    LLPF_FFBS_CASE(5)
    LLPF_FFBS_CASE(6)
    LLPF_FFBS_CASE(7)
    LLPF_FFBS_CASE(8)
#undef LLPF_FFBS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
