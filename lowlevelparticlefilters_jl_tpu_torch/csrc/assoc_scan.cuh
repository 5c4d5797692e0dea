// Temporal-parallel KF/RTS associative scans (kernel K): the kernel and
// its host-side launch, templated on the state size.  csrc/assoc_scan.cu
// holds the C entries and nx = 1, 2; csrc/assoc_scan_nx<n>.cu one
// larger nx each, so that the instances compile in parallel.
//
// Replaces lowlevelparticlefilters_jl_tpu/ops/pallas/assoc_scan.py
// (_plane_scan, assoc_scan.py:167; body _make_kernel :117; entries
// filter_scan_p :243 and smooth_scan_p :288).  It computes the inclusive
// prefix of T Sarkka--Garcia-Fernandez elements under an associative,
// NOT commutative, combine:
//   filter (A, b, C, eta, J), E = 3 nx^2 + 2 nx floats:
//     M = I + C1 J2,  A2D = A2 M^-1,  G = M^-1 A1
//     A = A2D A1, b = A2D (b1 + C1 eta2) + b2, C = sym(A2D C1 A2^T + C2)
//     eta = G^T (eta2 - J2 b1) + eta1,  J = sym(G^T J2 A1 + J1)
//   smooth (E, g, L), E = 2 nx^2 + nx floats, scanned from the end with
//     the prefix so far a and the next (earlier) element b:
//     E = Eb Ea, g = Eb ga + gb, L = sym(Eb La Eb^T + Lb)
// and writes the mean and covariance parts (b, C or g, L) of each prefix.
// The formulas are parallel/temporal.py's _filter_combine_soa and
// _smooth_combine_soa.
//
// The second entry, llpf_assoc_scan_full, replaces filter_scan_full
// (assoc_scan.py:314, the same _plane_scan): the filter scan with the top
// level writing whole prefixes (A, b, C, eta, J), [T, E], which the
// time-sharded scan (parallel/sharded.py) folds a cross-device carry
// into.  It is the same scan; only its writes are whole elements.  Its
// bound is
// memory: 4 E T bytes read and 4 E T written, 128 MB at nx = 2 and
// T = 1e6 (0.038 ms at 3.35 TB/s).
//
// Design.  One cooperative launch (grid.sync needs every block resident
// at once: the grid is sized by the occupancy calculator).  Elements are
// element-major [T, E] f32, one contiguous record per step.  Thread g of
// the grid owns the run of L consecutive scan positions [g L, g L + L),
// L = ceil(T / (G B)) for G blocks of B threads, so any T takes one
// launch; a block owns B runs.
//   1. Each thread combines its run left to right into an aggregate.  The
//      block scans its threads' aggregates in shared memory (Kogge-Stone:
//      at distance d, thread t combines its value with t - d's, always
//      with the earlier one on the left), keeps its exclusive prefix (the
//      inclusive value of thread t - 1) and publishes the block's
//      aggregate.  grid.sync.
//   2. Block b combines the aggregates of blocks 0..b-1: thread i folds
//      the consecutive group [i s, i s + s) left to right (s = ceil(G /
//      B)), then the same Kogge-Stone scan over the groups gives the
//      block's exclusive prefix.
//   3. Each thread combines the block's prefix with its own exclusive
//      prefix, then walks its run again, combining and writing each
//      step's output.
// The runs' records reach the threads through shared memory: in rounds of
// a few records a thread (128 bytes or more), the block copies every
// thread's next records with coalesced 16-, 8- or 4-byte cp.async copies
// into one of two buffers while it combines the other; outputs go back
// the same way, staged and written by the whole block.  A thread reading
// its own 64-byte records straight from device memory, 1 KB from its
// neighbour's, and writing 4-byte stores as far apart, reached an eighth
// of the card's memory rate (0.35 ms for K-full at T = 1e6, against
// 0.104 staged; PERF.md).
// Every association is fixed by T, G and B (no atomics, no look-back that
// depends on which blocks finished first), so two calls give the same
// bits.  No identity element is needed: the first run of the first block
// has no prefix and starts from its first element.  The combine is not
// commutative; the prefix always stays on the left.  The smoother's
// reverse scan reads and writes step T-1-k at scan position k, so no
// flipped copy is made.  The combine inverts each pivot of M = I + C1 J2
// once (a reciprocal, then multiplies; at nx = 2 the closed-form inverse
// with one reciprocal of det M >= 1) in place of two solves' divisions.
//
// Bound on the card: memory, then the dependent chain.  At nx = 2 the
// scan reads 16 floats and writes 6 a step (8.8 MB at T = 1e5, 2.6 us at
// 3.35 TB/s); this design reads the records twice (the second time from
// L2 while they fit there, 50 MB) and its chain is 2 L combines, two
// Kogge-Stone scans of log2 B and log2 of the groups levels, a group
// fold of s combines and two prefix combines: at T = 1e5 about 20
// combines, against 9 launches and some 130 dependent combines in the
// chunk recursion this replaces.  Shared memory holds B elements for the
// scans (odd stride, no bank conflicts) and, at other times, the staging
// buffers: 256 threads up to 32 floats an element, 128 up to 96, 64
// beyond; registers hold the working elements up to nx = 4, local memory
// beyond (nx = 8: 208 floats an element).
//
// TPU workarounds not ported: the [E, NB, 8, L] plane layout and its
// _lane_width VMEM sizing, the pltpu.roll + iota-mask lane sweep, the
// 3-pass sublane carry sweep, and the carry kept in VMEM scratch across
// an "arbitrary" (sequential) grid.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "coop.cuh"

namespace cg = cooperative_groups;

namespace llpf_k {

// M^-1 for M = I + C J with C, J PSD (eig(M) >= 1): Gauss-Jordan without
// pivoting, one reciprocal a pivot; the closed form at N = 1 and 2.
template <int N>
__device__ __forceinline__ void invert(const float (&M)[N][N],
                                       float (&R)[N][N]) {
  if constexpr (N == 1) {
    R[0][0] = __frcp_rn(M[0][0]);
  } else if constexpr (N == 2) {
    const float id = __frcp_rn(M[0][0] * M[1][1] - M[0][1] * M[1][0]);
    R[0][0] = M[1][1] * id;
    R[0][1] = -M[0][1] * id;
    R[1][0] = -M[1][0] * id;
    R[1][1] = M[0][0] * id;
  } else {
    float a[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        a[i][j] = M[i][j];
        R[i][j] = i == j ? 1.f : 0.f;
      }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float p = __frcp_rn(a[k][k]);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        a[k][j] *= p;
        R[k][j] *= p;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (i == k) continue;
        const float f = a[i][k];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          a[i][j] -= f * a[k][j];
          R[i][j] -= f * R[k][j];
        }
      }
    }
  }
}

template <int N>
struct FilterOp {
  static constexpr int E = 3 * N * N + 2 * N;
  static constexpr int kOutOff = N * N;  // b then C
  static constexpr int kOutW = N + N * N;
  // o = l (earlier) combined with r (later); o aliases neither
  __device__ __forceinline__ static void combine(const float* l,
                                                 const float* r, float* o) {
    const float* A1 = l;
    const float* b1 = l + N * N;
    const float* C1 = l + N * N + N;
    const float* eta1 = l + 2 * N * N + N;
    const float* J1 = l + 2 * N * N + 2 * N;
    const float* A2 = r;
    const float* b2 = r + N * N;
    const float* C2 = r + N * N + N;
    const float* eta2 = r + 2 * N * N + N;
    const float* J2 = r + 2 * N * N + 2 * N;
    float* A = o;
    float* b = o + N * N;
    float* C = o + N * N + N;
    float* eta = o + 2 * N * N + N;
    float* J = o + 2 * N * N + 2 * N;

    // M = I + C1 J2, Mi = M^-1, X = A2D = A2 Mi, G = Mi A1
    float M[N][N], Mi[N][N], X[N][N], G[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = (i == j) ? 1.f : 0.f;
#pragma unroll
        for (int q = 0; q < N; ++q) s += C1[i * N + q] * J2[q * N + j];
        M[i][j] = s;
      }
    invert<N>(M, Mi);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float x = 0.f, g = 0.f;
#pragma unroll
        for (int q = 0; q < N; ++q) {
          x += A2[i * N + q] * Mi[q][j];
          g += Mi[i][q] * A1[q * N + j];
        }
        X[i][j] = x;
        G[i][j] = g;
      }

#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < N; ++q) s += X[i][q] * A1[q * N + j];
        A[i * N + j] = s;
      }
    float t[N];
#pragma unroll
    for (int q = 0; q < N; ++q) {
      float s = b1[q];
#pragma unroll
      for (int p = 0; p < N; ++p) s += C1[q * N + p] * eta2[p];
      t[q] = s;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < N; ++q) s += X[i][q] * t[q];
      b[i] = s + b2[i];
    }
    float P[N][N], Q[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < N; ++q) s += X[i][q] * C1[q * N + j];
        P[i][j] = s;  // A2D C1
      }
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < N; ++q) s += P[i][q] * A2[j * N + q];
        Q[i][j] = s + C2[i * N + j];
      }
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) C[i * N + j] = 0.5f * (Q[i][j] + Q[j][i]);

#pragma unroll
    for (int q = 0; q < N; ++q) {
      float s = eta2[q];
#pragma unroll
      for (int p = 0; p < N; ++p) s -= J2[q * N + p] * b1[p];
      t[q] = s;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < N; ++q) s += G[q][i] * t[q];
      eta[i] = s + eta1[i];
    }
#pragma unroll
    for (int q = 0; q < N; ++q)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = 0.f;
#pragma unroll
        for (int p = 0; p < N; ++p) s += J2[q * N + p] * A1[p * N + j];
        P[q][j] = s;  // J2 A1
      }
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < N; ++q) s += G[q][i] * P[q][j];
        Q[i][j] = s + J1[i * N + j];
      }
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) J[i * N + j] = 0.5f * (Q[i][j] + Q[j][i]);
  }
};

template <int N>
struct SmoothOp {
  static constexpr int E = 2 * N * N + N;
  static constexpr int kOutOff = N * N;  // g then L
  static constexpr int kOutW = N + N * N;
  // l: the prefix so far (later in time), r: the next, earlier element;
  // o = r absorbing l, i.e. _smooth_combine(r, l)
  __device__ __forceinline__ static void combine(const float* l,
                                                 const float* r, float* o) {
    const float* E1 = r;
    const float* g1 = r + N * N;
    const float* L1 = r + N * N + N;
    const float* E2 = l;
    const float* g2 = l + N * N;
    const float* L2 = l + N * N + N;
    float* Eo = o;
    float* g = o + N * N;
    float* L = o + N * N + N;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < N; ++q) s += E1[i * N + q] * E2[q * N + j];
        Eo[i * N + j] = s;
      }
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < N; ++q) s += E1[i * N + q] * g2[q];
      g[i] = s + g1[i];
    }
    float P[N][N], Q[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < N; ++q) s += E1[i * N + q] * L2[q * N + j];
        P[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < N; ++q) s += P[i][q] * E1[j * N + q];
        Q[i][j] = s + L1[i * N + j];
      }
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) L[i * N + j] = 0.5f * (Q[i][j] + Q[j][i]);
  }
};

// The combine, inlined up to 32 floats an element (nx <= 2, the smoother
// to nx = 3); beyond, one call: six inlined copies of a larger combine
// take minutes to compile, and from nx = 5 the elements live in local
// memory anyway.
template <class Op>
__device__ __noinline__ void combine_call(const float* l, const float* r,
                                          float* o) {
  Op::combine(l, r, o);
}

template <class Op>
__device__ __forceinline__ void combine(const float* l, const float* r,
                                        float* o) {
  if constexpr (Op::E > 32)
    combine_call<Op>(l, r, o);
  else
    Op::combine(l, r, o);
}

// One record of E floats, with the widest loads its alignment allows (the
// [T, E] base is 16-byte aligned).
template <int E>
__device__ __forceinline__ void load(const float* x, int64_t k, float* v) {
  const float* s = x + k * E;
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 f = *reinterpret_cast<const float4*>(s + e);
      v[e] = f.x;
      v[e + 1] = f.y;
      v[e + 2] = f.z;
      v[e + 3] = f.w;
    }
  } else if constexpr (E % 2 == 0) {
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      const float2 f = *reinterpret_cast<const float2*>(s + e);
      v[e] = f.x;
      v[e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = s[e];
  }
}

template <int E>
__device__ __forceinline__ void copy(const float* s, float* d) {
#pragma unroll
  for (int e = 0; e < E; ++e) d[e] = s[e];
}

// Threads a block: as many as keep B elements in shared memory small.
template <class Op>
__host__ __device__ constexpr int threads_of() {
  return Op::E <= 32 ? 256 : (Op::E <= 96 ? 128 : 64);
}

// Shared-memory stride of an element: odd, so that thread t's element at
// t * stride hits its own bank.
template <class Op>
__host__ __device__ constexpr int stride_of() {
  return Op::E | 1;
}

// The staging of a thread's run through shared memory: a round moves C
// consecutive records of every thread (at least 128 bytes a thread), in
// units of U floats (16- or 8-byte copies where the records allow), into
// a thread's slot of SI floats (in) or SO floats (out); two input buffers
// alternate, so that the next round's copy runs while this one combines.
// A thread's slot stride in units is odd, so the threads' reads of their
// own records do not conflict in the shared-memory banks.
__host__ __device__ constexpr int slot_floats(int n, int u) {
  return u == 4 ? (n % 8 == 4 ? n : n + 4)
                : (u == 2 ? (n % 4 == 2 ? n : n + 2) : (n | 1));
}

__host__ __device__ constexpr int unit_of(int n) {
  return n % 4 == 0 ? 4 : (n % 2 == 0 ? 2 : 1);
}

template <class Op, bool kFull>
struct Stage {
  static constexpr int E = Op::E, B = threads_of<Op>();
  static constexpr int W = kFull ? E : Op::kOutW;
  static constexpr int C = E >= 32 ? 1 : (32 + E - 1) / E;
  static constexpr int UI = unit_of(E), UO = unit_of(W);
  static constexpr int SI = slot_floats(C * E, UI);
  static constexpr int SO = slot_floats(C * W, UO);
  static constexpr int kIn = 2 * B * SI, kOut = B * SO;
  static constexpr int kFloats =
      kIn + kOut > B * stride_of<Op>() ? kIn + kOut : B * stride_of<Op>();
};

struct ScanArgs {
  const float* x;   // [T, E] elements in memory order
  float* out;       // [T, kOutW] parts, or [T, E] whole elements
  float* agg;       // [G, E] block aggregates
  int64_t T;
  int64_t L;        // scan positions a thread
  int reverse;      // scan position k reads and writes step T-1-k
};

// Thread ts's records in round r: scan positions [p0, p0 + n) and the
// first memory step of the n contiguous records they occupy.
struct Seg {
  int64_t m0;
  int n;
};

template <int C>
__device__ __forceinline__ Seg segment(const ScanArgs& a, int64_t first,
                                       int ts, int r) {
  const int64_t run = first + (int64_t)ts * a.L;
  const int64_t end = run + a.L < a.T ? run + a.L : a.T;
  const int64_t p0 = run + (int64_t)r * C;
  const int64_t p1 = p0 + C < end ? p0 + C : end;
  Seg g;
  g.n = p1 > p0 ? (int)(p1 - p0) : 0;
  g.m0 = a.reverse ? a.T - p1 : p0;
  return g;
}

// Round r's records of the block's threads into buf, asynchronously.
template <class Op, bool kFull>
__device__ __forceinline__ void stage_in(const ScanArgs& a, float* buf,
                                         int64_t first, int r) {
  using S = Stage<Op, kFull>;
  constexpr int E = S::E, U = S::UI, per = S::C * E / U;
#pragma unroll 1
  for (int q = threadIdx.x; q < S::B * per; q += S::B) {
    const int ts = q / per, o = (q % per) * U;
    const Seg g = segment<S::C>(a, first, ts, r);
    if (o < g.n * E)
      llpf_async_copy<4 * U>(buf + ts * S::SI + o, a.x + g.m0 * E + o);
  }
  llpf_async_commit();
}

// Round r's outputs of the block's threads from the stage to out.
template <class Op, bool kFull>
__device__ __forceinline__ void stage_out(const ScanArgs& a,
                                          const float* st, int64_t first,
                                          int r) {
  using S = Stage<Op, kFull>;
  constexpr int W = S::W, U = S::UO, per = S::C * W / U;
#pragma unroll 1
  for (int q = threadIdx.x; q < S::B * per; q += S::B) {
    const int ts = q / per, o = (q % per) * U;
    const Seg g = segment<S::C>(a, first, ts, r);
    if (o < g.n * W) {
      float* d = a.out + g.m0 * W + o;
      const float* s = st + ts * S::SO + o;
      if constexpr (U == 4)
        *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
      else if constexpr (U == 2)
        *reinterpret_cast<float2*>(d) = *reinterpret_cast<const float2*>(s);
      else
        *d = *s;
    }
  }
}

// Record j of the thread's n records of a round, in scan order, from its
// slot (memory order: reversed for the smoother).
template <int E, int U>
__device__ __forceinline__ void read_rec(const float* slot, int j, int n,
                                         int reverse, float* v) {
  const float* s = slot + (reverse ? n - 1 - j : j) * E;
  if constexpr (U == 4) {
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 f = *reinterpret_cast<const float4*>(s + e);
      v[e] = f.x;
      v[e + 1] = f.y;
      v[e + 2] = f.z;
      v[e + 3] = f.w;
    }
  } else if constexpr (U == 2) {
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      const float2 f = *reinterpret_cast<const float2*>(s + e);
      v[e] = f.x;
      v[e + 1] = f.y;
    }
  } else {
    copy<E>(s, v);
  }
}

// Kogge-Stone inclusive scan of the first n elements of sm (rows of
// `stride` floats), in place; v holds the calling thread's element (row
// threadIdx.x, already stored) and leaves with its inclusive value.  The
// whole block calls it.
template <class Op>
__device__ __forceinline__ void block_scan(float* sm, float* v, int n) {
  constexpr int E = Op::E, S = stride_of<Op>(), B = threads_of<Op>();
  const int t = threadIdx.x;
  float w[E], o[E];
#pragma unroll 1
  for (int d = 1; d < B; d <<= 1) {
    const bool act = t < n && t >= d;
    if (act) {
      copy<E>(sm + (t - d) * S, w);
      combine<Op>(w, v, o);
    }
    __syncthreads();
    if (act) {
      copy<E>(o, v);
      copy<E>(v, sm + t * S);
    }
    __syncthreads();
  }
}

// kFull writes whole elements, otherwise the mean and covariance parts.
template <class Op, bool kFull>
__global__ void __launch_bounds__(threads_of<Op>())
    scan_kernel(const ScanArgs a) {
  using St = Stage<Op, kFull>;
  constexpr int E = Op::E, S = stride_of<Op>(), B = threads_of<Op>();
  constexpr int kOff = kFull ? 0 : Op::kOutOff, W = St::W, C = St::C;
  cg::grid_group grid = cg::this_grid();
  float* sm = llpf_smem<float>();
  float* in[2] = {sm, sm + B * St::SI};
  float* outst = sm + St::kIn;
  const int t = threadIdx.x;
  const int64_t T = a.T, L = a.L;
  const int64_t first = (int64_t)blockIdx.x * B * L;
  const int64_t k0 = first + t * L;
  const bool has = k0 < T;
  const int64_t runs = (T + L - 1) / L - (int64_t)blockIdx.x * B;
  const int nvalid = runs < B ? (int)runs : B;   // >= 1 in every block
  const int rounds = (int)((L + C - 1) / C);

  // 1. the run's aggregate (its records staged a round ahead), the block
  // scan, the block's aggregate
  float acc[E], cur[E], nxt[E];
  stage_in<Op, kFull>(a, in[0], first, 0);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    if (r + 1 < rounds) {
      stage_in<Op, kFull>(a, in[(r + 1) & 1], first, r + 1);
      llpf_async_wait<1>();
    } else {
      llpf_async_wait<0>();
    }
    __syncthreads();
    const Seg g = segment<C>(a, first, t, r);
    const float* slot = in[r & 1] + t * St::SI;
#pragma unroll 1
    for (int j = 0; j < g.n; ++j) {
      if (r == 0 && j == 0) {
        read_rec<E, St::UI>(slot, j, g.n, a.reverse, acc);
      } else {
        read_rec<E, St::UI>(slot, j, g.n, a.reverse, cur);
        combine<Op>(acc, cur, nxt);
        copy<E>(nxt, acc);
      }
    }
    __syncthreads();
  }
  if (has) copy<E>(acc, sm + t * S);
  __syncthreads();
  block_scan<Op>(sm, acc, nvalid);
  float mine[E];   // the inclusive value of thread t - 1
  if (has && t > 0) copy<E>(sm + (t - 1) * S, mine);
  if (t == nvalid - 1) copy<E>(acc, a.agg + (int64_t)blockIdx.x * E);
  grid.sync();

  // 2. the block's prefix: groups of s blocks folded, then scanned
  const int nb = blockIdx.x;
  if (nb > 0) {
    const int s = (gridDim.x + B - 1) / B;
    const int ng = (nb + s - 1) / s;
    if (t < ng) {
      const int i0 = t * s, i1 = i0 + s < nb ? i0 + s : nb;
      copy<E>(a.agg + (int64_t)i0 * E, acc);
#pragma unroll 1
      for (int i = i0 + 1; i < i1; ++i) {
        copy<E>(a.agg + (int64_t)i * E, cur);
        combine<Op>(acc, cur, nxt);
        copy<E>(nxt, acc);
      }
      copy<E>(acc, sm + t * S);
    }
    __syncthreads();
    block_scan<Op>(sm, acc, ng);
    copy<E>(sm + (ng - 1) * S, cur);   // the prefix of blocks 0..nb-1
  }
  __syncthreads();   // the stage below reuses the scan's shared memory

  // 3. the thread's prefix, then its run again, each round's outputs
  // staged and written by the whole block
  const bool pre = nb > 0 || t > 0;
  if (nb > 0 && t > 0) {
    combine<Op>(cur, mine, nxt);
    copy<E>(nxt, mine);
  } else if (nb > 0) {
    copy<E>(cur, mine);
  }
  stage_in<Op, kFull>(a, in[0], first, 0);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    if (r + 1 < rounds) {
      stage_in<Op, kFull>(a, in[(r + 1) & 1], first, r + 1);
      llpf_async_wait<1>();
    } else {
      llpf_async_wait<0>();
    }
    __syncthreads();
    const Seg g = segment<C>(a, first, t, r);
    const float* slot = in[r & 1] + t * St::SI;
    float* oslot = outst + t * St::SO;
#pragma unroll 1
    for (int j = 0; j < g.n; ++j) {
      read_rec<E, St::UI>(slot, j, g.n, a.reverse, cur);
      if (r > 0 || j > 0) {
        combine<Op>(acc, cur, nxt);
        copy<E>(nxt, acc);
      } else if (pre) {
        combine<Op>(mine, cur, acc);
      } else {
        copy<E>(cur, acc);
      }
      float* dst = oslot + (a.reverse ? g.n - 1 - j : j) * W;
#pragma unroll
      for (int w = 0; w < W; ++w) dst[w] = acc[kOff + w];
    }
    __syncthreads();
    stage_out<Op, kFull>(a, outst, first, r);
  }
}

// Inclusive scan of T elements at x into out; agg holds cap floats.
template <class Op, bool kFull>
cudaError_t run(const float* x, float* out, float* agg, int64_t cap,
                int64_t T, int reverse, cudaStream_t s) {
  constexpr int B = threads_of<Op>();
  const size_t smem = sizeof(float) * Stage<Op, kFull>::kFloats;
  const void* fn = (const void*)scan_kernel<Op, kFull>;
  int most = 0;
  cudaError_t e = llpf_coop_grid(fn, B, smem, 1LL << 30, &most);
  if (e != cudaSuccess) return e;
  ScanArgs a;
  a.x = x;
  a.out = out;
  a.agg = agg;
  a.T = T;
  a.L = (T + (int64_t)most * B - 1) / ((int64_t)most * B);
  a.reverse = reverse;
  const int64_t grid = (T + B * a.L - 1) / (B * a.L);
  if (grid * Op::E > cap) return cudaErrorInvalidValue;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(fn, dim3((unsigned)grid), dim3(B), args,
                                  smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// kind 0 = filter, 1 = smooth (reversed), 2 = filter writing whole elements
template <int N>
cudaError_t run_nx(const float* x, float* out, float* agg, int64_t cap,
                   int64_t T, int kind, cudaStream_t s) {
  if (kind == 1) return run<SmoothOp<N>, false>(x, out, agg, cap, T, 1, s);
  if (kind == 2) return run<FilterOp<N>, true>(x, out, agg, cap, T, 0, s);
  return run<FilterOp<N>, false>(x, out, agg, cap, T, 0, s);
}

}  // namespace llpf_k
