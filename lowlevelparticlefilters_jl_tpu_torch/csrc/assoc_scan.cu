// Temporal-parallel KF/RTS associative scans (kernel K).
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
// into.  It is the same chunk scheme; only the top level's writes are
// whole elements, as the aggregate levels' already are.  Its bound is
// memory: 4 E T bytes read and 4 E T written, 128 MB at nx = 2 and
// T = 1e6 (0.038 ms at 3.35 TB/s).
//
// Design.  Elements are element-major [T, E] f32, one contiguous record
// per step.  A thread owns a chunk of kChunk = 16 consecutive steps and
// combines them in sequence in registers, always with the prefix on the
// left.  Three phases per level: (1) each thread reduces its chunk to an
// aggregate; (2) the aggregates are scanned by the same scheme, one level
// up, until one thread can scan what is left alone; (3) each thread
// combines the inclusive prefix of the chunks before it with its own
// elements and writes the outputs.  Blocks never wait on each other:
// the carry between chunks goes through the aggregate buffer, between
// launches on one stream.  No identity element is needed: chunk 0 has no
// prefix and simply starts from its first element.  The smoother's
// reverse scan reads and writes step T-1-k at scan position k, so no
// flipped copy is made.
//
// Bound on the card: memory, then launch latency.  At nx = 2 the scan
// reads 16 floats and writes 6 a step (8.8 MB at T = 1e5, 2.6 us at
// 3.35 TB/s); this design reads the elements twice and runs 2 kernels a
// level (9 launches at T = 1e5), and a thread's chunk is a chain of
// dependent combines, each with two 2x2 no-pivot solves.  Registers hold
// three elements and the combine's temporaries: about 100 floats at
// nx = 2, some 1100 at nx = 8, where the rest spills to local memory.
//
// TPU workarounds not ported: the [E, NB, 8, L] plane layout and its
// _lane_width VMEM sizing, the pltpu.roll + iota-mask lane sweep, the
// 3-pass sublane carry sweep, and the carry kept in VMEM scratch across
// an "arbitrary" (sequential) grid.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;   // steps one thread combines in sequence
constexpr int kThreads = 64;

// Gaussian elimination without pivoting, M X = B in place (B becomes X,
// M is destroyed).  Safe for M = I + C J with C, J PSD (eig(M) >= 1).
template <int N>
__device__ __forceinline__ void solve_nopivot(float (&M)[N][N],
                                              float (&B)[N][N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const float f = M[i][k] / M[k][k];
#pragma unroll
      for (int j = k + 1; j < N; ++j) M[i][j] -= f * M[k][j];
#pragma unroll
      for (int j = 0; j < N; ++j) B[i][j] -= f * B[k][j];
    }
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = B[i][j];
#pragma unroll
      for (int q = i + 1; q < N; ++q) acc -= M[i][q] * B[q][j];
      B[i][j] = acc / M[i][i];
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

    float M[N][N], Mt[N][N], X[N][N], G[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = (i == j) ? 1.f : 0.f;
#pragma unroll
        for (int q = 0; q < N; ++q) s += C1[i * N + q] * J2[q * N + j];
        M[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        Mt[i][j] = M[j][i];
        X[i][j] = A2[j * N + i];
        G[i][j] = A1[i * N + j];
      }
    solve_nopivot<N>(Mt, X);  // X = M^-T A2^T, so A2D = X^T
    solve_nopivot<N>(M, G);   // G = M^-1 A1

#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < N; ++q) s += X[q][i] * A1[q * N + j];
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
      for (int q = 0; q < N; ++q) s += X[q][i] * t[q];
      b[i] = s + b2[i];
    }
    float P[N][N], Q[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < N; ++q) s += X[q][i] * C1[q * N + j];
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

template <int E>
__device__ __forceinline__ void load(const float* x, int64_t k, float* v) {
  const float* s = x + k * E;
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = s[e];
}

// position in memory of scan position k
__device__ __forceinline__ int64_t pos(int64_t k, int64_t n, int reverse) {
  return reverse ? n - 1 - k : k;
}

// phase 1: agg[c] = the combine of chunk c's elements, in order
template <class Op>
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* x, float* agg, int64_t n, int reverse) {
  constexpr int E = Op::E;
  const int64_t nch = (n + kChunk - 1) / kChunk;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nch) return;
  const int64_t k0 = c * kChunk;
  const int64_t k1 = (k0 + kChunk < n) ? k0 + kChunk : n;
  float acc[E], cur[E], nxt[E];
  load<E>(x, pos(k0, n, reverse), acc);
#pragma unroll 1
  for (int64_t k = k0 + 1; k < k1; ++k) {
    load<E>(x, pos(k, n, reverse), cur);
    Op::combine(acc, cur, nxt);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = nxt[e];
  }
  float* dst = agg + c * E;
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = acc[e];
}

// phase 3: the inclusive scan of chunk c, started from prefix[c - 1] (the
// inclusive scan of the aggregates; none for chunk 0 or a single chunk).
// kFull writes whole elements (the aggregate levels, in place, and the
// top level of the full mode); otherwise only the mean and covariance
// parts, at row width N + N^2.
template <class Op, bool kFull>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const float* x, const float* prefix, float* out, int64_t n,
                 int reverse) {
  constexpr int E = Op::E;
  constexpr int kOff = kFull ? 0 : Op::kOutOff;
  constexpr int kW = kFull ? E : Op::kOutW;
  const int64_t nch = (n + kChunk - 1) / kChunk;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nch) return;
  const int64_t k0 = c * kChunk;
  const int64_t k1 = (k0 + kChunk < n) ? k0 + kChunk : n;
  float acc[E], cur[E], nxt[E];
  load<E>(x, pos(k0, n, reverse), cur);
  if (prefix != nullptr && c > 0) {
    load<E>(prefix, c - 1, nxt);
    Op::combine(nxt, cur, acc);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = cur[e];
  }
  for (int64_t k = k0;;) {
    float* dst = out + pos(k, n, reverse) * kW;
#pragma unroll
    for (int w = 0; w < kW; ++w) dst[w] = acc[kOff + w];
    if (++k >= k1) break;
    load<E>(x, pos(k, n, reverse), cur);
    Op::combine(acc, cur, nxt);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = nxt[e];
  }
}

// Inclusive scan of n elements at x.  The top level (top) reads in scan
// order pos(k) and writes to out the mean/covariance parts, or with full
// whole elements; lower levels scan aggregate buffers in place (reverse 0,
// whole elements).  scratch holds cap floats for the aggregates of this
// level and the ones above it.
template <class Op>
cudaError_t scan_level(const float* x, float* out, float* scratch,
                       int64_t cap, int64_t n, int reverse, bool top,
                       bool full, cudaStream_t s) {
  constexpr int E = Op::E;
  const bool whole = full || !top;
  if (n <= kChunk) {
    if (whole)
      apply_kernel<Op, true><<<1, 1, 0, s>>>(x, nullptr, out, n, reverse);
    else
      apply_kernel<Op, false><<<1, 1, 0, s>>>(x, nullptr, out, n, reverse);
    return cudaGetLastError();
  }
  const int64_t nch = (n + kChunk - 1) / kChunk;
  if (nch * E > cap) return cudaErrorInvalidValue;
  float* agg = scratch;
  const unsigned blocks = (unsigned)((nch + kThreads - 1) / kThreads);
  reduce_kernel<Op><<<blocks, kThreads, 0, s>>>(x, agg, n, reverse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = scan_level<Op>(agg, agg, scratch + nch * E, cap - nch * E, nch, 0,
                       false, false, s);
  if (err != cudaSuccess) return err;
  if (whole)
    apply_kernel<Op, true><<<blocks, kThreads, 0, s>>>(x, agg, out, n,
                                                      reverse);
  else
    apply_kernel<Op, false><<<blocks, kThreads, 0, s>>>(x, agg, out, n,
                                                       reverse);
  return cudaGetLastError();
}

// kind 0 = filter, 1 = smooth (reversed), 2 = filter writing whole elements
template <int N>
cudaError_t run(const float* x, float* out, float* scratch, int64_t cap,
                int64_t T, int kind, cudaStream_t s) {
  if (kind == 1)
    return scan_level<SmoothOp<N>>(x, out, scratch, cap, T, 1, true, false,
                                   s);
  return scan_level<FilterOp<N>>(x, out, scratch, cap, T, 0, true,
                                 kind == 2, s);
}

int dispatch(const float* x, float* out, float* scratch, int64_t cap,
             int64_t T, int nx, int kind, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (nx) {
    case 1: return (int)run<1>(x, out, scratch, cap, T, kind, s);
    case 2: return (int)run<2>(x, out, scratch, cap, T, kind, s);
    case 3: return (int)run<3>(x, out, scratch, cap, T, kind, s);
    case 4: return (int)run<4>(x, out, scratch, cap, T, kind, s);
    case 5: return (int)run<5>(x, out, scratch, cap, T, kind, s);
    case 6: return (int)run<6>(x, out, scratch, cap, T, kind, s);
    case 7: return (int)run<7>(x, out, scratch, cap, T, kind, s);
    case 8: return (int)run<8>(x, out, scratch, cap, T, kind, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [T, E] elements, out [T, nx + nx^2]; kind 0 = filter, 1 = smooth.
int llpf_assoc_scan(const float* x, float* out, float* scratch, int64_t cap,
                    int64_t T, int nx, int kind, void* stream) {
  if (kind != 0 && kind != 1) return (int)cudaErrorInvalidValue;
  return dispatch(x, out, scratch, cap, T, nx, kind, stream);
}

// x [T, E] filter elements, out [T, E] (not x: x is only read) their
// inclusive prefixes, whole.
int llpf_assoc_scan_full(const float* x, float* out, float* scratch,
                         int64_t cap, int64_t T, int nx, void* stream) {
  if (out == x) return (int)cudaErrorInvalidValue;
  return dispatch(x, out, scratch, cap, T, nx, 2, stream);
}

}  // extern "C"
