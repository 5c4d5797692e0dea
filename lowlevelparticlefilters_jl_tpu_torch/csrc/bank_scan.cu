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
// The per-step scalars come packed [T, S] as M | AK | Linv | W2 | BmAKD |
// LD (row-major blocks), S = nx^2 + 2 nx ny + ny^2 + nx nu + ny nu; the
// constant sum_t (log|det Linv_t| - ny/2 log 2 pi) is added outside.
//
// Design: a chunked linear scan, a warp for one or two members.  The
// recursion is affine and its matrices are the bank's, so time splits
// over the lanes: in a segment of 32 L steps (L odd) lane k owns the L
// steps k L .. k L + L - 1.
//   pass 1  each chunk from x = 0 (lane 0 from the segment's start
//           state), which gives the chunk's offset d_k, and its composite
//           P_k = M_end ... M_start, formed beside it from the same M_t
//           (no further shared-memory reads; a warp forms its own, so no
//           block barrier waits on a producer);
//   scan    a Kogge-Stone over the lanes of the pairs (P, d): lane k ends
//           with the state at the end of its chunk;
//   pass 2  each chunk again from its true start state (lane k - 1's end
//           state), the sequential recurrence itself, summing -1/2 |Z|^2
//           in the lane; lane nch - 1's end state starts the next segment.
// The 32 lane sums are added in a fixed tree (shfl_down 16, 8, 4, 2, 1).
// kernels/bank_scan.py::bank_loglik_scan_plain repeats every step of it.
// With two members a warp (large banks) a step's scalar loads and the
// composites serve both.
//
// Memory.  A block of W warps stages each segment into shared memory
// with cp.async, two stages deep, so the loads of the next segment are in
// flight while this one runs: the segment's scalars once for the block
// (and a shared [T, nu] input once), each member's y and u rows by its
// own warp, all read from device memory once.  A segment is laid out
// step after step, so each of these is one contiguous run, copied in
// 16-byte pieces through L2 (cp.async.cg): 4- and 8-byte copies through
// L1 held the issuing warp ~100-160 cycles each on the card.  A member's
// run starts wherever b T ny falls, so it is copied from the 16-byte
// boundary below it and read from its head (0-3 floats in; the same in
// every segment, since a segment is 32 L steps): every run takes the
// 16-byte path at any T.  Each step block is padded with zeros to a width
// K (2 or 4) for x and y and KU (0, 1, 2, 4) for u, so that every loop
// and offset is a compile-time constant (a pad adds 0 * 0 or x * 0,
// which leaves every real sum as it was; padded shapes are copied float
// by float), and a lane reads a step's scalars, y and u as vectors
// (LDS.128, LDS.64; the wrapper hands in rows that start on 16 bytes, so
// a head is a multiple of the width where the width is 2 or 4).  L is odd
// and a step's scalars take an odd number of 16-byte vectors, so the
// lanes of a phase, each at its own step, read different banks.
//
// Bound on the card: bytes, 4 (ny + nu) bytes a member-step (2000 steps
// of 8192 members, 197 MB, take 0.059 ms at 3.35 TB/s).  What binds it
// here (block 0's clock64 split, stats=): issuing the copies, the two
// passes' shared-memory loads and chains, and the scan's shuffles.
//
// TPU workarounds not ported: the [8, L] sublane/lane member packing
// (_pack_channels), the _CHUNK_BYTES bank chunking and _TSEG time
// segments with their _MAX_CALLS cap, the _UNROLL / _FULL_UNROLL loop
// split, the [S, T] SMEM row-padding layout, and the VMEM limit pin.
#include <cuda_runtime.h>
#include <stdint.h>

#include "coop.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kMax = 4;            // nx, ny, nu <= 4
constexpr int kMaxWarps = 16;
constexpr unsigned kFull = 0xffffffffu;
// floats a staged row holds beyond its steps: a head of up to 3 and the
// rest of its last 16-byte piece
constexpr int kSlack = 8;
// flag of a launch: the scalars need no padding and are 16-byte aligned
constexpr int kPackedScalars = 1;
// clock64 slots of block 0's first warp (kernels/bank_scan.py::CLOCKS)
constexpr int kStage = 0, kWait = 1, kPass1 = 2, kScan = 3, kPass2 = 4,
              kClocks = 6;

// clock64 laps into the stats' slots; the instance without stats carries
// no timing code
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

// Offsets of the padded step block: M, AK, Linv, W2 K x K; BmAKD, LD K x KU.
template <int K, int KU>
struct Step {
  static constexpr int M = 0, AK = K * K, Li = 2 * K * K, W2 = 3 * K * K,
                       BD = 4 * K * K, LD = 4 * K * K + K * KU,
                       size = 4 * K * K + 2 * K * KU;  // a multiple of 4
};

// Strides (floats) and the floats of one stage, as
// kernels/bank_scan.py::bank_smem_bytes computes them: a segment's steps
// one after another, a step's scalars at Ss floats (an odd number of
// 16-byte vectors), its y and u at K and KU floats, MB members' rows a
// warp, each row with kSlack floats for its head and its last piece.  L
// is odd, so the 32 lanes, each at its step k L + j, read different
// banks.  Every region starts 16-byte aligned.
template <int K, int KU>
struct Layout {
  int Ss, sc, ush, rows_y, rows_u, warp, stage;
  __host__ __device__ Layout(int L, int W, int MB, bool shared_u) {
    constexpr int SP = Step<K, KU>::size;
    Ss = (SP / 4) % 2 ? SP : SP + 4;
    const int n = kLanes * L;
    sc = n * Ss;
    rows_y = n * K + kSlack;
    rows_u = KU ? n * KU + kSlack : 0;
    ush = shared_u ? rows_u : 0;
    warp = MB * (rows_y + (shared_u ? 0 : rows_u));
    stage = sc + ush + W * warp;
  }
};

// Where scalar s of the packed [S] row goes in the padded step block.
template <int K, int KU>
__device__ int padded_offset(int s, int nx, int ny, int nu) {
  using St = Step<K, KU>;
  if (s < nx * nx) return St::M + (s / nx) * K + s % nx;
  s -= nx * nx;
  if (s < nx * ny) return St::AK + (s / ny) * K + s % ny;
  s -= nx * ny;
  if (s < ny * ny) return St::Li + (s / ny) * K + s % ny;
  s -= ny * ny;
  if (s < nx * ny) return St::W2 + (s / ny) * K + s % ny;
  s -= nx * ny;
  if (s < nx * nu) return St::BD + (s / nu) * KU + s % nu;
  s -= nx * nu;
  return St::LD + (s / nu) * KU + s % nu;
}

// N floats from shared memory in vectors of 4, 2 or 1.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else if constexpr (N == 1) {
    v[0] = p[0];
  }
}

// Where a row staged from src starts in its region: the floats from the
// 16-byte boundary below src where the row is copied as a run (w == KW),
// else 0.  The same for every segment of a member's row.
template <int KW>
__device__ __forceinline__ int row_head(const float* src, int w) {
  return w == KW ? (int)(((uintptr_t)src >> 2) & 3) : 0;
}

// One member's rows of a segment, n steps of w floats, to step t at
// row_head + t * KW: where w == KW as one run, the 16-byte pieces that
// hold it copied from the boundary below src (such a piece lies in the
// page of the float it holds, and no lane reads the floats around the
// run); else float by float into the padded places (e / w for w <= 4 and
// e < 32768 as one multiply and a shift).
template <int KW>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int n, int w, int lane) {
  if (w == KW) {
    const int head = row_head<KW>(src, w);
    const float* from = src - head;
    const int pieces = (head + n * KW + 3) >> 2;
    for (int q = lane; q < pieces; q += kLanes)
      llpf_async_copy_cg(dst + 4 * q, from + 4 * q);
    return;
  }
  const int magic = (65536 + w - 1) / w;
  for (int e = lane; e < n * w; e += kLanes) {
    const int t = (e * magic) >> 16;
    llpf_async_copy<4>(dst + t * KW + e - t * w, src + e);
  }
}

// x <- AK y + BmAKD u + M x (the drive first, each sum in index order).
template <int K, int KU>
__device__ __forceinline__ void advance(const float (&s)[Step<K, KU>::size],
                                        const float (&y)[K],
                                        const float (&u)[KU ? KU : 1],
                                        float (&x)[K]) {
  using St = Step<K, KU>;
  float xn[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float a = s[St::AK + i * K] * y[0];
#pragma unroll
    for (int c = 1; c < K; ++c) a = fmaf(s[St::AK + i * K + c], y[c], a);
#pragma unroll
    for (int c = 0; c < KU; ++c) a = fmaf(s[St::BD + i * KU + c], u[c], a);
#pragma unroll
    for (int q = 0; q < K; ++q) a = fmaf(s[St::M + i * K + q], x[q], a);
    xn[i] = a;
  }
#pragma unroll
  for (int i = 0; i < K; ++i) x[i] = xn[i];
}

template <int K, int KU, int MB, bool kStats>
__global__ void __launch_bounds__(kLanes* kMaxWarps)
    bank_loglik_kernel(const float* __restrict__ sc, int S,
                       const float* __restrict__ ys,
                       const float* __restrict__ us, int64_t us_b,
                       const float* __restrict__ x0, float* __restrict__ ll,
                       int64_t B, int T, int nx, int ny, int nu, int L,
                       int flags, long long* stats) {
  using St = Step<K, KU>;
  constexpr int SP = St::size;
  constexpr int MU = KU ? KU : 1;
  const int W = blockDim.x / kLanes;
  const bool shared_u = KU > 0 && us_b == 0;
  const Layout<K, KU> lay(L, W, MB, shared_u);
  float* smem = llpf_smem<float>();
  const int tid = threadIdx.x, lane = tid & (kLanes - 1), warp = tid >> 5;
  // the warp's members b0 .. b0 + MB - 1
  const int64_t b0 = ((int64_t)blockIdx.x * W + warp) * MB;
  bool live[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) live[m] = b0 + m < B;
  Clock<kStats> clk{blockIdx.x == 0 && warp == 0, 0, {}};
  clk.start();
  const long long t_begin = kStats ? clk.last : 0;

  // the pads stay zero: no copy ever writes them
  if (S != SP) {
    for (int i = tid; i < 2 * lay.stage; i += blockDim.x) smem[i] = 0.f;
    __syncthreads();
  }
  // this lane's scalars on the padded path: s = lane + 32 r to pad_off[r]
  int pad_off[3] = {0, 0, 0};
  if (!(flags & kPackedScalars)) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int s = lane + kLanes * r;
      if (s < S) pad_off[r] = padded_offset<K, KU>(s, nx, ny, nu);
    }
  }
  const int seg = kLanes * L;
  const int nseg = (T + seg - 1) / seg;
  // member m's rows in a stage: y at m rows_y, u after the MB y rows
  auto warp_base = [&](int buf) {
    return smem + buf * lay.stage + lay.sc + lay.ush + warp * lay.warp;
  };

  auto stage = [&](int g, int buf) {
    float* base = smem + buf * lay.stage;
    const int g0 = g * seg;
    const int n = min(seg, T - g0);
    if (flags & kPackedScalars) {  // 16-byte pieces, the block's threads
      constexpr int Q = SP / 4;
      const float* src = sc + (int64_t)g0 * SP;
      for (int e = tid; e < n * Q; e += blockDim.x) {
        const int t = e / Q;
        llpf_async_copy_cg(base + t * lay.Ss + 4 * (e - t * Q), src + 4 * e);
      }
    } else {  // a warp a step, a lane a scalar
      for (int t = warp; t < n; t += W) {
        const float* src = sc + (int64_t)(g0 + t) * S;
        float* dst = base + t * lay.Ss;
#pragma unroll
        for (int r = 0; r < 3; ++r)
          if (lane + kLanes * r < S)
            llpf_async_copy<4>(dst + pad_off[r], src + lane + kLanes * r);
      }
    }
    float* wb = warp_base(buf);
#pragma unroll
    for (int m = 0; m < MB; ++m)
      if (live[m])
        stage_rows<K>(wb + m * lay.rows_y, ys + ((b0 + m) * T + g0) * ny, n,
                      ny, lane);
    if constexpr (KU > 0) {
      if (shared_u && warp == 0)  // the shared input, once a block
        stage_rows<KU>(base + lay.sc, us + (int64_t)g0 * nu, n, nu, lane);
#pragma unroll
      for (int m = 0; m < MB; ++m)
        if (live[m] && !shared_u)
          stage_rows<KU>(wb + MB * lay.rows_y + m * lay.rows_u,
                         us + (b0 + m) * us_b + (int64_t)g0 * nu, n, nu,
                         lane);
    }
  };

  // member m's y and u rows in a stage: where its region starts, plus
  // its head (the u offset from the block's region where u is shared)
  int yo[MB], uo[MB];
  float xin[MB][K], acc[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    yo[m] = m * lay.rows_y + row_head<K>(ys + (b0 + m) * T * ny, ny);
    uo[m] = shared_u ? row_head<KU>(us, nu)
                     : MB * lay.rows_y + m * lay.rows_u +
                           row_head<KU>(us + (b0 + m) * us_b, nu);
    acc[m] = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) xin[m][i] = i < nx ? x0[i] : 0.f;
  }

  // the next segment in flight while one runs; one block barrier a
  // segment, after which the stage the last segment used is free
  if (nseg > 0) stage(0, 0);
  llpf_async_commit();
  clk.lap(kStage);
  for (int g = 0; g < nseg; ++g) {
    llpf_async_wait<0>();
    __syncthreads();
    clk.lap(kWait);
    if (g + 1 < nseg) stage(g + 1, (g + 1) & 1);
    llpf_async_commit();
    clk.lap(kStage);
    if (!live[0]) continue;
    const int buf = g & 1;
    const int n = min(seg, T - g * seg);
    const int nch = (n + L - 1) / L;
    const int cnt = max(0, min(L, n - lane * L));
    const float* s_l = smem + buf * lay.stage + lane * L * lay.Ss;
    const float* y_l = warp_base(buf) + lane * L * K;
    const float* u_l = (shared_u ? smem + buf * lay.stage + lay.sc
                                 : warp_base(buf)) +
                       lane * L * KU;
    float sv[SP], y[K], u[MU];
    // pass 1: each chunk from zero (lane 0 from the start state), and its
    // composite P = M_end ... M_start, once for the warp's members
    float d[MB][K], P[K][K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int m = 0; m < MB; ++m) d[m][i] = lane == 0 ? xin[m][i] : 0.f;
#pragma unroll
      for (int c = 0; c < K; ++c) P[i][c] = i == c ? 1.f : 0.f;
    }
#pragma unroll 2
    for (int j = 0; j < cnt; ++j) {
      load_vec<SP>(s_l + j * lay.Ss, sv);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        load_vec<K>(y_l + yo[m] + j * K, y);
        load_vec<KU>(u_l + uo[m] + j * KU, u);
        advance<K, KU>(sv, y, u, d[m]);
      }
      float Pn[K][K];
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int c = 0; c < K; ++c) {
          float a = sv[St::M + i * K] * P[0][c];
#pragma unroll
          for (int q = 1; q < K; ++q)
            a = fmaf(sv[St::M + i * K + q], P[q][c], a);
          Pn[i][c] = a;
        }
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int c = 0; c < K; ++c) P[i][c] = Pn[i][c];
    }
    clk.lap(kPass1);
    // Kogge-Stone over the chunk ends: after the level of offset o, lane
    // k holds the end state of its chunk from chunks k - 2 o + 1 .. k
    for (int o = 1; o < nch; o <<= 1) {
      const bool more = 2 * o < nch;  // P is needed at the next level
      float pd[MB][K], pP[K][K];
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int q = 0; q < K; ++q)
          pd[m][q] = __shfl_up_sync(kFull, d[m][q], o);
      if (more) {
#pragma unroll
        for (int q = 0; q < K; ++q)
#pragma unroll
          for (int c = 0; c < K; ++c)
            pP[q][c] = __shfl_up_sync(kFull, P[q][c], o);
      }
      if (lane >= o) {
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          float dn[K];
#pragma unroll
          for (int i = 0; i < K; ++i) {
            float a = P[i][0] * pd[m][0];
#pragma unroll
            for (int q = 1; q < K; ++q) a = fmaf(P[i][q], pd[m][q], a);
            dn[i] = a + d[m][i];
          }
#pragma unroll
          for (int i = 0; i < K; ++i) d[m][i] = dn[i];
        }
        if (more) {
          float Pn[K][K];
#pragma unroll
          for (int i = 0; i < K; ++i)
#pragma unroll
            for (int c = 0; c < K; ++c) {
              float a = P[i][0] * pP[0][c];
#pragma unroll
              for (int q = 1; q < K; ++q) a = fmaf(P[i][q], pP[q][c], a);
              Pn[i][c] = a;
            }
#pragma unroll
          for (int i = 0; i < K; ++i)
#pragma unroll
            for (int c = 0; c < K; ++c) P[i][c] = Pn[i][c];
        }
      }
    }
    // pass 2: each chunk from its true start state (lane k - 1's end)
    clk.lap(kScan);
    float x[MB][K];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float v = __shfl_up_sync(kFull, d[m][i], 1);
        x[m][i] = lane == 0 ? xin[m][i] : v;
        xin[m][i] = __shfl_sync(kFull, d[m][i], nch - 1);
      }
#pragma unroll 2
    for (int j = 0; j < cnt; ++j) {
      load_vec<SP>(s_l + j * lay.Ss, sv);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        load_vec<K>(y_l + yo[m] + j * K, y);
        load_vec<KU>(u_l + uo[m] + j * KU, u);
        float dll = 0.f;
#pragma unroll
        for (int z = 0; z < K; ++z) {
          float a = sv[St::Li + z * K] * y[0];
#pragma unroll
          for (int c = 1; c < K; ++c) a = fmaf(sv[St::Li + z * K + c], y[c], a);
#pragma unroll
          for (int c = 0; c < KU; ++c)
            a = fmaf(-sv[St::LD + z * KU + c], u[c], a);
#pragma unroll
          for (int i = 0; i < K; ++i)
            a = fmaf(-sv[St::W2 + i * K + z], x[m][i], a);
          dll = fmaf(-0.5f * a, a, dll);
        }
        acc[m] += dll;
        advance<K, KU>(sv, y, u, x[m]);
      }
    }
    clk.lap(kPass2);
  }
  llpf_async_wait<0>();
  if (kStats && clk.on && lane == 0) {
#pragma unroll
    for (int k = 0; k < kPass2 + 1; ++k) stats[k] = clk.acc[k];
    stats[kClocks - 1] = clock64() - t_begin;
  }
  // the lanes' sums in a fixed tree
#pragma unroll
  for (int m = 0; m < MB; ++m) {
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
      acc[m] += __shfl_down_sync(kFull, acc[m], o);
    if (live[m] && lane == 0) ll[b0 + m] = acc[m];
  }
}

// One call's arguments, as llpf_bank_loglik takes them.
struct Call {
  const float *sc, *ys, *us, *x0;
  float* ll;
  int64_t us_b, B;
  int S, T, nx, ny, nu, L, W, members;
  long long* stats;
  cudaStream_t stream;
};

template <int K, int KU, int MB, bool kStats>
cudaError_t launch(const Call& c) {
  const Layout<K, KU> lay(c.L, c.W, MB, KU > 0 && c.us_b == 0);
  const size_t smem = (size_t)2 * lay.stage * sizeof(float);
  auto kernel = bank_loglik_kernel<K, KU, MB, kStats>;
  // the largest size this instance has been opted in to, per device
  static size_t opted[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= 64 || smem > opted[dev])) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) opted[dev] = smem;
  }
  const auto aligned = [](const void* p, int bytes) {
    return (uintptr_t)p % bytes == 0;
  };
  const int flags =
      c.S == Step<K, KU>::size && aligned(c.sc, 16) ? kPackedScalars : 0;
  const int64_t per_block = (int64_t)c.W * MB;
  const unsigned blocks = (unsigned)((c.B + per_block - 1) / per_block);
  kernel<<<blocks, kLanes * c.W, smem, c.stream>>>(
      c.sc, c.S, c.ys, c.us, c.us_b, c.x0, c.ll, c.B, c.T, c.nx, c.ny, c.nu,
      c.L, flags, c.stats);
  return cudaGetLastError();
}

template <int K, int MB>
cudaError_t launch_k(const Call& c) {
  switch (c.nu <= 2 ? c.nu : 4) {
    case 0: return launch<K, 0, MB, false>(c);
    case 1: return launch<K, 1, MB, false>(c);
    case 2: return launch<K, 2, MB, false>(c);
    default: return launch<K, 4, MB, false>(c);
  }
}

}  // namespace

extern "C" {

// sc [T, S], ys [B, T, ny], us [B, T, nu] with member stride us_b (0 for a
// shared [T, nu] input), x0 [nx]; writes ll [B] without the constant.  L
// (odd, 1..63) steps a lane a segment, W (1..16) warps a block,
// `members` (1, or 2 where nx, ny <= 2) members a warp:
// kernels/bank_scan.py::bank_launch.  With
// `stats` (int64 [6]; nx, ny <= 2, nu = 1 and one member a warp only)
// block 0's first warp's clock64 cycles by kernels/bank_scan.py::CLOCKS.
int llpf_bank_loglik(const float* sc, int S, const float* ys, const float* us,
                     int64_t us_b, const float* x0, float* ll, int64_t B,
                     int T, int nx, int ny, int nu, int L, int W,
                     int members, long long* stats, void* stream) {
  const bool narrow = nx <= 2 && ny <= 2;
  if (nx < 1 || nx > kMax || ny < 1 || ny > kMax || nu < 0 || nu > kMax ||
      T < 0 || S != nx * nx + 2 * nx * ny + ny * ny + nx * nu + ny * nu ||
      W < 1 || W > kMaxWarps || L < 1 || L > 63 || L % 2 == 0 ||
      members < 1 || members > (narrow ? 2 : 1))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const Call c{sc, ys, us, x0, ll, us_b, B, S, T, nx, ny, nu, L, W, members,
               stats, (cudaStream_t)stream};
  if (stats)
    return (int)(narrow && nu == 1 && members == 1
                     ? launch<2, 1, 1, true>(c)
                     : cudaErrorInvalidValue);
  if (!narrow) return (int)launch_k<4, 1>(c);
  return (int)(members == 2 ? launch_k<2, 2>(c) : launch_k<2, 1>(c));
}

}  // extern "C"
