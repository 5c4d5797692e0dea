// Kernel K's C entries (the kernel: csrc/assoc_scan.cuh).
//
// Replaces lowlevelparticlefilters_jl_tpu/ops/pallas/assoc_scan.py
// (_plane_scan, assoc_scan.py:167; entries filter_scan_p :243,
// smooth_scan_p :288 and filter_scan_full :314).  The instances for
// nx = 1 and 2 compile here, each larger nx in its own
// csrc/assoc_scan_nx<n>.cu, so that the build runs them in parallel.
#include <stdint.h>

#include "assoc_scan.cuh"

namespace llpf_k {

// The instances of csrc/assoc_scan_nx<n>.cu.
#define LLPF_K_RUN_NX(N)                                                  \
  extern template cudaError_t run_nx<N>(const float*, float*, float*,     \
                                        int64_t, int64_t, int, cudaStream_t);
LLPF_K_RUN_NX(3)
LLPF_K_RUN_NX(4)
LLPF_K_RUN_NX(5)
LLPF_K_RUN_NX(6)
LLPF_K_RUN_NX(7)
LLPF_K_RUN_NX(8)
#undef LLPF_K_RUN_NX

int dispatch(const float* x, float* out, float* agg, int64_t cap, int64_t T,
             int nx, int kind, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  if (((uintptr_t)x & 15) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nx) {
    case 1: return (int)run_nx<1>(x, out, agg, cap, T, kind, s);
    case 2: return (int)run_nx<2>(x, out, agg, cap, T, kind, s);
    case 3: return (int)run_nx<3>(x, out, agg, cap, T, kind, s);
    case 4: return (int)run_nx<4>(x, out, agg, cap, T, kind, s);
    case 5: return (int)run_nx<5>(x, out, agg, cap, T, kind, s);
    case 6: return (int)run_nx<6>(x, out, agg, cap, T, kind, s);
    case 7: return (int)run_nx<7>(x, out, agg, cap, T, kind, s);
    case 8: return (int)run_nx<8>(x, out, agg, cap, T, kind, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace llpf_k

extern "C" {

// x [T, E] elements (16-byte aligned), out [T, nx + nx^2]; kind 0 =
// filter, 1 = smooth; agg scratch of cap floats (E a block).
int llpf_assoc_scan(const float* x, float* out, float* agg, int64_t cap,
                    int64_t T, int nx, int kind, void* stream) {
  if (kind != 0 && kind != 1) return (int)cudaErrorInvalidValue;
  return llpf_k::dispatch(x, out, agg, cap, T, nx, kind, stream);
}

// x [T, E] filter elements, out [T, E] (not x: x is only read) their
// inclusive prefixes, whole.
int llpf_assoc_scan_full(const float* x, float* out, float* agg, int64_t cap,
                         int64_t T, int nx, void* stream) {
  if (out == x) return (int)cudaErrorInvalidValue;
  return llpf_k::dispatch(x, out, agg, cap, T, nx, 2, stream);
}

}  // extern "C"
