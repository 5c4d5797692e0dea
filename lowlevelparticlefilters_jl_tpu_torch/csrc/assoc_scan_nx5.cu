// Kernel K's instances at nx = 5 (csrc/assoc_scan.cuh), compiled apart
// from csrc/assoc_scan.cu so that the build runs the instances in
// parallel.
#include "assoc_scan.cuh"

namespace llpf_k {
template cudaError_t run_nx<5>(const float*, float*, float*, int64_t,
                                int64_t, int, cudaStream_t);
}  // namespace llpf_k
