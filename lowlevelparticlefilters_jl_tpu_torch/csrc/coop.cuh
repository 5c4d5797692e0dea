// Pieces of the cooperative kernels E (csrc/resample_v2.cu) and K
// (csrc/assoc_scan.cu): typed dynamic shared memory, asynchronous copies
// into it, and the size of a grid whose blocks are all resident on the
// card at once, as a launch by cudaLaunchCooperativeKernel (and so
// grid.sync) requires.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

// The block's dynamic shared memory as an array of T.
template <typename T>
__device__ __forceinline__ T* llpf_smem() {
  extern __shared__ __align__(16) unsigned char llpf_smem_bytes[];
  return reinterpret_cast<T*>(llpf_smem_bytes);
}

// Asynchronous copies from device to shared memory (cp.async, Ampere and
// later): `bytes` (4, 8 or 16, both addresses aligned to it) from src to
// dst; a commit closes a group, a wait leaves at most N groups in flight.
template <int bytes>
__device__ __forceinline__ void llpf_async_copy(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(bytes));
}
// 16 bytes from device to shared memory through L2 only (cp.async.cg), so
// the copy takes no L1 line while it is in flight.
__device__ __forceinline__ void llpf_async_copy_cg(void* dst,
                                                   const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void llpf_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void llpf_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// *grid = min(want, the blocks of `threads` threads and `smem` bytes of
// dynamic shared memory that the card holds at once), at least 1.  Opts
// the kernel in to more than 48 KB of dynamic shared memory where asked.
// The count is computed once per kernel, block shape and device, then
// looked up: the occupancy query costs microseconds of host time a call.
inline cudaError_t llpf_coop_grid(const void* kernel, int threads,
                                  size_t smem, long long want, int* grid) {
  struct Entry {
    const void* kernel;
    int threads, dev, blocks;
    size_t smem;
  };
  static Entry seen[64];
  static int n_seen = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  long long g = -1;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n_seen; ++i)
      if (seen[i].kernel == kernel && seen[i].threads == threads &&
          seen[i].smem == smem && seen[i].dev == dev)
        g = seen[i].blocks;
  }
  if (g < 0) {
    int sms = 0, coop = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    if (!coop) return cudaErrorNotSupported;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return e;
    }
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    g = (long long)per_sm * sms;
    std::lock_guard<std::mutex> lock(mu);
    if (n_seen < 64) seen[n_seen++] = Entry{kernel, threads, dev, (int)g, smem};
  }
  if (want < g) g = want;
  *grid = g < 1 ? 1 : (int)g;
  return cudaSuccess;
}
