// Philox4x32-10 counter-based generator and Box-Muller normals, shared by
// the noise kernels (noise.cu), the fused particle-filter scan
// (pf_scan.cu) and the FFBS backward pass (ffbs.cu, Gumbel noise).
//
// Replaces the TPU hardware PRNG (`pltpu.prng_seed`/`prng_random_bits`)
// that the Pallas kernels in ops/pallas/noise.py and ops/pallas/pf_scan.py
// draw from.  A draw is a pure function of (key, counter): the key is the
// 64-bit seed, the counter is (row, step, block, tag).  Each call yields
// four 32-bit words, which Box-Muller turns into four normals: row `i`
// (particle or flat group), step `t`, and `block = dim / 4` pick the call,
// `dim % 4` picks the lane.  The plain PyTorch twin in kernels/noise.py
// computes the same words in int64 tensor arithmetic, so a kernel and its
// plain version draw the same numbers.
//
// Bound on the card: ten rounds of two 32x32->64 multiplies per four
// words, i.e. ALU work; at particle-filter sizes it is far below the
// memory traffic of the kernels that call it.
#pragma once
#include <stdint.h>

#define LLPF_TAG_NORMAL 1u
#define LLPF_TAG_PROPAGATE 2u
#define LLPF_TAG_INIT 3u
#define LLPF_TAG_RESAMPLE 4u
#define LLPF_TAG_FFBS 5u

__device__ __forceinline__ uint4 llpf_philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// 24-bit uniforms: (b >> 8) * 2^-24 is exact in f32, so the plain twin
// reproduces it bit for bit.
__device__ __forceinline__ float llpf_uniform_co(uint32_t b) {  // [0, 1)
  return (float)(b >> 8) * 5.9604644775390625e-08f;
}

__device__ __forceinline__ float llpf_uniform_oc(uint32_t b) {  // (0, 1]
  return (float)((b >> 8) + 1u) * 5.9604644775390625e-08f;
}

// Box-Muller on the pairs (x, y) and (z, w): four standard normals.
__device__ __forceinline__ void llpf_box_muller4(uint4 b, float out[4]) {
  const float r0 = sqrtf(-2.0f * logf(llpf_uniform_oc(b.x)));
  const float r1 = sqrtf(-2.0f * logf(llpf_uniform_oc(b.z)));
  float s0, c0, s1, c1;
  sincosf(6.283185307179586f * llpf_uniform_co(b.y), &s0, &c0);
  sincosf(6.283185307179586f * llpf_uniform_co(b.w), &s1, &c1);
  out[0] = r0 * c0;
  out[1] = r0 * s0;
  out[2] = r1 * c1;
  out[3] = r1 * s1;
}

// the first pair alone: out[0], out[1] of llpf_box_muller4, the same bits
__device__ __forceinline__ void llpf_box_muller2(uint4 b, float out[2]) {
  const float r0 = sqrtf(-2.0f * logf(llpf_uniform_oc(b.x)));
  float s0, c0;
  sincosf(6.283185307179586f * llpf_uniform_co(b.y), &s0, &c0);
  out[0] = r0 * c0;
  out[1] = r0 * s0;
}

__device__ __forceinline__ uint2 llpf_key(uint64_t seed) {
  return make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
}

// Normal number `dim` of row `row` at step `step` for stream `tag`.
__device__ __forceinline__ void llpf_normals4(uint64_t seed, uint32_t tag,
                                              uint32_t step, uint32_t row,
                                              uint32_t block, float out[4]) {
  llpf_box_muller4(
      llpf_philox4x32_10(make_uint4(row, step, block, tag), llpf_key(seed)),
      out);
}
