// Scalar helpers of the generated callback code (kernels/callback_codegen.py).
//
// The code generator prints a user callback as a straight-line function
// over floats; kernel I's callbacks also compute their Jacobian in x,
// differentiated at code generation (callback_codegen.Program.jacobian).
// Every m_* function below is the C++ of one instruction, whose Python
// evaluation is callback_codegen._EVAL, so the CPU tests hold the
// semantics that run here.  A sine and a cosine of one operand come from
// one sincosf (m_sincos).
#pragma once
#include <math.h>

__device__ __forceinline__ float m_sigmoid(float a) {
  return 1.f / (1.f + expf(-a));
}
__device__ __forceinline__ float m_sign(float a) {
  return (float)((a > 0.f) - (a < 0.f));
}
__device__ __forceinline__ float m_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ float m_exp(float a) { return expf(a); }
__device__ __forceinline__ float m_log(float a) { return logf(a); }
__device__ __forceinline__ float m_expm1(float a) { return expm1f(a); }
__device__ __forceinline__ float m_log1p(float a) { return log1pf(a); }
__device__ __forceinline__ float m_sin(float a) { return sinf(a); }
__device__ __forceinline__ float m_cos(float a) { return cosf(a); }
__device__ __forceinline__ void m_sincos(float a, float* s, float* c) {
  sincosf(a, s, c);
}
__device__ __forceinline__ float m_tanh(float a) { return tanhf(a); }
__device__ __forceinline__ float m_abs(float a) { return fabsf(a); }
__device__ __forceinline__ float m_floor(float a) { return floorf(a); }
__device__ __forceinline__ float m_ceil(float a) { return ceilf(a); }
__device__ __forceinline__ float m_round(float a) { return rintf(a); }
__device__ __forceinline__ float m_trunc(float a) { return truncf(a); }

__device__ __forceinline__ float m_powc(float a, float b) {
  return powf(a, b);
}
__device__ __forceinline__ float m_powt(float a, float b) {
  return powf(a, b);
}
__device__ __forceinline__ float m_atan2(float a, float b) {
  return atan2f(a, b);
}
__device__ __forceinline__ float m_rem(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.f && ((b < 0.f) != (m < 0.f))) m += b;
  return m;
}
__device__ __forceinline__ float m_fmod(float a, float b) {
  return fmodf(a, b);
}
