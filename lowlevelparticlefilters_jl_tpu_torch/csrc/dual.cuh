// Scalar helpers of the generated callback code (kernels/callback_codegen.py).
//
// The code generator prints a user callback as a function template over a
// scalar type S.  With S = float it computes the value; with S = Dual<N>
// (a value and N tangents) it also computes the Jacobian in N directions by
// forward-mode differentiation, the counterpart of the in-kernel jax.jacfwd
// of ops/pallas/ukf_scan.py.  Every m_* function below exists for float and
// for Dual<N>, and its derivative rule is the one callback_codegen._EVAL
// evaluates in Python, so the CPU tests hold the rules that run here.
#pragma once
#include <math.h>

template <int N>
struct Dual {
  float v;
  float d[N];
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(float a) : v(a) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = 0.f;
  }
};

__device__ __forceinline__ float m_val(float a) { return a; }
__device__ __forceinline__ bool m_val(bool a) { return a; }
template <int N>
__device__ __forceinline__ float m_val(const Dual<N>& a) { return a.v; }

// value f and derivative df of a unary function applied to a dual number
template <int N>
__device__ __forceinline__ Dual<N> m_chain(const Dual<N>& a, float f,
                                           float df) {
  Dual<N> r;
  r.v = f;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = df * a.d[i];
  return r;
}

// ---- arithmetic ---------------------------------------------------------
template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = a.v + b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(float a, const Dual<N>& b) {
  Dual<N> r = b;
  r.v = a + b.v;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a) {
  Dual<N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = a.v - b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(float a, const Dual<N>& b) {
  Dual<N> r = -b;
  r.v = a - b.v;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, float b) {
  return m_chain(a, a.v * b, b);
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(float a, const Dual<N>& b) {
  return m_chain(b, a * b.v, a);
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a,
                                             const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v / b.v;
  const float ib = 1.f / b.v, q = -a.v / (b.v * b.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * ib + q * b.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, float b) {
  return m_chain(a, a.v / b, 1.f / b);
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(float a, const Dual<N>& b) {
  return m_chain(b, a / b.v, -a / (b.v * b.v));
}

// ---- unary functions ----------------------------------------------------
#define LLPF_UNARY(NAME, F, DF)                                     \
  __device__ __forceinline__ float NAME(float a) { return F; }     \
  template <int N>                                                  \
  __device__ __forceinline__ Dual<N> NAME(const Dual<N>& x) {      \
    const float a = x.v;                                            \
    return m_chain(x, F, DF);                                       \
  }

__device__ __forceinline__ float m_sigmoid_f(float a) {
  return 1.f / (1.f + expf(-a));
}
__device__ __forceinline__ float m_sign_f(float a) {
  return (float)((a > 0.f) - (a < 0.f));
}

LLPF_UNARY(m_sqrt, sqrtf(a), 0.5f / sqrtf(a))
LLPF_UNARY(m_exp, expf(a), expf(a))
LLPF_UNARY(m_log, logf(a), 1.f / a)
LLPF_UNARY(m_expm1, expm1f(a), expf(a))
LLPF_UNARY(m_log1p, log1pf(a), 1.f / (1.f + a))
LLPF_UNARY(m_sin, sinf(a), cosf(a))
LLPF_UNARY(m_cos, cosf(a), -sinf(a))
LLPF_UNARY(m_tanh, tanhf(a), 1.f - tanhf(a) * tanhf(a))
LLPF_UNARY(m_sigmoid, m_sigmoid_f(a),
           m_sigmoid_f(a) * (1.f - m_sigmoid_f(a)))
LLPF_UNARY(m_abs, fabsf(a), m_sign_f(a))
LLPF_UNARY(m_sign, m_sign_f(a), 0.f)
LLPF_UNARY(m_floor, floorf(a), 0.f)
LLPF_UNARY(m_ceil, ceilf(a), 0.f)
LLPF_UNARY(m_round, rintf(a), 0.f)
#undef LLPF_UNARY

// ---- binary functions: value and both partials ---------------------------
__device__ __forceinline__ float m_rem_f(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.f && ((b < 0.f) != (m < 0.f))) m += b;
  return m;
}

// f(a, b) with partials da, db, for any mix of float and Dual<N>
template <int N>
__device__ __forceinline__ Dual<N> m_bin(const Dual<N>& a, const Dual<N>& b,
                                         float f, float da, float db) {
  Dual<N> r;
  r.v = f;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = da * a.d[i] + db * b.d[i];
  return r;
}

#define LLPF_BINARY(NAME, F, DA, DB)                                      \
  __device__ __forceinline__ float NAME(float a, float b) { return F; }  \
  template <int N>                                                        \
  __device__ __forceinline__ Dual<N> NAME(const Dual<N>& x,              \
                                          const Dual<N>& y) {            \
    const float a = x.v, b = y.v;                                         \
    return m_bin(x, y, F, DA, DB);                                        \
  }                                                                       \
  template <int N>                                                        \
  __device__ __forceinline__ Dual<N> NAME(const Dual<N>& x, float b) {   \
    return NAME(x, Dual<N>(b));                                           \
  }                                                                       \
  template <int N>                                                        \
  __device__ __forceinline__ Dual<N> NAME(float a, const Dual<N>& y) {   \
    return NAME(Dual<N>(a), y);                                           \
  }

LLPF_BINARY(m_powc, powf(a, b), b * powf(a, b - 1.f), 0.f)
LLPF_BINARY(m_powt, powf(a, b), b * powf(a, b - 1.f), powf(a, b) * logf(a))
LLPF_BINARY(m_atan2, atan2f(a, b), b / (a * a + b * b),
            -a / (a * a + b * b))
LLPF_BINARY(m_rem, m_rem_f(a, b), 1.f, -floorf(a / b))
LLPF_BINARY(m_fmod, fmodf(a, b), 1.f, -truncf(a / b))
#undef LLPF_BINARY

// ---- selection ------------------------------------------------------------
__device__ __forceinline__ float m_sel(bool c, float a, float b) {
  return c ? a : b;
}
__device__ __forceinline__ bool m_sel(bool c, bool a, bool b) {
  return c ? a : b;
}
template <int N>
__device__ __forceinline__ Dual<N> m_sel(bool c, const Dual<N>& a,
                                         const Dual<N>& b) {
  return c ? a : b;
}
template <int N>
__device__ __forceinline__ Dual<N> m_sel(bool c, const Dual<N>& a, float b) {
  return c ? a : Dual<N>(b);
}
template <int N>
__device__ __forceinline__ Dual<N> m_sel(bool c, float a, const Dual<N>& b) {
  return c ? Dual<N>(a) : b;
}
