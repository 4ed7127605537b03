// Shared scalar helpers for the port's CUDA kernels.
//
// Every kernel is templated on its scalar type (float or double). The
// per-thread bodies are marked NPTT_HD, so that they also compile as host
// C++ and the arithmetic can be exercised without a card.
#pragma once

#include <cmath>
#include <type_traits>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define NPTT_HD __host__ __device__ __forceinline__
#else
#define NPTT_HD inline
#endif

namespace nptt {

NPTT_HD float nsin(float x) { return sinf(x); }
NPTT_HD double nsin(double x) { return sin(x); }
NPTT_HD float ncos(float x) { return cosf(x); }
NPTT_HD double ncos(double x) { return cos(x); }
NPTT_HD float nsqrt(float x) { return sqrtf(x); }
NPTT_HD double nsqrt(double x) { return sqrt(x); }

template <typename T>
NPTT_HD bool nisfinite(T x) {
#ifdef __CUDA_ARCH__
  return isfinite(x);
#else
  return std::isfinite(x);
#endif
}

template <typename T>
NPTT_HD bool nisnan(T x) {
#ifdef __CUDA_ARCH__
  return isnan(x);
#else
  return std::isnan(x);
#endif
}

// The unroll count of a loop of `trips` iterations: all of them where
// `full`, else none (1). Each #pragma names its own loop's trip count, at
// least 2 (a count of 1 disables unrolling, and would keep a one-trip
// loop, such as one over the cartpole's single action, as a loop): a count
// of 64 everywhere left the cartpole's K6 3.1x slower than a plain #pragma
// unroll (scripts/torch_unroll_variants.py, PERF.md section 6).
NPTT_HD constexpr int unroll_by(bool full, int trips) { return full ? (trips > 2 ? trips : 2) : 1; }

// a / b. Where a is zero and b finite and nonzero the quotient is the
// signed zero a * b, so no division runs: on the card an IEEE division
// whose dividend is zero leaves its fast path for a call, and the frozen
// solve's PCG divides zeros in every row that does not clamp. The same
// bits either way; the host build's counting scalar (not a floating-point
// type) always divides.
template <typename S>
NPTT_HD S qdiv(S a, S b) {
  if constexpr (std::is_floating_point<S>::value) {
    if (a == S(0) && b != S(0) && nisfinite(b)) return a * b;
  }
  return a / b;
}

// Forward-mode dual number: a value and one tangent. The linearize kernel
// runs the device step on it, one basis direction per thread.
template <typename T>
struct Dual {
  T v, d;
  NPTT_HD Dual() : v(T(0)), d(T(0)) {}
  NPTT_HD Dual(T v_) : v(v_), d(T(0)) {}
  NPTT_HD Dual(T v_, T d_) : v(v_), d(d_) {}
};

template <typename T> NPTT_HD Dual<T> operator+(Dual<T> a, Dual<T> b) { return Dual<T>(a.v + b.v, a.d + b.d); }
template <typename T> NPTT_HD Dual<T> operator+(Dual<T> a, T b) { return Dual<T>(a.v + b, a.d); }
template <typename T> NPTT_HD Dual<T> operator+(T a, Dual<T> b) { return Dual<T>(a + b.v, b.d); }
template <typename T> NPTT_HD Dual<T> operator-(Dual<T> a, Dual<T> b) { return Dual<T>(a.v - b.v, a.d - b.d); }
template <typename T> NPTT_HD Dual<T> operator-(Dual<T> a, T b) { return Dual<T>(a.v - b, a.d); }
template <typename T> NPTT_HD Dual<T> operator-(T a, Dual<T> b) { return Dual<T>(a - b.v, -b.d); }
template <typename T> NPTT_HD Dual<T> operator-(Dual<T> a) { return Dual<T>(-a.v, -a.d); }
template <typename T> NPTT_HD Dual<T> operator*(Dual<T> a, Dual<T> b) { return Dual<T>(a.v * b.v, a.d * b.v + a.v * b.d); }
template <typename T> NPTT_HD Dual<T> operator*(Dual<T> a, T b) { return Dual<T>(a.v * b, a.d * b); }
template <typename T> NPTT_HD Dual<T> operator*(T a, Dual<T> b) { return Dual<T>(a * b.v, a * b.d); }
template <typename T> NPTT_HD Dual<T> operator/(Dual<T> a, Dual<T> b) {
  T q = a.v / b.v;
  return Dual<T>(q, (a.d - q * b.d) / b.v);
}
template <typename T> NPTT_HD Dual<T> operator/(Dual<T> a, T b) { return Dual<T>(a.v / b, a.d / b); }
template <typename T> NPTT_HD Dual<T> operator/(T a, Dual<T> b) {
  T q = a / b.v;
  return Dual<T>(q, -q * b.d / b.v);
}

template <typename T> NPTT_HD Dual<T> nsin(Dual<T> x) { return Dual<T>(nsin(x.v), ncos(x.v) * x.d); }
template <typename T> NPTT_HD Dual<T> ncos(Dual<T> x) { return Dual<T>(ncos(x.v), -nsin(x.v) * x.d); }
template <typename T> NPTT_HD Dual<T> nsqrt(Dual<T> x) {
  T s = nsqrt(x.v);
  return Dual<T>(s, x.d / (T(2) * s));
}

template <typename T> NPTT_HD T val(T x) { return x; }
template <typename T> NPTT_HD T val(Dual<T> x) { return x.v; }
template <typename T> NPTT_HD T tangent(Dual<T> x) { return x.d; }

// Selections on a value that are not arithmetic (the kernels' operation
// counts leave them out). Each keeps NaN as jnp/torch do: fmin/fmax would
// drop it.
template <typename S> NPTT_HD S nabs(S x) { return val(x) < 0 ? S(-val(x)) : x; }
// max(a, b), NaN if either is NaN (jnp.maximum, torch.maximum)
template <typename S> NPTT_HD S pmax(S a, S b) {
  if (nisnan(val(a))) return a;
  if (nisnan(val(b))) return b;
  return val(a) >= val(b) ? a : b;
}
// clip(x, lo, hi) = min(max(x, lo), hi); NaN passes through (jnp.clip)
template <typename S, typename T> NPTT_HD S nclip(S x, T lo, T hi) {
  S t = val(x) < lo ? S(lo) : x;
  return val(t) > hi ? S(hi) : t;
}

}  // namespace nptt
