// Correctly rounded quotients by one reciprocal and two fma corrections,
// shared by K3 (ldl_masked.cu) and the f32 builds of K14 and K15
// (panel_chol.cu, panel_solve.cu, through tri_solve.cuh).
//
// x / d for one d and many x, without the division's branches (so
// quotients overlap, and a chain of them is fmas): y = RN(1/d) once, then
// q0 = x y and two corrections q + (x - d q) y, each residual exact
// (fma).  With y = RN(1/d) and q1 within an ulp of x/d, q2 = RN(x/d)
// (Markstein's theorem) while nothing underflows or overflows: |d| and
// |q0| in [LO, HI], |x| >= XLO (so x - d q is representable; x is finite
// when q0 is).  A zero x gives its signed zero q0.  Where slow() holds (d
// or x out of range, inf, NaN) the caller takes the division itself:
// operator() does.  Either way the quotient is the IEEE one, bit for bit.
// Needs nvcc --fmad=false only for the caller's own sums; fma() is fused
// whatever the flag.

#pragma once

#include <cuda_runtime.h>

namespace dense {

template <typename T>
struct DivRange;

template <>
struct DivRange<double> {
  static __device__ __forceinline__ double rcp(double d) {
    return __drcp_rn(d);
  }
  // |d|, |q| in [2^-1000, 2^1000], |x| >= 2^-960
  static constexpr double LO = 0x1p-1000, HI = 0x1p1000, XLO = 0x1p-960;
};

template <>
struct DivRange<float> {
  static __device__ __forceinline__ float rcp(float d) {
    return __frcp_rn(d);
  }
  static constexpr float LO = 0x1p-120f, HI = 0x1p120f, XLO = 0x1p-90f;
};

template <typename T>
struct Div {
  T d, y;
  bool ok;
  __device__ __forceinline__ Div() : d(T(1)), y(T(1)), ok(true) {}
  __device__ __forceinline__ explicit Div(T dv) : d(dv) {
    using B = DivRange<T>;
    y = B::rcp(d);
    ok = fabs(d) >= B::LO && fabs(d) <= B::HI;
  }
  // with y = rcp(d) formed already (by another thread)
  __device__ __forceinline__ Div(T dv, T yv) : d(dv), y(yv) {
    using B = DivRange<T>;
    ok = fabs(d) >= B::LO && fabs(d) <= B::HI;
  }
  __device__ __forceinline__ T fast(T x) const {
    const T q0 = x * y;
    const T q1 = fma(fma(-d, q0, x), y, q0);
    const T q2 = fma(fma(-d, q1, x), y, q1);
    return x == T(0) ? q0 : q2;
  }
  // every test evaluated and combined bitwise: no branch, so a flag can
  // ride along a chain of quotients
  __device__ __forceinline__ bool slow(T x) const {
    using B = DivRange<T>;
    const T aq = fabs(x * y);
    const bool in = (fabs(x) >= B::XLO) & (aq >= B::LO) & (aq <= B::HI);
    return !ok | !((x == T(0)) | in);
  }
  // fast() holds for every x with |x| in [xmin, xmax] or zero (the
  // products round monotonically; xmin: the least nonzero |x|, +inf for
  // none; a NaN or inf xmax fails)
  __device__ __forceinline__ bool fast_for(T xmin, T xmax) const {
    using B = DivRange<T>;
    const T ay = fabs(y);
    return ok && xmax * ay <= B::HI &&
           (isinf(xmin) || (xmin >= B::XLO && xmin * ay >= B::LO));
  }
  __device__ __forceinline__ T operator()(T x) const {
    return slow(x) ? x / d : fast(x);
  }
};

}  // namespace dense
