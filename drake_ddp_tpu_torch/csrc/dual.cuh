// A forward-mode dual number for the templated device step.
//
// Dual {v, d} carries a value and one tangent direction: the device
// counterpart of jax.jvp / torch.func.jvp inside multibody/lanejac.py.
// The step of lanestep.cuh is a template over its scalar type, so
// instantiating it with Dual propagates one tangent through the same
// arithmetic that megastep and megaroll run in float.  Comparisons and
// branches in the step go through val(), so a dual evaluation takes the
// same branches as the plain one and a select never blends a tangent
// (a NaN tangent in the branch not taken, as sqrt at 0, stays there).
//
// Both parts are double: the Jacobian kernel (megajac.cu) computes in
// float64 and rounds only its outputs to float32; megajac.cu says why.
//
// Kinks follow the plain PyTorch version's derivatives: |x| has tangent
// sign(x) dx, 0 at x = 0; sign has tangent 0.
//
// TangentView is the working set of megajac's tangent passes: it reads
// a Dual whose value comes from the team primal's store (lane-strided,
// shared by the lane's directions) and whose tangent comes from the
// thread's own scratch, and a write keeps only the tangent.

#pragma once

#include "lanestep.cuh"

struct __align__(16) Dual {
  double v, d;
  Dual() = default;
  __host__ __device__ constexpr Dual(double value) : v(value), d(0.) {}
  __host__ __device__ constexpr Dual(double value, double tangent)
      : v(value), d(tangent) {}
  __device__ Dual& operator+=(Dual b) { d += b.d; v += b.v; return *this; }
  __device__ Dual& operator-=(Dual b) { d -= b.d; v -= b.v; return *this; }
};

__device__ inline Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ inline Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
__device__ inline Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
__device__ inline Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
}
__device__ inline Dual operator/(Dual a, Dual b) {
  const double q = a.v / b.v;
  return Dual(q, (a.d - q * b.d) / b.v);
}
// mixed operands: float constants of the table promote to double
__device__ inline Dual operator+(Dual a, double b) { return Dual(a.v + b, a.d); }
__device__ inline Dual operator+(double a, Dual b) { return Dual(a + b.v, b.d); }
__device__ inline Dual operator-(Dual a, double b) { return Dual(a.v - b, a.d); }
__device__ inline Dual operator-(double a, Dual b) { return Dual(a - b.v, -b.d); }
__device__ inline Dual operator*(Dual a, double b) { return Dual(a.v * b, a.d * b); }
__device__ inline Dual operator*(double a, Dual b) { return Dual(a * b.v, a * b.d); }
__device__ inline Dual operator/(Dual a, double b) { return Dual(a.v / b, a.d / b); }
__device__ inline Dual operator/(double a, Dual b) {
  const double q = a / b.v;
  return Dual(q, -q * b.d / b.v);
}

__device__ inline double val(Dual x) { return x.v; }
__device__ inline Dual s_sqrt(Dual x) {
  const double r = sqrt(x.v);
  return Dual(r, x.d / (2. * r));
}
__device__ inline Dual s_exp(Dual x) {
  const double e = exp(x.v);
  return Dual(e, e * x.d);
}
__device__ inline Dual s_log1p(Dual x) {
  return Dual(log1p(x.v), x.d / (1. + x.v));
}
__device__ inline Dual s_sin(Dual x) { return Dual(sin(x.v), cos(x.v) * x.d); }
__device__ inline Dual s_cos(Dual x) { return Dual(cos(x.v), -sin(x.v) * x.d); }
__device__ inline Dual s_abs(Dual x) {
  return Dual(fabs(x.v), x.v > 0. ? x.d : (x.v < 0. ? -x.d : 0.));
}
__device__ inline Dual s_sign(Dual x) { return Dual(s_sign(x.v), 0.); }

// One field of a TangentView.  Assigning or adding a Dual stores or adds
// its tangent only: the value stays the primal's.  That is exact for
// every field that megajac's tangent pass reads as a factor, since the
// pass writes it once with the value the primal stored; fields the step
// writes more than once (M, TMP, TC) are only ever summed into, where a
// tangent needs no value.  `zero`: a field constant along this
// direction, whose tangent reads as 0 without touching the scratch.
// (Testing a null tangent pointer instead, with writes to it dropped,
// ran the tangent passes 1.4x slower on an H100: PERF.md.)
struct TangentRef {
  const double* p;
  double* t;
  bool zero;
  __device__ operator Dual() const { return Dual(*p, zero ? 0. : *t); }
  __device__ const TangentRef& operator=(Dual b) const {
    *t = b.d;
    return *this;
  }
  __device__ const TangentRef& operator=(const TangentRef& b) const {
    return *this = Dual(b);
  }
  __device__ const TangentRef& operator+=(Dual b) const {
    return *this = Dual(*this) + b;
  }
  __device__ const TangentRef& operator-=(Dual b) const {
    return *this = Dual(*this) - b;
  }
};

// Element i: value at p[i * Lp] (the primal's store); tangent at
// t[(i - base) * Lt] (this thread's scratch), zero below `base`.  The
// scratch has no room below base, so a pass must not write a field
// there: the step writes those fields only in fk, mass_matrix and
// contact_primal, which run in a q-direction alone, whose base is 0.
struct TangentView {
  using scalar = Dual;
  const double* p;
  double* t;
  int Lp, Lt, base;
  __device__ TangentRef operator[](int i) const {
    return TangentRef{p + (size_t)i * Lp, t + (ptrdiff_t)(i - base) * Lt,
                      i < base};
  }
};
