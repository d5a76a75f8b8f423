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
