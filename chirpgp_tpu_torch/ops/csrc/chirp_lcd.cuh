// Device code shared by the chirp filter and smoother kernels: the math
// wrappers of both precisions, the stable softplus, the model constants in
// the layout of ops/chirp_filter.py::_chirp_constants, and the chirp-LCD
// transition mean (rotation with decay at the frozen frequency softplus(V),
// exact Matern-3/2 step).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kD = 4;            // state dimension
constexpr int kV = 2;            // the state V whose softplus is the frequency
constexpr int kMaxPoints = 81;   // cap on S (GH-3 at d = 4)
constexpr int kMaxThreads = 256;   // threads per block
constexpr int kWords = kD + kD * kD + 1;   // output words per lane-step
constexpr int kNumConsts = 4 + 16 + 16 + 4 + 3;

template <typename Real>
struct ChirpConsts {
  Real F[2][2];       // Matern-3/2 transition
  Real LqT[kD][kD];   // transpose of the process-noise factor
  Real L0[kD][kD];    // initial factor, lower
  Real m0[kD];        // initial mean
  Real decay;         // exp(-lam dt)
  Real sqrt_xi;       // sqrt of the measurement-noise variance
  Real dt;
};

// The constants, computed in float64 on the host, cast to Real.
template <typename Real>
ChirpConsts<Real> load_consts(const double* consts) {
  ChirpConsts<Real> c;
  int p = 0;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) c.F[i][j] = static_cast<Real>(consts[p++]);
  for (int r = 0; r < kD; ++r)
    for (int i = 0; i < kD; ++i) c.LqT[r][i] = static_cast<Real>(consts[p++]);
  for (int i = 0; i < kD; ++i)
    for (int j = 0; j < kD; ++j) c.L0[i][j] = static_cast<Real>(consts[p++]);
  for (int i = 0; i < kD; ++i) c.m0[i] = static_cast<Real>(consts[p++]);
  c.decay = static_cast<Real>(consts[p++]);
  c.sqrt_xi = static_cast<Real>(consts[p++]);
  c.dt = static_cast<Real>(consts[p++]);
  return c;
}

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dlog1p(float x) { return log1pf(x); }
__device__ __forceinline__ double dlog1p(double x) { return log1p(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }
// 2 / x, correctly rounded: 2 rcp_rn(x) == rn(2 / x), doubling is exact.
__device__ __forceinline__ float two_over(float x) { return 2.0f * __frcp_rn(x); }
__device__ __forceinline__ double two_over(double x) { return 2.0 * __drcp_rn(x); }
// sin(pi x), cos(pi x): the reduction of x mod 2 is exact, so there is no
// slow path for large arguments (and no branch that splits the rows).
__device__ __forceinline__ void dsincospi(float x, float* s, float* c) {
  sincospif(x, s, c);
}
__device__ __forceinline__ void dsincospi(double x, double* s, double* c) {
  sincospi(x, s, c);
}

template <typename Real>
__device__ __forceinline__ Real softplus(Real x) {
  return (x > Real(0) ? x : Real(0)) + dlog1p(dexp(-dabs(x)));
}

// The chirp-LCD mean mu of one sigma point chi.
template <typename Real>
__device__ __forceinline__ void lcd_mean(const ChirpConsts<Real>& c,
                                         const Real (&chi)[kD],
                                         Real (&mu)[kD]) {
  // The rotation angle dt 2 pi softplus(chi_V), as pi times 2 dt softplus.
  Real sn, cs;
  dsincospi(Real(2) * c.dt * softplus(chi[kV]), &sn, &cs);
  cs *= c.decay;
  sn *= c.decay;
  mu[0] = cs * chi[0] - sn * chi[1];
  mu[1] = sn * chi[0] + cs * chi[1];
  mu[2] = c.F[0][0] * chi[2] + c.F[0][1] * chi[3];
  mu[3] = c.F[1][0] * chi[2] + c.F[1][1] * chi[3];
}

}  // namespace
