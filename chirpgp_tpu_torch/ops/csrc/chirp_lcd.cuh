// Device code shared by the chirp filter, smoother and fused
// filter+smoother kernels: the math wrappers of both precisions, the stable
// softplus, the model constants in the layout of
// ops/chirp_filter.py::_chirp_constants, the chirp-LCD transition mean
// (rotation with decay at the frozen frequency softplus(V), exact
// Matern-3/2 step), the filter step's parts that a team of P threads per
// lane computes (sigma-point rows, the team's Householder, the 1-D
// measurement update), the packed row of the smoother's maps, the
// cp.async copies of the backward recursions, the mbarriers of a hand-off
// between warps, and for the sweep objective's adjoint
// (ghfs_chirp_filter_adjoint.cu) a lane's constants from a row in global
// memory and the adjoints of the LCD mean, of the 1-D update and of the
// Cholesky factor.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kD = 4;            // state dimension
constexpr int kV = 2;            // the state V whose softplus is the frequency
constexpr int kMaxPoints = 81;   // cap on S (GH-3 at d = 4)
constexpr int kGroup = 3;        // point slots of a group of one xi[0..2]
constexpr int kMaxThreads = 256;   // threads per block
constexpr int kWords = kD + kD * kD + 1;   // output words per lane-step
constexpr int kNumConsts = 4 + 16 + 16 + 4 + 3;
// Words of the constants in their layout (ChirpConsts, load_consts):
// F32 from word 0, then Lq^T, L0, m0, the decay, sqrt(Xi), dt.
constexpr int kLqTWord = 4, kL0Word = 20, kM0Word = 36, kDecayWord = 40,
              kSqrtXiWord = 41, kDtWord = 42;
constexpr int kH = 1;            // measured state component
constexpr double kLog2Pi = 1.8378770664093454835606594728112;
constexpr double kPi = 3.1415926535897932384626433832795;
// The packed row of a smoothing step, per lane, B minor: m_p or u (kD),
// X = R11^-1 R12 or G = X^T (kD * kD, row-major), then the upper triangle
// of R22 or of D = R22^T R22 (row by row).
constexpr int kXWord = kD;
constexpr int kR22Word = kD + kD * kD;
constexpr int kRowWords = kR22Word + kD * (kD + 1) / 2;

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

// The constants of one lane from their row `consts` (the layout's
// words), cast to Real: the host's float64 copy for the one-theta
// kernels, a lane's row of the (B, kNumConsts) tensor on the card for the
// per-lane ones.
template <typename Real, typename Word>
__host__ __device__ __forceinline__ ChirpConsts<Real> load_consts(
    const Word* __restrict__ consts) {
  ChirpConsts<Real> c;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) c.F[i][j] = static_cast<Real>(consts[2 * i + j]);
#pragma unroll
  for (int r = 0; r < kD; ++r)
#pragma unroll
    for (int i = 0; i < kD; ++i)
      c.LqT[r][i] = static_cast<Real>(consts[kLqTWord + kD * r + i]);
#pragma unroll
  for (int i = 0; i < kD; ++i)
#pragma unroll
    for (int j = 0; j < kD; ++j)
      c.L0[i][j] = static_cast<Real>(consts[kL0Word + kD * i + j]);
#pragma unroll
  for (int i = 0; i < kD; ++i) c.m0[i] = static_cast<Real>(consts[kM0Word + i]);
  c.decay = static_cast<Real>(consts[kDecayWord]);
  c.sqrt_xi = static_cast<Real>(consts[kSqrtXiWord]);
  c.dt = static_cast<Real>(consts[kDtWord]);
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
__device__ __forceinline__ float dfma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dfma(double a, double b, double c) { return fma(a, b, c); }
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

// The chirp-LCD mean mu of one sigma point chi, with what its adjoint
// needs: the rotation's cos and sin (before the decay) and
// softplus(chi_V).
template <typename Real>
__device__ __forceinline__ void lcd_mean_parts(const ChirpConsts<Real>& c,
                                               const Real (&chi)[kD],
                                               Real (&mu)[kD], Real& cos_a,
                                               Real& sin_a, Real& sp) {
  // The rotation angle dt 2 pi softplus(chi_V), as pi times 2 dt softplus.
  sp = softplus(chi[kV]);
  dsincospi(Real(2) * c.dt * sp, &sin_a, &cos_a);
  const Real cs = cos_a * c.decay, sn = sin_a * c.decay;
  mu[0] = cs * chi[0] - sn * chi[1];
  mu[1] = sn * chi[0] + cs * chi[1];
  mu[2] = c.F[0][0] * chi[2] + c.F[0][1] * chi[3];
  mu[3] = c.F[1][0] * chi[2] + c.F[1][1] * chi[3];
}

// The chirp-LCD mean mu of one sigma point chi (inlined, the parts that
// only the adjoint reads are dropped).
template <typename Real>
__device__ __forceinline__ void lcd_mean(const ChirpConsts<Real>& c,
                                         const Real (&chi)[kD],
                                         Real (&mu)[kD]) {
  Real cos_a, sin_a, sp;
  lcd_mean_parts(c, chi, mu, cos_a, sin_a, sp);
}

// Word of entry (r, c), c >= r, of the upper triangle in a packed row.
__host__ __device__ constexpr int r22_word(int r, int c) {
  return kR22Word + r * kD - r * (r - 1) / 2 + (c - r);
}

// The shuffle mask of the calling thread's team of P threads (P divides
// 32; a team never straddles a warp).
template <int P>
__device__ __forceinline__ unsigned team_mask() {
  return P == 32 ? 0xffffffffu
                 : ((1u << P) - 1u) << ((threadIdx.x & 31u) & ~unsigned(P - 1));
}

// Member `member`'s rows r = member + P i of a step's sigma points: chi =
// m + L xi_r (L lower), the chirp-LCD mean into mu[i], and the partial
// weighted mean mp.  Every row slot is computed, without a branch, so that
// the rows' independent chains interleave; a slot past S computes point
// S-1 at weight 0.  xi_s is xi transposed, kD x S.
template <typename Real, int P, int kRows>
__device__ __forceinline__ void predict_rows(
    const ChirpConsts<Real>& c, const Real (&xi_s)[kD][kMaxPoints],
    const Real (&w_s)[kMaxPoints], const int S, const int member,
    const Real (&m)[kD], const Real (&L)[kD][kD], Real (&mu)[kRows][kD],
    Real (&mp)[kD]) {
#pragma unroll
  for (int k = 0; k < kD; ++k) mp[k] = Real(0);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = member + P * i;
    const int s = r < S ? r : S - 1;
    Real chi[kD];
#pragma unroll
    for (int a = 0; a < kD; ++a) {
      Real acc = Real(0);
#pragma unroll
      for (int j = 0; j <= a; ++j) acc += xi_s[j][s] * L[a][j];
      chi[a] = m[a] + acc;
    }
    lcd_mean(c, chi, mu[i]);
    const Real wgt = r < S ? w_s[s] : Real(0);
#pragma unroll
    for (int k = 0; k < kD; ++k) mp[k] += wgt * mu[i][k];
  }
}

// Member `member`'s groups g = member + P i (i < kGroups) of a step's
// sigma points in the grouped layout (ops/chirp_fused.py::fused_layout):
// point slot s = kGroup g + k holds point k of group g, and the kGroup
// points of a group share xi[0..2] (a slot of weight 0 pads a group or
// the rule).  chi[0..2] and the part of chi[3] from xi[0..2] are the
// group's, and with them the angle's softplus and sincospi and mu[0..1];
// chi[3], mu[2..3] and the weighted mean are per slot.  This is
// lcd_mean's arithmetic, in its order, so each point's mu has the bits it
// would have alone.  base = kGroup member; mu[kGroup i + k] is slot base +
// kGroup P i + k.  xi_s is xi transposed, kD x N.
template <typename Real, int P, int kGroups, int N>
__device__ __forceinline__ void predict_groups(
    const ChirpConsts<Real>& c, const Real (&xi_s)[kD][N],
    const Real (&w_s)[N], const int base, const Real (&m)[kD],
    const Real (&L)[kD][kD], Real (&mu)[kGroups * kGroup][kD],
    Real (&mp)[kD]) {
#pragma unroll
  for (int k = 0; k < kD; ++k) mp[k] = Real(0);
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int s0 = base + kGroup * P * g;
    Real chi[kD], part = Real(0);
#pragma unroll
    for (int a = 0; a < kD - 1; ++a) {
      Real acc = Real(0);
#pragma unroll
      for (int j = 0; j <= a; ++j) acc += xi_s[j][s0] * L[a][j];
      chi[a] = m[a] + acc;
      part += xi_s[a][s0] * L[kD - 1][a];
    }
    Real sn, cs;
    dsincospi(Real(2) * c.dt * softplus(chi[kV]), &sn, &cs);
    cs *= c.decay;
    sn *= c.decay;
    const Real mu0 = cs * chi[0] - sn * chi[1];
    const Real mu1 = sn * chi[0] + cs * chi[1];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int i = kGroup * g + k;
      const int s = s0 + k;
      chi[kD - 1] = m[kD - 1] + (part + xi_s[kD - 1][s] * L[kD - 1][kD - 1]);
      mu[i][0] = mu0;
      mu[i][1] = mu1;
      mu[i][2] = c.F[0][0] * chi[2] + c.F[0][1] * chi[3];
      mu[i][3] = c.F[1][0] * chi[2] + c.F[1][1] * chi[3];
      const Real wgt = w_s[s];
#pragma unroll
      for (int j = 0; j < kD; ++j) mp[j] += wgt * mu[i][j];
    }
  }
}

// Sum of x over the team: a __shfl_xor_sync butterfly over log2 P levels,
// after which every member holds the sum (IEEE addition commutes, so every
// member gets the same bits).
template <int P, int N, typename Real>
__device__ __forceinline__ void team_sum(const unsigned mask, Real (&x)[N]) {
#pragma unroll
  for (int o = P / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] += __shfl_xor_sync(mask, x[k], o, P);
  }
}

// Householder triangularization of an n x kD array spread over the team:
// member p owns rows p, p + P, ... (pre[i], i < kRows); row j < kD is owned
// by member j (i = 0).  Column j needs the partial Gram row G_jk = sum_{r
// >= j} M_rj M_rk (k >= j): one team reduction of kD - j values.  With
// alpha = -sign(M_jj) |x| (tria_cf's sign rule; M_jj broadcast from its
// owner), |v|^2 = 2 (G_jj - alpha M_jj), with no cancellation since -alpha
// M_jj >= 0, and w_k = G_jk - alpha M_jk; each member then reflects the
// columns k > j of its own rows (column j is not read again).  Reflections
// with |v|^2 <= 1e-30 are skipped, as in tria_cf.  Row j of R is computed
// by every member from the broadcast row j and the reduced w, the owner's
// own arithmetic: R (upper) ends on every member.
template <typename Real, int P, int kRows>
__device__ __forceinline__ void team_tria(const unsigned mask, const int member,
                                          Real (&pre)[kRows][kD],
                                          Real (&R)[kD][kD]) {
#pragma unroll
  for (int j = 0; j < kD; ++j) {
    Real g[kD], Mj[kD];
#pragma unroll
    for (int k = j; k < kD; ++k) g[k] = Real(0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const Real x = (i > 0 || member >= j) ? pre[i][j] : Real(0);
#pragma unroll
      for (int k = j; k < kD; ++k) g[k] += x * pre[i][k];
    }
#pragma unroll
    for (int k = j; k < kD; ++k) Mj[k] = __shfl_sync(mask, pre[0][k], j, P);
#pragma unroll
    for (int o = P / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int k = j; k < kD; ++k) g[k] += __shfl_xor_sync(mask, g[k], o, P);
    }
    const Real norm = dsqrt(g[j]);
    const Real alpha = Mj[j] >= Real(0) ? -norm : norm;
    const Real vn2 = Real(2) * (g[j] - alpha * Mj[j]);
    const Real beta = vn2 > Real(1e-30) ? two_over(vn2) : Real(0);
    const Real vj = Mj[j] - alpha;
    Real wk[kD];
#pragma unroll
    for (int k = j; k < kD; ++k) {
      wk[k] = g[k] - alpha * Mj[k];
      R[j][k] = Mj[k] - beta * vj * wk[k];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const Real v = (i > 0 || member > j) ? pre[i][j] : Real(0);
#pragma unroll
      for (int k = j + 1; k < kD; ++k) pre[i][k] -= beta * v * wk[k];
    }
  }
}

// One Householder reflection of column J of the N x N array M, over rows
// J..Last: the rows below Last hold exact zeros in column J, so the dense
// reflection would leave them as they are.  Columns J..N-1 are updated.
// Over one row (J == Last) the reflection is x -> alpha = -x: the row is
// negated, exactly, where the dense arithmetic would round -x by an ulp
// or two; it is skipped where |v|^2 = (2x)^2 <= 1e-30, as there.
template <int J, int Last, int N, typename Real>
__device__ __forceinline__ void reflect(Real (&M)[N][N]) {
  if constexpr (J == Last) {
    const Real v = M[J][J] + M[J][J];
    if (v * v > Real(1e-30)) {
#pragma unroll
      for (int k = J; k < N; ++k) M[J][k] = -M[J][k];
    }
    return;
  }
  Real nrm2 = Real(0);
#pragma unroll
  for (int r = J; r <= Last; ++r) nrm2 += M[r][J] * M[r][J];
  const Real norm = dsqrt(nrm2);
  const Real alpha = M[J][J] >= Real(0) ? -norm : norm;
  Real v[N];
  Real vn2 = Real(0);
#pragma unroll
  for (int r = J; r <= Last; ++r) {
    v[r] = r == J ? M[r][J] - alpha : M[r][J];
    vn2 += v[r] * v[r];
  }
  const Real beta = vn2 > Real(1e-30) ? two_over(vn2) : Real(0);
#pragma unroll
  for (int k = J; k < N; ++k) {
    Real wk = Real(0);
#pragma unroll
    for (int r = J; r <= Last; ++r) wk += v[r] * M[r][k];
#pragma unroll
    for (int r = J; r <= Last; ++r) M[r][k] -= beta * v[r] * wk;
  }
}

// The 1-D measurement update of y on state kH, from the predicted mean mp
// and upper factor Up: the (kD+1) x (kD+1) array [[sqrt(Xi), 0], [Up[:,
// kH], Up]] triangularized in registers (its structural zeros skipped:
// they add exact zeros, so the result is that of the dense reflections),
// then the innovation, the filtered m and lower L, and the cumulative nll.
template <typename Real>
__device__ __forceinline__ void measurement_update(
    const ChirpConsts<Real>& c, const Real (&Up)[kD][kD], const Real (&mp)[kD],
    const Real y, Real (&m)[kD], Real (&L)[kD][kD], Real& nll) {
  Real U[kD + 1][kD + 1];
  U[0][0] = c.sqrt_xi;
#pragma unroll
  for (int k = 0; k < kD; ++k) U[0][1 + k] = Real(0);
#pragma unroll
  for (int r = 0; r < kD; ++r) {
    U[1 + r][0] = r <= kH ? Up[r][kH] : Real(0);
#pragma unroll
    for (int k = 0; k < kD; ++k) U[1 + r][1 + k] = r <= k ? Up[r][k] : Real(0);
  }
  // Column 0 is nonzero in rows 0..2 only, column 1 (after the first
  // reflection) in rows 1..2, and columns 2..4 on the diagonal only.
  reflect<0, 2>(U);
  reflect<1, 2>(U);
  reflect<2, 2>(U);
  reflect<3, 3>(U);
  reflect<4, 4>(U);

  const Real sS = U[0][0];
  const Real innov = y - mp[kH];
  const Real ratio = innov / sS;
#pragma unroll
  for (int k = 0; k < kD; ++k) m[k] = mp[k] + U[0][1 + k] * ratio;
  // Lf = Uf^T: Lf[i][j] = U[1+j][1+i] for j <= i.
#pragma unroll
  for (int i = 0; i < kD; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) L[i][j] = U[1 + j][1 + i];
  }
  nll += Real(0.5) * (Real(kLog2Pi) + dlog(sS * sS) + innov * innov / (sS * sS));
}

// Entry (i, j) of a symmetric matrix of which only the lower triangle is
// computed (i, j constant after unrolling: the upper entries never live).
template <typename Real>
__device__ __forceinline__ Real& sym_at(Real (&P)[kD][kD], int i, int j) {
  return i >= j ? P[i][j] : P[j][i];
}

template <typename Real>
__device__ __forceinline__ Real sigmoid(Real x) {
  const Real e = dexp(-dabs(x));
  return (x >= Real(0) ? Real(1) : e) / (Real(1) + e);
}

// The adjoint of lcd_mean at one point: chi_bar from mu_bar, and the
// constants' adjoints added to gF, g_decay and g_dt.  With u = 2 dt
// softplus(chi_V) the angle is pi u, so u_bar = pi (sn_bar cs - cs_bar
// sn), chi_V gets u_bar 2 dt sigmoid(chi_V) and dt gets u_bar 2
// softplus(chi_V).  cos_a, sin_a, sp (lcd_mean_parts) and sig =
// sigmoid(chi_V) are the point's, none of them from the carry.
template <typename Real>
__device__ __forceinline__ void lcd_mean_adjoint(
    const ChirpConsts<Real>& c, const Real (&chi)[kD], const Real cos_a,
    const Real sin_a, const Real sp, const Real sig, const Real (&mu_bar)[kD],
    Real (&chi_bar)[kD], Real (&gF)[2][2], Real& g_decay, Real& g_dt) {
  const Real cs = cos_a * c.decay, sn = sin_a * c.decay;
  const Real cs_bar = mu_bar[0] * chi[0] + mu_bar[1] * chi[1];
  const Real sn_bar = mu_bar[1] * chi[0] - mu_bar[0] * chi[1];
  const Real u_bar = Real(kPi) * (sn_bar * cs - cs_bar * sn);
  g_decay += cs_bar * cos_a + sn_bar * sin_a;
  g_dt += u_bar * Real(2) * sp;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) gF[i][j] += mu_bar[2 + i] * chi[2 + j];
  chi_bar[0] = cs * mu_bar[0] + sn * mu_bar[1];
  chi_bar[1] = cs * mu_bar[1] - sn * mu_bar[0];
  chi_bar[2] = c.F[0][0] * mu_bar[2] + c.F[1][0] * mu_bar[3] +
               u_bar * Real(2) * c.dt * sig;
  chi_bar[3] = c.F[0][1] * mu_bar[2] + c.F[1][1] * mu_bar[3];
}

// 1 / S, S = P_p[kH][kH] + Xi: the innovation's variance.
template <typename Real>
__device__ __forceinline__ Real update_rs(const Real (&Pp)[kD][kD],
                                          const Real Xi) {
  const Real S = Pp[kH][kH] + Xi;
  return Real(1) / S;
}

// The adjoint of the 1-D update on state kH in covariance terms: S =
// P_p[kH][kH] + Xi, p = P_p e_kH, m_f = m_p + p innov / S, P_f = P_p - p
// p^T / S, l = (log 2 pi S + innov^2 / S) / 2, innov = y - m_p[kH].  From
// the adjoints (mbar, Pbar) of m_f and P_f (Pbar symmetric, lower
// triangle) and gbar of l, the adjoints of m_p (mp_bar) and of P_p (G,
// symmetric, lower triangle), and S_bar, the adjoint of S (so of Xi).
// rS = 1 / S (update_rs), which no carry enters.
template <typename Real>
__device__ __forceinline__ void update_adjoint(
    Real (&Pp)[kD][kD], const Real rS, const Real innov, const Real gbar,
    const Real (&mbar)[kD], Real (&Pbar)[kD][kD], Real (&G)[kD][kD],
    Real (&mp_bar)[kD], Real& S_bar) {
  Real p[kD], Pbp[kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) p[i] = sym_at(Pp, i, kH);
  Real a = Real(0), pPbp = Real(0);
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    Real acc = Real(0);
#pragma unroll
    for (int j = 0; j < kD; ++j) acc += sym_at(Pbar, i, j) * p[j];
    Pbp[i] = acc;
    a += mbar[i] * p[i];
  }
#pragma unroll
  for (int i = 0; i < kD; ++i) pPbp += p[i] * Pbp[i];
  const Real innov_bar = (a + gbar * innov) * rS;
#pragma unroll
  for (int i = 0; i < kD; ++i) mp_bar[i] = i == kH ? mbar[i] - innov_bar : mbar[i];
  S_bar = (pPbp - a * innov) * rS * rS +
          gbar * Real(0.5) * (Real(1) - innov * innov * rS) * rS;
#pragma unroll
  for (int i = 0; i < kD; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) G[i][j] = Pbar[i][j];
  }
  // G = Pbar + (p_bar e_kH^T + e_kH p_bar^T) / 2 + S_bar e_kH e_kH^T, with
  // p_bar = (mbar innov - 2 Pbar p) / S.
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    const Real p_bar = (mbar[i] * innov - Real(2) * Pbp[i]) * rS;
    sym_at(G, i, kH) += i == kH ? p_bar : Real(0.5) * p_bar;
  }
  G[kH][kH] += S_bar;
}

// L^-1 of the lower L (lower triangle) by forward substitution.
template <typename Real>
__device__ __forceinline__ void lower_inverse(const Real (&L)[kD][kD],
                                              Real (&inv)[kD][kD]) {
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    const Real r = Real(1) / L[i][i];
    inv[i][i] = r;
#pragma unroll
    for (int j = 0; j < i; ++j) {
      Real acc = L[i][j] * inv[j][j];
#pragma unroll
      for (int q = j + 1; q < i; ++q) acc += L[i][q] * inv[q][j];
      inv[i][j] = -acc * r;
    }
  }
}

// The adjoint of the lower factor L of P = L L^T (Murray 2016): from
// Lbar (lower triangle), Pbar = L^-T sym(Phi(L^T Lbar)) L^-1 (lower
// triangle), Phi the lower triangle with the diagonal halved, with inv =
// L^-1 (lower_inverse), which no carry enters.  Column signs of L leave
// it unchanged.
template <typename Real>
__device__ __forceinline__ void cholesky_adjoint(const Real (&L)[kD][kD],
                                                 const Real (&inv)[kD][kD],
                                                 const Real (&Lbar)[kD][kD],
                                                 Real (&Pbar)[kD][kD]) {
  // Y = sym(Phi(L^T Lbar)): Y_ij = (L^T Lbar)_ij / 2 for i >= j.
  Real Y[kD][kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      Real acc = Real(0);
#pragma unroll
      for (int k = i; k < kD; ++k) acc += L[k][i] * Lbar[k][j];
      Y[i][j] = Real(0.5) * acc;
    }
  }
  // Z = Y L^-1, then Pbar = L^-T Z.
  Real Z[kD][kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) {
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      Real acc = Real(0);
#pragma unroll
      for (int k = j; k < kD; ++k) acc += sym_at(Y, i, k) * inv[k][j];
      Z[i][j] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < kD; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      Real acc = Real(0);
#pragma unroll
      for (int k = i; k < kD; ++k) acc += inv[k][i] * Z[k][j];
      Pbar[i][j] = acc;
    }
  }
}

// One word of global memory into shared memory, asynchronously (cp.async,
// sm_80 and later); the copy compiled for a host is the same copy, done at
// once.  Each asm names memory as clobbered, so the compiler keeps the
// loads of a slot between the wait for its copies and the next copies
// into it: with no barrier after the wait, nothing else orders them.
template <typename Real>
__device__ __forceinline__ void copy_async(Real* dst, const Real* src) {
#if defined(__CUDA_ARCH__)
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(saddr),
               "l"(src), "n"(sizeof(Real)) : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// The mbarriers of a hand-off between warps of a block (sm_90: kernel F's
// ring, the sweep adjoint's): an arrival count set once, arrive (release
// at CTA scope), and wait for the completion of the phase of the given
// parity (acquire).
__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_address(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}\n" ::"r"(
          smem_address(bar)) : "memory");
}

// One test of the completion of the phase of the given parity (acquire).
__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar,
                                              unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}\n"
      : "=r"(done) : "r"(smem_address(bar)), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

}  // namespace
