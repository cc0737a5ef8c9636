// Adjoint of the square-root GHFS filter NLL of the chirp LCD model (d = 4,
// H = e_1), one parameter vector per lane: dNLL/dconsts (B, kNumConsts)
// from the forward's filtered means and factors.
//
// Replaces no Pallas kernel: with the per-lane instances of
// ghfs_chirp_filter.cu it replaces the JAX package's
//   chirpgp_tpu/infer/sqrt.py::sqrt_sgp_filter
// under jax.value_and_grad, a compiled lax.scan with jax.checkpoint per
// step and XLA's reverse mode of it.  The plain PyTorch version is
// ops/chirp_filter_grad.py::filter_nll_adjoint_reference, whose algebra
// this is.
//
// What it computes.  The NLL as a function of the constants, without the
// Householder reflections.  Walking t = T-1 .. 0, each step is recomputed
// from the previous step's filtered m and L (the forward's outputs, or m0
// and L0 at t = 0), as jax.checkpoint recomputes it: the sigma points
// chi_s = m + L xi_s, their chirp-LCD means mu_s, m_p = sum_s w_s mu_s and
// P_p = sum_s w_s (mu_s - m_p)(mu_s - m_p)^T + Lq Lq^T.  Then, from the
// carried adjoints (mbar, Pbar) of the step's filtered m and P:
// 1. the 1-D update's adjoint in closed form (chirp_lcd.cuh::
//    update_adjoint) gives G, the adjoint of P_p, and mp_bar;
// 2. mu_bar_s = w_s (2 G (mu_s - m_p) + mp_bar) (the deviations sum to
//    zero, so m_p's part of them adds nothing), and Lq^T's adjoint is
//    2 Lq^T G, summed over t as 2 Lq^T sum_t G_t;
// 3. the LCD mean's adjoint (lcd_mean_adjoint) gives chi_bar_s and the
//    adjoints of F, the decay and dt;
// 4. m's adjoint sum_s chi_bar_s and L's sum_s chi_bar_s xi_s^T;
// 5. at t > 0, Pbar = L^-T sym(Phi(L^T Lbar)) L^-1, the adjoint of the
//    Cholesky factor (cholesky_adjoint), which the column signs the
//    forward's reflections left leave unchanged; at t = 0 they are the
//    adjoints of m0 and L0.
// Every step's NLL increment is seeded with gbar[b], the upstream gradient
// of lane b's final NLL.
//
// What bounds it.  Per lane-step 14.7k flop at S = 81 (ops/
// chirp_filter_grad.py::adjoint_cost: the recomputed points, the Gram,
// the point adjoints, the 4 x 4 algebra of every member) against 15 words
// read (m, the lower L, y); at B = 300, T = 3141 that is 13.83 GFLOP and
// 57 MB in float32, a bound of 0.206 ms at 67 TFLOP/s.  As for the forward, the T steps are
// a chain: below ~16k lanes the latency of one step, not the card's rate,
// sets the time.
//
// Design: the forward's team of P = 32 threads per lane (launch_geometry
// with team 32), member p owning the sigma points p, p + 32, p + 64.  Per
// step three team reductions (team_sum): m_p (4 values), the Gram (10),
// and the adjoints of m and L (14); the 4 x 4 algebra of the update and
// the factor runs on every member, so each ends with the carry.  The
// adjoints of F, the decay and dt stay per member until the end (one
// reduction), and G and S_bar are summed over t by every member.  The
// next step's inputs are loaded into registers one step ahead.  Member p
// writes the output words w with w % 32 == p.  Accurate math (no fast
// math); templated on float and double.

#include <cuda_runtime.h>

#include <cstddef>

#include "chirp_lcd.cuh"

namespace {

constexpr int kTeam = 32;
constexpr int kLowerWords = kD * (kD + 1) / 2;

// The inputs of step t: the filtered m and lower L of step t-1 (m0 and
// L0, from the lane's row of constants, at t = 0) and y_t.
template <typename Real>
__device__ __forceinline__ void load_step(
    const Real* __restrict__ row, const Real* __restrict__ ys,
    const Real* __restrict__ mfs, const Real* __restrict__ lfs, const int t,
    const int b, const size_t Bs, Real (&m)[kD], Real (&L)[kD][kD], Real& y) {
  y = ys[static_cast<size_t>(t) * Bs + b];
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      m[i] = row[kM0Word + i];
#pragma unroll
      for (int j = 0; j <= i; ++j) L[i][j] = row[kL0Word + i * kD + j];
    }
    return;
  }
  const size_t tp = static_cast<size_t>(t - 1);
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    m[i] = mfs[(tp * kD + i) * Bs + b];
#pragma unroll
    for (int j = 0; j <= i; ++j) L[i][j] = lfs[(tp * kD * kD + i * kD + j) * Bs + b];
  }
}

template <typename Real, int kRows>
__global__ void __launch_bounds__(kMaxThreads)
ghfs_chirp_filter_adjoint_kernel(const Real* __restrict__ ys,     // (T, B)
                                 const Real* __restrict__ xi_g,   // (S, kD)
                                 const Real* __restrict__ w_g,    // (S,)
                                 const Real* __restrict__ lane_consts,
                                 const Real* __restrict__ mfs,    // (T, kD, B)
                                 const Real* __restrict__ lfs,    // (T, kD*kD, B)
                                 const Real* __restrict__ gbar,   // (B,)
                                 const int S, const int T, const int B,
                                 const int lanes_per_block,
                                 Real* __restrict__ dconsts) {    // (B, kNumConsts)
  constexpr int P = kTeam;
  __shared__ Real xi_s[kD][kMaxPoints];
  __shared__ Real w_s[kMaxPoints];
  for (int i = threadIdx.x; i < S * kD; i += blockDim.x)
    xi_s[i % kD][i / kD] = xi_g[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) w_s[i] = w_g[i];
  __syncthreads();

  const int member = threadIdx.x % P;
  const int b = blockIdx.x * lanes_per_block + static_cast<int>(threadIdx.x) / P;
  if (b >= B) return;
  const unsigned mask = team_mask<P>();
  const size_t Bs = static_cast<size_t>(B);
  // Of the constants only F, the decay and dt live through the loop (what
  // lcd_mean_parts and lcd_mean_adjoint read); m0, L0 and Lq^T are read
  // from the row where they are needed, which keeps the float64 instance
  // within the registers.
  const Real* __restrict__ row = lane_consts + static_cast<size_t>(b) * kNumConsts;
  ChirpConsts<Real> c;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) c.F[i][j] = row[2 * i + j];
  c.decay = row[kDecayWord];
  c.dt = row[kDtWord];
  const Real sqrt_xi = row[kSqrtXiWord];
  const Real g = gbar[b];
  const Real Xi = sqrt_xi * sqrt_xi;
  Real LqLqT[kD][kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      Real acc = Real(0);
#pragma unroll
      for (int k = 0; k < kD; ++k)
        acc += row[kLqTWord + k * kD + i] * row[kLqTWord + k * kD + j];
      LqLqT[i][j] = acc;
    }
  }

  // The carry (lower triangles of the symmetric ones), the sums over t,
  // the member's own parts of F's, the decay's and dt's adjoints.
  Real mbar[kD], Pbar[kD][kD], Gsum[kD][kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    mbar[i] = Real(0);
#pragma unroll
    for (int j = 0; j <= i; ++j) Pbar[i][j] = Gsum[i][j] = Real(0);
  }
  Real Ssum = Real(0), gF[2][2] = {{Real(0), Real(0)}, {Real(0), Real(0)}};
  Real g_decay = Real(0), g_dt = Real(0);
  Real* __restrict__ out = dconsts + static_cast<size_t>(b) * kNumConsts;

  Real m[kD], L[kD][kD], y;
  if (T > 0) load_step(row, ys, mfs, lfs, T - 1, b, Bs, m, L, y);
  for (int t = T - 1; t >= 0; --t) {
    Real mn[kD], Ln[kD][kD], yn;
    if (t > 0) load_step(row, ys, mfs, lfs, t - 1, b, Bs, mn, Ln, yn);

    // The step's forward, recomputed: own points, m_p, then the Gram.
    Real chi[kRows][kD], mu[kRows][kD], cos_a[kRows], sin_a[kRows], sp[kRows];
    Real wgt[kRows];
    int sidx[kRows];
    Real mp[kD];
#pragma unroll
    for (int k = 0; k < kD; ++k) mp[k] = Real(0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = member + P * i;
      const int s = r < S ? r : S - 1;
      sidx[i] = s;
      wgt[i] = r < S ? w_s[s] : Real(0);
#pragma unroll
      for (int a = 0; a < kD; ++a) {
        Real acc = Real(0);
#pragma unroll
        for (int j = 0; j <= a; ++j) acc += xi_s[j][s] * L[a][j];
        chi[i][a] = m[a] + acc;
      }
      lcd_mean_parts(c, chi[i], mu[i], cos_a[i], sin_a[i], sp[i]);
#pragma unroll
      for (int k = 0; k < kD; ++k) mp[k] += wgt[i] * mu[i][k];
    }
    team_sum<P>(mask, mp);
    Real gram[kLowerWords];
#pragma unroll
    for (int q = 0; q < kLowerWords; ++q) gram[q] = Real(0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int k = 0; k < kD; ++k) mu[i][k] -= mp[k];   // the deviation
      int q = 0;
#pragma unroll
      for (int a = 0; a < kD; ++a) {
#pragma unroll
        for (int j = 0; j <= a; ++j) gram[q++] += wgt[i] * mu[i][a] * mu[i][j];
      }
    }
    team_sum<P>(mask, gram);
    Real Pp[kD][kD];
    {
      int q = 0;
#pragma unroll
      for (int a = 0; a < kD; ++a) {
#pragma unroll
        for (int j = 0; j <= a; ++j) Pp[a][j] = gram[q++] + LqLqT[a][j];
      }
    }

    // The update's adjoint, then each own point's.
    Real G[kD][kD], mp_bar[kD], S_bar;
    update_adjoint(Pp, Xi, y - mp[kH], g, mbar, Pbar, G, mp_bar, S_bar);
    Ssum += S_bar;
#pragma unroll
    for (int a = 0; a < kD; ++a) {
#pragma unroll
      for (int j = 0; j <= a; ++j) Gsum[a][j] += G[a][j];
    }
    Real red[kD + kLowerWords];   // adjoints of m, then of L (lower)
#pragma unroll
    for (int q = 0; q < kD + kLowerWords; ++q) red[q] = Real(0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      Real mu_bar[kD], chi_bar[kD];
#pragma unroll
      for (int a = 0; a < kD; ++a) {
        Real acc = Real(0);
#pragma unroll
        for (int j = 0; j < kD; ++j) acc += sym_at(G, a, j) * mu[i][j];
        mu_bar[a] = wgt[i] * (Real(2) * acc + mp_bar[a]);
      }
      lcd_mean_adjoint(c, chi[i], cos_a[i], sin_a[i], sp[i], mu_bar, chi_bar,
                       gF, g_decay, g_dt);
      const int s = sidx[i];
      int q = kD;
#pragma unroll
      for (int a = 0; a < kD; ++a) {
        red[a] += chi_bar[a];
#pragma unroll
        for (int j = 0; j <= a; ++j) red[q++] += chi_bar[a] * xi_s[j][s];
      }
    }
    team_sum<P>(mask, red);
    Real Lbar[kD][kD];
    {
      int q = kD;
#pragma unroll
      for (int a = 0; a < kD; ++a) {
#pragma unroll
        for (int j = 0; j <= a; ++j) Lbar[a][j] = red[q++];
      }
    }
    if (t > 0) {
      cholesky_adjoint(L, Lbar, Pbar);
#pragma unroll
      for (int a = 0; a < kD; ++a) {
        mbar[a] = red[a];
        m[a] = mn[a];
#pragma unroll
        for (int j = 0; j <= a; ++j) L[a][j] = Ln[a][j];
      }
      y = yn;
    } else {
      // The adjoints of L0 (lower; its upper words 0) and m0, written by
      // their owners at once rather than held through the loop.
#pragma unroll
      for (int w = kL0Word; w < kDecayWord; ++w) {
        if (w % P != member) continue;
        const int i = (w - kL0Word) / kD, j = (w - kL0Word) % kD;
        out[w] = w >= kM0Word ? red[w - kM0Word]
                              : (j <= i ? Lbar[i][j] : Real(0));
      }
    }
  }

  Real fin[6] = {gF[0][0], gF[0][1], gF[1][0], gF[1][1], g_decay, g_dt};
  team_sum<P>(mask, fin);
#pragma unroll
  for (int w = 0; w < kNumConsts; ++w) {
    if (w % P != member || (T > 0 && w >= kL0Word && w < kDecayWord))
      continue;
    Real v;
    if (w < kLqTWord) {
      v = fin[w];
    } else if (w < kL0Word) {
      const int k = (w - kLqTWord) / kD, j = (w - kLqTWord) % kD;   // Lq^T[k][j]
      Real acc = Real(0);
#pragma unroll
      for (int i = 0; i < kD; ++i)
        acc += row[kLqTWord + k * kD + i] * sym_at(Gsum, i, j);
      v = Real(2) * acc;
    } else if (w < kDecayWord) {
      v = Real(0);   // T = 0: m0 and L0 reach no NLL
    } else if (w == kDecayWord) {
      v = fin[4];
    } else if (w == kSqrtXiWord) {
      v = Real(2) * sqrt_xi * Ssum;
    } else {
      v = fin[5];
    }
    out[w] = v;
  }
}

template <typename Real>
int launch(const Real* ys, const Real* xi, const Real* w,
           const Real* lane_consts, const Real* mfs, const Real* lfs,
           const Real* gbar, int S, int T, int B, int rows,
           int lanes_per_block, Real* dconsts, void* stream) {
  if (S < 1 || S > kMaxPoints || T < 0 || B < 0 || lanes_per_block < 1 ||
      kTeam * lanes_per_block > kMaxThreads || S > kTeam * rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (B + lanes_per_block - 1) / lanes_per_block;
  const int threads = kTeam * lanes_per_block;
  switch (rows) {
    case 1:
      ghfs_chirp_filter_adjoint_kernel<Real, 1><<<blocks, threads, 0, s>>>(
          ys, xi, w, lane_consts, mfs, lfs, gbar, S, T, B, lanes_per_block,
          dconsts);
      break;
    case 3:
      ghfs_chirp_filter_adjoint_kernel<Real, 3><<<blocks, threads, 0, s>>>(
          ys, xi, w, lane_consts, mfs, lfs, gbar, S, T, B, lanes_per_block,
          dconsts);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ghfs_chirp_filter_adjoint_num_consts() { return kNumConsts; }

int ghfs_chirp_filter_adjoint_team() { return kTeam; }

int ghfs_chirp_filter_adjoint_f32(const float* ys, const float* xi,
                                  const float* w, const float* lane_consts,
                                  const float* mfs, const float* lfs,
                                  const float* gbar, int S, int T, int B,
                                  int rows, int lanes_per_block,
                                  float* dconsts, void* stream) {
  return launch<float>(ys, xi, w, lane_consts, mfs, lfs, gbar, S, T, B, rows,
                       lanes_per_block, dconsts, stream);
}

int ghfs_chirp_filter_adjoint_f64(const double* ys, const double* xi,
                                  const double* w, const double* lane_consts,
                                  const double* mfs, const double* lfs,
                                  const double* gbar, int S, int T, int B,
                                  int rows, int lanes_per_block,
                                  double* dconsts, void* stream) {
  return launch<double>(ys, xi, w, lane_consts, mfs, lfs, gbar, S, T, B,
                        rows, lanes_per_block, dconsts, stream);
}

}  // extern "C"
