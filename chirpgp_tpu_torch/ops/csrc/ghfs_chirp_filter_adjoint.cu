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
// 57 MB in float32, a bound of 0.206 ms at 67 TFLOP/s.  As for the
// forward, the T steps are a chain: below ~16k lanes the latency of one
// step, not the card's rate, sets the time.  Of one step of the team of
// 32 (H100, B = 300, GH-3 f32, time_sweep_objective.py --breakdown) the
// part that reads the carry -- the update's adjoint, the points'
// adjoints, the 14-word reduction and the factor's adjoint given L^-1 --
// took 1335 of 2842 cycles (47%): its 2.12 ms over T = 3141 at 1.98 GHz
// is the chain floor.  The rest (sigma points, LCD means, the m_p and
// Gram reductions, L^-1) reads no carry: it can run ahead.
//
// The chain design (adjoint_chain_kernel; the default while its blocks
// fit the SMs at once, up to 3 lanes per SM): per lane a chain warp and K
// producer warps (K = 3 for GH-3 in float32, else 2), up to kChainLanes
// lanes a block.
// - Producer j walks the steps n = j, j + K, .. (t = T-1-n), the team
//   design's recompute on its 32 threads: the sigma points, cos, sin,
//   softplus and sigmoid of chi_V, the deviations mu - m_p, P_p, the
//   innovation, 1 / S, L and L^-1 (lower_inverse), written into slot n mod
//   ring of the lane's ring of steps in dynamic shared memory: 32 words a
//   step and 12 a point slot (3 quads), 4.7 KB a step in float32 and 9.5
//   KB in float64 at GH-3's 96 slots.  It waits on the slot's `empty`
//   mbarrier before its first store and arrives on `full` after its last
//   (32 arrivals each).
// - The chain warp takes the steps in order: it waits on `full`, runs
//   update_adjoint, its points' mu_bar and lcd_mean_adjoint, one 14-word
//   team reduction and cholesky_adjoint with the delivered L^-1, carries
//   (mbar, Pbar), sums G, S_bar and its parts of F's, the decay's and dt's
//   adjoints, and arrives on `empty`.  It reads shared memory only.
// - A parity wait cannot tell a phase from the one two before it, so the
//   ring holds at least K steps (the launcher refuses fewer); the wrapper
//   sizes it from the shared memory the one block an SM holds leaves, at
//   most kMaxRing.  A wait that outlasts ~9 s faults (ring_wait) rather
//   than hang the card.
// - The chains of an SM's lanes sit in one block, warps 0..L-1, so that
//   no two share one of the SM's four schedulers, as they may where each
//   lane is a block of 1 + K warps (H100, B = 300 f32: 2.54 ms in blocks
//   of 3 lanes, 2.67 ms in blocks of 1; f64 6.24 against 9.45;
//   time_sweep_objective.py --adjoint --designs).
// - K: GH-3 in float32 with K = 2 took 3.40 ms against K = 3's 2.54;
//   float64 with K = 3 took 7.53 ms against K = 2's 6.24 (the same
//   script).
// - The step's reductions are team_allreduce: team_sum's bits, in 30
//   shuffles where the butterfly takes 70 for the chain's 14 words.
// - The arithmetic is the team design's, with the same device functions
//   (update_adjoint given 1 / S, cholesky_adjoint given L^-1), so the two
//   designs give the same bits wherever the compiler contracts alike.
//
// The team design (adjoint_team_kernel; beyond the chain design's one
// wave): one warp of lanes a block, P threads per lane, member p owning
// the sigma points p, p + P, ...  P = 32 up to 16 lanes per SM (173
// registers in float32, 11 blocks an SM: 1452 lanes at once), P = 8
// beyond (B = 4096 in one wave: 1024 blocks of 4 lanes, 8 an SM at up to
// 255 registers; the team of 32 takes three).  H100, GH-3 f32, T = 3141
// (time_sweep_objective.py --adjoint --designs --widths): the team of 32
// 5.56 ms at B = 1000 and 11.09 at 2112 against the chain design's 7.56
// and 15.00 in waves (6.16 and 12.13 in blocks of one lane) and the team
// of 8's 16.08 and 15.91; at B = 3000 16.52 against the team of 8's
// 16.13; at B = 4096 21.99 against 16.20.  Per step
// three team reductions: m_p (4 values), the Gram (10), and the adjoints
// of m and L (14); the 4 x 4 algebra of the update and the factor runs
// on every member, so each ends with the carry.  The adjoints of F, the decay and
// dt stay per member until the end (one reduction), and G and S_bar are
// summed over t by every member.  The next step's inputs are loaded into
// registers one step ahead.  Member p writes the output words w with w %
// P == p.
//
// Accurate math (no fast math); templated on float and double.

#include <cuda_runtime.h>

#include <cstddef>

#include "chirp_lcd.cuh"

namespace {

constexpr int kLowerWords = kD * (kD + 1) / 2;
constexpr int kRedWords = kD + kLowerWords;   // adjoints of m, then of L

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

// What of a lane's constants lives through the loop: F, the decay and dt
// (what lcd_mean_parts and lcd_mean_adjoint read), sqrt(Xi), Xi and Lq
// Lq^T (lower); m0, L0 and Lq^T are read from the row where they are
// needed, which keeps the float64 instances within the registers.
template <typename Real>
struct LaneConsts {
  ChirpConsts<Real> c;
  Real sqrt_xi, Xi;
  Real LqLqT[kD][kD];

  __device__ __forceinline__ explicit LaneConsts(const Real* __restrict__ row) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) c.F[i][j] = row[2 * i + j];
    c.decay = row[kDecayWord];
    c.dt = row[kDtWord];
    sqrt_xi = row[kSqrtXiWord];
    Xi = sqrt_xi * sqrt_xi;
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
  }
};

// The sums a lane carries to its outputs: G and S_bar over t (every
// member the same), the member's own parts of F's, the decay's and dt's
// adjoints.
template <typename Real>
struct AdjointSums {
  Real Gsum[kD][kD];   // lower triangle
  Real Ssum, gF[2][2], g_decay, g_dt;

  __device__ __forceinline__ AdjointSums() : Ssum(0), g_decay(0), g_dt(0) {
#pragma unroll
    for (int i = 0; i < kD; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) Gsum[i][j] = Real(0);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) gF[i][j] = Real(0);
  }

  __device__ __forceinline__ void add_step(const Real (&G)[kD][kD],
                                           const Real S_bar) {
    Ssum += S_bar;
#pragma unroll
    for (int a = 0; a < kD; ++a)
#pragma unroll
      for (int j = 0; j <= a; ++j) Gsum[a][j] += G[a][j];
  }
};

// One point's share of the step's adjoint: mu_bar = w (2 G dev + mp_bar),
// the LCD mean's adjoint, and chi_bar's parts of the adjoints of m and L
// (lower) added to red.
template <typename Real>
__device__ __forceinline__ void point_adjoint(
    const ChirpConsts<Real>& c, const Real wgt, const Real (&xi)[kD],
    const Real (&dev)[kD], const Real (&chi)[kD], const Real cos_a,
    const Real sin_a, const Real sp, const Real sig, Real (&G)[kD][kD],
    const Real (&mp_bar)[kD], AdjointSums<Real>& sums,
    Real (&red)[kRedWords]) {
  Real mu_bar[kD], chi_bar[kD];
#pragma unroll
  for (int a = 0; a < kD; ++a) {
    Real acc = Real(0);
#pragma unroll
    for (int j = 0; j < kD; ++j) acc += sym_at(G, a, j) * dev[j];
    mu_bar[a] = wgt * (Real(2) * acc + mp_bar[a]);
  }
  lcd_mean_adjoint(c, chi, cos_a, sin_a, sp, sig, mu_bar, chi_bar, sums.gF,
                   sums.g_decay, sums.g_dt);
  int q = kD;
#pragma unroll
  for (int a = 0; a < kD; ++a) {
    red[a] += chi_bar[a];
#pragma unroll
    for (int j = 0; j <= a; ++j) red[q++] += chi_bar[a] * xi[j];
  }
}

// At t = 0: the adjoints of L0 (lower; its upper words 0) and m0 from the
// step's reduction, written by their owners among the P members.
template <typename Real, int P>
__device__ __forceinline__ void write_initial(const int member,
                                             const Real (&red)[kRedWords],
                                             Real* __restrict__ out) {
#pragma unroll
  for (int w = kL0Word; w < kDecayWord; ++w) {
    if (w % P != member) continue;
    const int i = (w - kL0Word) / kD, j = (w - kL0Word) % kD;
    out[w] = w >= kM0Word ? red[w - kM0Word]
                          : (j <= i ? red[kD + i * (i + 1) / 2 + j] : Real(0));
  }
}

// The other outputs after the loop, written by their owners among the P
// members of the team `mask`: F's, the decay's and dt's adjoints (one
// team reduction), Lq^T's 2 Lq^T sum_t G_t, sqrt(Xi)'s 2 sqrt(Xi) sum_t
// S_bar; m0's and L0's are 0 where T = 0.
template <typename Real, int P>
__device__ __forceinline__ void write_outputs(const unsigned mask,
                                             const int member, const int T,
                                             const Real* __restrict__ row,
                                             const Real sqrt_xi,
                                             AdjointSums<Real>& sums,
                                             Real* __restrict__ out) {
  Real fin[6] = {sums.gF[0][0], sums.gF[0][1], sums.gF[1][0], sums.gF[1][1],
                 sums.g_decay, sums.g_dt};
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
        acc += row[kLqTWord + k * kD + i] * sym_at(sums.Gsum, i, j);
      v = Real(2) * acc;
    } else if (w < kDecayWord) {
      v = Real(0);   // T = 0: m0 and L0 reach no NLL
    } else if (w == kDecayWord) {
      v = fin[4];
    } else if (w == kSqrtXiWord) {
      v = Real(2) * sqrt_xi * sums.Ssum;
    } else {
      v = fin[5];
    }
    out[w] = v;
  }
}

template <typename Real, int P, int kRows>
__global__ void __launch_bounds__(kMaxThreads)
adjoint_team_kernel(const Real* __restrict__ ys,     // (T, B)
                    const Real* __restrict__ xi_g,   // (S, kD)
                    const Real* __restrict__ w_g,    // (S,)
                    const Real* __restrict__ lane_consts,
                    const Real* __restrict__ mfs,    // (T, kD, B)
                    const Real* __restrict__ lfs,    // (T, kD*kD, B)
                    const Real* __restrict__ gbar,   // (B,)
                    const int S, const int T, const int B,
                    const int lanes_per_block,
                    Real* __restrict__ dconsts) {    // (B, kNumConsts)
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
  const Real* __restrict__ row = lane_consts + static_cast<size_t>(b) * kNumConsts;
  const LaneConsts<Real> k(row);
  const Real g = gbar[b];
  Real mbar[kD], Pbar[kD][kD];   // the carry (Pbar: lower triangle)
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    mbar[i] = Real(0);
#pragma unroll
    for (int j = 0; j <= i; ++j) Pbar[i][j] = Real(0);
  }
  AdjointSums<Real> sums;
  Real* __restrict__ out = dconsts + static_cast<size_t>(b) * kNumConsts;

  Real m[kD], L[kD][kD], y;
  if (T > 0) load_step(row, ys, mfs, lfs, T - 1, b, Bs, m, L, y);
  for (int t = T - 1; t >= 0; --t) {
    Real mn[kD], Ln[kD][kD], yn;
    if (t > 0) load_step(row, ys, mfs, lfs, t - 1, b, Bs, mn, Ln, yn);

    // The step's forward, recomputed: own points, m_p, then the Gram.
    // The points' chi are kept for the adjoint pass where they are few
    // (the team of 32's rows), recomputed, the same bits, where keeping
    // them would cost the team of 8 its registers.
    constexpr bool kKeepChi = kRows <= 3;
    Real mu[kRows][kD], cos_a[kRows], sin_a[kRows], sp[kRows];
    Real kept[kKeepChi ? kRows : 1][kD];
    Real mp[kD];
#pragma unroll
    for (int q = 0; q < kD; ++q) mp[q] = Real(0);
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
      lcd_mean_parts(k.c, chi, mu[i], cos_a[i], sin_a[i], sp[i]);
      if constexpr (kKeepChi) {
#pragma unroll
        for (int a = 0; a < kD; ++a) kept[i][a] = chi[a];
      }
      const Real wgt = r < S ? w_s[s] : Real(0);
#pragma unroll
      for (int q = 0; q < kD; ++q) mp[q] += wgt * mu[i][q];
    }
    team_sum<P>(mask, mp);
    Real gram[kLowerWords];
#pragma unroll
    for (int q = 0; q < kLowerWords; ++q) gram[q] = Real(0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = member + P * i;
      const Real wgt = r < S ? w_s[r < S ? r : S - 1] : Real(0);
#pragma unroll
      for (int q = 0; q < kD; ++q) mu[i][q] -= mp[q];   // the deviation
      int q = 0;
#pragma unroll
      for (int a = 0; a < kD; ++a) {
#pragma unroll
        for (int j = 0; j <= a; ++j) gram[q++] += wgt * mu[i][a] * mu[i][j];
      }
    }
    team_sum<P>(mask, gram);
    Real Pp[kD][kD];
    {
      int q = 0;
#pragma unroll
      for (int a = 0; a < kD; ++a) {
#pragma unroll
        for (int j = 0; j <= a; ++j) Pp[a][j] = gram[q++] + k.LqLqT[a][j];
      }
    }

    // The update's adjoint, then each own point's.
    Real G[kD][kD], mp_bar[kD], S_bar;
    update_adjoint(Pp, update_rs(Pp, k.Xi), y - mp[kH], g, mbar, Pbar, G,
                   mp_bar, S_bar);
    sums.add_step(G, S_bar);
    Real red[kRedWords];
#pragma unroll
    for (int q = 0; q < kRedWords; ++q) red[q] = Real(0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = member + P * i;
      const int s = r < S ? r : S - 1;
      Real chi[kD], xi[kD];
#pragma unroll
      for (int a = 0; a < kD; ++a) {
        xi[a] = xi_s[a][s];
        if constexpr (kKeepChi) {
          chi[a] = kept[i][a];
        } else {
          Real acc = Real(0);
#pragma unroll
          for (int j = 0; j <= a; ++j) acc += xi_s[j][s] * L[a][j];
          chi[a] = m[a] + acc;
        }
      }
      point_adjoint(k.c, r < S ? w_s[s] : Real(0), xi, mu[i], chi, cos_a[i],
                    sin_a[i], sp[i], sigmoid(chi[kV]), G, mp_bar, sums, red);
    }
    team_sum<P>(mask, red);
    if (t > 0) {
      Real Lbar[kD][kD], inv[kD][kD];
      int q = kD;
#pragma unroll
      for (int a = 0; a < kD; ++a) {
#pragma unroll
        for (int j = 0; j <= a; ++j) Lbar[a][j] = red[q++];
      }
      lower_inverse(L, inv);
      cholesky_adjoint(L, inv, Lbar, Pbar);
#pragma unroll
      for (int a = 0; a < kD; ++a) {
        mbar[a] = red[a];
        m[a] = mn[a];
#pragma unroll
        for (int j = 0; j <= a; ++j) L[a][j] = Ln[a][j];
      }
      y = yn;
    } else {
      write_initial<Real, P>(member, red, out);
    }
  }

  write_outputs<Real, P>(mask, member, T, row, k.sqrt_xi, sums, out);
}

template <typename Real, int P, int kRows>
int launch_team(const Real* ys, const Real* xi, const Real* w,
                const Real* lane_consts, const Real* mfs, const Real* lfs,
                const Real* gbar, int S, int T, int B, int lanes_per_block,
                Real* dconsts, cudaStream_t s) {
  if (S > P * kRows || P * lanes_per_block > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + lanes_per_block - 1) / lanes_per_block;
  adjoint_team_kernel<Real, P, kRows><<<blocks, P * lanes_per_block, 0, s>>>(
      ys, xi, w, lane_consts, mfs, lfs, gbar, S, T, B, lanes_per_block,
      dconsts);
  return static_cast<int>(cudaGetLastError());
}

// Sum of x over the team of P members, on every member, with team_sum's
// bits in fewer shuffles: recursive halving.  At offset O with M words
// left a member keeps the half of them that its bit O picks and adds its
// partner's copy of that half, one shuffle a kept word; with one word
// left, the later levels are team_sum's; then each word is fetched from a
// member that holds it.  Every sum adds team_sum's two operands.  For the
// 14 words of the chain's step at P = 32: 30 shuffles where the butterfly
// takes 70 (H100, B = 300, the chain design: f64 6.28 ms against 6.94,
// f32 2.54 against 2.55; time_sweep_objective.py --adjoint --variants
// butterfly).
template <int P, int O, int M, typename Real, int K>
__device__ __forceinline__ void halve(const unsigned mask, const int member,
                                      Real (&v)[K]) {
  if constexpr (O > 0) {
    if constexpr (M > 1) {
      const bool upper = (member & O) != 0;
#pragma unroll
      for (int j = 0; j < M / 2; ++j) {
        const Real lo = v[j], hi = v[j + M / 2];
        v[j] = (upper ? hi : lo) +
               __shfl_xor_sync(mask, upper ? lo : hi, O, P);
      }
      halve<P, O / 2, M / 2>(mask, member, v);
    } else {
      v[0] += __shfl_xor_sync(mask, v[0], O, P);
      halve<P, O / 2, 1>(mask, member, v);
    }
  }
}

// Which member holds word k after halve (its halving bits), and where
// among that member's words, for M words halved at offsets P/2, P/4, ..
template <int P, int M>
__host__ __device__ constexpr int fetch_lane(int k) {
  int src = 0, w = M;
  for (int o = P / 2; o > 0 && w > 1; o >>= 1) {
    w /= 2;
    if (k >= w) {
      src |= o;
      k -= w;
    }
  }
  return src;
}

template <int P, int M>
__host__ __device__ constexpr int fetch_word(int k) {
  int w = M;
  for (int o = P / 2; o > 0 && w > 1; o >>= 1) {
    w /= 2;
    if (k >= w) k -= w;
  }
  return k;
}

template <int P, int N, typename Real>
__device__ __forceinline__ void team_allreduce(const unsigned mask,
                                               const int member,
                                               Real (&x)[N]) {
  constexpr int M = N <= 4 ? 4 : N <= 8 ? 8 : 16;
  static_assert(N <= 16, "at most 16 words");
  Real v[M];
#pragma unroll
  for (int k = 0; k < M; ++k) v[k] = k < N ? x[k] : Real(0);
  halve<P, P / 2, M>(mask, member, v);
#define ADJOINT_FETCH(k)                                                \
  if constexpr ((k) < N)                                                \
    x[k] = __shfl_sync(mask, v[fetch_word<P, M>(k)], fetch_lane<P, M>(k), P);
  ADJOINT_FETCH(0) ADJOINT_FETCH(1) ADJOINT_FETCH(2) ADJOINT_FETCH(3)
  ADJOINT_FETCH(4) ADJOINT_FETCH(5) ADJOINT_FETCH(6) ADJOINT_FETCH(7)
  ADJOINT_FETCH(8) ADJOINT_FETCH(9) ADJOINT_FETCH(10) ADJOINT_FETCH(11)
  ADJOINT_FETCH(12) ADJOINT_FETCH(13) ADJOINT_FETCH(14) ADJOINT_FETCH(15)
#undef ADJOINT_FETCH
}

// The chain design: one lane a block, warp 0 the chain warp, warps 1..K
// its producers, a ring of `ring` steps in dynamic shared memory between
// them.  A slot holds, per step, kStepWords words (P_p's lower triangle,
// the innovation, 1 / S, L's and L^-1's lower triangles) and, per point
// slot r < 32 kRows, three quads: the deviation mu - m_p, chi, and (cos,
// sin, softplus(chi_V), sigmoid(chi_V)).
constexpr int kChainTeam = 32;
constexpr int kMaxRing = 8;
constexpr int kStepPp = 0, kStepInnov = kLowerWords, kStepRs = kStepInnov + 1,
              kStepL = kStepRs + 1, kStepInv = kStepL + kLowerWords,
              kStepWords = kStepInv + kLowerWords;
static_assert(kStepWords == 32, "the step's words are 8 quads");

// A wait on a ring slot's mbarrier that faults (__trap: the launch
// reports an error) after 2^34 cycles, ~9 s at 1.98 GHz, where a lost
// hand-off would otherwise hang the card.
__device__ __forceinline__ void ring_wait(unsigned long long* bar,
                                          unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

template <typename Real>
struct alignas(16) Quad {
  Real v[4];
};

template <typename Real, int kRows>
struct ChainSlot {
  static constexpr int kPoints = kChainTeam * kRows;
  static constexpr int kWords = kStepWords + 12 * kPoints;
  Real* step;
  Quad<Real>* dev;
  Quad<Real>* chi;
  Quad<Real>* trig;

  __device__ __forceinline__ ChainSlot(Real* ring, const int slot)
      : step(ring + static_cast<size_t>(slot) * kWords),
        dev(reinterpret_cast<Quad<Real>*>(step + kStepWords)),
        chi(dev + kPoints),
        trig(chi + kPoints) {}
};

// Producer `j` of the lane: steps n = j, j + K, .. (t = T-1-n), each the
// team kernel's recompute, handed to the chain warp through ring slot n
// mod ring.  It waits for the slot's `empty` before its first store and
// stores chi and the trigonometric quad as each point is done, then the
// deviations after the m_p reduction; member 0 stores the step's words.
// Wait and release count the 32 threads.
template <typename Real, int kRows, int K>
__device__ __forceinline__ void chain_producer(
    const LaneConsts<Real>& k, const Real* __restrict__ row,
    const Real* __restrict__ ys, const Real* __restrict__ mfs,
    const Real* __restrict__ lfs, const Real (&xi_s)[kD][kMaxPoints],
    const Real (&w_s)[kMaxPoints], const int S, const int T, const int b,
    const size_t Bs, Real* ring_base, const int ring,
    unsigned long long* full, unsigned long long* empty, const int j) {
  constexpr int P = kChainTeam;
  const int member = threadIdx.x % P;
  const unsigned mask = 0xffffffffu;
  int slot = j;
  unsigned parity = 0;
  Real m[kD], L[kD][kD], y;
  if (j < T) load_step(row, ys, mfs, lfs, T - 1 - j, b, Bs, m, L, y);
  for (int n = j; n < T; n += K) {
    const int t = T - 1 - n;
    Real mn[kD], Ln[kD][kD], yn;
    if (t - K >= 0) load_step(row, ys, mfs, lfs, t - K, b, Bs, mn, Ln, yn);
    ring_wait(&empty[slot], parity ^ 1u);
    const ChainSlot<Real, kRows> out(ring_base, slot);

    Real mu[kRows][kD], mp[kD];
#pragma unroll
    for (int q = 0; q < kD; ++q) mp[q] = Real(0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = member + P * i;
      const int s = r < S ? r : S - 1;
      Quad<Real> chi, trig;
#pragma unroll
      for (int a = 0; a < kD; ++a) {
        Real acc = Real(0);
#pragma unroll
        for (int jj = 0; jj <= a; ++jj) acc += xi_s[jj][s] * L[a][jj];
        chi.v[a] = m[a] + acc;
      }
      lcd_mean_parts(k.c, chi.v, mu[i], trig.v[0], trig.v[1], trig.v[2]);
      trig.v[3] = sigmoid(chi.v[kV]);
      out.chi[r] = chi;
      out.trig[r] = trig;
      const Real wgt = r < S ? w_s[s] : Real(0);
#pragma unroll
      for (int q = 0; q < kD; ++q) mp[q] += wgt * mu[i][q];
    }
    team_allreduce<P>(mask, member, mp);
    Real gram[kLowerWords];
#pragma unroll
    for (int q = 0; q < kLowerWords; ++q) gram[q] = Real(0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = member + P * i;
      const Real wgt = r < S ? w_s[r] : Real(0);
      Quad<Real> dev;
#pragma unroll
      for (int q = 0; q < kD; ++q) dev.v[q] = mu[i][q] - mp[q];
      out.dev[r] = dev;
      int q = 0;
#pragma unroll
      for (int a = 0; a < kD; ++a) {
#pragma unroll
        for (int jj = 0; jj <= a; ++jj) gram[q++] += wgt * dev.v[a] * dev.v[jj];
      }
    }
    team_allreduce<P>(mask, member, gram);
    if (member == 0) {
      Real Pp[kD][kD], inv[kD][kD];
      int q = 0;
#pragma unroll
      for (int a = 0; a < kD; ++a) {
#pragma unroll
        for (int jj = 0; jj <= a; ++jj, ++q) {
          Pp[a][jj] = gram[q] + k.LqLqT[a][jj];
          out.step[kStepPp + q] = Pp[a][jj];
          out.step[kStepL + q] = L[a][jj];
        }
      }
      lower_inverse(L, inv);
      q = 0;
#pragma unroll
      for (int a = 0; a < kD; ++a) {
#pragma unroll
        for (int jj = 0; jj <= a; ++jj) out.step[kStepInv + q++] = inv[a][jj];
      }
      out.step[kStepInnov] = y - mp[kH];
      out.step[kStepRs] = update_rs(Pp, k.Xi);
    }
    mbar_arrive(&full[slot]);
    slot += K;
    if (slot >= ring) {
      slot -= ring;
      parity ^= 1u;
    }
#pragma unroll
    for (int a = 0; a < kD; ++a) {
      m[a] = mn[a];
#pragma unroll
      for (int jj = 0; jj <= a; ++jj) L[a][jj] = Ln[a][jj];
    }
    y = yn;
  }
}

// The chain warp: steps n = 0, 1, .. in order from the ring, the carry
// (mbar, Pbar) and the sums in registers; per step the update's adjoint,
// its points' adjoints, one 14-word team reduction and the factor's
// adjoint with the delivered L^-1, reading shared memory only.  It
// releases a slot once it has read it, and writes the outputs at the end.
template <typename Real, int kRows>
__device__ __forceinline__ void chain_warp(
    const LaneConsts<Real>& k, const Real* __restrict__ row, const Real g,
    const Real (&xi_s)[kD][kMaxPoints], const Real (&w_s)[kMaxPoints],
    const int S, const int T, Real* ring_base, const int ring,
    unsigned long long* full, unsigned long long* empty,
    Real* __restrict__ out) {
  constexpr int P = kChainTeam;
  const int member = threadIdx.x % P;
  const unsigned mask = 0xffffffffu;
  Real mbar[kD], Pbar[kD][kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    mbar[i] = Real(0);
#pragma unroll
    for (int j = 0; j <= i; ++j) Pbar[i][j] = Real(0);
  }
  AdjointSums<Real> sums;
  int slot = 0;
  unsigned parity = 0;
  for (int n = 0; n < T; ++n) {
    ring_wait(&full[slot], parity);
    const ChainSlot<Real, kRows> in(ring_base, slot);
    Real Pp[kD][kD];
    {
      int q = 0;
#pragma unroll
      for (int a = 0; a < kD; ++a) {
#pragma unroll
        for (int j = 0; j <= a; ++j) Pp[a][j] = in.step[kStepPp + q++];
      }
    }
    Real G[kD][kD], mp_bar[kD], S_bar;
    update_adjoint(Pp, in.step[kStepRs], in.step[kStepInnov], g, mbar, Pbar,
                   G, mp_bar, S_bar);
    sums.add_step(G, S_bar);
    Real red[kRedWords];
#pragma unroll
    for (int q = 0; q < kRedWords; ++q) red[q] = Real(0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = member + P * i;
      const int s = r < S ? r : S - 1;
      const Quad<Real> dev = in.dev[r], chi = in.chi[r], trig = in.trig[r];
      Real xi[kD];
#pragma unroll
      for (int a = 0; a < kD; ++a) xi[a] = xi_s[a][s];
      point_adjoint(k.c, r < S ? w_s[s] : Real(0), xi, dev.v, chi.v,
                    trig.v[0], trig.v[1], trig.v[2], trig.v[3], G, mp_bar,
                    sums, red);
    }
    team_allreduce<P>(mask, member, red);
    if (n < T - 1) {
      Real L[kD][kD], inv[kD][kD], Lbar[kD][kD];
      int q = 0;
#pragma unroll
      for (int a = 0; a < kD; ++a) {
#pragma unroll
        for (int j = 0; j <= a; ++j, ++q) {
          L[a][j] = in.step[kStepL + q];
          inv[a][j] = in.step[kStepInv + q];
          Lbar[a][j] = red[kD + q];
        }
      }
      cholesky_adjoint(L, inv, Lbar, Pbar);
#pragma unroll
      for (int a = 0; a < kD; ++a) mbar[a] = red[a];
    } else {
      write_initial<Real, P>(member, red, out);
    }
    mbar_arrive(&empty[slot]);
    if (++slot == ring) {
      slot = 0;
      parity ^= 1u;
    }
  }
  write_outputs<Real, P>(mask, member, T, row, k.sqrt_xi, sums, out);
}

// A block of the chain design holds L <= kChainLanes lanes: warps 0..L-1
// their chain warps, warps L + j L + l producer j of lane l.  A block's
// consecutive warps sit on the SM's four schedulers in turn, so the
// chains of an SM's lanes (3 at B = 300 on 132 SMs) do not share one.
// At most 32 L (1 + K) threads a block, one block an SM where L = 3:
// 170 (K = 3) or 227 (K = 2) registers a thread.
constexpr int kChainLanes = 3;

template <typename Real, int kRows, int K>
__global__ void __launch_bounds__(kChainLanes * kChainTeam * (1 + K), 1)
adjoint_chain_kernel(const Real* __restrict__ ys,     // (T, B)
                     const Real* __restrict__ xi_g,   // (S, kD)
                     const Real* __restrict__ w_g,    // (S,)
                     const Real* __restrict__ lane_consts,
                     const Real* __restrict__ mfs,    // (T, kD, B)
                     const Real* __restrict__ lfs,    // (T, kD*kD, B)
                     const Real* __restrict__ gbar,   // (B,)
                     const int S, const int T, const int B, const int ring,
                     const int lanes_per_block,
                     Real* __restrict__ dconsts) {    // (B, kNumConsts)
  __shared__ Real xi_s[kD][kMaxPoints];
  __shared__ Real w_s[kMaxPoints];
  __shared__ unsigned long long full[kChainLanes][kMaxRing],
      empty[kChainLanes][kMaxRing];
  extern __shared__ __align__(16) unsigned char chain_smem[];
  const int L = lanes_per_block;
  for (int i = threadIdx.x; i < S * kD; i += blockDim.x)
    xi_s[i % kD][i / kD] = xi_g[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) w_s[i] = w_g[i];
  if (threadIdx.x == 0) {
    for (int l = 0; l < L; ++l) {
      for (int s = 0; s < ring; ++s) {
        mbar_init(&full[l][s], kChainTeam);
        mbar_init(&empty[l][s], kChainTeam);
      }
    }
  }
  __syncthreads();

  const int warp = static_cast<int>(threadIdx.x) / kChainTeam;
  const int l = warp < L ? warp : (warp - L) % L;
  const int b = static_cast<int>(blockIdx.x) * L + l;
  if (b >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  const Real* __restrict__ row = lane_consts + static_cast<size_t>(b) * kNumConsts;
  const LaneConsts<Real> k(row);
  Real* ring_base = reinterpret_cast<Real*>(chain_smem) +
                    static_cast<size_t>(l) * ring * ChainSlot<Real, kRows>::kWords;
  if (warp < L) {
    chain_warp<Real, kRows>(k, row, gbar[b], xi_s, w_s, S, T, ring_base,
                            ring, full[l], empty[l],
                            dconsts + static_cast<size_t>(b) * kNumConsts);
  } else {
    chain_producer<Real, kRows, K>(k, row, ys, mfs, lfs, xi_s, w_s, S, T, b,
                                   Bs, ring_base, ring, full[l], empty[l],
                                   (warp - L) / L);
  }
}

template <typename Real, int kRows, int K>
int launch_chain(const Real* ys, const Real* xi, const Real* w,
                 const Real* lane_consts, const Real* mfs, const Real* lfs,
                 const Real* gbar, int S, int T, int B, int ring,
                 int lanes_per_block, Real* dconsts, cudaStream_t s) {
  // A parity wait cannot tell a phase from the one two before it: a
  // producer may wait on a slot's round only once the slot's previous
  // round was read, which the step it wrote before (K steps back) ensures
  // only if ring >= K.
  if (S > kChainTeam * kRows || ring < K || ring > kMaxRing ||
      lanes_per_block > kChainLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(sizeof(Real) *
                                     ChainSlot<Real, kRows>::kWords * ring *
                                     lanes_per_block);
  const cudaError_t err = cudaFuncSetAttribute(
      adjoint_chain_kernel<Real, kRows, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + lanes_per_block - 1) / lanes_per_block;
  adjoint_chain_kernel<Real, kRows, K>
      <<<blocks, lanes_per_block * kChainTeam * (1 + K), bytes, s>>>(
          ys, xi, w, lane_consts, mfs, lfs, gbar, S, T, B, ring,
          lanes_per_block, dconsts);
  return static_cast<int>(cudaGetLastError());
}

// The geometry words (ops/chirp_filter_grad.py::adjoint_geometry): the
// team (threads per lane, or per producer and chain warp) and rows (sigma
// points per member); producers = 0 selects the team design, producers K
// > 0 the chain design with a ring of `ring` steps a lane.
template <typename Real>
int launch(const Real* ys, const Real* xi, const Real* w,
           const Real* lane_consts, const Real* mfs, const Real* lfs,
           const Real* gbar, int S, int T, int B, int team, int rows,
           int producers, int ring, int lanes_per_block, Real* dconsts,
           void* stream) {
  if (S < 1 || S > kMaxPoints || T < 0 || B < 0 || lanes_per_block < 1 ||
      producers < 0 || ring < 0 ||
      (producers > 0 && team != kChainTeam))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
#define TEAM_LAUNCH(P, ROWS)                                                 \
  launch_team<Real, P, ROWS>(ys, xi, w, lane_consts, mfs, lfs, gbar, S, T, B, \
                             lanes_per_block, dconsts, s)
#define CHAIN_LAUNCH(ROWS, K)                                              \
  launch_chain<Real, ROWS, K>(ys, xi, w, lane_consts, mfs, lfs, gbar, S, T, \
                              B, ring, lanes_per_block, dconsts, s)
  // The instantiated (team, rows) and (rows, producers) pairs;
  // ops/chirp_filter_grad.py lists the same.
  switch (producers * 10000 + team * 100 + rows) {
    case 802: return TEAM_LAUNCH(8, 2);
    case 811: return TEAM_LAUNCH(8, 11);
    case 3201: return TEAM_LAUNCH(32, 1);
    case 3203: return TEAM_LAUNCH(32, 3);
    case 23201: return CHAIN_LAUNCH(1, 2);
    case 23203: return CHAIN_LAUNCH(3, 2);
    case 33203: return CHAIN_LAUNCH(3, 3);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CHAIN_LAUNCH
#undef TEAM_LAUNCH
}

}  // namespace

extern "C" {

int ghfs_chirp_filter_adjoint_num_consts() { return kNumConsts; }

int ghfs_chirp_filter_adjoint_f32(const float* ys, const float* xi,
                                  const float* w, const float* lane_consts,
                                  const float* mfs, const float* lfs,
                                  const float* gbar, int S, int T, int B,
                                  int team, int rows, int producers, int ring,
                                  int lanes_per_block, float* dconsts,
                                  void* stream) {
  return launch<float>(ys, xi, w, lane_consts, mfs, lfs, gbar, S, T, B, team,
                       rows, producers, ring, lanes_per_block, dconsts,
                       stream);
}

int ghfs_chirp_filter_adjoint_f64(const double* ys, const double* xi,
                                  const double* w, const double* lane_consts,
                                  const double* mfs, const double* lfs,
                                  const double* gbar, int S, int T, int B,
                                  int team, int rows, int producers, int ring,
                                  int lanes_per_block, double* dconsts,
                                  void* stream) {
  return launch<double>(ys, xi, w, lane_consts, mfs, lfs, gbar, S, T, B, team,
                        rows, producers, ring, lanes_per_block, dconsts,
                        stream);
}

}  // extern "C"
