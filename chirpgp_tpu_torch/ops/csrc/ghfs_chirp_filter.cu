// Fused square-root Gauss-Hermite filter (GHFS) for the chirp LCD model,
// d = 4, measurement H = e_1 (the second state component).
//
// Replaces the TPU kernel
//   chirpgp_tpu/experimental/pallas_filter.py::ghfs_chirp_filter_pallas
// and computes what the plain PyTorch version
//   chirpgp_tpu_torch/infer/batched.py::sqrt_sgp_filter_batched
// computes for the chirp model: per step, sigma points chi = m + xi L, the
// chirp-LCD mean (softplus frequency, rotation with decay e^{-lam dt},
// Matern-3/2 2x2 step), the weighted mean, a Householder triangularization
// of the (S+4) x 4 pre-array [sqrt(w)(mu - mp); Lq^T], a 5 x 5 update
// triangularization, the innovation and the cumulative NLL.
//
// What bounds it.  Per seed-step ~7.2k flop at S = 81, counted as the
// step needs them (ops/chirp_filter.py::filter_cost): chi with L lower
// 1.6k, LCD mean 1.4k, weighted mean and deviations 1.3k, the Householder
// Gram rows and rank-one updates on 85 x 4 2.75k, the 5 x 5 update 0.1k;
// plus 3 transcendentals per sigma point, against 88 B of traffic in
// float32 (one y read; 4 + 16 + 1 words written).  At B = 4096, T = 3141
// that is 92.2 GFLOP and 1.13 GB: compute-bound, 1.38 ms at the
// 67 TFLOP/s float32 peak (2.71 ms at 34 TFLOP/s in float64), 0.34 ms of
// bytes.  The T recursion is sequential, so the only parallelism is across
// lanes and across the sigma points of one step; below ~16k lanes the
// latency of one step's dependent chain, not the card's rate, sets the
// time.
//
// Design: a team of P threads per Monte-Carlo lane (P = 8 or 32, a
// template constant; the wrapper picks it and the launch geometry).  It
// replaces a design of one thread per lane, and what it does about that
// design's limits:
// 1. Latency.  One thread per lane gave 4096 threads at B = 4096, one warp
//    per scheduler on 32 of 132 SMs, and every dependent FMA and local load
//    stalled.  Here a lane's S sigma points are spread over P threads: at
//    P = 32, B = 100 is 100 warps on 100 SMs, each carrying 3 sigma points
//    per thread; at P = 8, B = 4096 is 1024 warps, ~8 per SM.  A member's
//    rows are computed without a branch (slots past S at weight 0) and the
//    rotation uses sincospi, whose argument reduction is exact and has no
//    slow path, so the rows' independent chains interleave.
// 2. Local memory.  The (S+4) x 4 pre-array lives in registers, spread over
//    the team: member p owns rows p, p + P, p + 2P, ... (kRows of them,
//    a template constant); it computes chi, the LCD mean and the deviation
//    of its own sigma points.  The Lq^T rows S..S+3 fall to fixed members;
//    rows past S+4 hold zeros and add nothing.  kRows is the smallest of a
//    few instantiated counts with P kRows >= S + 4, those of cubature and
//    GH-3: at P = 8, 2 and 11; at P = 32, 1 and 3.  So cubature does the
//    work of its own rows, not GH-3's.  Nothing is indexed at run time:
//    ptxas reports no stack frame at all.
// 3. Long sequential sums.  Column j of the Householder triangularization
//    needs the partial Gram row G_jk = sum_{r >= j} M_rj M_rk (k >= j): one
//    team reduction (a __shfl_xor_sync butterfly over log2 P levels, every
//    member ends with the sum) of 4 - j values.  With alpha = -sign(M_jj)
//    |x| (the sign rule of tria_cf and _tria_cols; M_jj broadcast from its
//    owner), |v|^2 = 2 (G_jj - alpha M_jj), with no cancellation since
//    -alpha M_jj >= 0, and w_k = G_jk - alpha M_jk; each member then
//    reflects columns k > j of its own rows (column j is not read again).
//    10 reduced values per step (plus the 4 of the weighted mean) replace
//    three sequential passes over 85 rows per column, and each sum is a
//    few rows per member, then a pairwise tree.
//    Reflections with |v|^2 <= 1e-30 are skipped, as in tria_cf.
//    IEEE addition commutes, so every member of a butterfly gets the same
//    bits, and the redundant work below gives the same m, L and nll on all.
// 4. Time that does not fall with B.  The wrapper spreads small batches one
//    lane per block over the SMs and packs large ones into one-warp blocks
//    (ops/chirp_filter.py::launch_geometry); it takes P = 32 up to 16
//    lanes per SM and P = 8, which repeats less work per lane, beyond.
//    The kernel checks the geometry it is given.
// - Row j of R is computed by every member from the broadcast row j and
//   the reduced w: R_jk = M_jk - beta (M_jj - alpha) w_k, the owner's own
//   arithmetic.  The 5 x 5 update array is then built and triangularized
//   by every member in registers; its structural zeros are skipped (they
//   add exact zeros, so the result is that of the dense reflections).
// - Every member of a team loads the same y (one transaction per warp).
//   Member p stores the output words w with w % P == p (mfs[t, i, b],
//   lfs[t, i*4+j, b], nll[t, b], b minor).
// - A team whose lane is >= B leaves after the sigma table is loaded.
//   Teams never straddle a warp, and every shuffle names only its team's
//   threads in its mask, so no live thread waits on one that has left.
// - The sigma-point table (xi transposed to 4 x S, w, sqrt(w)) and Lq^T
//   are loaded into shared memory once per block; consecutive members read
//   consecutive words.  S is capped at kMaxPoints = 81 (GH-3 at d = 4).
// - Softplus is the stable max(x, 0) + log1p(exp(-|x|)).  No fast math.
//   Model constants are kernel arguments, computed in float64 on the host
//   and cast to Real.  Templated on float and double; the double instance
//   is an on-card oracle.
// - Per-lane instances (kPerLane; ops/chirp_filter_grad.py, the Table-I
//   sweep objective): lane b's constants are row b of a (B, kNumConsts)
//   tensor on the card (each team loads its own, its Lq^T into its slot of
//   shared memory), and only the final NLL is written, (B,); the means and
//   factors are written as above for the adjoint kernel
//   (ghfs_chirp_filter_adjoint.cu).  Together with it they replace the JAX
//   package's chirpgp_tpu/infer/sqrt.py::sqrt_sgp_filter under
//   jax.value_and_grad.  The one-theta instances are unchanged.

#include <cuda_runtime.h>

#include <cstddef>

#include "chirp_lcd.cuh"

namespace {

// One lane's filter, run by its team: the constants c (kernel
// parameters, or the lane's own row), lqt its Lq^T in shared memory.
// kPerLane: write the final nll only (nll_out (B,)), else every step's
// cumulative nll (nll_out (T, B)).
template <typename Real, int P, int kRows, bool kPerLane>
__device__ __forceinline__ void filter_lane(
    const ChirpConsts<Real>& c, const Real (&lqt)[kD][kD],
    const Real (&xi_s)[kD][kMaxPoints], const Real (&w_s)[kMaxPoints],
    const Real (&sw_s)[kMaxPoints], const Real* __restrict__ ys,
    const int member, const int b, const int S, const int T, const int B,
    Real* __restrict__ mfs, Real* __restrict__ lfs,
    Real* __restrict__ nll_out) {
  const unsigned mask = team_mask<P>();
  const size_t Bs = static_cast<size_t>(B);
  const int n = S + kD;

  Real m[kD], L[kD][kD];   // L: lower triangle only
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    m[i] = c.m0[i];
#pragma unroll
    for (int j = 0; j <= i; ++j) L[i][j] = c.L0[i][j];
  }
  Real nll = Real(0);
  Real pre[kRows][kD];   // rows member + P*i of the pre-array

  for (int t = 0; t < T; ++t) {
    const Real y = ys[t * Bs + b];

    // Own sigma points, chirp-LCD mean, weighted mean over the team.
    Real mp[kD];
    predict_rows<Real, P, kRows>(c, xi_s, w_s, S, member, m, L, pre, mp);
    team_sum<P>(mask, mp);

    // Own rows of the pre-array [sqrt(w)(mu - mp); Lq^T; 0].
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = member + P * i;
      const int s = r < S ? r : S - 1;
      const int q = r < S ? 0 : (r - S < kD ? r - S : kD - 1);
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        const Real lq = r < n ? lqt[q][k] : Real(0);
        pre[i][k] = r < S ? sw_s[s] * (pre[i][k] - mp[k]) : lq;
      }
    }

    // Householder triangularization, one team reduction per column: Up =
    // R, the upper factor of the prediction, on every member; then the
    // measurement update.
    Real R[kD][kD];
    team_tria<Real, P>(mask, member, pre, R);
    measurement_update(c, R, mp, y, m, L, nll);

    // Member p writes the words w with w % P == p.
    const size_t ts = static_cast<size_t>(t);
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      if (w % P != member) continue;
      if (w < kD) {
        mfs[(ts * kD + w) * Bs + b] = m[w];
      } else if (w < kD + kD * kD) {
        const int i = (w - kD) / kD, j = (w - kD) % kD;
        lfs[(ts * kD * kD + (w - kD)) * Bs + b] = j <= i ? L[i][j] : Real(0);
      } else if (!kPerLane) {
        nll_out[ts * Bs + b] = nll;
      }
    }
  }
  if (kPerLane && member == 0) nll_out[b] = nll;
}

// kRows: pre-array rows a member owns, with P kRows >= S + kD.
// kPerLane: lane b's constants are row b of lane_consts (B, kNumConsts),
// and c is not read; else every lane's are c.
template <typename Real, int P, int kRows, bool kPerLane>
__global__ void __launch_bounds__(kMaxThreads)
ghfs_chirp_filter_kernel(const Real* __restrict__ ys,    // (T, B)
                         const Real* __restrict__ xi_g,  // (S, kD)
                         const Real* __restrict__ w_g,   // (S,)
                         const Real* __restrict__ sw_g,  // (S,)
                         const ChirpConsts<Real> c,
                         const Real* __restrict__ lane_consts,
                         const int S, const int T, const int B,
                         const int lanes_per_block,
                         Real* __restrict__ mfs,         // (T, kD, B)
                         Real* __restrict__ lfs,         // (T, kD*kD, B)
                         Real* __restrict__ nll_out) {   // (T, B) or (B,)
  __shared__ Real xi_s[kD][kMaxPoints];
  __shared__ Real w_s[kMaxPoints];
  __shared__ Real sw_s[kMaxPoints];
  __shared__ Real lqt_s[kPerLane ? kMaxThreads / 8 : 1][kD][kD];
  for (int i = threadIdx.x; i < S * kD; i += blockDim.x)
    xi_s[i % kD][i / kD] = xi_g[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    w_s[i] = w_g[i];
    sw_s[i] = sw_g[i];
  }
  const int member = threadIdx.x % P;
  const int slot = static_cast<int>(threadIdx.x) / P;
  const int b = blockIdx.x * lanes_per_block + slot;
  if constexpr (kPerLane) {
    for (int i = member; i < kD * kD; i += P)
      lqt_s[slot][i / kD][i % kD] =
          b < B ? lane_consts[static_cast<size_t>(b) * kNumConsts +
                              kLqTWord + i]
                : Real(0);
  } else if (threadIdx.x == 0) {   // constant indices: c stays in parameter space
#pragma unroll
    for (int i = 0; i < kD * kD; ++i) lqt_s[0][i / kD][i % kD] = c.LqT[i / kD][i % kD];
  }
  __syncthreads();

  if (b >= B) return;
  if constexpr (kPerLane) {
    const ChirpConsts<Real> lane = load_consts<Real>(
        lane_consts + static_cast<size_t>(b) * kNumConsts);
    filter_lane<Real, P, kRows, true>(lane, lqt_s[slot], xi_s, w_s, sw_s, ys,
                                      member, b, S, T, B, mfs, lfs, nll_out);
  } else {
    filter_lane<Real, P, kRows, false>(c, lqt_s[0], xi_s, w_s, sw_s, ys,
                                       member, b, S, T, B, mfs, lfs, nll_out);
  }
}

template <typename Real, int P, int kRows, bool kPerLane>
int launch_team(const Real* ys, const Real* xi, const Real* w, const Real* sw,
                const ChirpConsts<Real>& c, const Real* lane_consts, int S,
                int T, int B, int lanes_per_block, Real* mfs, Real* lfs,
                Real* nll, cudaStream_t stream) {
  if (lanes_per_block < 1 || P * lanes_per_block > kMaxThreads ||
      S + kD > P * kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0 || B == 0) return 0;
  const int blocks = (B + lanes_per_block - 1) / lanes_per_block;
  ghfs_chirp_filter_kernel<Real, P, kRows, kPerLane>
      <<<blocks, P * lanes_per_block, 0, stream>>>(
          ys, xi, w, sw, c, lane_consts, S, T, B, lanes_per_block, mfs, lfs,
          nll);
  return static_cast<int>(cudaGetLastError());
}

// consts: the host's float64 constants of every lane, or nullptr with
// lane_consts (B, kNumConsts) on the card, one row per lane.
template <typename Real>
int launch(const Real* ys, const Real* xi, const Real* w, const Real* sw,
           const double* consts, const Real* lane_consts, int S, int T, int B,
           int team, int rows, int lanes_per_block, Real* mfs, Real* lfs,
           Real* nll, void* stream) {
  if (S < 1 || S > kMaxPoints || T < 0 || B < 0 ||
      (consts == nullptr) == (lane_consts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ChirpConsts<Real> c =
      consts != nullptr ? load_consts<Real>(consts) : ChirpConsts<Real>{};
  const auto s = static_cast<cudaStream_t>(stream);
  // The instantiated (team, rows) pairs; ops/chirp_filter.py::ROWS lists
  // the same.
#define GHFS_LAUNCH(P, ROWS)                                                 \
  (lane_consts != nullptr                                                    \
       ? launch_team<Real, P, ROWS, true>(ys, xi, w, sw, c, lane_consts, S,  \
                                          T, B, lanes_per_block, mfs, lfs,   \
                                          nll, s)                            \
       : launch_team<Real, P, ROWS, false>(ys, xi, w, sw, c, lane_consts, S, \
                                           T, B, lanes_per_block, mfs, lfs,  \
                                           nll, s))
  switch (team * 100 + rows) {
    case 802: return GHFS_LAUNCH(8, 2);
    case 811: return GHFS_LAUNCH(8, 11);
    case 3201: return GHFS_LAUNCH(32, 1);
    case 3203: return GHFS_LAUNCH(32, 3);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GHFS_LAUNCH
}

}  // namespace

extern "C" {

int ghfs_chirp_filter_max_points() { return kMaxPoints; }

int ghfs_chirp_filter_num_consts() { return kNumConsts; }

int ghfs_chirp_filter_max_threads() { return kMaxThreads; }

int ghfs_chirp_filter_f32(const float* ys, const float* xi, const float* w,
                          const float* sw, const double* consts, int S, int T,
                          int B, int team, int rows, int lanes_per_block,
                          float* mfs, float* lfs, float* nll, void* stream) {
  return launch<float>(ys, xi, w, sw, consts, nullptr, S, T, B, team, rows,
                       lanes_per_block, mfs, lfs, nll, stream);
}

int ghfs_chirp_filter_f64(const double* ys, const double* xi, const double* w,
                          const double* sw, const double* consts, int S, int T,
                          int B, int team, int rows, int lanes_per_block,
                          double* mfs, double* lfs, double* nll, void* stream) {
  return launch<double>(ys, xi, w, sw, consts, nullptr, S, T, B, team, rows,
                        lanes_per_block, mfs, lfs, nll, stream);
}

// One parameter vector per lane: lane_consts (B, kNumConsts) on the card,
// nll (B,) the final NLL.
int ghfs_chirp_filter_lanes_f32(const float* ys, const float* xi,
                                const float* w, const float* sw,
                                const float* lane_consts, int S, int T, int B,
                                int team, int rows, int lanes_per_block,
                                float* mfs, float* lfs, float* nll,
                                void* stream) {
  return launch<float>(ys, xi, w, sw, nullptr, lane_consts, S, T, B, team,
                       rows, lanes_per_block, mfs, lfs, nll, stream);
}

int ghfs_chirp_filter_lanes_f64(const double* ys, const double* xi,
                                const double* w, const double* sw,
                                const double* lane_consts, int S, int T, int B,
                                int team, int rows, int lanes_per_block,
                                double* mfs, double* lfs, double* nll,
                                void* stream) {
  return launch<double>(ys, xi, w, sw, nullptr, lane_consts, S, T, B, team,
                        rows, lanes_per_block, mfs, lfs, nll, stream);
}

}  // extern "C"
