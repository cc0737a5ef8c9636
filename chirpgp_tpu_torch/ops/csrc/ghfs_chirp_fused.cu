// Fused square-root Gauss-Hermite filter + smoother (GHFS) for the chirp LCD
// model, d = 4, measurement H = e_1: two kernels.
//
// Replaces no Pallas kernel: it replaces the XLA-compiled scans of
// chirpgp_tpu/infer/batched.py::sqrt_sgp_filter_smoother_batched, the JAX
// package's benchmarked fused form (bench.py's make_fused_slim), and
// computes what the plain twins in ops/chirp_fused.py compute:
//   F. fused_forward_kernel replaces the forward scan (batched.py:297-341):
//      per step the filter's prediction, the projected joint
//      triangularization that yields the smoother's gain and conditional
//      factor, the measurement update and the NLL.  Row t-1 of its
//      (T-1, 30, B) output, B minor, is what iteration t emits, the one
//      that smooths time t-1.  Maps mode writes the affine recursion's u
//      (4), G = X^T (16, row-major) and D = R22^T R22's upper triangle
//      (10, row by row), the nll and the last filtered moments; factor
//      mode writes m_p, X and R22's upper triangle, the packed row that
//      the smoother's phase B (ghfs_chirp_smoother.cu) reads, with every
//      filtered mean and factor and the nll.
//   G. affine_backward_kernel replaces the reverse scan of the covariance
//      branch (bstep_cov, batched.py:383-398): ms <- u + G ms, Ps <- D + G
//      Ps G^T from the last filtered moments, full (mss, Pss) or slim (the
//      mean and variance of one state).  The factor branch's backward pass
//      is phase B of the smoother, unchanged.
//
// The step of F, per lane, with m, L the filtered moments carried from the
// previous step: sigma points chi = m + L xi, the chirp-LCD means mu, m_p =
// sum w mu and dev = sqrt(w) (mu - m_p) (S x 4).  sqrt(w) xi = Q has
// orthonormal columns for every implemented rule, so the smoother's
// dev_prev = sqrt(w) (chi - m) = Q L^T, and the (S+4) x 8 joint pre-array
// [[dev, Q L^T], [Lq^T, 0]] has the Gram of the 12 x 8 array
//   [[E, 0], [A, L^T], [Lq^T, 0]],  A = Q^T dev (4 x 4),
// with E the triangular factor of dev - Q A.  Its triangular factor R
// (8 x 8) gives the prediction's Up = R11, the gain X = R11^-1 R12 and the
// conditional factor R22; then the filter's 1-D update of Up.
//
// What bounds them.  F: ~13.5k flop per seed-step at S = 81 (the filter's
// prediction, the projection A and dev - Q A, 64 flop per point, the S x 4
// and the 12 x 8 Householders, the gain and the maps; ops/chirp_fused.py::
// fused_cost), plus 3 transcendentals per sigma point, against 128 B per
// seed-step of least traffic in float32 (y read; the 30-word row and the
// nll written).  At B = 4096, T = 3141 that is ~173 GFLOP: compute-bound,
// ~2.6 ms at the 67 TFLOP/s float32 peak.  The T recursion is sequential,
// so below ~16k lanes the latency of one step's dependent chain, not the
// card's rate, sets the time, as for the filter kernel.  G: ~250 flop and
// 30 words read, 2 (slim) or 20 (full) written per seed-step: bound by its
// bytes, and in fact by the latency of its recursion (B lanes give B / 32
// warps).
//
// Design of F: the filter kernel's team (ghfs_chirp_filter.cu, whose note
// explains each choice).  A team of P = 8 or 32 threads per lane (a
// template constant; ops/chirp_filter.py::launch_geometry picks it and the
// blocks); member p owns the S rows p, p + P, ... of dev in registers
// (kRows of them, a template constant: those of cubature and GH-3, 1 and
// 11 at P = 8, 1 and 3 at P = 32) and computes chi, mu and dev of its own
// sigma points; m_p and the 16 sums of A are team reductions (__shfl_xor_
// sync butterflies); E is the filter's team Householder of dev - Q A
// (team_tria in chirp_lcd.cuh), so every member holds E.
// - The 12 x 8 joint array is spread over the team by columns, not rows:
//   member k < 8 holds column k (12 values), so nothing of it is held
//   whole by any thread (96 values: ~192 registers in float64).  For
//   column j, every member receives the column's live entries from member
//   j by __shfl_sync, computes the same norm, alpha = -sign(M_jj) |x|, v
//   and beta = 2 / |v|^2 (tria_cf's sign rule and arithmetic; skipped at
//   |v|^2 <= 1e-30), and reflects its own column: w_k = v^T M_k, M_k -=
//   beta v w_k.  No reduction is needed.  A member whose column is already
//   finished reflects only entries below its diagonal, which are never
//   read again, so the reflection needs no mask.  The structural zeros are
//   skipped with compile-time row sets (joint_row): E and Lq^T are upper
//   triangular (Lq is psd_cholesky's lower factor), so column j < 4 of the
//   array is live in rows j, 4..7 and 8..8+j only until its reflection,
//   and the zeros add exact zeros, so the result is that of the dense
//   reflections.
// - Afterwards member k holds column k of R: the 10 words of R11 are
//   broadcast (every member runs the measurement update on Up = R11, as the
//   filter kernel does), member 4 + c solves for column c of X by
//   back-substitution and, in maps mode, receives R22's columns for its
//   column of D, and stores its words of the row.
// - The last filtered moments (maps mode) or every step's (factor mode),
//   and the nll, are stored by member w % P for word w, as in the filter.
// Design of G: one thread per lane, blocks of one warp, so that a small
// batch spreads over the SMs; the 30 words of a step are copied kStages - 1
// steps ahead with cp.async into a ring in shared memory, so that no step
// waits on device memory (phase B's scheme, ghfs_chirp_smoother.cu).  A
// thread copies and then reads only its own lane's words, so no barrier is
// needed.  Ps is carried as its upper triangle; W = Ps G^T, then the upper
// triangle of G W.
//
// What is not used, and why: tensor cores (the per-lane products are 4
// wide; TF32 is barred by the port's precision policy), a Cholesky of the
// Gram in place of the Householder (it squares the condition number).
// Model constants in the filter's layout (ops/chirp_filter.py::
// _chirp_constants, float64 on the host).  No fast math.  Templated on
// float and double.  Registers and spills of each instance: phase 1 of
// chip_smoke.py prints ptxas's report.

#include <cuda_runtime.h>

#include <cstddef>

#include "chirp_lcd.cuh"

namespace {

constexpr int kJ = 3 * kD;        // rows of the joint array
constexpr int kJCols = 2 * kD;    // its columns
constexpr int kLastWords = kD + kD * kD;   // the last filtered m and L
constexpr int kStages = 4;        // G's ring of steps
constexpr int kBackLanes = 32;    // G's lanes per block

// Whether row r of the joint array [[E, 0], [A, L^T], [Lq^T, 0]] may be
// nonzero in column j when column j is reflected.  Before its own
// reflection, row r < 4 of E is zero left of its diagonal and untouched by
// the reflections of the columns before; row 8 + i of Lq^T (upper) is zero
// in the columns j < i until reflection i.  Columns 4.. are reached with
// rows 4..11 dense.
__host__ __device__ constexpr bool joint_row(int j, int r) {
  return j < kD ? (r == j || (r >= kD && r < 2 * kD) || (r >= 2 * kD && r - 2 * kD <= j))
                : r >= j;
}

// kRows: rows of dev a member owns, with P kRows >= S.  factors: write the
// factor mode's rows, mfs and lfs at every step; else the maps, and mfs
// and lfs at t = T-1 only (into their row 0).
template <typename Real, int P, int kRows>
__global__ void __launch_bounds__(kMaxThreads)
fused_forward_kernel(const Real* __restrict__ ys,    // (T, B)
                     const Real* __restrict__ xi_g,  // (S, kD)
                     const Real* __restrict__ w_g,   // (S,)
                     const Real* __restrict__ sw_g,  // (S,)
                     const ChirpConsts<Real> c, const int S, const int T,
                     const int B, const int lanes_per_block, const bool factors,
                     Real* __restrict__ rows,        // (T-1, kRowWords, B)
                     Real* __restrict__ mfs,         // (T or 1, kD, B)
                     Real* __restrict__ lfs,         // (T or 1, kD*kD, B)
                     Real* __restrict__ nll_out) {   // (T, B)
  __shared__ Real xi_s[kD][kMaxPoints];
  __shared__ Real q_s[kD][kMaxPoints];   // Q = sqrt(w) xi, transposed
  __shared__ Real w_s[kMaxPoints];
  __shared__ Real sw_s[kMaxPoints];
  __shared__ Real lqt_s[kD][kD];
  for (int i = threadIdx.x; i < S * kD; i += blockDim.x) {
    xi_s[i % kD][i / kD] = xi_g[i];
    q_s[i % kD][i / kD] = sw_g[i / kD] * xi_g[i];
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    w_s[i] = w_g[i];
    sw_s[i] = sw_g[i];
  }
  if (threadIdx.x == 0) {   // constant indices: c stays in parameter space
#pragma unroll
    for (int i = 0; i < kD * kD; ++i) lqt_s[i / kD][i % kD] = c.LqT[i / kD][i % kD];
  }
  __syncthreads();

  const int member = threadIdx.x % P;
  const int b = blockIdx.x * lanes_per_block + static_cast<int>(threadIdx.x) / P;
  if (b >= B) return;
  const unsigned mask = team_mask<P>();
  const size_t Bs = static_cast<size_t>(B);

  Real m[kD], L[kD][kD];   // L: lower triangle only
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    m[i] = c.m0[i];
#pragma unroll
    for (int j = 0; j <= i; ++j) L[i][j] = c.L0[i][j];
  }
  Real nll = Real(0);
  Real dev[kRows][kD];   // rows member + P*i of dev, then of dev - Q A

  for (int t = 0; t < T; ++t) {
    const Real y = ys[t * Bs + b];

    // Own sigma points and LCD means; m_p over the team.
    Real mp[kD];
    predict_rows<Real, P, kRows>(c, xi_s, w_s, S, member, m, L, dev, mp);
    team_sum<P>(mask, mp);

    // dev = sqrt(w) (mu - m_p) (rows past S: zero), and A = Q^T dev over
    // the team: A[p][k] = sum_s Q[s][p] dev[s][k].
    Real A[kD * kD];
#pragma unroll
    for (int k = 0; k < kD * kD; ++k) A[k] = Real(0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = member + P * i;
      const int s = r < S ? r : S - 1;
#pragma unroll
      for (int k = 0; k < kD; ++k)
        dev[i][k] = r < S ? sw_s[s] * (dev[i][k] - mp[k]) : Real(0);
#pragma unroll
      for (int p = 0; p < kD; ++p) {
        const Real q = r < S ? q_s[p][s] : Real(0);
#pragma unroll
        for (int k = 0; k < kD; ++k) A[p * kD + k] += q * dev[i][k];
      }
    }
    team_sum<P>(mask, A);

    // dev - Q A on the own rows, and its triangular factor E (every
    // member).
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = member + P * i;
      const int s = r < S ? r : S - 1;
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        Real qa = Real(0);
#pragma unroll
        for (int p = 0; p < kD; ++p) qa += (r < S ? q_s[p][s] : Real(0)) * A[p * kD + k];
        dev[i][k] -= qa;
      }
    }
    Real E[kD][kD];
    team_tria<Real, P>(mask, member, dev, E);

    // Member k < 8 takes column k of [[E, 0], [A, L^T], [Lq^T, 0]].
    Real col[kJ];
#pragma unroll
    for (int r = 0; r < kJ; ++r) col[r] = Real(0);
#pragma unroll
    for (int cc = 0; cc < kD; ++cc) {
      if (member == cc) {
#pragma unroll
        for (int r = 0; r <= cc; ++r) col[r] = E[r][cc];
#pragma unroll
        for (int r = 0; r < kD; ++r) col[kD + r] = A[r * kD + cc];
#pragma unroll
        for (int r = 0; r <= cc; ++r) col[2 * kD + r] = lqt_s[r][cc];
      } else if (member == kD + cc) {
#pragma unroll
        for (int r = 0; r <= cc; ++r) col[kD + r] = L[cc][r];
      }
    }

    // Householder triangularization of the joint array by columns.
#pragma unroll
    for (int j = 0; j < kJCols; ++j) {
      Real v[kJ];
      Real nrm2 = Real(0);
#pragma unroll
      for (int r = 0; r < kJ; ++r) {
        if (joint_row(j, r)) {
          v[r] = __shfl_sync(mask, col[r], j, P);
          nrm2 += v[r] * v[r];
        }
      }
      const Real norm = dsqrt(nrm2);
      const Real alpha = v[j] >= Real(0) ? -norm : norm;
      v[j] -= alpha;
      Real vn2 = Real(0), wk = Real(0);
#pragma unroll
      for (int r = 0; r < kJ; ++r) {
        if (joint_row(j, r)) {
          vn2 += v[r] * v[r];
          wk += v[r] * col[r];
        }
      }
      const Real beta = vn2 > Real(1e-30) ? two_over(vn2) : Real(0);
#pragma unroll
      for (int r = 0; r < kJ; ++r) {
        if (joint_row(j, r)) col[r] -= beta * v[r] * wk;
      }
    }

    // Up = R11 on every member; member 4 + c solves R11 x = column c of
    // R12 (x = column c of X).
    Real R11[kD][kD];
#pragma unroll
    for (int cc = 0; cc < kD; ++cc) {
#pragma unroll
      for (int r = 0; r <= cc; ++r) R11[r][cc] = __shfl_sync(mask, col[r], cc, P);
    }
    Real x[kD];
#pragma unroll
    for (int i = kD - 1; i >= 0; --i) {
      Real acc = col[i];
#pragma unroll
      for (int k = i + 1; k < kD; ++k) acc = acc - R11[i][k] * x[k];
      x[i] = acc / R11[i][i];
    }

    Real m_prev[kD];
#pragma unroll
    for (int k = 0; k < kD; ++k) m_prev[k] = m[k];
    measurement_update(c, R11, mp, y, m, L, nll);

    const size_t ts = static_cast<size_t>(t);
    if (t > 0) {   // the row that smooths time t-1
      Real* out = rows + (ts - 1) * kRowWords * Bs + b;
      if (factors) {
        // m_p, X (X[i][c] from member 4 + c), R22's upper triangle.
#pragma unroll
        for (int w = 0; w < kD; ++w)
          if (member == w) out[w * Bs] = mp[w];
#pragma unroll
        for (int cc = 0; cc < kD; ++cc) {
          if (member == kD + cc) {
#pragma unroll
            for (int i = 0; i < kD; ++i) out[(kXWord + i * kD + cc) * Bs] = x[i];
#pragma unroll
            for (int r = 0; r <= cc; ++r) out[r22_word(r, cc) * Bs] = col[kD + r];
          }
        }
      } else {
        // R22's columns, r22[i][k] = R22[k][i] for k <= i, on every member.
        Real r22[kD][kD];
#pragma unroll
        for (int i = 0; i < kD; ++i) {
#pragma unroll
          for (int k = 0; k <= i; ++k) r22[i][k] = __shfl_sync(mask, col[kD + k], kD + i, P);
        }
        // Member 4 + c: u[c] = m_prev[c] - sum_j G[c][j] m_p[j], row c of
        // G (= x), column c of D's upper triangle.
#pragma unroll
        for (int cc = 0; cc < kD; ++cc) {
          if (member == kD + cc) {
            Real gm = Real(0);
#pragma unroll
            for (int j = 0; j < kD; ++j) gm += x[j] * mp[j];
            out[cc * Bs] = m_prev[cc] - gm;
#pragma unroll
            for (int j = 0; j < kD; ++j) out[(kXWord + cc * kD + j) * Bs] = x[j];
#pragma unroll
            for (int i = 0; i <= cc; ++i) {
              Real d = Real(0);
#pragma unroll
              for (int k = 0; k <= i; ++k) d += r22[i][k] * col[kD + k];
              out[r22_word(i, cc) * Bs] = d;
            }
          }
        }
      }
    }

    // Member p writes the words w with w % P == p: m and L of this step
    // (factor mode) or of the last (maps mode, into row 0), and the nll.
    const bool moments = factors || t == T - 1;
    const size_t to = factors ? ts : 0;
#pragma unroll
    for (int w = 0; w < kLastWords + 1; ++w) {
      if (w % P != member) continue;
      if (w < kD) {
        if (moments) mfs[(to * kD + w) * Bs + b] = m[w];
      } else if (w < kLastWords) {
        const int i = (w - kD) / kD, j = (w - kD) % kD;
        if (moments) lfs[(to * kD * kD + (w - kD)) * Bs + b] = j <= i ? L[i][j] : Real(0);
      } else {
        nll_out[ts * Bs + b] = nll;
      }
    }
  }
}

// G: one thread per lane.  slim: write ms[out_index] and Ps[out_index]
// [out_index] of every step into (T, B) out_m and out_p; else ms into
// (T, kD, B) out_m and the whole Ps into (T, kD*kD, B) out_p.
template <typename Real, bool kSlim>
__global__ void __launch_bounds__(kBackLanes)
affine_backward_kernel(const Real* __restrict__ rows,    // (T-1, kRowWords, B)
                       const Real* __restrict__ mf,      // (kD, B), time T-1
                       const Real* __restrict__ lf,      // (kD*kD, B), time T-1
                       const int T, const int B, const int out_index,
                       Real* __restrict__ out_m, Real* __restrict__ out_p) {
  // Step t's row sits in ring[t % kStages].
  __shared__ Real ring[kStages][kRowWords][kBackLanes];
  const int lane = threadIdx.x;
  const int b = blockIdx.x * kBackLanes + lane;
  if (b >= B || T < 1) return;
  const size_t Bs = static_cast<size_t>(B);

  auto fetch = [&](int t) {
    const size_t ts = static_cast<size_t>(t);
    Real(*slot)[kBackLanes] = ring[t % kStages];
#pragma unroll
    for (int w = 0; w < kRowWords; ++w)
      copy_async(&slot[w][lane], &rows[(ts * kRowWords + w) * Bs + b]);
  };
  // Ps[i][j] for j >= i; the lower triangle mirrors it.
  auto store = [&](int t, const Real(&ms)[kD], const Real(&Ps)[kD][kD]) {
    const size_t ts = static_cast<size_t>(t);
    if (kSlim) {
      Real vm = Real(0), vv = Real(0);
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        if (k == out_index) {
          vm = ms[k];
          vv = Ps[k][k];
        }
      }
      out_m[ts * Bs + b] = vm;
      out_p[ts * Bs + b] = vv;
    } else {
#pragma unroll
      for (int i = 0; i < kD; ++i) {
        out_m[(ts * kD + i) * Bs + b] = ms[i];
#pragma unroll
        for (int j = 0; j < kD; ++j)
          out_p[(ts * kD * kD + i * kD + j) * Bs + b] = j >= i ? Ps[i][j] : Ps[j][i];
      }
    }
  };

  // The first kStages - 1 steps in flight, one group each (empty past t = 0).
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (T - 2 - s >= 0) fetch(T - 2 - s);
    copy_commit();
  }

  // The last filtered moments: ms = mf, Ps = Lf Lf^T.
  Real ms[kD], Ps[kD][kD];
  {
    Real Lf[kD][kD];
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      ms[i] = mf[i * Bs + b];
#pragma unroll
      for (int j = 0; j <= i; ++j) Lf[i][j] = lf[(i * kD + j) * Bs + b];
    }
#pragma unroll
    for (int i = 0; i < kD; ++i) {
#pragma unroll
      for (int j = i; j < kD; ++j) {
        Real acc = Real(0);
#pragma unroll
        for (int k = 0; k <= i; ++k) acc += Lf[i][k] * Lf[j][k];
        Ps[i][j] = acc;
      }
    }
  }
  store(T - 1, ms, Ps);

  for (int t = T - 2; t >= 0; --t) {
    if (t - (kStages - 1) >= 0) fetch(t - (kStages - 1));
    copy_commit();
    copy_wait<kStages - 1>();   // step t's group has landed
    const Real(*slot)[kBackLanes] = ring[t % kStages];
    Real G[kD][kD];
#pragma unroll
    for (int i = 0; i < kD; ++i) {
#pragma unroll
      for (int j = 0; j < kD; ++j) G[i][j] = slot[kXWord + i * kD + j][lane];
    }
    // ms <- u + G ms.
    Real mn[kD];
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      Real acc = Real(0);
#pragma unroll
      for (int j = 0; j < kD; ++j) acc += G[i][j] * ms[j];
      mn[i] = slot[i][lane] + acc;
    }
    // W = Ps G^T, then Ps <- D + G W (upper triangle).
    Real W[kD][kD];
#pragma unroll
    for (int i = 0; i < kD; ++i) {
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        Real acc = Real(0);
#pragma unroll
        for (int k = 0; k < kD; ++k) acc += (k >= i ? Ps[i][k] : Ps[k][i]) * G[j][k];
        W[i][j] = acc;
      }
    }
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      ms[i] = mn[i];
#pragma unroll
      for (int j = i; j < kD; ++j) {
        Real acc = Real(0);
#pragma unroll
        for (int k = 0; k < kD; ++k) acc += G[i][k] * W[k][j];
        Ps[i][j] = slot[r22_word(i, j)][lane] + acc;
      }
    }
    store(t, ms, Ps);
  }
}

template <typename Real, int P, int kRows>
int launch_forward_team(const Real* ys, const Real* xi, const Real* w,
                        const Real* sw, const ChirpConsts<Real>& c, int S,
                        int T, int B, int lanes_per_block, bool factors,
                        Real* rows, Real* mfs, Real* lfs, Real* nll,
                        cudaStream_t stream) {
  if (lanes_per_block < 1 || P * lanes_per_block > kMaxThreads ||
      S > P * kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int blocks = (B + lanes_per_block - 1) / lanes_per_block;
  fused_forward_kernel<Real, P, kRows><<<blocks, P * lanes_per_block, 0, stream>>>(
      ys, xi, w, sw, c, S, T, B, lanes_per_block, factors, rows, mfs, lfs, nll);
  return static_cast<int>(cudaGetLastError());
}

template <typename Real>
int launch_forward(const Real* ys, const Real* xi, const Real* w,
                   const Real* sw, const double* consts, int S, int T, int B,
                   int team, int rows_per_member, int lanes_per_block,
                   int factors, Real* rows, Real* mfs, Real* lfs, Real* nll,
                   void* stream) {
  if (S < 1 || S > kMaxPoints || T < 1 || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ChirpConsts<Real> c = load_consts<Real>(consts);
  const auto s = static_cast<cudaStream_t>(stream);
  // The instantiated (team, rows) pairs; ops/chirp_fused.py::ROWS lists
  // the same.
#define FUSED_LAUNCH(P, ROWS)                                                  \
  launch_forward_team<Real, P, ROWS>(ys, xi, w, sw, c, S, T, B,               \
                                     lanes_per_block, factors != 0, rows, mfs, \
                                     lfs, nll, s)
  switch (team * 100 + rows_per_member) {
    case 801: return FUSED_LAUNCH(8, 1);
    case 811: return FUSED_LAUNCH(8, 11);
    case 3201: return FUSED_LAUNCH(32, 1);
    case 3203: return FUSED_LAUNCH(32, 3);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FUSED_LAUNCH
}

template <typename Real>
int launch_backward(const Real* rows, const Real* mf, const Real* lf, int T,
                    int B, int out_index, Real* out_m, Real* out_p,
                    void* stream) {
  if (T < 1 || B < 0 || out_index < -1 || out_index >= kD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int blocks = (B + kBackLanes - 1) / kBackLanes;
  const auto s = static_cast<cudaStream_t>(stream);
  if (out_index >= 0) {
    affine_backward_kernel<Real, true><<<blocks, kBackLanes, 0, s>>>(
        rows, mf, lf, T, B, out_index, out_m, out_p);
  } else {
    affine_backward_kernel<Real, false><<<blocks, kBackLanes, 0, s>>>(
        rows, mf, lf, T, B, out_index, out_m, out_p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ghfs_chirp_fused_max_points() { return kMaxPoints; }

int ghfs_chirp_fused_num_consts() { return kNumConsts; }

int ghfs_chirp_fused_row_words() { return kRowWords; }

int fused_forward_f32(const float* ys, const float* xi, const float* w,
                      const float* sw, const double* consts, int S, int T,
                      int B, int team, int rows_per_member, int lanes_per_block,
                      int factors, float* rows, float* mfs, float* lfs,
                      float* nll, void* stream) {
  return launch_forward<float>(ys, xi, w, sw, consts, S, T, B, team,
                               rows_per_member, lanes_per_block, factors, rows,
                               mfs, lfs, nll, stream);
}

int fused_forward_f64(const double* ys, const double* xi, const double* w,
                      const double* sw, const double* consts, int S, int T,
                      int B, int team, int rows_per_member, int lanes_per_block,
                      int factors, double* rows, double* mfs, double* lfs,
                      double* nll, void* stream) {
  return launch_forward<double>(ys, xi, w, sw, consts, S, T, B, team,
                                rows_per_member, lanes_per_block, factors, rows,
                                mfs, lfs, nll, stream);
}

int affine_backward_f32(const float* rows, const float* mf, const float* lf,
                        int T, int B, int out_index, float* out_m,
                        float* out_p, void* stream) {
  return launch_backward<float>(rows, mf, lf, T, B, out_index, out_m, out_p,
                                stream);
}

int affine_backward_f64(const double* rows, const double* mf, const double* lf,
                        int T, int B, int out_index, double* out_m,
                        double* out_p, void* stream) {
  return launch_backward<double>(rows, mf, lf, T, B, out_index, out_m, out_p,
                                 stream);
}

}  // extern "C"
