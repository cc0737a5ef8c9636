// Square-root Gauss-Hermite smoother (GHFS) for the chirp LCD model, d = 4,
// with the Gauss-Hermite expectation of g(V) = softplus(V) of every step.
//
// Replaces no Pallas kernel: it replaces the XLA-compiled reverse lax.scan
// of chirpgp_tpu/infer/batched.py:152 (sqrt_sgp_smoother_batched) and the
// expectation of :546 (gaussian_expectation_batched) on the JAX package's
// main path, apps/pipeline.py::estimate_if_batched.  It computes what the
// plain PyTorch versions chirpgp_tpu_torch/infer/batched.py::
// sqrt_sgp_smoother_batched and smoothed_expectation_batched compute for
// the chirp model, from the filter kernel's outputs as they are (mfs
// (T, 4, B), Lfs (T, 4, 4, B) lower, B minor).  Per step, from t = T-2
// down to 0, with ms and Ls carried from t+1: sigma points chi = mf + xi
// Lf, the chirp-LCD mean mu, m_p = sum w mu, a Householder
// triangularization of the (S+4) x 8 joint pre-array
//   [[sqrt(w)(mu - m_p), sqrt(w)(chi - mf)], [Lq^T, 0]]  ->  R (8 x 8),
// the gain G = X^T with X = R11^-1 R12 by back-substitution, ms <- mf +
// G (ms - m_p), Ls <- tria([(G Ls)^T; R22])^T, and E[g(V)] with V ~
// N(ms[kV], sum_k Ls[kV][k]^2) by the order-K Gauss-Hermite rule (kV = 2,
// the chirp model's frequency state, in chirp_lcd.cuh).
//
// The split.  Only three operations of a step read the carry (ms_{t+1},
// Ls_{t+1}): the mean update, G Ls and the 8 x 4 triangularization.  The
// rest -- the sigma points, the LCD means, m_p, the (S+4) x 8 Householder,
// X and R22, ~15.7k of the ~16.4k flop of a step at S = 81 -- depends on
// the filter's (mf_t, Lf_t) alone.  So the smoother runs as three phases,
// five kernels, in one wrapper call (three where C = 1 below), the count
// whatever T is:
//   A. smoother_rows_kernel, parallel over (t, lane): for t = 0..T-2 the
//      30 words m_p (4), X (16, row-major) and R22's upper triangle (10,
//      row by row) into a (T-1, 30, B) scratch, B minor (the packed rows
//      of the JAX package's fused form, infer/batched.py:297-337);
//   B. the short recursion ms <- mf + X^T (ms - m_p), Ls <- tria([(X^T
//      Ls)^T; R22])^T, the factor branch's bstep (infer/batched.py:
//      349-365), writing mss and Lss, as a chunked square-root scan over
//      time in three kernels: smoother_compose_kernel composes the steps
//      of each of C chunks into one step of the same packing, parallel
//      over (chunk, lane); smoother_carry_kernel runs the recursion over
//      the C-1 aggregates, one thread per lane, for the carry at each
//      chunk's later end; smoother_backward_kernel (Apply) runs each
//      chunk's steps from its carry, parallel over (chunk, lane).  With
//      C = 1 Apply alone is the whole recursion;
//   E. smoother_expect_kernel, parallel over (t, lane): E[g(V)] from the
//      stored ms[kV] and row kV of Ls.  Its second input mode,
//      smoother_expect_var_kernel, reads a (T, B) mean and variance of V
//      as they are (the fused filter+smoother's slim output,
//      ghfs_chirp_fused.cu): the counterpart of bench.py's
//      gaussian_expectation_batched(v_mean, sqrt(max(v_var, 0)), g).
// The wrapper (ops/chirp_smoother.py) allocates the scratch (phase A's
// rows, phase B's aggregates and carries) with torch.empty and, where (T-1)
// x 30 x B words pass its cap, runs A and B over slabs of lanes.
//
// What bounds it.  The least work of a step (ops/chirp_smoother.py::
// smoother_cost) is that of the projected form: a rule exact to degree two
// has sum w xi xi^T = I, so sqrt(w) xi has orthonormal columns Q, sqrt(w)
// (chi - mf) = Q Lf^T, and the same R comes from C = Q^T dev_pred, E =
// dev_pred - Q C, a triangularization of the S x 4 array E and one of the
// 12 x 8 array [[C, Lf^T], [R_E, 0], [Lq^T, 0]]: ~14.3k flop per seed-step
// at S = 81.  Phase A runs the full (S+4) x 8 form (~16.4k with the
// tail).  Besides, 3 transcendentals per sigma point and 2 per GH node,
// against 164 B of least traffic in float32 (4 + 16 words read, 4 + 16 + 1
// written).  At B = 4096, T = 3141 that is ~184 GFLOP and 2.1 GB:
// compute-bound, 2.75 ms at the 67 TFLOP/s float32 peak.  The scratch is
// the kernel's own traffic (120 B written and read per seed-step in
// float32, 1.5 GB each way at that shape, ~0.9 ms at 3.35 TB/s); the
// bound does not count it.
// - Phase A has 12.9M lane-steps to spread at that shape and is bound by
//   instruction issue: its float32 instance is ~7.1k SASS instructions
//   per lane-step of a team (measured on an H100: more warps per SM, the
//   butterflies' shuffles and the block size do not move it).  It keeps
//   the filter kernel's team (ghfs_chirp_filter.cu, whose note explains
//   each choice): kTeam = 8 threads per lane-step (8 was faster than 16
//   and 32 at B = 100 and 4096, in float32 and float64), member p owning
//   rows p, p + 8, ... (kRows of them, a template constant) of the
//   pre-array in registers and
//   computing chi, mu and both deviations of its own sigma points; column
//   j of the Householder is one __shfl_xor_sync butterfly of the partial
//   Gram row, alpha = -sign(M_jj) |x| (tria_cf's sign rule), reflections
//   with |v|^2 <= 1e-30 skipped.  Row j is owned by member j, which
//   broadcasts it; every member builds the rows of R from the broadcast
//   rows and the reduced w, and solves for the one column of X whose
//   words it stores (member p stores the words w with w % kTeam == p,
//   and kTeam is a multiple of 4).  The work is spread over t, so there
//   is no carry and nothing to wait on: the grid holds as many blocks of
//   kRowsThreads as
//   the SMs take at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
//   which sizes it by the instance's registers), and each team walks the
//   (t, lane) items with a grid stride, lanes minor, so a warp's loads and
//   stores fall on neighbouring lanes.  The sigma table and Lq^T are
//   loaded into shared memory once per block.
// - Phase B's step is a dependent chain (G Ls, then the 8 x 4
//   triangularization with its 4 IEEE sqrts and divisions in series) that
//   more threads per lane cannot shorten.  Run once per step over T, it
//   took ~0.9 us a step on an H100 whatever B (2.8 ms at B = 100 and at B
//   = 4096: B / 32 one-warp blocks keep one scheduler in four busy).  The
//   time axis is the parallelism left: the step is an affine map with
//   Gaussian noise, and two such maps compose into one of the same form
//   (the JAX package's covariance-form _combine_smoother, infer/
//   parallel_kf.py:229).  In square-root form the composition is phase
//   B's own step: for a chunk of steps t0..t1-1, Compose walks t = t1-1 ..
//   t0 with the mean c from x_ref = mf_t1 (the filtered mean, so that c
//   stays on the smoothed mean's scale: from 0 the mean would form mf -
//   X^T m_p, which cancels in float32), the factor S from 0 and A <- X^T
//   A from I, and ms_t0 = c + A (ms_t1 - x_ref), Ls_t0 Ls_t0^T = A Ls_t1
//   Ls_t1^T A^T + S S^T is phase B's step with mf := c, m_p := x_ref, X :=
//   A^T, R22 := S^T.  Carry runs that step over the C-1 aggregates from
//   the filter's row T-1; Apply runs each chunk's steps from its carry
//   and writes them (its values at the chunk ends are the ones written).
//   The chain is then ~2 (T-1) / C + C steps, with C B / 32 warps
//   (ops/chirp_smoother.py::backward_chunks picks C from T, B and the SM
//   count), at the cost of reading the 34 words of a step twice: 352 B
//   per lane-step in float32 where one pass needs 216.  The expectation,
//   which reads nothing of the carry, is left to phase E; the 34 words a
//   step reads (mf_t and row t) are copied kStages - 1 steps ahead with
//   cp.async into a ring in shared memory.  A thread copies and then
//   reads only its own lane's words, so no barrier is needed; a warp's
//   copies of one word are 32 neighbouring lanes, 128 B in float32.
//   Blocks are one warp (one chunk of 32 lanes), so a small batch spreads
//   over the SMs; a ring of 3 steps keeps a float64 block at 26 KB, so
//   that 8 blocks fit an SM.  The triangularization is tria_dense below,
//   tria_cf's arithmetic reflection for reflection.
// - Phase E is bound by the instructions it issues, not by its bytes
//   (float32 at B = 4096, T = 3141: 20 B per element in the first mode,
//   12 B in the second, 0.077 and 0.046 ms at 3.35 TB/s).  Its old form,
//   a loop over K nodes from shared memory with an accurate expf and
//   log1pf at each, issued some 500 instructions per element.  So:
//   (1) the nodes in pairs.  The port's gauss_hermite(1, K) is symmetric
//   bit for bit for every K of 1..32 (x_q = -x_{K-1-q}, w_q =
//   w_{K-1-q}, the centre 0), so with a = sd x_q, softplus(m + a) +
//   softplus(m - a) = max(m + a, 0) + max(m - a, 0) + ln((1 +
//   e^-|m+a|)(1 + e^-|m-a|)): 2 exponentials and 1 logarithm a pair
//   where there were 2 of each; an odd K adds its centre node.  NaN goes
//   where the plain version takes it: through the logarithm (fmax drops
//   it), and a NaN variance is not clamped to 0.
//   (2) float32 on the special-function unit (the one exception to "no
//   fast math" below, in E's device code alone): in units of ln 2, e^-|z|
//   is ex2.approx(-|z| log2 e) and the logarithm lg2.approx times ln 2,
//   one MUFU operation each; with the square root's rsqrt, 16 MUFU
//   operations per element at K = 10, which Hopper issues at 16 per clock
//   per SM (~0.05 ms at that shape).  Error: ex2's relative 2^-22.5 and
//   lg2's absolute 2^-22.6 give each pair's logarithm ~5e-7 absolute,
//   and the weights sum to 1, so E is within ~5e-7 + a few float32
//   roundings of |E| of the exact sum; the card tests and chip_smoke.py
//   hold it to 2e-6 max(1, |E|) of the float64 twin on the same inputs.
//   float64 keeps the accurate exp and log1p (of t + u + t u, which keeps
//   a tiny sum's relative precision), and holds 1e-12 of the twin.
//   (3) the rule by value in the kernel's parameters (GhPairs, built by
//   the launcher from the host's float64 arrays, as the model constants
//   are): each FFMA reads its node or weight from constant bank 0, with
//   no shared memory and no barrier.  An instance unrolled for the main
//   path's K = 10, and one for any K of 1..32 (the same pair form,
//   unrolled to 16 pairs and cut at K / 2), behind the same entry point.
//   (4) a grid over (tile of lanes, step), so no index is divided; a
//   thread takes 16 bytes of neighbouring lanes (4 in float32, 2 in
//   float64) with 16-byte loads and stores where B and the pointers
//   allow, one lane at a time where they do not, so a warp's accesses are
//   whole 128-byte lines and each thread has several elements in flight.
//   Blocks of up to 128 threads along the lanes (at B = 100, one warp or
//   two a step).
//
// What is not used, and why.  Tensor cores: the per-lane products are 4
// wide, and TF32 is barred by the port's precision policy (reduced-
// precision products moved the JAX package's CKFS IF-RMSE x10 from 0.777 to
// 0.92).  A Cholesky of the Gram matrix in place of the Householder: it
// squares the condition number, which float32 does not survive on the
// chirp smoother.  The filter kernel is not changed.
//
// Registers and spills of each instance: phase 1 of chip_smoke.py prints
// ptxas's report.  Model constants in the filter's layout
// (ops/chirp_filter.py::_chirp_constants, computed in float64 on the host;
// only F, Lq^T, the decay and dt are read).  No fast math (--use_fast_math
// is not among the build's flags: the filter and phase A need the
// accurate sin/cos/log), but for phase E's float32 ex2 and lg2 above.
// Templated on float and double.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "chirp_lcd.cuh"

namespace {

constexpr int kD2 = 2 * kD;      // columns of the joint pre-array
constexpr int kMaxNodes = 32;    // cap on the GH nodes of the expectation
constexpr int kMaxPairs = kMaxNodes / 2;
constexpr int kMainOrder = 10;   // the main path's GH order, unrolled in E
// Phase A's row per lane-step is chirp_lcd.cuh's packed row: m_p, X
// (row-major), R22's upper triangle (row by row).
constexpr int kStepWords = kD + kRowWords;   // phase B's words per step
constexpr int kStages = 3;                   // phase B's ring of steps
constexpr int kTeam = 8;                     // phase A's threads per lane-step
constexpr int kRowsThreads = 64;             // phase A's threads per block
constexpr int kBackLanes = 32;               // phase B's lanes per block
constexpr int kExpectThreads = 128;          // phase E's most threads a block

// Householder triangularization of the Rows x Cols array M (Rows >= Cols)
// in registers, with tria_cf's arithmetic: per column j, norm over rows
// j.., alpha = -sign(M_jj) norm, v = (M_jj - alpha, M_rj), beta = 2 / |v|^2
// (0 where |v|^2 <= 1e-30), and columns j.. of rows j.. reflected.  Row j
// is final after reflection j; the upper triangle holds R.
template <int Rows, int Cols, typename Real>
__device__ __forceinline__ void tria_dense(Real (&M)[Rows][Cols]) {
#pragma unroll
  for (int j = 0; j < Cols; ++j) {
    Real nrm2 = Real(0);
#pragma unroll
    for (int r = j; r < Rows; ++r) nrm2 += M[r][j] * M[r][j];
    const Real norm = dsqrt(nrm2);
    const Real alpha = M[j][j] >= Real(0) ? -norm : norm;
    Real v[Rows];
    Real vn2 = Real(0);
#pragma unroll
    for (int r = j; r < Rows; ++r) {
      v[r] = r == j ? M[r][j] - alpha : M[r][j];
      vn2 += v[r] * v[r];
    }
    const Real beta = vn2 > Real(1e-30) ? two_over(vn2) : Real(0);
#pragma unroll
    for (int k = j; k < Cols; ++k) {
      Real wk = Real(0);
#pragma unroll
      for (int r = j; r < Rows; ++r) wk += v[r] * M[r][k];
#pragma unroll
      for (int r = j; r < Rows; ++r) M[r][k] -= beta * v[r] * wk;
    }
  }
}

// Phase A.  kRows: pre-array rows a member owns, with kTeam kRows >= S +
// kD.  Item g = t nb + b of the (T-1) x nb lane-steps of a slab of nb
// lanes; mfs and lfs have ld lanes per row, the rows out nb.
template <typename Real, int kRows>
__global__ void __launch_bounds__(kRowsThreads)
smoother_rows_kernel(const Real* __restrict__ mfs,   // (T, kD, ld)
                     const Real* __restrict__ lfs,   // (T, kD*kD, ld)
                     const Real* __restrict__ xi_g,  // (S, kD)
                     const Real* __restrict__ w_g,   // (S,)
                     const Real* __restrict__ sw_g,  // (S,)
                     const ChirpConsts<Real> c, const int S, const int T,
                     const int ld, const int nb,
                     Real* __restrict__ rows) {      // (T-1, kRowWords, nb)
  __shared__ Real xi_s[kD][kMaxPoints];
  __shared__ Real w_s[kMaxPoints];
  __shared__ Real sw_s[kMaxPoints];
  __shared__ Real lqt_s[kD][kD];
  for (int i = threadIdx.x; i < S * kD; i += blockDim.x)
    xi_s[i % kD][i / kD] = xi_g[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    w_s[i] = w_g[i];
    sw_s[i] = sw_g[i];
  }
  if (threadIdx.x == 0) {   // constant indices: c stays in parameter space
#pragma unroll
    for (int i = 0; i < kD * kD; ++i) lqt_s[i / kD][i % kD] = c.LqT[i / kD][i % kD];
  }
  __syncthreads();

  constexpr int P = kTeam;
  constexpr int kTeams = kRowsThreads / P;
  const int member = threadIdx.x % P;
  const unsigned mask = ((1u << P) - 1u) << ((threadIdx.x & 31u) & ~unsigned(P - 1));
  const int xcol = member % kD;   // the column of X whose words it stores
  const int n = S + kD;
  const size_t Ld = static_cast<size_t>(ld), Ns = static_cast<size_t>(nb);
  const long long items = static_cast<long long>(T - 1) * nb;
  const long long stride = static_cast<long long>(gridDim.x) * kTeams;

  for (long long g = static_cast<long long>(blockIdx.x) * kTeams + threadIdx.x / P;
       g < items; g += stride) {
    const size_t ts = static_cast<size_t>(g / nb);
    const int b = static_cast<int>(g % nb);
    Real mf[kD], Lf[kD][kD];
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      mf[i] = mfs[(ts * kD + i) * Ld + b];
#pragma unroll
      for (int j = 0; j <= i; ++j) Lf[i][j] = lfs[(ts * kD * kD + i * kD + j) * Ld + b];
    }

    // Own sigma points, their LCD means and the partial weighted mean.
    // Every row slot is computed, without a branch; a slot past S computes
    // point S-1 at weight 0.
    Real pre[kRows][kD2];   // rows member + P*i of the pre-array
    Real mp[kD];
#pragma unroll
    for (int k = 0; k < kD; ++k) mp[k] = Real(0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = member + P * i;
      const int s = r < S ? r : S - 1;
      Real chi[kD], mu[kD];
#pragma unroll
      for (int a = 0; a < kD; ++a) {
        Real acc = Real(0);
#pragma unroll
        for (int j = 0; j <= a; ++j) acc += xi_s[j][s] * Lf[a][j];
        chi[a] = mf[a] + acc;
      }
      lcd_mean(c, chi, mu);
      const Real wgt = r < S ? w_s[s] : Real(0);
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        mp[k] += wgt * mu[k];
        pre[i][k] = mu[k];
        pre[i][kD + k] = chi[k] - mf[k];
      }
    }
#pragma unroll
    for (int o = P / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k < kD; ++k) mp[k] += __shfl_xor_sync(mask, mp[k], o, P);
    }

    // Own rows of [[sqrt(w)(mu - mp), sqrt(w)(chi - mf)]; [Lq^T, 0]; 0].
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = member + P * i;
      const int s = r < S ? r : S - 1;
      const int q = r < S ? 0 : (r - S < kD ? r - S : kD - 1);
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        const Real lq = r < n ? lqt_s[q][k] : Real(0);
        pre[i][k] = r < S ? sw_s[s] * (pre[i][k] - mp[k]) : lq;
        pre[i][kD + k] = r < S ? sw_s[s] * pre[i][kD + k] : Real(0);
      }
    }

    // Householder triangularization, one team reduction per column.  Row
    // j is owned by member j (i = 0); rows r < j are finished and masked.
    // Every member keeps R11, R22 and its column xcol of R12.
    Real R11[kD][kD], r12[kD] = {}, R22[kD][kD];
#pragma unroll
    for (int j = 0; j < kD2; ++j) {
      Real g2[kD2], Mj[kD2];
#pragma unroll
      for (int k = j; k < kD2; ++k) g2[k] = Real(0);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const Real x = (i > 0 || member >= j) ? pre[i][j] : Real(0);
#pragma unroll
        for (int k = j; k < kD2; ++k) g2[k] += x * pre[i][k];
      }
#pragma unroll
      for (int k = j; k < kD2; ++k) Mj[k] = __shfl_sync(mask, pre[0][k], j, P);
#pragma unroll
      for (int o = P / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int k = j; k < kD2; ++k) g2[k] += __shfl_xor_sync(mask, g2[k], o, P);
      }
      const Real norm = dsqrt(g2[j]);
      const Real alpha = Mj[j] >= Real(0) ? -norm : norm;
      const Real vn2 = Real(2) * (g2[j] - alpha * Mj[j]);
      const Real beta = vn2 > Real(1e-30) ? two_over(vn2) : Real(0);
      const Real vj = Mj[j] - alpha;
      Real wk[kD2];
#pragma unroll
      for (int k = j; k < kD2; ++k) {
        wk[k] = g2[k] - alpha * Mj[k];
        const Real rjk = Mj[k] - beta * vj * wk[k];
        if (j >= kD) {
          R22[j - kD][k - kD] = rjk;
        } else if (k < kD) {
          R11[j][k] = rjk;
        } else if (k - kD == xcol) {
          r12[j] = rjk;
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const Real v = (i > 0 || member > j) ? pre[i][j] : Real(0);
#pragma unroll
        for (int k = j + 1; k < kD2; ++k) pre[i][k] -= beta * v * wk[k];
      }
    }

    // Column xcol of X = R11^-1 R12 by back-substitution (_backsub_cf).
    Real x[kD];
#pragma unroll
    for (int i = kD - 1; i >= 0; --i) {
      Real acc = r12[i];
#pragma unroll
      for (int k = i + 1; k < kD; ++k) acc = acc - R11[i][k] * x[k];
      x[i] = acc / R11[i][i];
    }

    // Member p stores the words w with w % P == p: m_p, X (its words are
    // in column w % kD = xcol), R22's upper triangle.
    Real* out = rows + ts * kRowWords * Ns + b;
#pragma unroll
    for (int w = 0; w < kXWord; ++w)
      if (w % P == member) out[w * Ns] = mp[w];
#pragma unroll
    for (int i = 0; i < kD; ++i) {
#pragma unroll
      for (int col = 0; col < kD; ++col) {
        const int w = kXWord + i * kD + col;
        if (w % P == member) out[w * Ns] = x[i];
      }
    }
#pragma unroll
    for (int r = 0; r < kD; ++r) {
#pragma unroll
      for (int col = r; col < kD; ++col) {
        const int w = r22_word(r, col);
        if (w % P == member) out[w * Ns] = R22[r][col];
      }
    }
  }
}

// Phase B's ring and its steps.  Where step s's kStepWords words lie, for
// one lane: mf word i at mf + s mf_step + i mf_word, row word w at row + s
// row_step + w row_word (the filter's mfs and phase A's rows, or the
// aggregates of the chunks, whose 34 words have the same order).
template <typename Real>
struct StepSource {
  const Real* mf;
  size_t mf_step, mf_word;
  const Real* row;
  size_t row_step, row_word;
};

template <typename Real>
using BackRing = Real[kStages][kStepWords][kBackLanes];

template <typename Real>
__device__ __forceinline__ void fetch_step(BackRing<Real>& ring, const int lane,
                                           const StepSource<Real>& src,
                                           const int s) {
  const size_t ss = static_cast<size_t>(s);
  Real(*slot)[kBackLanes] = ring[s % kStages];
#pragma unroll
  for (int i = 0; i < kD; ++i)
    copy_async(&slot[i][lane], src.mf + ss * src.mf_step + i * src.mf_word);
#pragma unroll
  for (int w = 0; w < kRowWords; ++w)
    copy_async(&slot[kD + w][lane], src.row + ss * src.row_step + w * src.row_word);
}

// Steps s = hi-1 down to lo of src, each once its words are in the ring:
// body(s, slot), the next kStages - 1 steps in flight (one cp.async group
// each, empty past lo).  A thread copies and then reads only its own
// lane's words, so no barrier is needed.
template <typename Real, typename Body>
__device__ __forceinline__ void walk_steps(BackRing<Real>& ring, const int lane,
                                           const StepSource<Real>& src,
                                           const int lo, const int hi,
                                           Body&& body) {
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (hi - 1 - i >= lo) fetch_step(ring, lane, src, hi - 1 - i);
    copy_commit();
  }
  for (int s = hi - 1; s >= lo; --s) {
    if (s - (kStages - 1) >= lo) fetch_step(ring, lane, src, s - (kStages - 1));
    copy_commit();
    copy_wait<kStages - 1>();   // step s's group has landed
    body(s, ring[s % kStages]);
  }
}

// The smoothing step of the factor branch on the carry (ms, Ls), Ls lower,
// with a step's words (mf, m_p, X, R22's upper triangle): ms <- mf + X^T
// (ms - m_p), Ls <- tria([(X^T Ls)^T; R22])^T.  X is returned.
template <typename Real>
__device__ __forceinline__ void smooth_step(const Real (*slot)[kBackLanes],
                                            const int lane, Real (&X)[kD][kD],
                                            Real (&ms)[kD], Real (&Ls)[kD][kD]) {
  Real mf[kD], mp[kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    mf[i] = slot[i][lane];
    mp[i] = slot[kD + i][lane];
#pragma unroll
    for (int col = 0; col < kD; ++col) X[i][col] = slot[kD + kXWord + i * kD + col][lane];
  }
  // The array [(G Ls)^T; R22], (G Ls)^T[r][col] = sum_j X[j][col] Ls[j][r]
  // over j >= r (Ls lower), from the carried Ls.
  Real A[kD2][kD];
#pragma unroll
  for (int r = 0; r < kD; ++r) {
#pragma unroll
    for (int col = 0; col < kD; ++col) {
      Real acc = Real(0);
#pragma unroll
      for (int j = r; j < kD; ++j) acc += X[j][col] * Ls[j][r];
      A[r][col] = acc;
      A[kD + r][col] = col >= r ? slot[kD + r22_word(r, col)][lane] : Real(0);
    }
  }
  // ms <- mf + G (ms - mp).
  Real dm[kD];
#pragma unroll
  for (int j = 0; j < kD; ++j) dm[j] = ms[j] - mp[j];
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    Real acc = Real(0);
#pragma unroll
    for (int j = 0; j < kD; ++j) acc += X[j][i] * dm[j];
    ms[i] = mf[i] + acc;
  }
  // Ls <- tria([(G Ls)^T; R22])^T.
  tria_dense(A);
#pragma unroll
  for (int i = 0; i < kD; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) Ls[i][j] = A[j][i];
  }
}

// The first step of chunk k of C over the T-1 steps (chunk k covers steps
// chunk_start(k) .. chunk_start(k+1) - 1; ops/chirp_smoother.py::
// chunk_starts computes the same).
__device__ __forceinline__ int chunk_start(const int k, const int T,
                                           const int chunks) {
  return static_cast<int>(static_cast<long long>(k) * (T - 1) / chunks);
}

// Phase B's pointers for lane b of a slab: mfs with ld lanes per row, the
// rows of phase A with nb.
template <typename Real>
__device__ __forceinline__ StepSource<Real> filter_steps(const Real* mfs,
                                                         const Real* rows,
                                                         const int b,
                                                         const size_t Ld,
                                                         const size_t Ns) {
  return {mfs + b, kD * Ld, Ld, rows + b, kRowWords * Ns, Ns};
}

// Phase B, Compose: block (x, k-1) of one warp runs chunk k >= 1 on lanes
// 32x.., from the reference point x_ref = mf at the chunk's later end t1:
// walking t = t1-1 .. t0, the mean c from x_ref, the factor S from 0 and
// the product A = X_t0^T .. X_{t1-1}^T from I.  The chunk's aggregate,
// ms_t0 = c + A (ms_t1 - x_ref), Ls_t0 Ls_t0^T = A Ls_t1 Ls_t1^T A^T + S
// S^T, is one step in phase B's packing: mf := c, m_p := x_ref, X := A^T,
// R22 := S^T (upper), into agg[k-1] (kStepWords words, lanes nb).
template <typename Real>
__global__ void __launch_bounds__(kBackLanes)
smoother_compose_kernel(const Real* __restrict__ mfs,    // (T, kD, ld)
                        const Real* __restrict__ rows,   // (T-1, kRowWords, nb)
                        const int T, const int ld, const int nb,
                        const int chunks,
                        Real* __restrict__ agg) {        // (chunks-1, kStepWords, nb)
  __shared__ BackRing<Real> ring;
  const int lane = threadIdx.x;
  const int b = blockIdx.x * kBackLanes + lane;
  if (b >= nb) return;
  const int k = blockIdx.y + 1;
  const int t0 = chunk_start(k, T, chunks), t1 = chunk_start(k + 1, T, chunks);
  const size_t Ld = static_cast<size_t>(ld), Ns = static_cast<size_t>(nb);
  Real x_ref[kD], c[kD], S[kD][kD], A[kD][kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    x_ref[i] = mfs[(static_cast<size_t>(t1) * kD + i) * Ld + b];
    c[i] = x_ref[i];
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      S[i][j] = Real(0);
      A[i][j] = i == j ? Real(1) : Real(0);
    }
  }
  walk_steps(ring, lane, filter_steps(mfs, rows, b, Ld, Ns), t0, t1,
             [&](int, const Real (*slot)[kBackLanes]) {
               Real X[kD][kD];
               smooth_step(slot, lane, X, c, S);
               // A <- X^T A.
               Real An[kD][kD];
#pragma unroll
               for (int i = 0; i < kD; ++i) {
#pragma unroll
                 for (int j = 0; j < kD; ++j) {
                   Real acc = Real(0);
#pragma unroll
                   for (int m = 0; m < kD; ++m) acc += X[m][i] * A[m][j];
                   An[i][j] = acc;
                 }
               }
#pragma unroll
               for (int i = 0; i < kD; ++i) {
#pragma unroll
                 for (int j = 0; j < kD; ++j) A[i][j] = An[i][j];
               }
             });
  Real* out = agg + static_cast<size_t>(k - 1) * kStepWords * Ns + b;
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    out[i * Ns] = c[i];
    out[(kD + i) * Ns] = x_ref[i];
#pragma unroll
    for (int col = 0; col < kD; ++col) {
      out[(kD + kXWord + i * kD + col) * Ns] = A[col][i];
      if (col >= i) out[(kD + r22_word(i, col)) * Ns] = S[col][i];
    }
  }
}

// The carry words at a chunk boundary, per lane: ms (kD), then Ls's lower
// triangle row by row.
constexpr int kCarryWords = kD + kD * (kD + 1) / 2;

// Phase B, Carry: one thread per lane walks the aggregates of chunks C-1 ..
// 1 from the filter's row T-1, phase B's step on each, and writes the carry
// after chunk k, at step t1 of chunk k-1, to bounds[k-1] (kCarryWords
// words, lanes nb).
template <typename Real>
__global__ void __launch_bounds__(kBackLanes)
smoother_carry_kernel(const Real* __restrict__ mfs,    // (T, kD, ld)
                      const Real* __restrict__ lfs,    // (T, kD*kD, ld)
                      const Real* __restrict__ agg,    // (chunks-1, kStepWords, nb)
                      const int T, const int ld, const int nb,
                      const int chunks,
                      Real* __restrict__ bounds) {     // (chunks-1, kCarryWords, nb)
  __shared__ BackRing<Real> ring;
  const int lane = threadIdx.x;
  const int b = blockIdx.x * kBackLanes + lane;
  if (b >= nb) return;
  const size_t Ld = static_cast<size_t>(ld), Ns = static_cast<size_t>(nb);
  Real ms[kD], Ls[kD][kD];
  {
    const size_t ts = static_cast<size_t>(T - 1);
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      ms[i] = mfs[(ts * kD + i) * Ld + b];
#pragma unroll
      for (int j = 0; j <= i; ++j) Ls[i][j] = lfs[(ts * kD * kD + i * kD + j) * Ld + b];
    }
  }
  const StepSource<Real> src{agg + b, kStepWords * Ns, Ns, agg + kD * Ns + b,
                             kStepWords * Ns, Ns};
  walk_steps(ring, lane, src, 0, chunks - 1,
             [&](int s, const Real (*slot)[kBackLanes]) {
               Real X[kD][kD];
               smooth_step(slot, lane, X, ms, Ls);
               Real* out = bounds + static_cast<size_t>(s) * kCarryWords * Ns + b;
#pragma unroll
               for (int i = 0; i < kD; ++i) {
                 out[i * Ns] = ms[i];
#pragma unroll
                 for (int j = 0; j <= i; ++j) out[(kD + i * (i + 1) / 2 + j) * Ns] = Ls[i][j];
               }
             });
}

// Phase B, Apply: block (x, k) of one warp runs chunk k on lanes 32x..,
// the recursion from its later end, writing mss and Lss of its steps: the
// last chunk from the filter's row T-1 (which it writes as row T-1 of the
// outputs), the others from Carry's bounds[k].  With one chunk it is the
// whole recursion, as one thread per lane.
template <typename Real>
__global__ void __launch_bounds__(kBackLanes)
smoother_backward_kernel(const Real* __restrict__ mfs,     // (T, kD, ld)
                         const Real* __restrict__ lfs,     // (T, kD*kD, ld)
                         const Real* __restrict__ rows,    // (T-1, kRowWords, nb)
                         const Real* __restrict__ bounds,  // (chunks-1, kCarryWords, nb)
                         const int T, const int ld, const int nb,
                         const int chunks,
                         Real* __restrict__ mss,           // (T, kD, ld)
                         Real* __restrict__ lss) {         // (T, kD*kD, ld)
  __shared__ BackRing<Real> ring;
  const int lane = threadIdx.x;
  const int b = blockIdx.x * kBackLanes + lane;
  if (b >= nb || T < 1) return;
  const int k = blockIdx.y;
  const int t0 = chunk_start(k, T, chunks), t1 = chunk_start(k + 1, T, chunks);
  const size_t Ld = static_cast<size_t>(ld), Ns = static_cast<size_t>(nb);

  auto store = [&](int t, const Real(&m)[kD], const Real(&L)[kD][kD]) {
    const size_t ts = static_cast<size_t>(t);
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      mss[(ts * kD + i) * Ld + b] = m[i];
#pragma unroll
      for (int j = 0; j < kD; ++j)
        lss[(ts * kD * kD + i * kD + j) * Ld + b] = j <= i ? L[i][j] : Real(0);
    }
  };

  Real ms[kD], Ls[kD][kD];   // the carry; Ls: lower triangle only
  if (k == chunks - 1) {     // row T-1 is the filter's
    const size_t ts = static_cast<size_t>(T - 1);
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      ms[i] = mfs[(ts * kD + i) * Ld + b];
#pragma unroll
      for (int j = 0; j <= i; ++j) Ls[i][j] = lfs[(ts * kD * kD + i * kD + j) * Ld + b];
    }
    store(T - 1, ms, Ls);
  } else {
    const Real* in = bounds + static_cast<size_t>(k) * kCarryWords * Ns + b;
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      ms[i] = in[i * Ns];
#pragma unroll
      for (int j = 0; j <= i; ++j) Ls[i][j] = in[(kD + i * (i + 1) / 2 + j) * Ns];
    }
  }
  walk_steps(ring, lane, filter_steps(mfs, rows, b, Ld, Ns), t0, t1,
             [&](int t, const Real (*slot)[kBackLanes]) {
               Real X[kD][kD];
               smooth_step(slot, lane, X, ms, Ls);
               store(t, ms, Ls);
             });
}

// Phase E's order-K Gauss-Hermite rule, by value in the kernel's
// parameters (constant bank 0, which an FFMA reads as an operand: no
// shared memory, no barrier): the K / 2 pairs of nodes +-x_q (x_q > 0,
// outermost first) with their weights, and where K is odd the centre node
// (+-0) and its weight.  gh_pairs builds it from the host's float64 rule.
template <typename Real>
struct GhPairs {
  Real x[kMaxPairs];
  Real w[kMaxPairs];
  Real x0;     // the centre node (odd K; 0 otherwise)
  Real w0;     // its weight (odd K; 0 otherwise)
  int pairs;   // K / 2
  int odd;     // K % 2
};

// 2^x and log2(x) on the special-function unit (MUFU.EX2, MUFU.LG2):
// relative error 2^-22.5 for ex2, absolute error 2^-22.6 for lg2 (PTX
// ISA); subnormal results flush to 0.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// softplus(m + a) + softplus(m - a) for a pair of nodes, as max(m + a, 0)
// + max(m - a, 0) + ln((1 + e^-|m+a|)(1 + e^-|m-a|)): one logarithm for
// the two nodes (the product lies in [1, 4]); and softplus(c) of the
// centre node.  A NaN in m or a reaches the logarithm (fmax drops it).
// float64 with the accurate exp and log1p (of t + u + t u, so that a
// tiny sum keeps its relative precision); float32 in units of ln 2
// (`scale` maps m and a there, `unscale` maps the sum back), with ex2 and
// lg2 on the special-function unit.
template <typename Real>
struct PairSoftplus;

template <>
struct PairSoftplus<double> {
  __device__ static double scale(double x) { return x; }
  __device__ static double unscale(double x) { return x; }
  __device__ static double pair(double m, double a) {
    const double p = m + a, q = m - a;
    const double t = exp(-fabs(p)), u = exp(-fabs(q));
    return (fmax(p, 0.0) + fmax(q, 0.0)) + log1p(fma(t, u, t + u));
  }
  __device__ static double one(double c) {
    return fmax(c, 0.0) + log1p(exp(-fabs(c)));
  }
};

template <>
struct PairSoftplus<float> {
  __device__ static float scale(float x) { return x * 1.4426950408889634f; }
  __device__ static float unscale(float x) { return x * 0.6931471805599453f; }
  __device__ static float pair(float m, float a) {
    const float p = m + a, q = m - a;
    const float e = 1.0f + ex2_approx(-fabsf(p));
    return (fmaxf(p, 0.0f) + fmaxf(q, 0.0f))
           + lg2_approx(fmaf(e, ex2_approx(-fabsf(q)), e));
  }
  __device__ static float one(float c) {
    return fmaxf(c, 0.0f) + lg2_approx(1.0f + ex2_approx(-fabsf(c)));
  }
};

// The order-K Gauss-Hermite sum E[softplus(V)], V ~ N(m, sd^2), in the
// pair form: kOrder = K unrolled with K known (the main path's 10), or 0
// for any K of the rule, the same sums unrolled to kMaxPairs and cut at
// rule.pairs (a branch that the whole launch takes alike).  Pairs from the
// outermost in, then the centre node.
template <typename Real, int kOrder>
__device__ __forceinline__ Real gh_softplus(const Real m, const Real sd,
                                            const GhPairs<Real>& rule) {
  using SP = PairSoftplus<Real>;
  const Real ms = SP::scale(m), ss = SP::scale(sd);
  constexpr int kPairs = kOrder > 0 ? kOrder / 2 : kMaxPairs;
  Real acc = Real(0);
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    if (kOrder == 0 && q >= rule.pairs) break;
    acc = dfma(rule.w[q], SP::pair(ms, ss * rule.x[q]), acc);
  }
  if (kOrder > 0 ? kOrder % 2 == 1 : rule.odd != 0)
    acc = dfma(rule.w0, SP::one(ms + ss * rule.x0), acc);
  return SP::unscale(acc);
}

// Phase E's lanes per thread: 16 bytes of neighbouring lanes.
template <typename Real>
constexpr int kLanes = 16 / static_cast<int>(sizeof(Real));

template <typename Real>
struct Vec16;
template <>
struct Vec16<float> { using Type = float4; };
template <>
struct Vec16<double> { using Type = double2; };

// N neighbouring lanes at p: one 16-byte access where `whole` (p is then
// 16-byte aligned and all N lanes exist), else the `left` lanes that
// exist one by one (0 past them on loads).
template <int N, typename Real>
__device__ __forceinline__ void load_lanes(const Real* __restrict__ p,
                                           const bool whole, const int left,
                                           Real (&x)[N]) {
  if constexpr (N * sizeof(Real) == 16) {
    if (whole) {
      const auto v = *reinterpret_cast<const typename Vec16<Real>::Type*>(p);
      x[0] = v.x;
      x[1] = v.y;
      if constexpr (N == 4) {
        x[2] = v.z;
        x[3] = v.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = i < left ? p[i] : Real(0);
}

template <int N, typename Real>
__device__ __forceinline__ void store_lanes(Real* __restrict__ p,
                                            const bool whole, const int left,
                                            const Real (&x)[N]) {
  if constexpr (N * sizeof(Real) == 16) {
    if (whole) {
      typename Vec16<Real>::Type v;
      v.x = x[0];
      v.y = x[1];
      if constexpr (N == 4) {
        v.z = x[2];
        v.w = x[3];
      }
      *reinterpret_cast<typename Vec16<Real>::Type*>(p) = v;
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < left) p[i] = x[i];
}

// Phase E: E[softplus(V)], V ~ N(mss[t, kV], sum_{j <= kV} Lss[t, kV, j]^2).
// The grid is (tiles of lanes, steps): thread x of a block takes lanes b
// .. b + kLanes - 1 of step t, so no index is divided; steps past the
// grid's y extent stride by it.  `whole`: B is a multiple of kLanes and
// every pointer 16-byte aligned.
template <typename Real, int kOrder>
__global__ void __launch_bounds__(kExpectThreads)
smoother_expect_kernel(const Real* __restrict__ mss,    // (T, kD, B)
                       const Real* __restrict__ lss,    // (T, kD*kD, B)
                       const GhPairs<Real> rule, const int T, const int B,
                       const bool whole,
                       Real* __restrict__ if_out) {     // (T, B)
  constexpr int N = kLanes<Real>;
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) * N;
  if (b >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  for (int t = blockIdx.y; t < T; t += gridDim.y) {
    const size_t ts = static_cast<size_t>(t);
    Real m[N], l[kV + 1][N], out[N];
    load_lanes(mss + (ts * kD + kV) * Bs + b, whole, B - b, m);
#pragma unroll
    for (int j = 0; j <= kV; ++j)
      load_lanes(lss + (ts * kD * kD + kV * kD + j) * Bs + b, whole, B - b,
                 l[j]);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      Real vv = Real(0);
#pragma unroll
      for (int j = 0; j <= kV; ++j) vv += l[j][i] * l[j][i];
      out[i] = gh_softplus<Real, kOrder>(m[i], dsqrt(vv), rule);
    }
    store_lanes(if_out + ts * Bs + b, whole, B - b, out);
  }
}

// Phase E's second input mode, for the fused filter+smoother's slim output
// (ops/chirp_fused.py): E[softplus(V)], V ~ N(v_mean, max(v_var, 0)), from
// the (T, B) means and variances as they are, on smoother_expect_kernel's
// grid.  The standard deviation is sqrt(max(v_var, 0)), as bench.py's
// pipeline takes it (the affine recursion's variance may round below 0),
// so no clamp or sqrt launch sits between the recursion and the
// expectation; a NaN variance stays NaN.
template <typename Real, int kOrder>
__global__ void __launch_bounds__(kExpectThreads)
smoother_expect_var_kernel(const Real* __restrict__ v_mean,  // (T, B)
                           const Real* __restrict__ v_var,   // (T, B)
                           const GhPairs<Real> rule, const int T,
                           const int B, const bool whole,
                           Real* __restrict__ if_out) {      // (T, B)
  constexpr int N = kLanes<Real>;
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) * N;
  if (b >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  for (int t = blockIdx.y; t < T; t += gridDim.y) {
    const size_t at = static_cast<size_t>(t) * Bs + b;
    Real m[N], var[N], out[N];
    load_lanes(v_mean + at, whole, B - b, m);
    load_lanes(v_var + at, whole, B - b, var);
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = gh_softplus<Real, kOrder>(
          m[i], dsqrt(var[i] < Real(0) ? Real(0) : var[i]), rule);
    store_lanes(if_out + at, whole, B - b, out);
  }
}

// Blocks of `threads` that the card holds at once for `kernel`, at least 1.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  *blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(err);
}

template <typename Real, int kRows>
int launch_rows_instance(const Real* mfs, const Real* lfs, const Real* xi,
                         const Real* w, const Real* sw,
                         const ChirpConsts<Real>& c, int S, int T, int ld,
                         int nb, Real* rows, cudaStream_t stream) {
  if (S + kD > kTeam * kRows) return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(T - 1) * nb;
  if (items <= 0) return 0;
  constexpr int kTeams = kRowsThreads / kTeam;
  int cap = 0;
  const int err = resident_blocks(smoother_rows_kernel<Real, kRows>,
                                  kRowsThreads, &cap);
  if (err != 0) return err;
  const long long need = (items + kTeams - 1) / kTeams;
  const int blocks = static_cast<int>(need < cap ? need : cap);
  smoother_rows_kernel<Real, kRows><<<blocks, kRowsThreads, 0, stream>>>(
      mfs, lfs, xi, w, sw, c, S, T, ld, nb, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename Real>
int launch_rows(const Real* mfs, const Real* lfs, const Real* xi,
                const Real* w, const Real* sw, const double* consts, int S,
                int T, int ld, int nb, int rows_per_member, Real* rows,
                void* stream) {
  if (S < 1 || S > kMaxPoints || T < 1 || nb < 0 || ld < nb)
    return static_cast<int>(cudaErrorInvalidValue);
  const ChirpConsts<Real> c = load_consts<Real>(consts);
  const auto s = static_cast<cudaStream_t>(stream);
  // The instantiated rows per member, which ops/chirp_smoother.py::ROWS
  // lists: those of cubature (S + 4 = 12) and GH-3 (S + 4 = 85) at d = 4.
#define SMOOTHER_ROWS_LAUNCH(ROWS)                                           \
  launch_rows_instance<Real, ROWS>(mfs, lfs, xi, w, sw, c, S, T, ld, nb, rows, s)
  switch (rows_per_member) {
    case 2: return SMOOTHER_ROWS_LAUNCH(2);
    case 11: return SMOOTHER_ROWS_LAUNCH(11);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SMOOTHER_ROWS_LAUNCH
}

// Phase B's chunks: 1..T-1 (one at T = 1), at most a grid's y extent.
int check_chunks(int T, int ld, int nb, int chunks) {
  const int most = T > 1 ? T - 1 : 1;
  return T < 1 || nb < 0 || ld < nb || chunks < 1 || chunks > most || chunks > 65535
             ? static_cast<int>(cudaErrorInvalidValue)
             : 0;
}

template <typename Real>
int launch_compose(const Real* mfs, const Real* rows, int T, int ld, int nb,
                   int chunks, Real* agg, void* stream) {
  if (const int err = check_chunks(T, ld, nb, chunks)) return err;
  if (nb == 0 || chunks == 1) return 0;
  const dim3 grid((nb + kBackLanes - 1) / kBackLanes, chunks - 1);
  smoother_compose_kernel<Real><<<grid, kBackLanes, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      mfs, rows, T, ld, nb, chunks, agg);
  return static_cast<int>(cudaGetLastError());
}

template <typename Real>
int launch_carry(const Real* mfs, const Real* lfs, const Real* agg, int T,
                 int ld, int nb, int chunks, Real* bounds, void* stream) {
  if (const int err = check_chunks(T, ld, nb, chunks)) return err;
  if (nb == 0 || chunks == 1) return 0;
  smoother_carry_kernel<Real><<<(nb + kBackLanes - 1) / kBackLanes, kBackLanes,
                                0, static_cast<cudaStream_t>(stream)>>>(
      mfs, lfs, agg, T, ld, nb, chunks, bounds);
  return static_cast<int>(cudaGetLastError());
}

template <typename Real>
int launch_backward(const Real* mfs, const Real* lfs, const Real* rows,
                    const Real* bounds, int T, int ld, int nb, int chunks,
                    Real* mss, Real* lss, void* stream) {
  if (const int err = check_chunks(T, ld, nb, chunks)) return err;
  if (nb == 0) return 0;
  const dim3 grid((nb + kBackLanes - 1) / kBackLanes, chunks);
  smoother_backward_kernel<Real><<<grid, kBackLanes, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      mfs, lfs, rows, bounds, T, ld, nb, chunks, mss, lss);
  return static_cast<int>(cudaGetLastError());
}

// Phase E's rule from the host's float64 order-K Gauss-Hermite rule (x, w
// of K nodes, ascending), which must be symmetric bit for bit: x_q =
// -x_{K-1-q}, w_q = w_{K-1-q} (the port's gauss_hermite(1, K) is, for
// every K of 1..kMaxNodes).  Cast to Real as the plain version casts it.
template <typename Real>
int gh_pairs(const double* x, const double* w, int K, GhPairs<Real>* rule) {
  if (K < 1 || K > kMaxNodes || x == nullptr || w == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int q = 0; q < K; ++q)
    if (x[q] != -x[K - 1 - q] || w[q] != w[K - 1 - q])
      return static_cast<int>(cudaErrorInvalidValue);
  *rule = GhPairs<Real>{};
  rule->pairs = K / 2;
  rule->odd = K % 2;
  for (int q = 0; q < K / 2; ++q) {
    rule->x[q] = static_cast<Real>(x[K - 1 - q]);
    rule->w[q] = static_cast<Real>(w[K - 1 - q]);
  }
  if (K % 2) {
    rule->x0 = static_cast<Real>(x[K / 2]);
    rule->w0 = static_cast<Real>(w[K / 2]);
  }
  return 0;
}

// Phase E's geometry for B lanes and T steps: kLanes lanes a thread, the
// ceil(B / kLanes) threads of a step in blocks of up to kExpectThreads
// (whole warps), a row of blocks per step, at most 65535 rows.  At B =
// 4096 a step is 8 (float32) or 16 (float64) blocks of 128 threads, ~12
// (~6) waves of the blocks an SM holds at 40-60 registers; at B = 100 one
// warp (two) a step, 3141 blocks that the card holds at once.
template <typename Real>
void expect_geometry(int T, int B, dim3* grid, int* threads) {
  const int groups = (B + kLanes<Real> - 1) / kLanes<Real>;
  const int warps = (groups + 31) / 32;
  *threads = 32 * (warps < kExpectThreads / 32 ? warps : kExpectThreads / 32);
  *grid = dim3((groups + *threads - 1) / *threads, T < 65535 ? T : 65535);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// A phase-E kernel: two (T, B)-shaped inputs (mss and lss, or v_mean and
// v_var), the rule, T, B, `whole`, the (T, B) output.
template <typename Real>
using ExpectKernel = void (*)(const Real*, const Real*, GhPairs<Real>, int,
                              int, bool, Real*);

// One launch of phase E in the mode of its two instances: `main_order`
// (unrolled for kMainOrder) where K is that order, `any_order` otherwise.
template <typename Real>
int launch_expect(ExpectKernel<Real> main_order, ExpectKernel<Real> any_order,
                  const Real* a, const Real* c, const double* ghx,
                  const double* ghw, int K, int T, int B, Real* if_out,
                  void* stream) {
  GhPairs<Real> rule;
  if (const int err = gh_pairs(ghx, ghw, K, &rule)) return err;
  if (T < 0 || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0 || B == 0) return 0;
  dim3 grid;
  int threads = 0;
  expect_geometry<Real>(T, B, &grid, &threads);
  const bool whole = B % kLanes<Real> == 0 && aligned16(a) && aligned16(c) &&
                     aligned16(if_out);
  const ExpectKernel<Real> kernel = K == kMainOrder ? main_order : any_order;
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, c, rule, T, B, whole, if_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ghfs_chirp_smoother_max_points() { return kMaxPoints; }

int ghfs_chirp_smoother_max_nodes() { return kMaxNodes; }

int ghfs_chirp_smoother_num_consts() { return kNumConsts; }

int ghfs_chirp_smoother_row_words() { return kRowWords; }

int smoother_rows_f32(const float* mfs, const float* lfs, const float* xi,
                      const float* w, const float* sw, const double* consts,
                      int S, int T, int ld, int nb, int rows_per_member,
                      float* rows, void* stream) {
  return launch_rows<float>(mfs, lfs, xi, w, sw, consts, S, T, ld, nb,
                            rows_per_member, rows, stream);
}

int smoother_rows_f64(const double* mfs, const double* lfs, const double* xi,
                      const double* w, const double* sw, const double* consts,
                      int S, int T, int ld, int nb, int rows_per_member,
                      double* rows, void* stream) {
  return launch_rows<double>(mfs, lfs, xi, w, sw, consts, S, T, ld, nb,
                             rows_per_member, rows, stream);
}

int ghfs_chirp_smoother_carry_words() { return kCarryWords; }

int smoother_compose_f32(const float* mfs, const float* rows, int T, int ld,
                         int nb, int chunks, float* agg, void* stream) {
  return launch_compose<float>(mfs, rows, T, ld, nb, chunks, agg, stream);
}

int smoother_compose_f64(const double* mfs, const double* rows, int T, int ld,
                         int nb, int chunks, double* agg, void* stream) {
  return launch_compose<double>(mfs, rows, T, ld, nb, chunks, agg, stream);
}

int smoother_carry_f32(const float* mfs, const float* lfs, const float* agg,
                       int T, int ld, int nb, int chunks, float* bounds,
                       void* stream) {
  return launch_carry<float>(mfs, lfs, agg, T, ld, nb, chunks, bounds, stream);
}

int smoother_carry_f64(const double* mfs, const double* lfs, const double* agg,
                       int T, int ld, int nb, int chunks, double* bounds,
                       void* stream) {
  return launch_carry<double>(mfs, lfs, agg, T, ld, nb, chunks, bounds,
                              stream);
}

int smoother_backward_f32(const float* mfs, const float* lfs, const float* rows,
                          const float* bounds, int T, int ld, int nb,
                          int chunks, float* mss, float* lss, void* stream) {
  return launch_backward<float>(mfs, lfs, rows, bounds, T, ld, nb, chunks, mss,
                                lss, stream);
}

int smoother_backward_f64(const double* mfs, const double* lfs,
                          const double* rows, const double* bounds, int T,
                          int ld, int nb, int chunks, double* mss, double* lss,
                          void* stream) {
  return launch_backward<double>(mfs, lfs, rows, bounds, T, ld, nb, chunks,
                                 mss, lss, stream);
}

int smoother_expect_f32(const float* mss, const float* lss, const double* ghx,
                        const double* ghw, int K, int T, int B, float* if_out,
                        void* stream) {
  return launch_expect<float>(smoother_expect_kernel<float, kMainOrder>,
                              smoother_expect_kernel<float, 0>, mss, lss, ghx,
                              ghw, K, T, B, if_out, stream);
}

int smoother_expect_f64(const double* mss, const double* lss,
                        const double* ghx, const double* ghw, int K, int T,
                        int B, double* if_out, void* stream) {
  return launch_expect<double>(smoother_expect_kernel<double, kMainOrder>,
                               smoother_expect_kernel<double, 0>, mss, lss,
                               ghx, ghw, K, T, B, if_out, stream);
}

int smoother_expect_var_f32(const float* v_mean, const float* v_var,
                            const double* ghx, const double* ghw, int K, int T,
                            int B, float* if_out, void* stream) {
  return launch_expect<float>(smoother_expect_var_kernel<float, kMainOrder>,
                              smoother_expect_var_kernel<float, 0>, v_mean,
                              v_var, ghx, ghw, K, T, B, if_out, stream);
}

int smoother_expect_var_f64(const double* v_mean, const double* v_var,
                            const double* ghx, const double* ghw, int K, int T,
                            int B, double* if_out, void* stream) {
  return launch_expect<double>(smoother_expect_var_kernel<double, kMainOrder>,
                               smoother_expect_var_kernel<double, 0>, v_mean,
                               v_var, ghx, ghw, K, T, B, if_out, stream);
}

}  // extern "C"
