// Square-root Gauss-Hermite smoother (GHFS) for the chirp LCD model, d = 4,
// with the Gauss-Hermite expectation of g(V) = softplus(V) as its epilogue.
//
// Replaces no Pallas kernel: it replaces the XLA-compiled reverse lax.scan
// of chirpgp_tpu/infer/batched.py:152 (sqrt_sgp_smoother_batched) and the
// expectation of :546 (gaussian_expectation_batched) on the JAX package's
// main path, apps/pipeline.py::estimate_if_batched.  It computes what the
// plain PyTorch versions chirpgp_tpu_torch/infer/batched.py::
// sqrt_sgp_smoother_batched and gaussian_expectation_batched compute for
// the chirp model, from the filter kernel's outputs as they are (mfs
// (T, 4, B), Lfs (T, 4, 4, B) lower, B minor).  Per step, from t = T-2
// down to 0, with ms and Ls carried from t+1: sigma points chi = mf + xi
// Lf, the chirp-LCD mean mu, m_p = sum w mu, a Householder
// triangularization of the (S+4) x 8 joint pre-array
//   [[sqrt(w)(mu - m_p), sqrt(w)(chi - mf)], [Lq^T, 0]]  ->  R (8 x 8),
// the gain G = (R11^-1 R12)^T by back-substitution, ms <- mf + G (ms -
// m_p), Ls <- tria([(G Ls)^T; R22])^T, and E[g(V)] with V ~ N(ms[kV],
// sum_k Ls[kV][k]^2) by the order-K Gauss-Hermite rule (kV = 2, the
// chirp model's frequency state, in chirp_lcd.cuh).
//
// What bounds it.  The least work of a step (ops/chirp_smoother.py::
// smoother_cost) is that of the projected form, which this kernel does
// not yet run: a rule exact to degree two has sum w xi xi^T = I, so
// sqrt(w) xi has orthonormal columns Q, sqrt(w)(chi - mf) = Q Lf^T, and
// the same R comes from C = Q^T dev_pred, E = dev_pred - Q C, a
// triangularization of the S x 4 array E and one of the 12 x 8 array
// [[C, Lf^T], [R_E, 0], [Lq^T, 0]].  At S = 81 that is ~14.3k flop per
// seed-step: sigma points, LCD mean, weighted mean, dev_pred, C and E
// 117 S = 9.5k, the two Householders 4.1k, the gain, mean update, G Ls
// and the 8 x 4 triangularization 0.7k, the GH-10 expectation 0.07k.
// This kernel's form, the Householder of the whole (S + 4) x 8 pre-array,
// costs ~16.5k (61 S = 4.9k and 10.8k for the Householder).  Besides, 3
// transcendentals per sigma point and 2 per GH node, against 164 B of
// traffic in float32 (4 + 16 words read, 4 + 16 + 1 written).  At B =
// 4096, T = 3141 that is ~184 GFLOP and 2.1 GB: compute-bound, ~2.7 ms
// at the 67 TFLOP/s float32 peak.  The T recursion is sequential, so the
// only parallelism is across lanes and across the sigma points of one
// step.
//
// Design: the filter kernel's (ghfs_chirp_filter.cu, whose note explains
// each choice), with twice its columns.
// - A team of P threads per Monte-Carlo lane (P = 8 or 32, a template
//   constant; the wrapper picks it and the launch geometry with
//   ops/chirp_filter.py::launch_geometry).  Member p owns rows p, p + P,
//   ... (kRows of them) of the pre-array, in registers, and computes chi,
//   mu and both deviations of its own sigma points; the Lq^T rows S..S+3
//   fall to fixed members; rows past S+4 hold zeros.  Nothing is indexed
//   at run time.
// - Column j of the Householder triangularization is one team reduction
//   (a __shfl_xor_sync butterfly) of the partial Gram row G_jk = sum_{r >=
//   j} M_rj M_rk, k >= j; alpha = -sign(M_jj) |x| (tria_cf's sign rule),
//   |v|^2 = 2 (G_jj - alpha M_jj), w_k = G_jk - alpha M_jk, and each member
//   reflects columns k > j of its own rows.  Row j (j < 8 <= P) is owned
//   by member j, which broadcasts it.  Reflections with |v|^2 <= 1e-30 are
//   skipped, as in tria_cf.  IEEE addition commutes, so every member of a
//   butterfly gets the same bits.
// - The tail is done redundantly by every member in registers, so that no
//   member waits on another: the rows of R are built from the broadcast
//   rows and the reduced w, then G, ms, G Ls and the dense 8 x 4
//   triangularization with tria_cf's arithmetic reflection for reflection.
// - The epilogue's GH nodes are spread over the members, one butterfly
//   sums them.  Member p stores the output words w with w % P == p
//   (mss[t, i, b], lss[t, i*4+j, b], if_mean[t, b]).  Row T-1 is the
//   filter's, copied, with its expectation.
// - A team whose lane is >= B leaves after the tables are loaded; teams
//   never straddle a warp, and every shuffle names only its team's
//   threads.  The sigma table (xi transposed to 4 x S, w, sqrt(w)), Lq^T
//   and the GH table (K <= kMaxNodes) sit in shared memory.
// - Registers: twice the filter's pre-array.  P = 8 with GH-3 holds 11
//   rows x 8 values per member: ~200 registers in float32, no spill; in
//   float64 it spills (255 registers), and is kept, since at B = 4096 it
//   is still faster than P = 32 on an H100.  Phase 1 of chip_smoke.py
//   prints ptxas's registers, stack and spills of each instance.
// - Model constants in the filter's layout (ops/chirp_filter.py::
//   _chirp_constants, computed in float64 on the host; only F, Lq^T, the
//   decay and dt are read).  No fast math.  Templated on float and double.

#include <cuda_runtime.h>

#include <cstddef>

#include "chirp_lcd.cuh"

namespace {

constexpr int kD2 = 2 * kD;      // columns of the joint pre-array
constexpr int kMaxNodes = 32;    // cap on the GH nodes of the epilogue

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

// E[softplus(V)], V ~ N(mean, std^2), over the team: member p adds the GH
// nodes p, p + P, ...; a butterfly leaves the sum on every member.
template <typename Real, int P>
__device__ __forceinline__ Real expect_softplus(Real mean, Real std,
                                                const Real* ghx,
                                                const Real* ghw, int K,
                                                int member, unsigned mask) {
  Real acc = Real(0);
  for (int q = member; q < K; q += P) acc += ghw[q] * softplus(mean + std * ghx[q]);
#pragma unroll
  for (int o = P / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(mask, acc, o, P);
  return acc;
}

// Row t of the outputs from (m, L), with E[softplus(V)], V ~ N(m[kV],
// sum_k L[kV][k]^2).  Member p writes the words w with w % P == p.
template <typename Real, int P>
__device__ __forceinline__ void store_row(
    int t, const Real (&m)[kD], const Real (&L)[kD][kD], const Real* ghx,
    const Real* ghw, int K, int member, unsigned mask, size_t Bs, int b,
    Real* mss, Real* lss, Real* if_out) {
  Real vv = Real(0);
#pragma unroll
  for (int j = 0; j <= kV; ++j) vv += L[kV][j] * L[kV][j];
  const Real vm = expect_softplus<Real, P>(m[kV], dsqrt(vv), ghx, ghw, K,
                                           member, mask);
  // Words w = i (mss), kD + i kD + j (lss) and kWords - 1 (if_mean).
  const size_t ts = static_cast<size_t>(t);
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    if (i % P == member) mss[(ts * kD + i) * Bs + b] = m[i];
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      if ((kD + i * kD + j) % P == member)
        lss[(ts * kD * kD + i * kD + j) * Bs + b] = j <= i ? L[i][j] : Real(0);
    }
  }
  if ((kWords - 1) % P == member) if_out[ts * Bs + b] = vm;
}

// kRows: pre-array rows a member owns, with P kRows >= S + kD.
template <typename Real, int P, int kRows>
__global__ void __launch_bounds__(kMaxThreads)
ghfs_chirp_smoother_kernel(const Real* __restrict__ mfs,   // (T, kD, B)
                           const Real* __restrict__ lfs,   // (T, kD*kD, B)
                           const Real* __restrict__ xi_g,  // (S, kD)
                           const Real* __restrict__ w_g,   // (S,)
                           const Real* __restrict__ sw_g,  // (S,)
                           const Real* __restrict__ ghx_g,   // (K,)
                           const Real* __restrict__ ghw_g,   // (K,)
                           const ChirpConsts<Real> c, const int S,
                           const int K, const int T, const int B,
                           const int lanes_per_block,
                           Real* __restrict__ mss,         // (T, kD, B)
                           Real* __restrict__ lss,         // (T, kD*kD, B)
                           Real* __restrict__ if_out) {    // (T, B)
  __shared__ Real xi_s[kD][kMaxPoints];
  __shared__ Real w_s[kMaxPoints];
  __shared__ Real sw_s[kMaxPoints];
  __shared__ Real lqt_s[kD][kD];
  __shared__ Real ghx_s[kMaxNodes];
  __shared__ Real ghw_s[kMaxNodes];
  for (int i = threadIdx.x; i < S * kD; i += blockDim.x)
    xi_s[i % kD][i / kD] = xi_g[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    w_s[i] = w_g[i];
    sw_s[i] = sw_g[i];
  }
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    ghx_s[i] = ghx_g[i];
    ghw_s[i] = ghw_g[i];
  }
  if (threadIdx.x == 0) {   // constant indices: c stays in parameter space
#pragma unroll
    for (int i = 0; i < kD * kD; ++i) lqt_s[i / kD][i % kD] = c.LqT[i / kD][i % kD];
  }
  __syncthreads();

  const int member = threadIdx.x % P;
  const int b = blockIdx.x * lanes_per_block + static_cast<int>(threadIdx.x) / P;
  if (b >= B) return;
  const unsigned mask =
      P == 32 ? 0xffffffffu
              : ((1u << P) - 1u) << ((threadIdx.x & 31u) & ~unsigned(P - 1));
  const size_t Bs = static_cast<size_t>(B);
  const int n = S + kD;

  Real ms[kD], Ls[kD][kD];   // the carry; Ls: lower triangle only
  if (T < 1) return;
  {
    const size_t ts = static_cast<size_t>(T - 1);
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      ms[i] = mfs[(ts * kD + i) * Bs + b];
#pragma unroll
      for (int j = 0; j <= i; ++j) Ls[i][j] = lfs[(ts * kD * kD + i * kD + j) * Bs + b];
    }
  }
  store_row<Real, P>(T - 1, ms, Ls, ghx_s, ghw_s, K, member, mask, Bs, b,
                     mss, lss, if_out);

  Real pre[kRows][kD2];   // rows member + P*i of the pre-array
  for (int t = T - 2; t >= 0; --t) {
    const size_t ts = static_cast<size_t>(t);
    Real mf[kD], Lf[kD][kD];
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      mf[i] = mfs[(ts * kD + i) * Bs + b];
#pragma unroll
      for (int j = 0; j <= i; ++j) Lf[i][j] = lfs[(ts * kD * kD + i * kD + j) * Bs + b];
    }

    // Own sigma points, their LCD means and the partial weighted mean.
    // Every row slot is computed, without a branch; a slot past S computes
    // point S-1 at weight 0.
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
    Real R[kD2][kD2];   // upper triangle, on every member
#pragma unroll
    for (int j = 0; j < kD2; ++j) {
      Real g[kD2], Mj[kD2];
#pragma unroll
      for (int k = j; k < kD2; ++k) g[k] = Real(0);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const Real x = (i > 0 || member >= j) ? pre[i][j] : Real(0);
#pragma unroll
        for (int k = j; k < kD2; ++k) g[k] += x * pre[i][k];
      }
#pragma unroll
      for (int k = j; k < kD2; ++k) Mj[k] = __shfl_sync(mask, pre[0][k], j, P);
#pragma unroll
      for (int o = P / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int k = j; k < kD2; ++k) g[k] += __shfl_xor_sync(mask, g[k], o, P);
      }
      const Real norm = dsqrt(g[j]);
      const Real alpha = Mj[j] >= Real(0) ? -norm : norm;
      const Real vn2 = Real(2) * (g[j] - alpha * Mj[j]);
      const Real beta = vn2 > Real(1e-30) ? two_over(vn2) : Real(0);
      const Real vj = Mj[j] - alpha;
      Real wk[kD2];
#pragma unroll
      for (int k = j; k < kD2; ++k) {
        wk[k] = g[k] - alpha * Mj[k];
        R[j][k] = Mj[k] - beta * vj * wk[k];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const Real v = (i > 0 || member > j) ? pre[i][j] : Real(0);
#pragma unroll
        for (int k = j + 1; k < kD2; ++k) pre[i][k] -= beta * v * wk[k];
      }
    }

    // X = R11^-1 R12 by back-substitution (_backsub_cf); G = X^T.
    Real X[kD][kD];
#pragma unroll
    for (int i = kD - 1; i >= 0; --i) {
#pragma unroll
      for (int col = 0; col < kD; ++col) {
        Real acc = R[i][kD + col];
#pragma unroll
        for (int k = i + 1; k < kD; ++k) acc = acc - R[i][k] * X[k][col];
        X[i][col] = acc / R[i][i];
      }
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
        A[kD + r][col] = col >= r ? R[kD + r][kD + col] : Real(0);
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
    store_row<Real, P>(t, ms, Ls, ghx_s, ghw_s, K, member, mask, Bs, b,
                       mss, lss, if_out);
  }
}

template <typename Real, int P, int kRows>
int launch_team(const Real* mfs, const Real* lfs, const Real* xi,
                const Real* w, const Real* sw, const Real* ghx,
                const Real* ghw, const ChirpConsts<Real>& c, int S, int K,
                int T, int B, int lanes_per_block, Real* mss,
                Real* lss, Real* if_out, cudaStream_t stream) {
  if (lanes_per_block < 1 || P * lanes_per_block > kMaxThreads ||
      S + kD > P * kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0 || B == 0) return 0;
  const int blocks = (B + lanes_per_block - 1) / lanes_per_block;
  ghfs_chirp_smoother_kernel<Real, P, kRows>
      <<<blocks, P * lanes_per_block, 0, stream>>>(
          mfs, lfs, xi, w, sw, ghx, ghw, c, S, K, T, B,
          lanes_per_block, mss, lss, if_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename Real>
int launch(const Real* mfs, const Real* lfs, const Real* xi, const Real* w,
           const Real* sw, const Real* ghx, const Real* ghw,
           const double* consts, int S, int K, int T, int B,
           int team, int rows, int lanes_per_block, Real* mss, Real* lss,
           Real* if_out, void* stream) {
  if (S < 1 || S > kMaxPoints || T < 0 || B < 0 || K < 1 || K > kMaxNodes)
    return static_cast<int>(cudaErrorInvalidValue);
  const ChirpConsts<Real> c = load_consts<Real>(consts);
  const auto s = static_cast<cudaStream_t>(stream);
  // The instantiated (team, rows) pairs: the filter kernel's, which
  // ops/chirp_filter.py::ROWS lists.
#define GHFS_LAUNCH(P, ROWS)                                                \
  launch_team<Real, P, ROWS>(mfs, lfs, xi, w, sw, ghx, ghw, c, S, K, T, B,  \
                             lanes_per_block, mss, lss, if_out, s)
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

int ghfs_chirp_smoother_max_points() { return kMaxPoints; }

int ghfs_chirp_smoother_max_nodes() { return kMaxNodes; }

int ghfs_chirp_smoother_num_consts() { return kNumConsts; }

int ghfs_chirp_smoother_max_threads() { return kMaxThreads; }

int ghfs_chirp_smoother_f32(const float* mfs, const float* lfs,
                            const float* xi, const float* w, const float* sw,
                            const float* ghx, const float* ghw,
                            const double* consts, int S, int K, int T, int B,
                            int team, int rows,
                            int lanes_per_block, float* mss, float* lss,
                            float* if_out, void* stream) {
  return launch<float>(mfs, lfs, xi, w, sw, ghx, ghw, consts, S, K, T, B,
                       team, rows, lanes_per_block, mss, lss, if_out, stream);
}

int ghfs_chirp_smoother_f64(const double* mfs, const double* lfs,
                            const double* xi, const double* w,
                            const double* sw, const double* ghx,
                            const double* ghw, const double* consts, int S,
                            int K, int T, int B, int team, int rows,
                            int lanes_per_block, double* mss,
                            double* lss, double* if_out, void* stream) {
  return launch<double>(mfs, lfs, xi, w, sw, ghx, ghw, consts, S, K, T, B,
                        team, rows, lanes_per_block, mss, lss, if_out,
                        stream);
}

}  // extern "C"
