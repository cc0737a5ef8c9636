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

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kD = 4;            // state dimension
constexpr int kH = 1;            // measured state component
constexpr int kMaxPoints = 81;   // cap on S (GH-3 at d = 4)
constexpr int kMaxThreads = 256;   // threads per block
constexpr int kWords = kD + kD * kD + 1;   // output words per lane-step
constexpr int kNumConsts = 4 + 16 + 16 + 4 + 3;
constexpr double kLog2Pi = 1.8378770664093454835606594728112;

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

// kRows: pre-array rows a member owns, with P kRows >= S + kD.
template <typename Real, int P, int kRows>
__global__ void __launch_bounds__(kMaxThreads)
ghfs_chirp_filter_kernel(const Real* __restrict__ ys,    // (T, B)
                         const Real* __restrict__ xi_g,  // (S, kD)
                         const Real* __restrict__ w_g,   // (S,)
                         const Real* __restrict__ sw_g,  // (S,)
                         const ChirpConsts<Real> c, const int S,
                         const int T, const int B,
                         const int lanes_per_block,
                         Real* __restrict__ mfs,         // (T, kD, B)
                         Real* __restrict__ lfs,         // (T, kD*kD, B)
                         Real* __restrict__ nll_out) {   // (T, B)
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

  const int member = threadIdx.x % P;
  const int b = blockIdx.x * lanes_per_block + static_cast<int>(threadIdx.x) / P;
  if (b >= B) return;
  const unsigned mask =
      P == 32 ? 0xffffffffu
              : ((1u << P) - 1u) << ((threadIdx.x & 31u) & ~unsigned(P - 1));
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

    // Own sigma points, chirp-LCD mean, partial weighted mean.  Every row
    // slot is computed, without a branch, so that the rows' independent
    // chains interleave; a slot past S computes point S-1 at weight 0.
    Real mp[kD];
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
      // The rotation angle dt 2 pi softplus(chi_2), as pi times 2 dt softplus.
      Real sn, cs;
      dsincospi(Real(2) * c.dt * softplus(chi[2]), &sn, &cs);
      cs *= c.decay;
      sn *= c.decay;
      pre[i][0] = cs * chi[0] - sn * chi[1];
      pre[i][1] = sn * chi[0] + cs * chi[1];
      pre[i][2] = c.F[0][0] * chi[2] + c.F[0][1] * chi[3];
      pre[i][3] = c.F[1][0] * chi[2] + c.F[1][1] * chi[3];
      const Real wgt = r < S ? w_s[s] : Real(0);
#pragma unroll
      for (int k = 0; k < kD; ++k) mp[k] += wgt * pre[i][k];
    }
#pragma unroll
    for (int o = P / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k < kD; ++k) mp[k] += __shfl_xor_sync(mask, mp[k], o, P);
    }

    // Own rows of the pre-array [sqrt(w)(mu - mp); Lq^T; 0].
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = member + P * i;
      const int s = r < S ? r : S - 1;
      const int q = r < S ? 0 : (r - S < kD ? r - S : kD - 1);
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        const Real lq = r < n ? lqt_s[q][k] : Real(0);
        pre[i][k] = r < S ? sw_s[s] * (pre[i][k] - mp[k]) : lq;
      }
    }

    // Householder triangularization, one team reduction per column.  Row
    // j is owned by member j (i = 0); rows r < j are finished and masked.
    Real R[kD][kD];   // upper triangle, on every member
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

    // Update array: column 0 = [sqrt(Xi); Up[:, kH]], column 1+k =
    // [0; Up[:, k]], with Up = R the upper factor of the prediction.
    Real U[kD + 1][kD + 1];
    U[0][0] = c.sqrt_xi;
#pragma unroll
    for (int k = 0; k < kD; ++k) U[0][1 + k] = Real(0);
#pragma unroll
    for (int r = 0; r < kD; ++r) {
      U[1 + r][0] = r <= kH ? R[r][kH] : Real(0);
#pragma unroll
      for (int k = 0; k < kD; ++k) U[1 + r][1 + k] = r <= k ? R[r][k] : Real(0);
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
      } else {
        nll_out[ts * Bs + b] = nll;
      }
    }
  }
}

template <typename Real, int P, int kRows>
int launch_team(const Real* ys, const Real* xi, const Real* w, const Real* sw,
                const ChirpConsts<Real>& c, int S, int T, int B,
                int lanes_per_block, Real* mfs, Real* lfs, Real* nll,
                cudaStream_t stream) {
  if (lanes_per_block < 1 || P * lanes_per_block > kMaxThreads ||
      S + kD > P * kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0 || B == 0) return 0;
  const int blocks = (B + lanes_per_block - 1) / lanes_per_block;
  ghfs_chirp_filter_kernel<Real, P, kRows>
      <<<blocks, P * lanes_per_block, 0, stream>>>(
          ys, xi, w, sw, c, S, T, B, lanes_per_block, mfs, lfs, nll);
  return static_cast<int>(cudaGetLastError());
}

template <typename Real>
int launch(const Real* ys, const Real* xi, const Real* w, const Real* sw,
           const double* consts, int S, int T, int B, int team, int rows,
           int lanes_per_block, Real* mfs, Real* lfs, Real* nll,
           void* stream) {
  if (S < 1 || S > kMaxPoints || T < 0 || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
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
  const auto s = static_cast<cudaStream_t>(stream);
  // The instantiated (team, rows) pairs; ops/chirp_filter.py::ROWS lists
  // the same.
#define GHFS_LAUNCH(P, ROWS)                                               \
  launch_team<Real, P, ROWS>(ys, xi, w, sw, c, S, T, B, lanes_per_block,   \
                             mfs, lfs, nll, s)
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
  return launch<float>(ys, xi, w, sw, consts, S, T, B, team, rows,
                       lanes_per_block, mfs, lfs, nll, stream);
}

int ghfs_chirp_filter_f64(const double* ys, const double* xi, const double* w,
                          const double* sw, const double* consts, int S, int T,
                          int B, int team, int rows, int lanes_per_block,
                          double* mfs, double* lfs, double* nll, void* stream) {
  return launch<double>(ys, xi, w, sw, consts, S, T, B, team, rows,
                        lanes_per_block, mfs, lfs, nll, stream);
}

}  // extern "C"
