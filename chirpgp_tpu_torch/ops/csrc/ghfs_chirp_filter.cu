// Fused square-root Gauss-Hermite filter (GHFS) for the chirp LCD model,
// d = 4, measurement H = e_1 (the second state component).
//
// Replaces the TPU kernel
//   chirpgp_tpu/experimental/pallas_filter.py::ghfs_chirp_filter_pallas
// and computes exactly what the plain PyTorch version
//   chirpgp_tpu_torch/infer/batched.py::sqrt_sgp_filter_batched
// computes for the chirp model: per step, sigma points chi = m + xi L, the
// chirp-LCD mean (softplus frequency, rotation with decay e^{-lam dt},
// Matern-3/2 2x2 step), the weighted mean, a Householder triangularization
// of the (S+4) x 4 pre-array [sqrt(w)(mu - mp); Lq^T], a 5 x 5 update
// triangularization, the innovation and the cumulative NLL.
//
// Design.
// - One thread per Monte-Carlo lane b, masked at b < B.  The T loop runs
//   inside the kernel and the carry m (4), L (16) and nll stays in
//   registers.  (The TPU kernel carried it in VMEM scratch across a
//   sequential time grid; Hopper blocks run in no order, so nothing is
//   carried between blocks.)
// - The sigma-point table xi (S x 4), w and sqrt(w) is loaded into shared
//   memory once per block; every thread of a warp reads the same entry
//   (a broadcast).  S is capped at kMaxPoints = 81 (GH-3 at d = 4).
// - The (S+4) x 4 pre-array (340 values at S = 81) does not fit in
//   registers.  It lives in a per-thread LOCAL array (cached in L1/L2):
//   in shared memory it would take 128 x 1360 B = 174 KB per block in
//   float32 and twice that in float64.
// - The triangularizations reproduce the plain tria_cf (and the TPU
//   kernel's _tria_cols): alpha = -|x| when x_j >= 0, else +|x|;
//   reflections with |v|^2 <= 1e-30 are skipped; strictly-lower entries
//   of R are treated as zero.  So Lf matches the plain version
//   elementwise, not only as L L^T.
// - Softplus is the stable max(x, 0) + log1p(exp(-|x|)).  No fast math:
//   the sin/cos of the rotation and the log of the NLL are the accurate
//   library functions.
// - Model constants (F32, Lq^T, L0, m0, decay, sqrt(Xi), dt) are kernel
//   arguments, computed in float64 on the host and cast to Real.
// - Stores are mfs[t, r, b], lfs[t, i*4+j, b], nll[t, b], with b minor,
//   so the 32 lanes of a warp write 32 consecutive words.
// - Templated on float and double; the double instance is an on-card
//   oracle that separates algorithm faults from float32 rounding.
//
// What bounds it.  The T recursion is sequential, so the only parallelism
// is across lanes.  Per seed-step it does on the order of 1e4 flop
// (S = 81 sigma points x (16 FMA + softplus + sincos + 8) for the
// prediction, three passes over the 85 x 4 pre-array per Householder
// column), and it writes (4 + 16 + 1) x 4 B = 84 B per lane in float32.
// At B = 4096 it runs 4096 threads = 32 blocks of 128 on the 132 SMs of
// an H100: 100 SMs idle and 4 warps per busy SM, so latency, not
// throughput, bounds it.  That occupancy is the first thing to change.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kD = 4;            // state dimension
constexpr int kH = 1;            // measured state component
constexpr int kMaxPoints = 81;   // cap on S (GH-3 at d = 4)
constexpr int kThreads = 128;    // lanes per block
constexpr int kNumConsts = 4 + 16 + 16 + 4 + 3;
constexpr double kTwoPi = 6.283185307179586476925286766559;
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
__device__ __forceinline__ void dsincos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void dsincos(double x, double* s, double* c) {
  sincos(x, s, c);
}

template <typename Real>
__device__ __forceinline__ Real softplus(Real x) {
  return (x > Real(0) ? x : Real(0)) + dlog1p(dexp(-dabs(x)));
}

// Householder triangularization of the n x kD pre-array M (rows r >= j of
// column j are reflected at step j).  Afterwards R[r][k] = M[r][k] for
// r <= k < kD; entries below the diagonal are left as they fall and are
// never read.
template <typename Real>
__device__ __forceinline__ void tria_pre_array(Real (*M)[kD], int n) {
#pragma unroll
  for (int j = 0; j < kD; ++j) {
    Real nrm2 = Real(0);
    for (int r = j; r < n; ++r) nrm2 += M[r][j] * M[r][j];
    const Real norm = dsqrt(nrm2);
    const Real alpha = M[j][j] >= Real(0) ? -norm : norm;
    Real vn2 = Real(0);
    Real wk[kD];
#pragma unroll
    for (int k = 0; k < kD; ++k) wk[k] = Real(0);
    for (int r = j; r < n; ++r) {
      const Real v = r == j ? M[r][j] - alpha : M[r][j];
      vn2 += v * v;
#pragma unroll
      for (int k = j; k < kD; ++k) wk[k] += v * M[r][k];
    }
    const Real beta = vn2 > Real(1e-30) ? Real(2) / vn2 : Real(0);
    for (int r = j; r < n; ++r) {
      const Real v = r == j ? M[r][j] - alpha : M[r][j];
#pragma unroll
      for (int k = j; k < kD; ++k) M[r][k] -= beta * v * wk[k];
    }
  }
}

// The same reflections on the (kD+1) x (kD+1) update array, fully unrolled
// so that it stays in registers.
template <typename Real>
__device__ __forceinline__ void tria_update(Real (&M)[kD + 1][kD + 1]) {
  constexpr int n = kD + 1;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    Real nrm2 = Real(0);
#pragma unroll
    for (int r = j; r < n; ++r) nrm2 += M[r][j] * M[r][j];
    const Real norm = dsqrt(nrm2);
    const Real alpha = M[j][j] >= Real(0) ? -norm : norm;
    Real v[n];
    Real vn2 = Real(0);
#pragma unroll
    for (int r = j; r < n; ++r) {
      v[r] = r == j ? M[r][j] - alpha : M[r][j];
      vn2 += v[r] * v[r];
    }
    const Real beta = vn2 > Real(1e-30) ? Real(2) / vn2 : Real(0);
#pragma unroll
    for (int k = j; k < n; ++k) {
      Real wk = Real(0);
#pragma unroll
      for (int r = j; r < n; ++r) wk += v[r] * M[r][k];
#pragma unroll
      for (int r = j; r < n; ++r) M[r][k] -= beta * v[r] * wk;
    }
  }
}

template <typename Real>
__global__ void __launch_bounds__(kThreads)
ghfs_chirp_filter_kernel(const Real* __restrict__ ys,    // (T, B)
                         const Real* __restrict__ xi_g,  // (S, kD)
                         const Real* __restrict__ w_g,   // (S,)
                         const Real* __restrict__ sw_g,  // (S,)
                         const ChirpConsts<Real> c, const int S,
                         const int T, const int B,
                         Real* __restrict__ mfs,         // (T, kD, B)
                         Real* __restrict__ lfs,         // (T, kD*kD, B)
                         Real* __restrict__ nll_out) {   // (T, B)
  __shared__ Real xi_s[kMaxPoints][kD];
  __shared__ Real w_s[kMaxPoints];
  __shared__ Real sw_s[kMaxPoints];
  for (int i = threadIdx.x; i < S * kD; i += blockDim.x)
    xi_s[i / kD][i % kD] = xi_g[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    w_s[i] = w_g[i];
    sw_s[i] = sw_g[i];
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = static_cast<size_t>(B);

  Real m[kD], L[kD][kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    m[i] = c.m0[i];
#pragma unroll
    for (int j = 0; j < kD; ++j) L[i][j] = c.L0[i][j];
  }
  Real nll = Real(0);
  Real pre[kMaxPoints + kD][kD];   // local memory, see the note above
  const int n = S + kD;

  for (int t = 0; t < T; ++t) {
    const Real y = ys[t * Bs + b];

    // Sigma points, chirp-LCD mean, weighted mean.
    Real mp[kD];
#pragma unroll
    for (int i = 0; i < kD; ++i) mp[i] = Real(0);
    for (int s = 0; s < S; ++s) {
      Real chi[kD];
#pragma unroll
      for (int i = 0; i < kD; ++i) {
        Real acc = Real(0);
#pragma unroll
        for (int j = 0; j < kD; ++j) acc += xi_s[s][j] * L[i][j];
        chi[i] = m[i] + acc;
      }
      const Real wfreq = Real(kTwoPi) * softplus(chi[2]);
      Real sn, cs;
      dsincos(c.dt * wfreq, &sn, &cs);
      cs *= c.decay;
      sn *= c.decay;
      pre[s][0] = cs * chi[0] - sn * chi[1];
      pre[s][1] = sn * chi[0] + cs * chi[1];
      pre[s][2] = c.F[0][0] * chi[2] + c.F[0][1] * chi[3];
      pre[s][3] = c.F[1][0] * chi[2] + c.F[1][1] * chi[3];
#pragma unroll
      for (int i = 0; i < kD; ++i) mp[i] += w_s[s] * pre[s][i];
    }

    // Predict pre-array [sqrt(w)(mu - mp); Lq^T] and its triangularization.
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int i = 0; i < kD; ++i) pre[s][i] = sw_s[s] * (pre[s][i] - mp[i]);
    }
#pragma unroll
    for (int r = 0; r < kD; ++r) {
#pragma unroll
      for (int i = 0; i < kD; ++i) pre[S + r][i] = c.LqT[r][i];
    }
    tria_pre_array(pre, n);

    // Update array: column 0 = [sqrt(Xi); Up[:, kH]], column 1+k =
    // [0; Up[:, k]], with Up the upper factor of the prediction.
    Real U[kD + 1][kD + 1];
    U[0][0] = c.sqrt_xi;
#pragma unroll
    for (int k = 0; k < kD; ++k) U[0][1 + k] = Real(0);
#pragma unroll
    for (int r = 0; r < kD; ++r) {
      U[1 + r][0] = r <= kH ? pre[r][kH] : Real(0);
#pragma unroll
      for (int k = 0; k < kD; ++k) U[1 + r][1 + k] = r <= k ? pre[r][k] : Real(0);
    }
    tria_update(U);

    const Real sS = U[0][0];
    const Real innov = y - mp[kH];
    const Real ratio = innov / sS;
#pragma unroll
    for (int k = 0; k < kD; ++k) m[k] = mp[k] + U[0][1 + k] * ratio;
    // Lf = Uf^T: Lf[i][j] = U[1+j][1+i] for j <= i.
#pragma unroll
    for (int i = 0; i < kD; ++i) {
#pragma unroll
      for (int j = 0; j < kD; ++j) L[i][j] = j <= i ? U[1 + j][1 + i] : Real(0);
    }
    nll += Real(0.5) * (Real(kLog2Pi) + dlog(sS * sS) + innov * innov / (sS * sS));

    Real* mrow = mfs + t * kD * Bs + b;
#pragma unroll
    for (int i = 0; i < kD; ++i) mrow[i * Bs] = m[i];
    Real* lrow = lfs + t * kD * kD * Bs + b;
#pragma unroll
    for (int i = 0; i < kD; ++i) {
#pragma unroll
      for (int j = 0; j < kD; ++j) lrow[(i * kD + j) * Bs] = L[i][j];
    }
    nll_out[t * Bs + b] = nll;
  }
}

template <typename Real>
int launch(const Real* ys, const Real* xi, const Real* w, const Real* sw,
           const double* consts, int S, int T, int B, Real* mfs, Real* lfs,
           Real* nll, void* stream) {
  if (S < 1 || S > kMaxPoints || T < 0 || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0 || B == 0) return 0;
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
  const int blocks = (B + kThreads - 1) / kThreads;
  ghfs_chirp_filter_kernel<Real>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          ys, xi, w, sw, c, S, T, B, mfs, lfs, nll);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ghfs_chirp_filter_max_points() { return kMaxPoints; }

int ghfs_chirp_filter_num_consts() { return kNumConsts; }

int ghfs_chirp_filter_f32(const float* ys, const float* xi, const float* w,
                          const float* sw, const double* consts, int S, int T,
                          int B, float* mfs, float* lfs, float* nll,
                          void* stream) {
  return launch<float>(ys, xi, w, sw, consts, S, T, B, mfs, lfs, nll, stream);
}

int ghfs_chirp_filter_f64(const double* ys, const double* xi, const double* w,
                          const double* sw, const double* consts, int S, int T,
                          int B, double* mfs, double* lfs, double* nll,
                          void* stream) {
  return launch<double>(ys, xi, w, sw, consts, S, T, B, mfs, lfs, nll, stream);
}

}  // extern "C"
