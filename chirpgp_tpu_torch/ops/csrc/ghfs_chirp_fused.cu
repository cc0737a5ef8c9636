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
//      is phase B of the smoother (its Compose, Carry and Apply kernels).
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
// card's rate, sets the time, as for the filter kernel.  In practice F is
// bound by instruction issue at B = 4096 (about two team warps per
// scheduler) and by the step's chain at B = 100 (one lane per SM).  A
// design in which the team also built the joint array's columns 4..7, the
// maps and the stores, each member repeating the lane's scalar work under
// branches on its index, spent ~8k warp instructions per team warp and
// step; timing-only variants of it (time_fused.py) put 3.9 ms of its 25.5
// ms at B = 4096 f32 in what no later step reads, 3.2 ms in the
// transcendentals (2/3 of them repeats: see the groups below) and 1.5 ms
// in the member-specific stores.  G: ~250 flop and 30 words read, 2 (slim)
// or 20 (full) written per seed-step: bound by its bytes (0.49 ms slim at
// B = 4096, T = 3141 in float32), and by the issue of its step's
// instructions where one thread runs a lane.
//
// Design of F: the step splits where the carry leaves it, into warps of
// two roles in one block.
// - The team (producer): P = 8 or 32 threads per lane, the filter's team
//   (ghfs_chirp_filter.cu, whose note explains its choices), runs only
//   what the next step reads: the sigma points, m_p, A, dev - Q A and its
//   factor E (team_tria), R11 = Up from the first four columns of the joint
//   array, [E; A; Lq^T] (12 x 4, on every member, in registers:
//   joint_tria), the measurement update and the nll.  Every member runs
//   the same code, with no branch on its index, and it stores nothing to
//   device memory: m_p and the 16 sums of A are team reductions
//   (__shfl_xor_sync butterflies), E ends on every member.
// - The sigma points come grouped (ops/chirp_fused.py::fused_layout): the
//   kGroup = 3 point slots of a group share xi[0..2], so chi[0..2], the
//   part of chi[3] from them, the angle's softplus and sincospi and
//   mu[0..1] are computed once per group (predict_groups; GH-3: 27 groups
//   of 3; cubature: 7 groups, one of 2), with the same arithmetic as per
//   point, so sharing it changes no bit.  The rule is padded with points
//   of weight 0 to P kGroups groups; member p owns groups p, p + P, ...,
//   and its slots' offsets are compile-time constants from one base.
// - The hand-off: per lane-step the team writes the previous step's m and
//   L, m_p, E, A and the nll (kHandWords = 45 words, every member the same
//   values) into a ring of kRing steps in shared memory, [step][word]
//   [lane], and arrives on the slot's `full` mbarrier; before it writes a
//   slot it waits on the slot's `empty` mbarrier, so it runs up to kRing
//   steps ahead of the consumers.  After the last step one more hand-off
//   carries the last filtered m and L.
// - The consumers: kConsumers = 4 warps, one thread per lane (up to kLanes
//   = 32 lanes per block); warp c takes the steps t = c mod 4, since a
//   step's row depends on its hand-off alone.  A consumer waits on `full`,
//   reads its lane's words into registers, releases the slot on `empty`,
//   then builds the 12 x 8 joint array in its area of shared memory and
//   triangularizes it (joint_tria_shared: tria_cf's sign rule and skip,
//   dense over the rows below the pivot, whose structural zeros add exact
//   zeros), solves X = R11^-1 R12 by back-substitution and forms u, G and
//   D (maps) or m_p, X and R22 (factors) into its staging words, and
//   stores the row, the nll and, in factor mode, the previous step's
//   filtered m and L.  A store of one word by a warp covers 32
//   consecutive lanes: whole 128-byte lines in float32.
// - Code size.  Team and consumers share the SM's instruction caches, and
//   the consumer's code, more than its work, slows the team.  So the
//   consumer runs in loops that are not unrolled (over the columns, the
//   words it stores) on shared memory, at about twice the instructions of
//   an unrolled form, while the team's rows stay unrolled in registers.
//   On an H100 (time_fused.py's variants, f32 maps, B = 4096 / B = 100):
//   F 13.4 / 8.7 ms; 15.4 / 11.8 ms with the consumer's Householder
//   unrolled in registers (~1.3k instructions more), 12.4 / 7.6 ms without
//   the consumers' work.  Four consumer warps, since one warp of the loop
//   form took 33.3 / 27.2 ms; with 12 warps a scheduler holds 2 team
//   warps and 1 consumer, and the registers per thread are those of 9
//   warps (3 on a scheduler): 168, which the float64 team's 12 point rows
//   exceed (spills).
// - Geometry (ops/chirp_fused.py::fused_geometry): P = 8 with 32 lanes per
//   block (8 team warps and the 4 consumers) at the benchmark's B = 4096,
//   128 blocks (one SM must hold 32 lanes whatever the blocks, ceil(4096 /
//   132) = 32, so the four idle SMs cost nothing; blocks of 16 lanes took
//   22.7 ms, teams of 32 with 8 lanes 40.2 ms); P = 32 with one lane per
//   block up to one lane per SM, where the step's chain sets the time.
// Design of G.  Its chain from Ps to Ps is short (two layers of 4-deep FMA
// sums), but one thread per lane issued all of a step, ~260 instructions
// (30 shared-memory loads, ~120 FMAs, the copies and the stores), from one
// warp per SM at B = 4096 (that design, in one-warp blocks, took 1.12 ms
// at B = 4096 and at B = 100 on an H100: one lane's chain set the time).
// So a step is shared by a team of kBackTeam = 4 threads per lane, one
// warp per member: member p owns column j = p of the step (w_j = Ps g_j
// and column j of D + G W, W = Ps G^T, each summed in the one-thread
// order, so the outputs keep their bits), and every member updates ms
// itself.  The member is the warp's index, so each warp runs code of its
// own column with constant offsets and no branch inside a warp; the
// members hand the new upper triangle to each other through shared
// memory, one block barrier per step.  Measured on an H100 (time_fused.py;
// f32 slim, B = 4096): four members of a lane in one warp, exchanging by
// __shfl_sync, took 1.3-1.9 ms in four layouts, slower than one thread per
// lane: every member loaded all 30 words and picked its column by selects
// or runtime offsets, and a warp's 4-byte copies of 8 lanes of 4 words
// touched 4 lines each.  Blocks of up to 32 lanes (4 warps, one per
// scheduler at B = 4096; ops/chirp_fused.py::affine_geometry takes 8 at
// small B, to spread the lanes over the SMs).  The block's threads copy
// the rows kGStages - 1 steps ahead with cp.async into a ring in dynamic
// shared memory, whole lines a warp instruction: 16 bytes a copy where
// every block is whole and every line aligned, else 4 or 8 (4 or 8 bytes
// everywhere took 1.12 ms slim f32 at B = 4096, against 0.82).  TMA bulk
// copies of a step's 30 lines (one elected thread, mbarriers) took 4.3-4.6
// ms at B = 4096: a line of 32 lanes is 128 bytes, too small a copy.  A
// slim step stores from the member that owns out_index, a full one stores
// each member's column, the lower triangle mirrored.
//
// What is not used, and why: tensor cores (the per-lane products are 4
// wide; TF32 is barred by the port's precision policy), a Cholesky of the
// Gram in place of the Householder (it squares the condition number), a
// TMA bulk store of the rows (the consumer's stores are whole lines
// already).  Model constants in the filter's layout (ops/chirp_filter.py::
// _chirp_constants, float64 on the host).  No fast math.  Templated on
// float and double.  Registers and spills of each instance: phase 1 of
// chip_smoke.py prints ptxas's report (one count for both roles).

#include <cuda_runtime.h>

#include <cstddef>

#include "chirp_lcd.cuh"

namespace {

constexpr int kJ = 3 * kD;        // rows of the joint array
constexpr int kJCols = 2 * kD;    // its columns
constexpr int kTri = kD * (kD + 1) / 2;    // words of a triangle
constexpr int kLastWords = kD + kD * kD;   // the last filtered m and L
// G: threads per lane (its team), steps of its ring, most lanes per block
// and threads per block.
constexpr int kBackTeam = 4;
constexpr int kGStages = 8;
constexpr int kGLanes = 32;
constexpr int kGThreads = kBackTeam * kGLanes;
static_assert(kD % kBackTeam == 0 && kBackTeam <= 4,
              "a member owns whole columns, a warp of its own");
static_assert(kGStages >= 2, "a slot is refilled the step after it is read");

// F: lanes per block (a consumer warp's threads), consumer warps per block
// (warp c takes the steps t = c mod kConsumers), threads per block (8 team
// warps of 32 lanes and the consumers), steps of the hand-off ring, point
// slots of the padded rule (a team of 32 with 3 groups per member).
constexpr int kLanes = 32;
constexpr int kConsumers = 4;
constexpr int kForwardThreads = 8 * kLanes + 32 * kConsumers;
constexpr int kRing = 4;
constexpr int kMaxSlots = 32 * 3 * kGroup;
// A wait on an mbarrier's phase parity cannot tell that phase from the one
// two before it: a consumer may wait on a slot's round only once the
// slot's previous round was written, which the step it took before
// (kConsumers steps back) ensures only if kRing >= kConsumers.
static_assert(kRing >= kConsumers, "a consumer would wait two rounds ahead");
// The words of a hand-off, per lane: m and L (lower, row by row) of the
// previous step, m_p, E (upper, row by row), A (row-major), the nll.
constexpr int kHandM = 0;
constexpr int kHandL = kHandM + kD;
constexpr int kHandMp = kHandL + kTri;
constexpr int kHandE = kHandMp + kD;
constexpr int kHandA = kHandE + kTri;
constexpr int kHandNll = kHandA + kD * kD;
constexpr int kHandWords = kHandNll + 1;

__host__ __device__ constexpr int lower_word(int i, int j) {
  return i * (i + 1) / 2 + j;
}
__host__ __device__ constexpr int upper_word(int r, int c) {
  return r * kD - r * (r - 1) / 2 + (c - r);
}

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

// The first kD columns of the joint array, [E; A; Lq^T], from the words of
// E (upper) and A and the model's Lq^T.
template <typename Real>
__device__ __forceinline__ void joint_left(const ChirpConsts<Real>& c,
                                           const Real (&E)[kTri],
                                           const Real (&A)[kD * kD],
                                           Real (&M)[kJ][kD]) {
#pragma unroll
  for (int r = 0; r < kD; ++r) {
#pragma unroll
    for (int k = 0; k < kD; ++k) {
      M[kD + r][k] = A[r * kD + k];
      M[r][k] = k >= r ? E[upper_word(r, k)] : Real(0);
      M[2 * kD + r][k] = k >= r ? c.LqT[r][k] : Real(0);
    }
  }
}

// Householder triangularization of the first NC columns of the joint
// array, held whole by one thread in registers: NC = kD gives R11 (the
// team).  Column j over its live rows
// (joint_row): alpha = -sign(M_jj) |x| (tria_cf's sign rule), v, beta = 2
// / |v|^2 (skipped at |v|^2 <= 1e-30), then w_k = v^T M_k and M_k -= beta
// v w_k for every column k >= j.  The structural zeros add exact zeros, so
// the result is that of the dense reflections; row j of R is M's row j.
// Columns 0..kD-1 get the same arithmetic at any NC, and in
// joint_tria_shared.
template <int NC, typename Real>
__device__ __forceinline__ void joint_tria(Real (&M)[kJ][NC]) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    Real v[kJ];
    Real nrm2 = Real(0);
#pragma unroll
    for (int r = 0; r < kJ; ++r) {
      if (joint_row(j, r)) {
        v[r] = M[r][j];
        nrm2 += v[r] * v[r];
      }
    }
    const Real norm = dsqrt(nrm2);
    const Real alpha = v[j] >= Real(0) ? -norm : norm;
    v[j] -= alpha;
    Real vn2 = Real(0);
#pragma unroll
    for (int r = 0; r < kJ; ++r) {
      if (joint_row(j, r)) vn2 += v[r] * v[r];
    }
    const Real beta = vn2 > Real(1e-30) ? two_over(vn2) : Real(0);
#pragma unroll
    for (int k = j; k < NC; ++k) {
      Real wk = Real(0);
#pragma unroll
      for (int r = 0; r < kJ; ++r) {
        if (joint_row(j, r)) wk += v[r] * M[r][k];
      }
#pragma unroll
      for (int r = 0; r < kJ; ++r) {
        if (joint_row(j, r)) M[r][k] -= beta * v[r] * wk;
      }
    }
  }
}

// A consumer's joint array in shared memory, word r kJCols + k of row r,
// column k, lane minor; after its triangularization rows kJ - 4.. stage
// the packed row.
constexpr int kWork = kJ * kJCols;
constexpr int kStage = (kJ - kD) * kJCols;
static_assert(kWork - kStage >= kRowWords, "the row must fit in rows 8..11");

template <typename Real>
struct ForwardShared {
  Real ring[kRing][kHandWords][kLanes];
  Real work[kConsumers][kWork][kLanes];
  unsigned long long full[kRing], empty[kRing];
};

// The Householder triangularization of joint_tria on the dense array W
// (W[(r kJCols + k) kLanes], one lane's), in loops that are not unrolled
// over the columns: the consumer's code stays small.  Column j reflects
// rows j.. (the rows above are R's finished rows); the structural zeros
// among them are exact zeros, so the dense sums and updates give
// joint_tria's values.
template <typename Real>
__device__ __forceinline__ void joint_tria_shared(Real* __restrict__ W) {
#pragma unroll 1
  for (int j = 0; j < kJCols; ++j) {
    Real v[kJ];
    Real nrm2 = Real(0);
#pragma unroll
    for (int r = 0; r < kJ; ++r) {
      v[r] = r >= j ? W[(r * kJCols + j) * kLanes] : Real(0);
      nrm2 += v[r] * v[r];
    }
    const Real norm = dsqrt(nrm2);
    const Real pivot = W[(j * kJCols + j) * kLanes];
    const Real alpha = pivot >= Real(0) ? -norm : norm;
    Real vn2 = Real(0);
#pragma unroll
    for (int r = 0; r < kJ; ++r) {
      if (r == j) v[r] = pivot - alpha;
      vn2 += v[r] * v[r];
    }
    const Real beta = vn2 > Real(1e-30) ? two_over(vn2) : Real(0);
#pragma unroll 1
    for (int k = j; k < kJCols; ++k) {
      Real col[kJ];
      Real wk = Real(0);
#pragma unroll
      for (int r = 0; r < kJ; ++r) {
        col[r] = W[(r * kJCols + k) * kLanes];
        wk += v[r] * col[r];
      }
#pragma unroll
      for (int r = 0; r < kJ; ++r)
        W[(r * kJCols + k) * kLanes] = col[r] - beta * v[r] * wk;
    }
  }
}

// The team: threads [0, P lanes) of the block, member threadIdx % P of lane
// threadIdx / P.  Per step it hands off the words that the consumer needs
// (its ring slot, waited on `empty` and published on `full`); after the
// last step, the last filtered m and L.
template <typename Real, int P, int kGroups, int N>
__device__ __forceinline__ void forward_team(
    const ChirpConsts<Real>& c, const Real* __restrict__ ys,
    const Real (&xi_s)[kD][N], const Real (&w_s)[N], const Real (&sw_s)[N],
    ForwardShared<Real>& sh, const int T, const int B, const int lanes) {
  constexpr int kRows = kGroups * kGroup;   // point slots of a member
  const int member = threadIdx.x % P;
  const int lane = threadIdx.x / P;
  // A lane past B filters lane B-1's measurements; nothing of it is
  // stored.
  const int b = min(static_cast<int>(blockIdx.x) * lanes + lane, B - 1);
  const unsigned mask = team_mask<P>();
  const size_t Bs = static_cast<size_t>(B);
  const int base = kGroup * member;

  Real m[kD], L[kD][kD];   // L: lower triangle only
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    m[i] = c.m0[i];
#pragma unroll
    for (int j = 0; j <= i; ++j) L[i][j] = c.L0[i][j];
  }
  Real nll = Real(0);
  Real dev[kRows][kD];   // the member's point slots: mu, dev, dev - Q A
  int slot = 0;
  unsigned parity = 0;

  for (int t = 0; t < T; ++t) {
    const Real y = ys[t * Bs + b];
    Real mp[kD];
    predict_groups<Real, P, kGroups>(c, xi_s, w_s, base, m, L, dev, mp);
    team_sum<P>(mask, mp);

    // dev = sqrt(w) (mu - m_p) (padding slots: zero), and A = Q^T dev over
    // the team, Q = sqrt(w) xi: A[p][k] = sum_s Q[s][p] dev[s][k].
    Real A[kD * kD];
#pragma unroll
    for (int k = 0; k < kD * kD; ++k) A[k] = Real(0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int s = base + kGroup * P * (i / kGroup) + i % kGroup;
#pragma unroll
      for (int k = 0; k < kD; ++k) dev[i][k] = sw_s[s] * (dev[i][k] - mp[k]);
#pragma unroll
      for (int p = 0; p < kD; ++p) {
        const Real q = sw_s[s] * xi_s[p][s];
#pragma unroll
        for (int k = 0; k < kD; ++k) A[p * kD + k] += q * dev[i][k];
      }
    }
    team_sum<P>(mask, A);

    // dev - Q A on the own slots, and its triangular factor E (every
    // member).
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int s = base + kGroup * P * (i / kGroup) + i % kGroup;
      Real q[kD];
#pragma unroll
      for (int p = 0; p < kD; ++p) q[p] = sw_s[s] * xi_s[p][s];
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        Real qa = Real(0);
#pragma unroll
        for (int p = 0; p < kD; ++p) qa += q[p] * A[p * kD + k];
        dev[i][k] -= qa;
      }
    }
    Real R[kD][kD];
    team_tria<Real, P, kRows>(mask, member, dev, R);
    Real E[kTri], Lw[kTri], m_prev[kD];
#pragma unroll
    for (int r = 0; r < kD; ++r) {
      m_prev[r] = m[r];
#pragma unroll
      for (int k = r; k < kD; ++k) E[upper_word(r, k)] = R[r][k];
#pragma unroll
      for (int k = 0; k <= r; ++k) Lw[lower_word(r, k)] = L[r][k];
    }

    // Up = R11 from [E; A; Lq^T], then the update.
    Real M[kJ][kD], Up[kD][kD];
    joint_left(c, E, A, M);
    joint_tria<kD>(M);
#pragma unroll
    for (int r = 0; r < kD; ++r) {
#pragma unroll
      for (int k = r; k < kD; ++k) Up[r][k] = M[r][k];
    }
    measurement_update(c, Up, mp, y, m, L, nll);

    mbar_wait(&sh.empty[slot], parity ^ 1u);
    Real(*h)[kLanes] = sh.ring[slot];
#pragma unroll
    for (int k = 0; k < kD; ++k) {
      h[kHandM + k][lane] = m_prev[k];
      h[kHandMp + k][lane] = mp[k];
    }
#pragma unroll
    for (int k = 0; k < kTri; ++k) {
      h[kHandL + k][lane] = Lw[k];
      h[kHandE + k][lane] = E[k];
    }
#pragma unroll
    for (int k = 0; k < kD * kD; ++k) h[kHandA + k][lane] = A[k];
    h[kHandNll][lane] = nll;
    mbar_arrive(&sh.full[slot]);
    if (++slot == kRing) {
      slot = 0;
      parity ^= 1u;
    }
  }

  mbar_wait(&sh.empty[slot], parity ^ 1u);
  Real(*h)[kLanes] = sh.ring[slot];
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    h[kHandM + i][lane] = m[i];
#pragma unroll
    for (int j = 0; j <= i; ++j) h[kHandL + lower_word(i, j)][lane] = L[i][j];
  }
  mbar_arrive(&sh.full[slot]);
}

// A consumer: warp `consumer` of the block's last kConsumers warps, thread
// `lane` for lane `lane`, takes the hand-offs t = consumer mod kConsumers.
// Hand-off t < T gives the nll of step t and, for t > 0, the row that
// smooths time t-1 and (factor mode) the filtered m and L of time t-1;
// hand-off T the last filtered m and L.  The joint array, its
// triangularization, the row and the stores run in shared memory and in
// loops that are not unrolled: the consumer's code, not its work, is what
// slowed the team (a copy of its work in a loop of a few instructions
// cost F 0.3 ms where its unrolled form cost 2.6 ms at B = 4096 f32 on an
// H100; time_fused.py), since team and consumer share the SM's
// instruction caches.
template <typename Real>
__device__ __forceinline__ void forward_consumer(
    const ChirpConsts<Real>& c, ForwardShared<Real>& sh, const int consumer,
    const int T, const int B, const int lanes, const bool factors,
    Real* __restrict__ rows, Real* __restrict__ mfs, Real* __restrict__ lfs,
    Real* __restrict__ nll_out) {
  const int lane = static_cast<int>(threadIdx.x % 32u);
  const int b = static_cast<int>(blockIdx.x) * lanes + lane;
  const bool active = lane < lanes && b < B;
  const size_t Bs = static_cast<size_t>(B);
  Real* __restrict__ W = &sh.work[consumer][0][lane];
  Real* __restrict__ stage = W + kStage * kLanes;
  for (int t = consumer; t <= T; t += kConsumers) {
    const int slot = t % kRing;
    const unsigned parity = static_cast<unsigned>(t / kRing) & 1u;
    mbar_wait(&sh.full[slot], parity);
    const Real(*h)[kLanes] = sh.ring[slot];
    Real m_prev[kD], mp[kD], Lw[kTri], E[kTri], A[kD * kD];
#pragma unroll
    for (int k = 0; k < kD; ++k) {
      m_prev[k] = h[kHandM + k][lane];
      mp[k] = h[kHandMp + k][lane];
    }
#pragma unroll
    for (int k = 0; k < kTri; ++k) {
      Lw[k] = h[kHandL + k][lane];
      E[k] = h[kHandE + k][lane];
    }
#pragma unroll
    for (int k = 0; k < kD * kD; ++k) A[k] = h[kHandA + k][lane];
    const Real nll = h[kHandNll][lane];
    mbar_arrive(&sh.empty[slot]);

    if (active) {   // the consumer's work
      const size_t ts = static_cast<size_t>(t);
      if (t < T) nll_out[ts * Bs + b] = nll;
      if (t > 0 && t < T) {
        // The joint array [[E, 0], [A, L^T], [Lq^T, 0]], then R.
#pragma unroll 1
        for (int i = 0; i < kWork; ++i) W[i * kLanes] = Real(0);
#pragma unroll
        for (int r = 0; r < kD; ++r) {
#pragma unroll
          for (int k = 0; k < kD; ++k) {
            W[((kD + r) * kJCols + k) * kLanes] = A[r * kD + k];
            if (k < r) continue;
            W[(r * kJCols + k) * kLanes] = E[upper_word(r, k)];
            W[((kD + r) * kJCols + kD + k) * kLanes] = Lw[lower_word(k, r)];
            W[((2 * kD + r) * kJCols + k) * kLanes] = c.LqT[r][k];
          }
        }
        joint_tria_shared(W);
        // X = R11^-1 R12, column by column, into the row's X or G words.
#pragma unroll 1
        for (int cc = 0; cc < kD; ++cc) {
          Real x[kD];
#pragma unroll
          for (int i = kD - 1; i >= 0; --i) {
            Real acc = W[(i * kJCols + kD + cc) * kLanes];
#pragma unroll
            for (int k = i + 1; k < kD; ++k)
              acc = acc - W[(i * kJCols + k) * kLanes] * x[k];
            x[i] = acc / W[(i * kJCols + i) * kLanes];
            stage[(kXWord + (factors ? i * kD + cc : cc * kD + i)) * kLanes] = x[i];
          }
          // u[cc] = m_prev[cc] - sum_j G[cc][j] m_p[j], G[cc][j] = x[j].
          Real gm = Real(0);
#pragma unroll
          for (int j = 0; j < kD; ++j) gm += x[j] * mp[j];
          stage[cc * kLanes] = factors ? mp[cc] : m_prev[cc] - gm;
        }
        // R22's upper triangle (factors) or D = R22^T R22's (maps).
#pragma unroll
        for (int i = 0; i < kD; ++i) {
#pragma unroll
          for (int j = i; j < kD; ++j) {
            Real d = Real(0);
#pragma unroll
            for (int k = 0; k <= i; ++k)
              d += W[((kD + k) * kJCols + kD + i) * kLanes] *
                   W[((kD + k) * kJCols + kD + j) * kLanes];
            stage[r22_word(i, j) * kLanes] =
                factors ? W[((kD + i) * kJCols + kD + j) * kLanes] : d;
          }
        }
        Real* out = rows + (ts - 1) * kRowWords * Bs + b;
#pragma unroll 1
        for (int w = 0; w < kRowWords; ++w) out[w * Bs] = stage[w * kLanes];
      }
      if (factors ? t > 0 : t == T) {
        const size_t to = factors ? ts - 1 : 0;
#pragma unroll
        for (int i = 0; i < kD; ++i) {
          stage[i * kLanes] = m_prev[i];
#pragma unroll
          for (int j = 0; j < kD; ++j)
            stage[(kD + i * kD + j) * kLanes] = j <= i ? Lw[lower_word(i, j)] : Real(0);
        }
#pragma unroll 1
        for (int w = 0; w < kLastWords; ++w) {
          if (w < kD) {
            mfs[(to * kD + w) * Bs + b] = stage[w * kLanes];
          } else {
            lfs[(to * kD * kD + w - kD) * Bs + b] = stage[w * kLanes];
          }
        }
      }
    }
  }
}

// F.  xi_g, w_g, sw_g: the grouped rule of P kGroups groups of kGroup
// point slots (ops/chirp_fused.py::fused_layout).  factors: write the
// factor mode's rows, mfs and lfs at every step; else the maps, and mfs
// and lfs at t = T-1 only (into their row 0).  Blocks of P lanes + 32
// kConsumers threads: the team, then the consumer warps; the ring and its
// mbarriers in dynamic shared memory (ForwardShared).
template <typename Real, int P, int kGroups>
__global__ void __launch_bounds__(kForwardThreads)
fused_forward_kernel(const Real* __restrict__ ys,    // (T, B)
                     const Real* __restrict__ xi_g,  // (slots, kD)
                     const Real* __restrict__ w_g,   // (slots,)
                     const Real* __restrict__ sw_g,  // (slots,)
                     const ChirpConsts<Real> c, const int T, const int B,
                     const int lanes, const bool factors,
                     Real* __restrict__ rows,        // (T-1, kRowWords, B)
                     Real* __restrict__ mfs,         // (T or 1, kD, B)
                     Real* __restrict__ lfs,         // (T or 1, kD*kD, B)
                     Real* __restrict__ nll_out) {   // (T, B)
  constexpr int kSlots = P * kGroups * kGroup;
  __shared__ Real xi_s[kD][kSlots];
  __shared__ Real w_s[kSlots];
  __shared__ Real sw_s[kSlots];
  extern __shared__ __align__(16) unsigned char forward_smem[];
  ForwardShared<Real>& sh = *reinterpret_cast<ForwardShared<Real>*>(forward_smem);
  const int team_threads = P * lanes;
  for (int i = threadIdx.x; i < kSlots * kD; i += blockDim.x)
    xi_s[i % kD][i / kD] = xi_g[i];
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x) {
    w_s[i] = w_g[i];
    sw_s[i] = sw_g[i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&sh.full[s], static_cast<unsigned>(team_threads));
      mbar_init(&sh.empty[s], 32u);
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < team_threads) {
    forward_team<Real, P, kGroups>(c, ys, xi_s, w_s, sw_s, sh, T, B, lanes);
  } else {
    forward_consumer<Real>(c, sh, (threadIdx.x - team_threads) / 32, T, B,
                           lanes, factors, rows, mfs, lfs, nll_out);
  }
}

// G's shared memory (dynamic): a ring of kGStages steps of the kRowWords
// words of kGLanes lanes, [step][word][lane] as the rows lie in device
// memory, then the exchange of the new upper triangle, two buffers of kTri
// words of kGLanes lanes.  A block of fewer lanes leaves the rest unused,
// so that every offset in a step is a constant.
template <typename Real>
__host__ __device__ constexpr size_t g_smem_bytes() {
  return (static_cast<size_t>(kGStages) * kRowWords + 2 * kTri) * kGLanes *
         sizeof(Real);
}

// A 16-byte cp.async (L2 only) of V lanes of one word.
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_address(dst)), "l"(src) : "memory");
}

// A thread's cp.async copies of G's steps: pairs k = threadIdx.x + i
// kGThreads of the kRowWords x (lanes / V) (word, V-lane chunk) pairs,
// chunks fastest, so that a warp's copy of a word takes whole lines at
// 32 lanes a block; V = 1 (4 or 8 bytes a copy; a lane past B copies lane
// B-1's words) or 16 / sizeof(Real) (16 bytes a copy: whole blocks of
// aligned lines only).  As offsets in the rows of a time and in a ring
// slot.
template <typename Real, int V>
struct GCopies {
  static constexpr int kPerThread = (kRowWords * kGLanes / V + kGThreads - 1) / kGThreads;
  size_t src[kPerThread];
  int dst[kPerThread];

  __device__ __forceinline__ GCopies(const int lanes, const int b0, const int B) {
    const int chunks = lanes / V;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int k = static_cast<int>(threadIdx.x) + i * kGThreads;
      const int w = k / chunks, l = k % chunks * V;
      src[i] = w < kRowWords ? w * static_cast<size_t>(B) + min(b0 + l, B - 1) : 0;
      dst[i] = w < kRowWords ? w * kGLanes + l : -1;
    }
  }
  __device__ __forceinline__ void issue(Real* slot, const Real* rows_t) const {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (dst[i] >= 0) {
        if (V == 1) {
          copy_async(slot + dst[i], rows_t + src[i]);
        } else {
          copy_async16(slot + dst[i], rows_t + src[i]);
        }
      }
    }
  }
};

// The barrier of G's block: each warp reaches it from its own member's
// code, so not __syncthreads (whose `.aligned` form needs every thread at
// the same instruction): barrier 1, non-aligned, over the block's
// threads.  It orders shared memory as __syncthreads does.
__device__ __forceinline__ void g_barrier() {
  asm volatile("barrier.sync 1, %0;\n" ::"n"(kGThreads) : "memory");
}

// The step of G's member `p`, columns j = p, p + kBackTeam, .. (compile
// time), on lane `lane` of the block, for steps u = 0 .. T-2 (time T-2-u):
// Ps_{u+1} = D + G Ps_u G^T by columns, each summed in the one-thread
// order (W = Ps G^T, then D + G W), so that every entry keeps its bits, and
// ms <- u + G ms on every member.  Each iteration: the thread's copies of
// step u have landed and the block barrier shows every thread's, and the
// upper triangle that the members wrote to the exchange before it; the
// slot of step u-1 takes step u-1 + kGStages; the member loads G, its
// columns of D, u and Ps_u, stores what it owns of time T-1-u, and writes
// its columns of Ps_{u+1} (entries i <= j) to the other buffer.
// (The shared-memory pointers carry no __restrict__: other threads write
// what they point to between barriers.)
template <typename Real, bool kSlim, int p, int V>
__device__ __forceinline__ void affine_member(
    const Real* __restrict__ rows, Real* ring, Real* xch, const int T,
    const int B, const int lane, const int b, const bool active,
    const int out_index, const GCopies<Real, V>& copies, Real (&ms)[kD],
    Real* __restrict__ out_m, Real* __restrict__ out_p) {
  constexpr int P = kBackTeam;
  constexpr int kCols = kD / P;
  constexpr int kSlot = kRowWords * kGLanes;
  const size_t Bs = static_cast<size_t>(B);
  const int steps = T - 1;
  const size_t step_words = static_cast<size_t>(kRowWords) * Bs;
  // Step u is time T-2-u, in slot u % kGStages.
  auto fetch = [&](int u) {
    copies.issue(ring + (u % kGStages) * kSlot,
                 rows + static_cast<size_t>(steps - 1 - u) * step_words);
  };
  const size_t out_step = kSlim ? Bs : kD * Bs;
  const size_t p_step = kSlim ? Bs : kD * kD * Bs;
  Real* om = out_m + static_cast<size_t>(T - 1) * out_step + b;
  Real* op = out_p + static_cast<size_t>(T - 1) * p_step + b;
  // The outputs of one time from ms and the exchange's upper triangle.
  auto store = [&](const Real* __restrict__ up) {
    if (active) {
      if (kSlim) {
        if (p == out_index % P) {
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            if (p + P * q == out_index) {
              *om = ms[p + P * q];
              *op = up[upper_word(p + P * q, p + P * q) * kGLanes];
            }
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int j = p + P * q;
          om[j * Bs] = ms[j];
#pragma unroll
          for (int i = 0; i < kD; ++i)
            op[(i * kD + j) * Bs] = up[upper_word(i < j ? i : j, i < j ? j : i) * kGLanes];
        }
      }
    }
    om -= out_step;
    op -= p_step;
  };

  for (int u = 0; u < kGStages; ++u) {
    if (u < steps) fetch(u);
    copy_commit();
  }
  for (int u = 0; u < steps; ++u) {
    // Group g holds step g: the first kGStages, then one a step from u = 1,
    // so that u + kGStages - 1 groups are committed here (u >= 1) and all
    // but the newest kGStages - 2 make steps 0..u.
    copy_wait<kGStages - 2>();   // this thread's copies of step u landed
    g_barrier();                 // the block's, and the exchange of Ps_u
    if (u > 0) {
      if (u - 1 + kGStages < steps) fetch(u - 1 + kGStages);
      copy_commit();
    }
    const Real* st = ring + (u % kGStages) * kSlot + lane;
    const Real* up = xch + (u & 1) * kTri * kGLanes + lane;
    Real G[kD][kD], Ps[kD][kD];
#pragma unroll
    for (int i = 0; i < kD; ++i) {
#pragma unroll
      for (int k = 0; k < kD; ++k) G[i][k] = st[(kXWord + i * kD + k) * kGLanes];
    }
#pragma unroll
    for (int i = 0; i < kD; ++i) {
#pragma unroll
      for (int k = i; k < kD; ++k) {
        Ps[i][k] = up[upper_word(i, k) * kGLanes];
        Ps[k][i] = Ps[i][k];
      }
    }
    store(up);
    // ms <- u + G ms.
    Real mn[kD];
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      Real acc = Real(0);
#pragma unroll
      for (int k = 0; k < kD; ++k) acc += G[i][k] * ms[k];
      mn[i] = st[i * kGLanes] + acc;
    }
#pragma unroll
    for (int i = 0; i < kD; ++i) ms[i] = mn[i];
    // The member's columns of D + G W, W = Ps G^T, into the other buffer.
    Real* next = xch + ((u + 1) & 1) * kTri * kGLanes + lane;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int j = p + P * q;
      Real w[kD];
#pragma unroll
      for (int i = 0; i < kD; ++i) {
        Real a = Real(0);
#pragma unroll
        for (int k = 0; k < kD; ++k) a += Ps[i][k] * G[j][k];
        w[i] = a;
      }
#pragma unroll
      for (int i = 0; i <= j; ++i) {
        Real a = Real(0);
#pragma unroll
        for (int k = 0; k < kD; ++k) a += G[i][k] * w[k];
        next[upper_word(i, j) * kGLanes] = st[r22_word(i, j) * kGLanes] + a;
      }
    }
  }
  g_barrier();   // Ps of time 0
  store(xch + (steps & 1) * kTri * kGLanes + lane);
}

// G: a team of kBackTeam threads per lane in as many warps, the member
// index the warp's (so that each warp runs the code of its own columns,
// with no branch inside a warp and every offset a constant): member p of
// lane threadIdx.x % 32 owns the columns j = p, p + kBackTeam, .. of a
// step (affine_member).  The members hand the new upper triangle to each
// other through shared memory, one block barrier per step, which also
// shows the block's cp.async copies of the rows, kGStages - 1 steps
// ahead, shared out over the block's threads in whole lines.  slim: write
// ms[out_index] and Ps[out_index][out_index] of every step into (T, B)
// out_m and out_p (the member that owns column out_index); else ms into
// (T, kD, B) out_m and the whole Ps into (T, kD*kD, B) out_p, each member
// its columns, the lower triangle mirrored.  A lane past B runs lane
// B-1's steps and stores nothing.
template <typename Real, bool kSlim, int V>
__global__ void __launch_bounds__(kGThreads)
affine_backward_kernel(const Real* __restrict__ rows,    // (T-1, kRowWords, B)
                       const Real* __restrict__ mf,      // (kD, B), time T-1
                       const Real* __restrict__ lf,      // (kD*kD, B), time T-1
                       const int T, const int B, const int lanes,
                       const int out_index, Real* __restrict__ out_m,
                       Real* __restrict__ out_p) {
  extern __shared__ __align__(128) unsigned char backward_smem[];
  Real* ring = reinterpret_cast<Real*>(backward_smem);
  Real* xch = ring + kGStages * kRowWords * kGLanes;
  const int lane = static_cast<int>(threadIdx.x % 32u);
  const int member = static_cast<int>(threadIdx.x / 32u);
  const int b0 = static_cast<int>(blockIdx.x) * lanes;
  const bool active = lane < lanes && b0 + lane < B;
  const int b = min(b0 + min(lane, lanes - 1), B - 1);
  if (T < 1) return;

  const GCopies<Real, V> copies(lanes, b0, B);

  // The last filtered moments: ms = mf, Ps = Lf Lf^T, its upper triangle
  // to the exchange (member 0).
  Real ms[kD];
  {
    Real Lf[kD][kD];
    const size_t Bs = static_cast<size_t>(B);
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      ms[i] = mf[i * Bs + b];
#pragma unroll
      for (int j = 0; j <= i; ++j) Lf[i][j] = lf[(i * kD + j) * Bs + b];
    }
    if (member == 0) {
#pragma unroll
      for (int i = 0; i < kD; ++i) {
#pragma unroll
        for (int j = i; j < kD; ++j) {
          Real acc = Real(0);
#pragma unroll
          for (int k = 0; k <= i; ++k) acc += Lf[i][k] * Lf[j][k];
          xch[upper_word(i, j) * kGLanes + lane] = acc;
        }
      }
    }
  }
  // Warp-uniform: each warp runs its member's code.
  switch (member) {
#define G_MEMBER(M)                                                            \
  case M:                                                                      \
    if (M < kBackTeam)                                                         \
      affine_member<Real, kSlim, M % kBackTeam, V>(rows, ring, xch, T, B,      \
                                                   lane, b, active, out_index, \
                                                   copies, ms, out_m, out_p);  \
    break;
    G_MEMBER(0)
    G_MEMBER(1)
    G_MEMBER(2)
    G_MEMBER(3)
#undef G_MEMBER
  }
}

template <typename Real, int P, int kGroups>
int launch_forward_team(const Real* ys, const Real* xi, const Real* w,
                        const Real* sw, const ChirpConsts<Real>& c, int slots,
                        int T, int B, int lanes, bool factors, Real* rows,
                        Real* mfs, Real* lfs, Real* nll, cudaStream_t stream) {
  if (lanes < 1 || lanes > kLanes || (P * lanes) % 32 != 0 ||
      P * lanes + 32 * kConsumers > kForwardThreads ||
      slots != P * kGroups * kGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int blocks = (B + lanes - 1) / lanes;
  constexpr int kBytes = static_cast<int>(sizeof(ForwardShared<Real>));
  const cudaError_t err = cudaFuncSetAttribute(
      fused_forward_kernel<Real, P, kGroups>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_forward_kernel<Real, P, kGroups>
      <<<blocks, P * lanes + 32 * kConsumers, kBytes, stream>>>(
          ys, xi, w, sw, c, T, B, lanes, factors, rows, mfs, lfs, nll);
  return static_cast<int>(cudaGetLastError());
}

template <typename Real>
int launch_forward(const Real* ys, const Real* xi, const Real* w,
                   const Real* sw, const double* consts, int slots, int T,
                   int B, int team, int groups, int lanes, int factors,
                   Real* rows, Real* mfs, Real* lfs, Real* nll, void* stream) {
  if (slots < 1 || slots > kMaxSlots || T < 1 || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ChirpConsts<Real> c = load_consts<Real>(consts);
  const auto s = static_cast<cudaStream_t>(stream);
  // The instantiated (team, groups per member) pairs; ops/chirp_fused.py::
  // GROUPS lists the same.
#define FUSED_LAUNCH(P, GROUPS)                                                \
  launch_forward_team<Real, P, GROUPS>(ys, xi, w, sw, c, slots, T, B, lanes,   \
                                       factors != 0, rows, mfs, lfs, nll, s)
  switch (team * 100 + groups) {
    case 801: return FUSED_LAUNCH(8, 1);
    case 804: return FUSED_LAUNCH(8, 4);
    case 3201: return FUSED_LAUNCH(32, 1);
    case 3203: return FUSED_LAUNCH(32, 3);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FUSED_LAUNCH
}

template <typename Real, bool kSlim, int V>
int launch_backward_instance(const Real* rows, const Real* mf, const Real* lf,
                             int T, int B, int lanes, int out_index,
                             Real* out_m, Real* out_p, cudaStream_t stream) {
  const int bytes = static_cast<int>(g_smem_bytes<Real>());
  const cudaError_t err = cudaFuncSetAttribute(
      affine_backward_kernel<Real, kSlim, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  affine_backward_kernel<Real, kSlim, V>
      <<<(B + lanes - 1) / lanes, kGThreads, bytes, stream>>>(
          rows, mf, lf, T, B, lanes, out_index, out_m, out_p);
  return static_cast<int>(cudaGetLastError());
}

// G over B lanes in blocks of `lanes` (ops/chirp_fused.py::
// affine_geometry), each of kBackTeam warps.
template <typename Real>
int launch_backward(const Real* rows, const Real* mf, const Real* lf, int T,
                    int B, int lanes, int out_index, Real* out_m, Real* out_p,
                    void* stream) {
  if (T < 1 || B < 0 || out_index < -1 || out_index >= kD || lanes < 1 ||
      lanes > kGLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  // 16-byte copies where every block is whole and every line of V lanes
  // 16-byte aligned.
  constexpr int V = 16 / static_cast<int>(sizeof(Real));
  const bool vec = B % lanes == 0 && lanes % V == 0 && B % V == 0 &&
                   reinterpret_cast<size_t>(rows) % 16 == 0;
#define G_LAUNCH(SLIM, W)                                                      \
  launch_backward_instance<Real, SLIM, W>(rows, mf, lf, T, B, lanes,           \
                                          out_index, out_m, out_p, s)
  if (out_index >= 0) return vec ? G_LAUNCH(true, V) : G_LAUNCH(true, 1);
  return vec ? G_LAUNCH(false, V) : G_LAUNCH(false, 1);
#undef G_LAUNCH
}

}  // namespace

extern "C" {

int ghfs_chirp_fused_max_points() { return kMaxPoints; }

int ghfs_chirp_fused_max_slots() { return kMaxSlots; }

int ghfs_chirp_fused_num_consts() { return kNumConsts; }

int ghfs_chirp_fused_row_words() { return kRowWords; }

int fused_forward_f32(const float* ys, const float* xi, const float* w,
                      const float* sw, const double* consts, int slots, int T,
                      int B, int team, int groups, int lanes, int factors,
                      float* rows, float* mfs, float* lfs, float* nll,
                      void* stream) {
  return launch_forward<float>(ys, xi, w, sw, consts, slots, T, B, team,
                               groups, lanes, factors, rows, mfs, lfs, nll,
                               stream);
}

int fused_forward_f64(const double* ys, const double* xi, const double* w,
                      const double* sw, const double* consts, int slots, int T,
                      int B, int team, int groups, int lanes, int factors,
                      double* rows, double* mfs, double* lfs, double* nll,
                      void* stream) {
  return launch_forward<double>(ys, xi, w, sw, consts, slots, T, B, team,
                                groups, lanes, factors, rows, mfs, lfs, nll,
                                stream);
}

int ghfs_chirp_fused_back_team() { return kBackTeam; }

int ghfs_chirp_fused_back_stages() { return kGStages; }

int ghfs_chirp_fused_back_lanes() { return kGLanes; }

int affine_backward_f32(const float* rows, const float* mf, const float* lf,
                        int T, int B, int lanes, int out_index, float* out_m,
                        float* out_p, void* stream) {
  return launch_backward<float>(rows, mf, lf, T, B, lanes, out_index, out_m,
                                out_p, stream);
}

int affine_backward_f64(const double* rows, const double* mf, const double* lf,
                        int T, int B, int lanes, int out_index, double* out_m,
                        double* out_p, void* stream) {
  return launch_backward<double>(rows, mf, lf, T, B, lanes, out_index, out_m,
                                 out_p, stream);
}

}  // extern "C"
