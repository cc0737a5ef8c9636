// Fast nonlinear-least-squares fundamental-frequency (pitch) estimation.
//
// A from-scratch C++ implementation of windowed harmonic NLS pitch
// estimation with model-order selection, exposing the same C ABI the
// reference links against via ctypes (tetralith/jobs/fastf0nls.py:27-41:
// single_pitch_new / est / est_fast / model_order / del), so the Python
// wrapper contract is identical to the external fastF0Nls baseline the
// reference requires users to download separately.
//
// Method. For candidate pitch w (rad/sample) and model order L, the
// harmonic signal model is
//     y(n) = sum_{l=1..L} a_l cos(l w n) + b_l sin(l w n),  n = 0..N-1.
// The NLS objective is J_L(w) = y^T Z (Z^T Z)^{-1} Z^T y.  We compute
//  - Z^T y for ALL grid candidates and harmonics with ONE zero-padded FFT
//    of the data (grid frequencies are Fourier frequencies; harmonic l at
//    grid index k reads FFT bin l*k),
//  - Z^T Z in closed form from Dirichlet kernels
//    (sum_n cos(x n) over n=0..N-1 has a closed form), and
//  - J via a Cholesky solve of the (2L x 2L) normal equations.
// Estimation refines the best grid candidate with golden-section search
// to the requested accuracy, and model order is selected with a
// BIC-penalized log Bayes-factor rule against the order-0 (noise-only)
// model, with the caller-supplied lnBFZeroOrder offset.
//
// est (method != 0): refine the best candidate of EVERY order, then
// select the order.  est_fast (method == 0): select the order on grid
// values, then refine only the winner.  (Same split as the reference
// wrapper documents: fastf0nls.py:80-94.)

#include <cmath>
#include <complex>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ----- minimal iterative radix-2 complex FFT ------------------------------
void fft_radix2(std::vector<std::complex<double>>& a) {
  const size_t n = a.size();
  for (size_t i = 1, j = 0; i < n; ++i) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    const double ang = -2.0 * kPi / static_cast<double>(len);
    const std::complex<double> wl(std::cos(ang), std::sin(ang));
    for (size_t i = 0; i < n; i += len) {
      std::complex<double> w(1.0, 0.0);
      for (size_t k = 0; k < len / 2; ++k) {
        const std::complex<double> u = a[i + k];
        const std::complex<double> v = a[i + k + len / 2] * w;
        a[i + k] = u + v;
        a[i + k + len / 2] = u - v;
        w *= wl;
      }
    }
  }
}

size_t next_pow2(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Dirichlet-type sums over n = 0..N-1 in closed form.
//   dc(x) = sum cos(x n),  ds(x) = sum sin(x n)
void dirichlet(double x, int N, double* dc, double* ds) {
  const double half = 0.5 * x;
  const double s = std::sin(half);
  if (std::fabs(s) < 1e-12) {
    // x ~ 0 (mod 2 pi): cos terms sum to N, sin terms to 0.
    *dc = static_cast<double>(N);
    *ds = 0.0;
    return;
  }
  const double num = std::sin(0.5 * N * x);
  const double phase = 0.5 * (N - 1) * x;
  *dc = num * std::cos(phase) / s;
  *ds = num * std::sin(phase) / s;
}

// Solve the order-L NLS objective given harmonic projections
// c[l], s[l] (l = 1..L) and pitch w.  Returns J = v^T G^{-1} v, or a
// negative value if the normal equations are numerically singular.
double nls_objective(double w, int N, int L, const double* c,
                     const double* s) {
  const int m = 2 * L;
  std::vector<double> G(static_cast<size_t>(m) * m, 0.0);
  std::vector<double> v(m);
  for (int l = 1; l <= L; ++l) {
    v[l - 1] = c[l];
    v[L + l - 1] = s[l];
  }
  // G blocks from product-to-sum identities:
  //  CC[l,k] = 0.5 (dc((l-k) w) + dc((l+k) w))
  //  SS[l,k] = 0.5 (dc((l-k) w) - dc((l+k) w))
  //  CS[l,k] = 0.5 (ds((l+k) w) - ds((l-k) w))    (= sum cos(lwn) sin(kwn))
  for (int l = 1; l <= L; ++l) {
    for (int k = 1; k <= L; ++k) {
      double dcm, dsm, dcp, dsp;
      dirichlet((l - k) * w, N, &dcm, &dsm);
      dirichlet((l + k) * w, N, &dcp, &dsp);
      const double cc = 0.5 * (dcm + dcp);
      const double ss = 0.5 * (dcm - dcp);
      const double cs = 0.5 * (dsp - dsm);
      G[(l - 1) * m + (k - 1)] = cc;
      G[(L + l - 1) * m + (L + k - 1)] = ss;
      G[(l - 1) * m + (L + k - 1)] = cs;
      G[(L + k - 1) * m + (l - 1)] = cs;
    }
  }
  // Cholesky factorization G = R^T R (in place, upper). Add a tiny ridge
  // for near-singular grids (harmonics beyond Nyquist are filtered by the
  // caller, but closely spaced harmonics at tiny w can still degenerate).
  const double ridge = 1e-9 * N;
  for (int i = 0; i < m; ++i) G[i * m + i] += ridge;
  for (int i = 0; i < m; ++i) {
    for (int j = i; j < m; ++j) {
      double sum = G[i * m + j];
      for (int k = 0; k < i; ++k) sum -= G[k * m + i] * G[k * m + j];
      if (i == j) {
        if (sum <= 0.0) return -1.0;
        G[i * m + i] = std::sqrt(sum);
      } else {
        G[i * m + j] = sum / G[i * m + i];
      }
    }
  }
  // J = || R^{-T} v ||^2
  double J = 0.0;
  std::vector<double> z(m);
  for (int i = 0; i < m; ++i) {
    double sum = v[i];
    for (int k = 0; k < i; ++k) sum -= G[k * m + i] * z[k];
    z[i] = sum / G[i * m + i];
    J += z[i] * z[i];
  }
  return J;
}

// Exact harmonic projections at an arbitrary w (for refinement).
void project(const double* y, int N, int L, double w, double* c, double* s) {
  for (int l = 1; l <= L; ++l) {
    const double lw = l * w;
    // Recurrence-based oscillator accumulation.
    const double cd = std::cos(lw), sd = std::sin(lw);
    double cn = 1.0, sn = 0.0;  // cos(lw * 0), sin(lw * 0)
    double acc_c = 0.0, acc_s = 0.0;
    for (int n = 0; n < N; ++n) {
      acc_c += y[n] * cn;
      acc_s += y[n] * sn;
      const double cn_next = cn * cd - sn * sd;
      sn = sn * cd + cn * sd;
      cn = cn_next;
    }
    c[l] = acc_c;
    s[l] = acc_s;
  }
}

struct SinglePitch {
  int max_order;
  int n_fft_requested;
  size_t n_fft;           // actual (next pow2)
  int n_data;
  double pitch_lo, pitch_hi;   // bounds in cycles/sample (0.5 = Nyquist)
  int last_order = 0;
  double energy = 0.0;

  double objective_exact(const double* y, int L, double w) const {
    std::vector<double> c(L + 1), s(L + 1);
    project(y, n_data, L, w, c.data(), s.data());
    return nls_objective(w, n_data, L, c.data(), s.data());
  }

  // Golden-section maximization of J_L around [lo, hi] to accuracy eps.
  double refine(const double* y, int L, double lo, double hi,
                double eps) const {
    const double gr = 0.6180339887498949;
    double a = lo, b = hi;
    double x1 = b - gr * (b - a), x2 = a + gr * (b - a);
    double f1 = objective_exact(y, L, x1), f2 = objective_exact(y, L, x2);
    while (b - a > eps) {
      if (f1 < f2) {
        a = x1; x1 = x2; f1 = f2;
        x2 = a + gr * (b - a);
        f2 = objective_exact(y, L, x2);
      } else {
        b = x2; x2 = x1; f2 = f1;
        x1 = b - gr * (b - a);
        f1 = objective_exact(y, L, x1);
      }
    }
    return 0.5 * (a + b);
  }

  // Grid sweep: best grid pitch and objective per order 1..max_order.
  void grid_sweep(const double* y, std::vector<double>* best_w,
                  std::vector<double>* best_J) const {
    const size_t F = n_fft;
    std::vector<std::complex<double>> buf(F, {0.0, 0.0});
    for (int n = 0; n < n_data; ++n) buf[n] = {y[n], 0.0};
    fft_radix2(buf);

    // fastF0Nls convention: bounds are cycles/sample (the reference sweep
    // passes [2, 15] / fs, i.e. Hz / fs; see fastf0nls.py:125).
    const double w_lo = pitch_lo * 2.0 * kPi;
    const double w_hi = pitch_hi * 2.0 * kPi;
    const size_t k_lo =
        static_cast<size_t>(std::ceil(w_lo * F / (2.0 * kPi)));
    const size_t k_hi =
        static_cast<size_t>(std::floor(w_hi * F / (2.0 * kPi)));

    best_w->assign(max_order + 1, 0.0);
    best_J->assign(max_order + 1, -1.0);
    std::vector<double> c(max_order + 1), s(max_order + 1);
    for (size_t k = (k_lo == 0 ? 1 : k_lo); k <= k_hi; ++k) {
      const double w = 2.0 * kPi * static_cast<double>(k) / F;
      for (int L = 1; L <= max_order; ++L) {
        if (L * w >= kPi) break;  // harmonics beyond Nyquist
        const size_t bin = (static_cast<size_t>(L) * k) % F;
        c[L] = buf[bin].real();
        s[L] = -buf[bin].imag();  // sum y cos - i sum y sin convention
        const double J = nls_objective(w, n_data, L, c.data(), s.data());
        if (J > (*best_J)[L]) {
          (*best_J)[L] = J;
          (*best_w)[L] = w;
        }
      }
    }
  }

  // BIC-penalized log "Bayes factor" of order L vs noise-only order 0.
  double ln_bf(double J, int L) const {
    const double rss = std::max(energy - J, 1e-12 * energy + 1e-300);
    const double gain = 0.5 * n_data * std::log(energy / rss);
    const double penalty = 0.5 * (2.0 * L + 1.0) * std::log((double)n_data);
    return gain - penalty;
  }
};

}  // namespace

extern "C" {

void* single_pitch_new(int max_model_order, int n_fft_grid, int n_data,
                       const double* pitch_bounds) {
  auto* sp = new SinglePitch();
  sp->max_order = max_model_order;
  sp->n_fft_requested = n_fft_grid;
  sp->n_fft = next_pow2(static_cast<size_t>(
      n_fft_grid > n_data ? n_fft_grid : n_data));
  sp->n_data = n_data;
  sp->pitch_lo = pitch_bounds[0];
  sp->pitch_hi = pitch_bounds[1];
  return sp;
}

static double estimate_impl(SinglePitch* sp, const double* y,
                            double ln_bf_zero, double eps,
                            bool refine_all) {
  sp->energy = 0.0;
  for (int n = 0; n < sp->n_data; ++n) sp->energy += y[n] * y[n];
  if (sp->energy <= 0.0) {
    sp->last_order = 0;
    return 0.0;
  }

  std::vector<double> best_w, best_J;
  sp->grid_sweep(y, &best_w, &best_J);
  const double dw = 2.0 * kPi / static_cast<double>(sp->n_fft);

  if (refine_all) {
    for (int L = 1; L <= sp->max_order; ++L) {
      if (best_J[L] <= 0.0) continue;
      const double w = sp->refine(y, L, best_w[L] - dw, best_w[L] + dw, eps);
      const double J = sp->objective_exact(y, L, w);
      if (J > best_J[L]) {
        best_J[L] = J;
        best_w[L] = w;
      }
    }
  }

  int order = 0;
  double best_score = ln_bf_zero;
  for (int L = 1; L <= sp->max_order; ++L) {
    if (best_J[L] <= 0.0) continue;
    const double score = sp->ln_bf(best_J[L], L);
    if (score > best_score) {
      best_score = score;
      order = L;
    }
  }
  sp->last_order = order;
  if (order == 0) return 0.0;

  if (!refine_all) {
    return sp->refine(y, order, best_w[order] - dw, best_w[order] + dw, eps);
  }
  return best_w[order];
}

double single_pitch_est(void* handle, const double* data,
                        double ln_bf_zero, double eps) {
  return estimate_impl(static_cast<SinglePitch*>(handle), data, ln_bf_zero,
                       eps, /*refine_all=*/true);
}

double single_pitch_est_fast(void* handle, const double* data,
                             double ln_bf_zero, double eps) {
  return estimate_impl(static_cast<SinglePitch*>(handle), data, ln_bf_zero,
                       eps, /*refine_all=*/false);
}

int single_pitch_model_order(void* handle) {
  return static_cast<SinglePitch*>(handle)->last_order;
}

void single_pitch_del(void* handle) {
  delete static_cast<SinglePitch*>(handle);
}

}  // extern "C"
