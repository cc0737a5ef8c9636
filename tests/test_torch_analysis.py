"""The PyTorch port's analysis tools against the JAX package: the LTI
discretization, TME, the Matern-3/2 transition, the chirp pair
conditioned on V, and the covariance functions of the chirp SDEs.

Both packages get the same seeded NumPy inputs at float64 and must agree
within 1e-10 (the Monte-Carlo covariance cores, fed JAX's own normals,
within 1e-9).  The checks of ``tests/test_models.py`` and
``tests/test_crlb_covfuncs.py`` on these functions run here on the port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.models as jm
import chirpgp_tpu.models.cov_funcs as jcov
import chirpgp_tpu.models.tme as jtme
from chirpgp_tpu.utils import lti_sde_to_disc as jax_lti

import chirpgp_tpu_torch.models as tm
import chirpgp_tpu_torch.models.cov_funcs as tcov
from chirpgp_tpu_torch.utils import lti_sde_to_disc

torch.set_num_threads(1)

LAM, B, ELL, SIGMA, DELTA = 0.3, 0.5, 0.8, 1.1, 0.2
# float64 agreement with the JAX package: closed forms and expansions, and
# the Monte-Carlo cores on equal draws.
ATOL, MC_RTOL = 1e-10, 1e-9


def _t(x):
    return torch.from_numpy(np.array(x, np.float64))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("disp", ["scalar", "vector", "matrix"])
def test_lti_sde_to_disc_matches_jax(disp):
    rng = np.random.default_rng(0)
    d = 1 if disp == "scalar" else 3
    A = rng.standard_normal((d, d)) - 2.0 * np.eye(d)
    Bd = {"scalar": np.float64(0.7), "vector": rng.standard_normal(d),
          "matrix": rng.standard_normal((d, d))}[disp]
    for dt in (1e-3, 0.1, 1.0):
        F, S = lti_sde_to_disc(_t(A), _t(Bd), dt)
        Fj, Sj = jax_lti(jnp.asarray(A), jnp.asarray(Bd), dt)
        npt.assert_allclose(_np(F), np.asarray(Fj), rtol=0, atol=ATOL)
        npt.assert_allclose(_np(S), np.asarray(Sj), rtol=0, atol=ATOL)


def test_m32_solution_vs_lti():
    """The closed-form Matern-3/2 transition is the exact LTI
    discretization (``tests/test_models.py::test_m32_solution_vs_expm``)."""
    gamma = math.sqrt(3.0) / ELL
    A = _t([[0.0, 1.0], [-gamma ** 2, -2.0 * gamma]])
    Bm = _t([[0.0, 0.0], [0.0, 2.0 * SIGMA * gamma ** 1.5]])
    for dt in (1e-3, 1e-2, 0.1, 1.0):
        F_exact, S_exact = lti_sde_to_disc(A, Bm, dt)
        F, S = tm.m32_solution(ELL, SIGMA, dt)
        npt.assert_allclose(_np(F), _np(F_exact), rtol=1e-8, atol=1e-12)
        npt.assert_allclose(_np(S), _np(S_exact), rtol=1e-6, atol=1e-12)


def test_chirp_lcd_vs_lti_frozen_frequency():
    """With the frequency frozen at g(V), the chirp pair's LCD is the exact
    discretization of its LTI SDE
    (``tests/test_models.py::test_chirp_lcd_vs_expm_frozen_frequency``)."""
    u = _t([0.4, -0.7, 0.9, 0.1])
    w = 2.0 * math.pi * float(tm.g(u[2]))
    dt = 0.01
    F_exact, S_exact = lti_sde_to_disc(_t([[-LAM, -w], [w, -LAM]]),
                                       B * torch.eye(2, dtype=torch.float64),
                                       dt)
    m, cov = tm.disc_chirp_lcd(LAM, B, ELL, SIGMA)(u, dt)
    npt.assert_allclose(_np(m[:2]), _np(F_exact @ u[:2]), rtol=1e-8)
    npt.assert_allclose(_np(cov[:2, :2]), _np(S_exact), rtol=1e-6,
                        atol=1e-12)
    F32, S32 = tm.m32_solution(ELL, SIGMA, dt)
    npt.assert_allclose(_np(m[2:]), _np(F32 @ u[2:]), rtol=1e-10)
    npt.assert_allclose(_np(cov[2:, 2:]), _np(S32), rtol=1e-10)


@pytest.mark.parametrize("K", [1, 2, 3])
def test_harmonic_lcd_vs_lti(K):
    """``tests/test_models.py::test_harmonic_lcd_vs_expm`` on the port."""
    d = 2 * K + 2
    u = torch.arange(1.0, d + 1.0, dtype=torch.float64) / d
    dt = 0.01
    w = 2.0 * math.pi * float(tm.g(u[-2]))
    m, cov = tm.disc_harmonic_chirp_lcd(LAM, B, ELL, SIGMA,
                                        num_harmonics=K)(u, dt)
    for k in range(1, K + 1):
        F_exact, S_exact = lti_sde_to_disc(
            _t([[-LAM, -k * w], [k * w, -LAM]]),
            B * torch.eye(2, dtype=torch.float64), dt)
        sl = slice(2 * (k - 1), 2 * k)
        npt.assert_allclose(_np(m[sl]), _np(F_exact @ u[sl]), rtol=1e-8)
        npt.assert_allclose(_np(cov[sl, sl]), _np(S_exact), rtol=1e-6,
                            atol=1e-12)


def test_disc_m32_matches_jax():
    rng = np.random.default_rng(1)
    u = rng.standard_normal((5, 2))
    u_cf = rng.standard_normal((2, 7))
    jt, pt = jm.disc_m32(ELL, SIGMA), tm.disc_m32(ELL, SIGMA)
    for dt in (1e-3, 0.05):
        m, c = pt(_t(u), dt)
        mj, cj = jt(jnp.asarray(u), dt)
        npt.assert_allclose(_np(m), np.asarray(mj), rtol=0, atol=ATOL)
        npt.assert_allclose(_np(c), np.asarray(cj), rtol=0, atol=ATOL)
        npt.assert_allclose(_np(pt.mean_cf(_t(u_cf), dt)),
                            np.asarray(jt.mean_cf(jnp.asarray(u_cf), dt)),
                            rtol=0, atol=ATOL)
        jac = torch.func.jacfwd(lambda v: pt.mean(v, dt))(_t(u[0]))
        npt.assert_allclose(_np(pt.jac(_t(u), dt)[0]), _np(jac), atol=ATOL)


def test_disc_chirp_lcd_cond_v_matches_jax():
    rng = np.random.default_rng(2)
    u = rng.standard_normal((6, 2))
    for v in (-0.3, 1.7):
        m, c = tm.disc_chirp_lcd_cond_v(LAM, B)(_t(u), v, 0.02)
        mj, cj = jm.disc_chirp_lcd_cond_v(LAM, B)(jnp.asarray(u), v, 0.02)
        npt.assert_allclose(_np(m), np.asarray(mj), rtol=0, atol=ATOL)
        npt.assert_allclose(_np(c), np.asarray(cj), rtol=0, atol=ATOL)
    assert tm.disc_chirp_euler_maruyama() is NotImplemented


def test_tme_matches_jax():
    """The generator, the chirp model's expansion (order 2 at one state,
    order 1 over a batch of states) and the order-3 expansion of a linear
    SDE, against the JAX package."""
    drift, disp, _, _, _ = tm.model_chirp(LAM, B, ELL, SIGMA, 1.0)
    jdrift, jdisp, _, _, _ = jm.model_chirp(LAM, B, ELL, SIGMA, 1.0)
    x = np.array([0.2, 0.8, 0.4, -0.1])
    phi = lambda u: torch.stack([u[0] * u[2], torch.sin(u[1]) * u[3]])
    jphi = lambda u: jnp.stack([u[0] * u[2], jnp.sin(u[1]) * u[3]])
    npt.assert_allclose(_np(tm.generator(phi, drift, disp)(_t(x))),
                        np.asarray(jtme.generator(jphi, jdrift, jdisp)(
                            jnp.asarray(x))), rtol=0, atol=ATOL)

    # Order 2 at one state; order 1 over a batch of states (vmapped).
    states = np.stack([x, [-0.5, 0.3, 1.2, 0.2]])
    for order, u in ((2, x), (1, states)):
        m, c = tm.disc_chirp_tme(LAM, B, ELL, SIGMA, order=order)(_t(u),
                                                                   1e-2)
        mj, cj = jax.jit(lambda v: jtme.disc_chirp_tme(
            LAM, B, ELL, SIGMA, order=order)(v, 1e-2))(jnp.asarray(u))
        npt.assert_allclose(_np(m), np.asarray(mj), rtol=0, atol=ATOL)
        npt.assert_allclose(_np(c), np.asarray(cj), rtol=0, atol=ATOL)

    gamma = math.sqrt(3.0) / ELL
    lin = (lambda u: torch.stack([u[1], -gamma ** 2 * u[0]
                                  - 2.0 * gamma * u[1]]),
           lambda u: _t([[0.0, 0.0], [0.0, 2.0 * SIGMA * gamma ** 1.5]]))
    jlin = (lambda u: jnp.stack([u[1], -gamma ** 2 * u[0]
                                 - 2.0 * gamma * u[1]]),
            lambda u: jnp.array([[0.0, 0.0],
                                 [0.0, 2.0 * SIGMA * gamma ** 1.5]]))
    m, c = tm.tme_mean_and_cov(_t([0.3, -0.2]), 0.05, *lin, order=3)
    mj, cj = jax.jit(lambda v: jtme.tme_mean_and_cov(v, 0.05, *jlin,
                                                     order=3))(
        jnp.array([0.3, -0.2]))
    npt.assert_allclose(_np(m), np.asarray(mj), rtol=0, atol=ATOL)
    npt.assert_allclose(_np(c), np.asarray(cj), rtol=0, atol=ATOL)


def test_tme_exact_on_lti():
    """On the linear Matern-3/2 SDE, TME order 3 matches the exact
    discretization to O(dt^4) (``tests/test_models.py::
    test_tme_exact_on_lti``)."""
    gamma = math.sqrt(3.0) / ELL

    def drift(u):
        return torch.stack([u[..., 1],
                            -(gamma ** 2) * u[..., 0] - 2.0 * gamma * u[..., 1]],
                           dim=-1)

    def dispersion(_):
        return _t([[0.0, 0.0], [0.0, 2.0 * SIGMA * gamma ** 1.5]])

    u = _t([0.3, -0.2])
    for dt, rtol in [(1e-3, 1e-2), (1e-2, 5e-2)]:
        m_tme, cov_tme = tm.disc_tme(drift, dispersion, order=3)(u, dt)
        F, Sigma = tm.m32_solution(ELL, SIGMA, dt)
        npt.assert_allclose(_np(m_tme), _np(F @ u), rtol=1e-6, atol=1e-10)
        npt.assert_allclose(_np(cov_tme), _np(Sigma), rtol=rtol, atol=1e-12)


def test_lcd_vs_tme_small_dt():
    """LCD and TME order 3 agree at small dt (``tests/test_models.py::
    test_lcd_vs_tme_small_dt``)."""
    u = _t([0.2, 0.8, 0.4, -0.1])
    m_lcd, cov_lcd = tm.disc_chirp_lcd(LAM, B, ELL, SIGMA)(u, 1e-3)
    m_tme, cov_tme = tm.disc_chirp_tme(LAM, B, ELL, SIGMA, order=3)(u, 1e-3)
    npt.assert_allclose(_np(m_lcd), _np(m_tme), atol=1e-5)
    npt.assert_allclose(_np(cov_lcd), _np(cov_tme), atol=1e-5)


def test_harmonic_cov_functions_match_jax():
    lam, b, f = 0.3, 0.7, 2.0
    cov0 = 0.1 * np.eye(2) + 0.02
    for t1, t2 in ((0.5, 1.0), (1.0, 0.5), (1.0, 1.0)):
        npt.assert_allclose(
            _np(tcov.cov_harmonic_sde(t1, t2, cov0, f, lam, b)),
            np.asarray(jcov.cov_harmonic_sde(t1, t2, jnp.asarray(cov0), f,
                                             lam, b)), rtol=0, atol=ATOL)
    ts = np.linspace(0.1, 1.0, 5)
    grid = tcov.vmap_cov_harmonic_sde(_t(ts), _t(1.3 * ts), _t(cov0), f,
                                      lam, b)
    assert grid.shape == (5, 5, 2, 2)
    npt.assert_allclose(_np(grid), np.asarray(jax.jit(
        lambda a, c: jcov.vmap_cov_harmonic_sde(a, c, jnp.asarray(cov0), f,
                                                lam, b))(
        jnp.asarray(ts), jnp.asarray(1.3 * ts))), rtol=0, atol=ATOL)
    w = 2 * math.pi * f
    npt.assert_allclose(
        _np(tcov.vmap_marginal_cov_harmonic_sde(_t(ts), 0.0, _t(cov0), lam,
                                                b, w)),
        np.asarray(jcov.vmap_marginal_cov_harmonic_sde(
            jnp.asarray(ts), 0.0, jnp.asarray(cov0), lam, b, w)),
        rtol=0, atol=ATOL)
    # tests/test_crlb_covfuncs.py: the two-sided function on the diagonal
    # is the marginal covariance, and it decays with the gap.
    for t in (0.5, 2.0):
        npt.assert_allclose(
            _np(tcov.cov_harmonic_sde(t, t, cov0, f, lam, b)),
            _np(tcov.marginal_cov_harmonic_sde(t, 0.0, cov0, lam, b, w)),
            rtol=1e-10, atol=1e-12)
    norms = [float(torch.linalg.norm(tcov.cov_harmonic_sde(
        1.0, 1.0 + gap, cov0, f, 0.5, b))) for gap in (0.0, 1.0, 3.0, 6.0)]
    assert norms[0] > norms[1] > norms[2] > norms[3]


def _simulate_sde_draws(key, n, T, d):
    """The normals ``simulate_sde`` draws from each of ``split(key, n)``:
    x0 from the key, the increments from its first split."""
    keys = jax.random.split(key, n)
    z0 = jax.vmap(lambda k: jax.random.normal(k, (d,)))(keys)
    dws = jax.vmap(lambda k: jax.random.normal(jax.random.split(k)[0],
                                               (T, d)))(keys)
    return _t(z0), _t(dws)


def test_monte_carlo_cov_cores_match_jax():
    """The covariance surface, the conditional one and the PSD on JAX's own
    draws."""
    ts = np.linspace(0.01, 0.3, 30)
    args = (0.2, 0.3, 1.0, 1.0, 0.1)
    key, N = jax.random.PRNGKey(5), 64
    z0, dws = _simulate_sde_draws(key, N, 30, 4)

    want = jcov.approx_cov_chirp_sde(jnp.asarray(ts), *args, num_mcs=N,
                                     key=key)
    got = tcov._approx_cov_chirp_sde_from_noise(_t(ts), *args, z0, dws)
    npt.assert_allclose(_np(got), np.asarray(want), rtol=0,
                        atol=MC_RTOL * float(jnp.abs(want).max()))

    fj, pj = jcov.psd_chirp_sde(jnp.asarray(ts), *args, num_mcs=N, key=key)
    fp, pp = tcov._psd_chirp_sde_from_noise(_t(ts), *args, z0, dws)
    npt.assert_allclose(_np(fp), np.asarray(fj), rtol=1e-12)
    npt.assert_allclose(_np(pp), np.asarray(pj), rtol=0,
                        atol=MC_RTOL * float(jnp.abs(pj).max()))

    vj, cj = jcov.approx_cond_cov_chirp_sde(jnp.asarray(ts), *args,
                                            num_mcs=N, key=key)
    z0_v = jax.random.normal(key, (2,))
    dws_v = jax.random.normal(jax.random.split(key)[0], (30, 2))
    z0_x, dws_x = _simulate_sde_draws(jax.random.split(key)[0], N, 30, 2)
    vp, cp = tcov._approx_cond_cov_chirp_sde_from_noise(
        _t(ts), *args, _t(z0_v), _t(dws_v), z0_x, dws_x)
    npt.assert_allclose(_np(vp), np.asarray(vj), rtol=0, atol=ATOL)
    npt.assert_allclose(_np(cp), np.asarray(cj), rtol=0,
                        atol=MC_RTOL * float(jnp.abs(cj).max()))


def test_monte_carlo_cov_entry_points():
    """The entry points on the port's own draws: the shapes, the V block
    near the stationary Matern variance (``tests/test_crlb_covfuncs.py::
    test_mc_cov_matches_closed_form_stationary_block``), and the PSD peak
    at g(0) Hz under a tight prior (``test_psd_chirp_sde_peaks_at_prior_
    frequency``); NumPy times go to ``device``."""
    lam, b, ell, sigma, delta = 0.2, 0.3, 1.0, 1.0, 0.1
    ts = np.linspace(0.01, 0.5, 50)
    surf = tcov.approx_cov_chirp_sde(ts, lam, b, ell, sigma, delta,
                                     num_mcs=4000, device="cpu")
    assert surf.shape == (50, 50, 4, 4)
    vv = float(surf[25, 25, 2, 2]) * (50 - 1) / 4000
    npt.assert_allclose(vv, sigma ** 2, rtol=0.15)
    vs, cond = tcov.approx_cond_cov_chirp_sde(
        _t(ts), lam, b, ell, sigma, delta, num_mcs=16,
        generator=torch.Generator().manual_seed(3))
    assert vs.shape == (50, 2) and cond.shape == (50, 50, 2, 2)

    dt, T = 0.01, 1024
    freqs, psd = tcov.psd_chirp_sde(
        _t(np.linspace(dt, dt * T, T)), 0.2, 0.05, 1.0, 0.01, 1e-4,
        num_mcs=256, generator=torch.Generator().manual_seed(7))
    assert freqs.shape == psd.shape == (T // 2 + 1,)
    assert bool((psd >= 0.0).all())
    assert abs(float(freqs[torch.argmax(psd)]) - math.log(2.0)) < 0.2
