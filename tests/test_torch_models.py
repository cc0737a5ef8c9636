"""PyTorch port vs the JAX package: sigma-point rules, bijections,
numerics, Matern-3/2 and the chirp model.  Inputs are made with NumPy and
fed to both; JAX arrays carry an explicit dtype (x64 is on in tests)."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.models as jm
import chirpgp_tpu.quad as jq
import chirpgp_tpu.utils.numerics as jn
import chirpgp_tpu_torch.models as tm
import chirpgp_tpu_torch.quad as tq
import chirpgp_tpu_torch.utils.numerics as tn
from chirpgp_tpu.models.matern import _sigma11_factor as j_sigma11
from chirpgp_tpu_torch.models.matern import _sigma11_factor as t_sigma11

torch.set_num_threads(1)

F64 = dict(atol=1e-12, rtol=0)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("make", [
    lambda q: q.cubature(4), lambda q: q.cubature(2),
    lambda q: q.gauss_hermite(4, 3), lambda q: q.gauss_hermite(4, 2),
    lambda q: q.gauss_hermite(1, 10), lambda q: q.unscented(4),
    lambda q: q.unscented(3, alpha=0.5, beta=2.0, kappa=0.0),
], ids=["cub4", "cub2", "gh4-3", "gh4-2", "gh1-10", "ut4", "ut3"])
def test_rules_identical(make):
    rj, rt = make(jq), make(tq)
    assert (rt.d, rt.n_points) == (rj.d, rj.n_points)
    npt.assert_array_equal(rt.xi, np.asarray(rj.xi))
    npt.assert_array_equal(rt.w, np.asarray(rj.w))
    if rj.wc is None:
        assert rt.wc is None
    else:
        npt.assert_array_equal(rt.wc, np.asarray(rj.wc))


def test_rule_sigma_points_and_moments():
    rng = np.random.default_rng(0)
    m = rng.standard_normal((3, 4))
    A = rng.standard_normal((3, 4, 4))
    L = np.tril(A)
    rj, rt = jq.gauss_hermite(4, 3), tq.gauss_hermite(4, 3)
    chi_j = rj.gen_sigma_points(jnp.asarray(m), jnp.asarray(L))
    chi_t = rt.gen_sigma_points(torch.tensor(m), torch.tensor(L))
    npt.assert_allclose(_np(chi_t), np.asarray(chi_j), **F64)
    mj, Pj = rj.mean_and_cov(jnp.sin(chi_j))
    mt, Pt = rt.mean_and_cov(torch.sin(chi_t))
    npt.assert_allclose(_np(mt), np.asarray(mj), **F64)
    npt.assert_allclose(_np(Pt), np.asarray(Pj), **F64)
    Cj = rj.cross_cov(jnp.sin(chi_j), chi_j, mj, jnp.asarray(m))
    Ct = rt.cross_cov(torch.sin(chi_t), chi_t, mt, torch.tensor(m))
    npt.assert_allclose(_np(Ct), np.asarray(Cj), **F64)
    lead_j, lead_t = jnp.moveaxis(chi_j, -2, 0), chi_t.movedim(-2, 0)
    npt.assert_allclose(_np(rt.expectation(lead_t)),
                        np.asarray(rj.expectation(lead_j)), **F64)
    npt.assert_allclose(_np(rt.expectation_from_nodes(torch.cos, lead_t)),
                        np.asarray(rj.expectation_from_nodes(jnp.cos, lead_j)),
                        **F64)
    # The unscented rule's covariance weights differ from its mean weights.
    uj, ut = jq.unscented(4, kappa=1.0), tq.unscented(4, kappa=1.0)
    ev = np.random.default_rng(4).standard_normal((2, 9, 4))
    for a, b in zip(ut.mean_and_cov(torch.tensor(ev)),
                    uj.mean_and_cov(jnp.asarray(ev))):
        npt.assert_allclose(_np(a), np.asarray(b), **F64)


def test_bijections():
    xs = np.linspace(-30.0, 30.0, 2001)
    npt.assert_allclose(_np(tm.g(torch.tensor(xs))),
                        np.asarray(jm.g(jnp.asarray(xs))), **F64)
    # Above softplus's threshold=20 torch's builtin returns x; g must not.
    assert float(tm.g(torch.tensor(25.0, dtype=torch.float64))) != 25.0
    ys = np.concatenate([np.linspace(0.01, 30.0, 2000),
                         _np(tm.g(torch.tensor(xs)))])
    npt.assert_allclose(_np(tm.g_inv(torch.tensor(ys))),
                        np.asarray(jm.g_inv(jnp.asarray(ys))), **F64)


def test_phi1_ou_variance_and_psd_cholesky():
    xs = np.array([0.0, 1e-6, -5e-5, 9e-5, 2e-4, 0.3, 5.0])
    npt.assert_allclose(_np(tn.phi1(torch.tensor(xs))),
                        np.asarray(jn.phi1(jnp.asarray(xs))), **F64)
    for b, lam, dt in [(0.1, 0.1, 1e-3), (0.2, 0.0, 1e-3), (1.0, 4.9e-8, 1e-3),
                       (0.5, 30.0, 0.01)]:
        npt.assert_allclose(_np(tn.ou_variance(b, lam, dt)),
                            np.asarray(jn.ou_variance(b, lam, dt)), **F64)
    rng = np.random.default_rng(1)
    A = rng.standard_normal((5, 4, 3))
    P = A @ np.swapaxes(A, -1, -2)     # rank 3: singular 4x4 PSD
    Lt = tn.psd_cholesky(torch.tensor(P))
    npt.assert_allclose(_np(Lt), np.asarray(jn.psd_cholesky(jnp.asarray(P))),
                        atol=1e-10, rtol=0)
    npt.assert_allclose(_np(Lt @ Lt.transpose(-1, -2)), P, atol=1e-10)


@pytest.mark.parametrize("ell,sigma,dt", [
    (1.0, 1.0, 1e-3), (1.3829, 5.6127, 1e-3), (0.05, 2.0, 1e-2),
    (0.01, 0.5, 1e-2)])
def test_m32_solution(ell, sigma, dt):
    Fj, Sj = jm.m32_solution(ell, sigma, dt)
    Ft, St = tm.m32_solution(ell, sigma, dt)
    npt.assert_allclose(_np(Ft), np.asarray(Fj), **F64)
    npt.assert_allclose(_np(St), np.asarray(Sj), **F64)
    npt.assert_allclose(_np(tm.stationary_cov_m32(ell, sigma)),
                        np.asarray(jm.stationary_cov_m32(ell, sigma)), **F64)
    etas = np.array([1e-3, 0.1, 0.149, 0.151, 0.5, 3.0])
    npt.assert_allclose(_np(t_sigma11(torch.tensor(etas))),
                        np.asarray(j_sigma11(jnp.asarray(etas))), **F64)


def test_disc_chirp_lcd_means():
    lam, b, ell, sigma = 0.1, 0.1, 1.0, 1.0
    tj = jm.disc_chirp_lcd(lam, b, ell, sigma)
    tt = tm.disc_chirp_lcd(lam, b, ell, sigma)
    rng = np.random.default_rng(2)
    u_cf = rng.standard_normal((7, 4, 5)) * np.array([1, 1, 8, 3])[:, None]
    npt.assert_allclose(_np(tt.mean_cf(torch.tensor(u_cf), 1e-3)),
                        np.asarray(tj.mean_cf(jnp.asarray(u_cf), 1e-3)), **F64)
    u = np.swapaxes(u_cf, -1, -2)
    npt.assert_allclose(_np(tt.mean(torch.tensor(u), 1e-3)),
                        np.asarray(tj.mean(jnp.asarray(u), 1e-3)), **F64)
    mt, ct = tt(torch.tensor(u), 1e-3)
    assert ct.shape == (7, 5, 4, 4)
    npt.assert_allclose(_np(mt), np.asarray(tj.mean(jnp.asarray(u), 1e-3)),
                        **F64)


@pytest.mark.parametrize("params", [
    [0.1, 0.1, 0.1, 1.0, 1.0, 7.0],
    [4.92912954e-08, 6.88755505e-05, 4.09863245e-01, 1.38293558e+00,
     5.61270940e+00, 9.41084134e+00]], ids=["default", "ckfs-opt"])
def test_build_chirp_model(params):
    pj = jm.build_chirp_model(jnp.asarray(params, jnp.float64))
    pt = tm.build_chirp_model(torch.tensor(params, dtype=torch.float64))
    npt.assert_allclose(_np(pt.m0), np.asarray(pj.m0), **F64)
    npt.assert_allclose(_np(pt.P0), np.asarray(pj.P0), **F64)
    npt.assert_array_equal(_np(pt.H), np.asarray(pj.H))
    npt.assert_allclose(_np(pt.m_and_cov.cov_const(1e-3)),
                        np.asarray(pj.m_and_cov.cov_const(1e-3)), **F64)
    u = np.random.default_rng(3).standard_normal((6, 4))
    npt.assert_allclose(_np(pt.drift(torch.tensor(u))),
                        np.asarray(pj.drift(jnp.asarray(u))), **F64)
    npt.assert_allclose(_np(pt.dispersion(None)),
                        np.asarray(pj.dispersion(None)), **F64)


def test_transition_hooks():
    tt = tm.disc_chirp_lcd(0.1, 0.1, 1.0, 1.0)
    tj = jm.disc_chirp_lcd(0.1, 0.1, 1.0, 1.0)
    # A reference-style single-point closure is mapped over leading axes.
    wrapped_t = tm.as_transition(lambda u, dt: (tt.mean(u, dt), tt.cov(u, dt)))
    wrapped_j = jm.as_transition(lambda u, dt: (tj.mean(u, dt), tj.cov(u, dt)))
    pts = np.random.default_rng(4).standard_normal((3, 5, 4))
    assert not wrapped_t.const_cov
    npt.assert_allclose(_np(wrapped_t.mean(torch.tensor(pts), 1e-3)),
                        np.asarray(wrapped_j.mean(jnp.asarray(pts), 1e-3)), **F64)
    cov_t = wrapped_t.cov(torch.tensor(pts), 1e-3)
    assert cov_t.shape == (3, 5, 4, 4)
    npt.assert_allclose(_np(cov_t),
                        np.asarray(wrapped_j.cov(jnp.asarray(pts), 1e-3)), **F64)
    assert tm.as_transition(tt) is tt
    u = torch.randn(3, 4, 5, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    no_cf = tm.Transition(mean=tt.mean, cov=tt.cov, const_cov=True)
    npt.assert_allclose(_np(no_cf.mean_channels_first(u, 1e-3)),
                        _np(tt.mean_channels_first(u, 1e-3)), **F64)
    with pytest.raises(ValueError):
        tm.Transition(mean=tt.mean, cov=tt.cov).cov_const(1e-3)


def test_batched_mean_and_cov_matches_jax():
    """The chirp LCD transition (constant covariance) and a state-dependent
    closure on a (2, 81, 4) batch of points, float64."""
    from chirpgp_tpu.models.transitions import batched_mean_and_cov as jbmc
    from chirpgp_tpu_torch.models.transitions import batched_mean_and_cov
    chi = np.random.default_rng(5).standard_normal((2, 81, 4))
    dt = 1e-3
    for tj, tt in ((jm.disc_chirp_lcd(0.1, 0.1, 1.0, 1.0),
                    tm.disc_chirp_lcd(0.1, 0.1, 1.0, 1.0)),
                   (lambda u, dt_: (jnp.sin(u) * dt_, jnp.outer(u, u) + 1.0),
                    lambda u, dt_: (torch.sin(u) * dt_,
                                    torch.outer(u, u) + 1.0))):
        want = jbmc(tj, jnp.asarray(chi), dt)
        got = batched_mean_and_cov(tt, torch.tensor(chi), dt)
        for g_, w_ in zip(got, want):
            assert (g_ is None) == (w_ is None)
            if w_ is not None:
                npt.assert_allclose(_np(g_), np.asarray(w_), **F64)


def test_utils_reexport_the_simulators_as_jax():
    """``chirpgp_tpu_torch.utils`` re-exports the JAX package's four
    simulators; ``simulate_lgssm`` from JAX's own normals, float64."""
    import jax
    import chirpgp_tpu.utils as ju
    import chirpgp_tpu_torch.utils as tu
    from chirpgp_tpu_torch.utils.sim import _lgssm_from_noise
    names = ("simulate_lgssm", "simulate_sde", "simulate_sde_init",
             "simulate_function_parametrised_sde")
    assert set(names) <= set(tu.__all__) and set(names) <= set(ju.__all__)
    assert all(callable(getattr(tu, n)) for n in names)
    T, key = 40, jax.random.PRNGKey(11)
    A = np.array([[0.9, 0.2], [-0.1, 0.8]])
    Q = np.array([[0.5, 0.1], [0.1, 0.3]])
    x0 = np.array([1.0, -0.5])
    want = ju.simulate_lgssm(jnp.asarray(A), jnp.asarray(Q), jnp.asarray(x0),
                             T, key)
    rnds = np.asarray(jax.random.normal(key, (T, 2), dtype=jnp.float64))
    got = _lgssm_from_noise(torch.tensor(A), torch.tensor(Q),
                            torch.tensor(x0), torch.tensor(rnds))
    npt.assert_allclose(_np(got), np.asarray(want), **F64)
    assert tu.simulate_lgssm is _lgssm_from_noise.__globals__[
        "simulate_lgssm"]
