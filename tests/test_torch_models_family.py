"""PyTorch port vs the JAX package: the harmonic chirp and La Scala models
(priors, LCD transitions, builders) and their closed-form Jacobians.

The same NumPy inputs go to both packages, in float64.  Tolerances:
transitions and priors 1e-12 (absolute and relative); each ``jac``
against ``torch.func.jacfwd`` of its ``mean`` 1e-12."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.models as jm
import chirpgp_tpu_torch.models as tm

torch.set_num_threads(1)

F64 = dict(atol=1e-12, rtol=1e-12)
LAM, B, ELL, SIGMA, DELTA = 0.3, 0.2, 1.5, 0.7, 0.4
DT = 1e-3


def _np(x):
    return x.detach().cpu().numpy()


def _states(d, n=5, seed=1):
    return np.random.default_rng(seed).standard_normal((n, d))


def _transitions(kind):
    """(JAX transition, port transition, state dim) of one LCD."""
    if kind == "lascala":
        return (jm.disc_model_lascala_lcd(ELL, SIGMA),
                tm.disc_model_lascala_lcd(ELL, SIGMA), 4)
    K, fs = kind
    return (jm.disc_harmonic_chirp_lcd(LAM, B, ELL, SIGMA, num_harmonics=K,
                                       freq_scale=fs),
            tm.disc_harmonic_chirp_lcd(LAM, B, ELL, SIGMA, num_harmonics=K,
                                       freq_scale=fs), 2 * K + 2)


KINDS = [(1, 1.0), (3, 1.0), (1, 1e4), (3, 1e4), "lascala"]
IDS = ["K1", "K3", "K1-fs1e4", "K3-fs1e4", "lascala"]


@pytest.mark.parametrize("kind", KINDS, ids=IDS)
def test_transition_matches_jax(kind):
    tj, tt, d = _transitions(kind)
    u = _states(d)
    npt.assert_allclose(_np(tt.mean(torch.tensor(u), DT)),
                        np.asarray(tj.mean(jnp.asarray(u), DT)), **F64)
    u_cf = np.ascontiguousarray(np.transpose(_states(d, 6, 2)
                                             .reshape(2, 3, d), (0, 2, 1)))
    npt.assert_allclose(_np(tt.mean_cf(torch.tensor(u_cf), DT)),
                        np.asarray(tj.mean_cf(jnp.asarray(u_cf), DT)), **F64)
    npt.assert_allclose(_np(tt.cov_const(DT)), np.asarray(tj.cov_const(DT)),
                        **F64)
    m_t, c_t = tt(torch.tensor(u), DT)
    m_j, c_j = tj(jnp.asarray(u), DT)
    assert c_t.shape == (5, d, d)
    npt.assert_allclose(_np(c_t), np.asarray(c_j), **F64)
    npt.assert_allclose(_np(m_t), np.asarray(m_j), **F64)


@pytest.mark.parametrize("kind", KINDS, ids=IDS)
def test_closed_form_jacobian_matches_jacfwd(kind):
    _, tt, d = _transitions(kind)
    u = torch.tensor(_states(d, 7, 3))
    auto = torch.func.vmap(torch.func.jacfwd(lambda x: tt.mean(x, DT)))(u)
    assert tt.jac(u, DT).shape == (7, d, d)
    npt.assert_allclose(_np(tt.jac(u, DT)), _np(auto), **F64)
    # One state, no batch axis, as the EKF calls it.
    npt.assert_allclose(_np(tt.jac(u[0], DT)), _np(auto[0]), **F64)


def test_harmonic_reduces_to_chirp():
    """The K=1 harmonic model equals the chirp model (port of
    ``tests/test_models.py::test_harmonic_reduces_to_chirp``)."""
    u = torch.tensor([0.4, -0.7, 0.9, 0.1], dtype=torch.float64)
    dt = 0.02
    chirp = tm.disc_chirp_lcd(LAM, B, ELL, SIGMA)
    harm = tm.disc_harmonic_chirp_lcd(LAM, B, ELL, SIGMA, num_harmonics=1)
    for a, b in zip(chirp(u, dt), harm(u, dt)):
        npt.assert_allclose(_np(b), _np(a), rtol=1e-12, atol=0)
    npt.assert_allclose(_np(harm.jac(u, dt)), _np(chirp.jac(u, dt)),
                        rtol=1e-12, atol=0)


def test_lascala_is_the_undamped_noiseless_chirp():
    """La Scala's LCD is the chirp LCD at lam = b = 0 to the bit, and its
    JAX counterpart to round-off."""
    u = torch.tensor(_states(4, 6, 4))
    las = tm.disc_model_lascala_lcd(ELL, SIGMA)
    chirp = tm.disc_chirp_lcd(0.0, 0.0, ELL, SIGMA)
    assert torch.equal(las.mean(u, DT), chirp.mean(u, DT))
    assert torch.equal(las.cov_const(DT), chirp.cov_const(DT))
    assert torch.equal(las.cov_const(DT)[:2], torch.zeros(2, 4,
                                                          dtype=torch.float64))


@pytest.mark.parametrize("which", ["harmonic", "lascala"])
def test_priors_match_jax(which):
    if which == "harmonic":
        K = 3
        mj = jm.model_harmonic_chirp(LAM, B, ELL, SIGMA, DELTA,
                                     num_harmonics=K, freq_scale=2.0)
        mt = tm.model_harmonic_chirp(LAM, B, ELL, SIGMA, DELTA,
                                     num_harmonics=K, freq_scale=2.0)
        d = 2 * K + 2
    else:
        mj = jm.model_lascala(ELL, SIGMA, DELTA)
        mt = tm.model_lascala(ELL, SIGMA, DELTA)
        d = 4
    u = _states(d, 4, 5)
    npt.assert_allclose(_np(mt.drift(torch.tensor(u))),
                        np.asarray(mj.drift(jnp.asarray(u))), **F64)
    npt.assert_allclose(_np(mt.dispersion(torch.tensor(u[0]))),
                        np.asarray(mj.dispersion(jnp.asarray(u[0]))), **F64)
    for key in ("m0", "P0", "H"):
        npt.assert_allclose(_np(getattr(mt, key)),
                            np.asarray(getattr(mj, key)), **F64, err_msg=key)


@pytest.mark.parametrize("which", ["harmonic", "lascala"])
def test_builders_match_jax(which):
    if which == "harmonic":
        params = np.array([0.2, 0.1, 0.3, 1.2, 0.9, 6.0])
        kw = dict(num_harmonics=3, freq_scale=1.0)
        pj = jm.build_harmonic_chirp_model(jnp.asarray(params), **kw)
        pt = tm.build_harmonic_chirp_model(torch.tensor(params), **kw)
    else:
        params = np.array([0.3, 1.2, 0.9, 6.0])
        pj = jm.build_lascala_model(jnp.asarray(params))
        pt = tm.build_lascala_model(torch.tensor(params))
    d = pt.m0.shape[0]
    for key in ("m0", "P0", "H"):
        npt.assert_allclose(_np(getattr(pt, key)),
                            np.asarray(getattr(pj, key)), **F64, err_msg=key)
    u = _states(d, 3, 6)
    npt.assert_allclose(_np(pt.m_and_cov.mean(torch.tensor(u), DT)),
                        np.asarray(pj.m_and_cov.mean(jnp.asarray(u), DT)),
                        **F64)
    npt.assert_allclose(_np(pt.m_and_cov.cov_const(DT)),
                        np.asarray(pj.m_and_cov.cov_const(DT)), **F64)


def test_harmonic_builder_keeps_the_graph():
    """The harmonic transition built from params that require grad is
    differentiable in them through its cached per-dt constants, as the
    MLE objective needs."""
    params = torch.tensor([0.2, 0.1, 0.3, 1.2, 0.9, 6.0],
                          dtype=torch.float64, requires_grad=True)
    pack = tm.build_harmonic_chirp_model(params, num_harmonics=2)
    u = torch.tensor(_states(6, 3, 7))
    out = pack.m_and_cov.mean(u, DT).sum() + pack.m_and_cov.jac(u, DT).sum()
    grad, = torch.autograd.grad(out, params)
    assert torch.isfinite(grad).all() and bool((grad != 0).any())
