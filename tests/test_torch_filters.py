"""PyTorch port vs the JAX package: the unbatched filters and smoothers
(covariance and square-root forms) on the chirp, harmonic and La Scala
models, ``tria``, ``psd_solve``, the Gaussian expectations, and the EKF's
``torch.func.jacfwd`` linearization.

The same NumPy inputs go to both packages.  Tolerances: float64 atol
1e-10 on means, nll and covariances; float32 (square-root forms) atol 5e-5
on means, 1e-4 on L L^T, and 1e-5 relative on nll[-1]."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.infer as ji
import chirpgp_tpu.models as jm
import chirpgp_tpu.quad as jq
import chirpgp_tpu.utils.numerics as jn
import chirpgp_tpu_torch.infer as ti
import chirpgp_tpu_torch.models as tm
import chirpgp_tpu_torch.quad as tq
import chirpgp_tpu_torch.utils.numerics as tn

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PARAMS = [0.1, 0.1, 0.1, 1.0, 1.0, 7.0]
T, DT, XI = 60, 1e-3, 0.1
F64 = dict(atol=1e-10, rtol=0)


def _np(x):
    return x.detach().cpu().numpy()


def _ys(dtype="float64"):
    return np.load(ROOT / "results/data/toydata_const.npz")["ys"][0, :T] \
        .astype(dtype)


# (JAX builder, port builder, params, sigma-point rule) of each model; the
# harmonic model at K=2 (d=6).
MODELS = {
    "chirp": (jm.build_chirp_model, tm.build_chirp_model, PARAMS,
              lambda q: q.gauss_hermite(4, 3)),
    "harmonic": (lambda p: jm.build_harmonic_chirp_model(p, num_harmonics=2),
                 lambda p: tm.build_harmonic_chirp_model(p, num_harmonics=2),
                 PARAMS, lambda q: q.cubature(6)),
    "lascala": (jm.build_lascala_model, tm.build_lascala_model,
                [0.1, 1.0, 1.0, 7.0], lambda q: q.gauss_hermite(4, 3)),
}


def _packs(dtype, model="chirp"):
    bj, bt, params, _ = MODELS[model]
    return (bj(jnp.asarray(params, getattr(jnp, dtype))),
            bt(torch.tensor(params, dtype=getattr(torch, dtype))))


def _gram(L):
    L = np.asarray(L)
    return L @ np.swapaxes(L, -1, -2)


def _run(method, dtype, model="chirp"):
    """(filter out, smoother out) of one method in both packages."""
    pj, pt = _packs(dtype, model)
    yj, yt = jnp.asarray(_ys(dtype)), torch.tensor(_ys(dtype))
    rule = MODELS[model][3]
    rj, rt = rule(jq), rule(tq)
    # x64 is on: the JAX model's constant arrays (P0's eye) are float64.
    cj = (pj.H.astype(dtype), XI, pj.m0.astype(dtype), pj.P0.astype(dtype),
          DT, yj)
    ct = (pt.H, XI, pt.m0, pt.P0, DT, yt)
    if method == "sgp":
        fj = ji.sgp_filter(pj.m_and_cov, rj, *cj)
        ft = ti.sgp_filter(pt.m_and_cov, rt, *ct)
        sj = ji.sgp_smoother(pj.m_and_cov, rj, fj[0], fj[1], DT)
        st = ti.sgp_smoother(pt.m_and_cov, rt, ft[0], ft[1], DT)
    elif method == "ekf":
        fj = ji.ekf(pj.m_and_cov, *cj)
        ft = ti.ekf(pt.m_and_cov, *ct)
        sj = ji.eks(pj.m_and_cov, fj[0], fj[1], DT)
        st = ti.eks(pt.m_and_cov, ft[0], ft[1], DT)
    elif method == "sqrt_sgp":
        fj = ji.sqrt_sgp_filter(pj.m_and_cov, rj, *cj)
        ft = ti.sqrt_sgp_filter(pt.m_and_cov, rt, *ct)
        sj = ji.sqrt_sgp_smoother(pj.m_and_cov, rj, fj[0], fj[1], DT)
        st = ti.sqrt_sgp_smoother(pt.m_and_cov, rt, ft[0], ft[1], DT)
    else:
        fj = ji.sqrt_ekf(pj.m_and_cov, *cj)
        ft = ti.sqrt_ekf(pt.m_and_cov, *ct)
        sj = ji.sqrt_eks(pj.m_and_cov, fj[0], fj[1], DT)
        st = ti.sqrt_eks(pt.m_and_cov, ft[0], ft[1], DT)
    return (fj, sj), (ft, st)


@pytest.mark.parametrize("method", ["sgp", "ekf", "sqrt_sgp", "sqrt_ekf"])
def test_filter_and_smoother_match_jax_float64(method):
    ((mj, Pj, nj), (msj, Psj)), ((mt, Pt, nt), (mst, Pst)) = \
        _run(method, "float64")
    assert mt.shape == (T, 4) and Pt.shape == (T, 4, 4) and nt.shape == (T,)
    assert mst.shape == (T, 4) and Pst.shape == (T, 4, 4)
    second = _gram if method.startswith("sqrt") else np.asarray
    npt.assert_allclose(_np(mt), np.asarray(mj), **F64)
    npt.assert_allclose(_np(nt), np.asarray(nj), **F64)
    npt.assert_allclose(second(_np(Pt)), second(Pj), **F64)
    npt.assert_allclose(_np(mst), np.asarray(msj), **F64)
    npt.assert_allclose(second(_np(Pst)), second(Psj), **F64)


@pytest.mark.parametrize("method", ["sgp", "ekf", "sqrt_sgp", "sqrt_ekf"])
@pytest.mark.parametrize("model", ["harmonic", "lascala"])
def test_family_filter_and_smoother_match_jax_float64(model, method):
    """The harmonic (K=2, d=6, cubature) and La Scala (its zero
    process-noise block) models through each filter and smoother; the
    extended ones take the closed-form Jacobians."""
    ((mj, Pj, nj), (msj, Psj)), ((mt, Pt, nt), (mst, Pst)) = \
        _run(method, "float64", model)
    d = 6 if model == "harmonic" else 4
    assert mt.shape == (T, d) and Pst.shape == (T, d, d)
    second = _gram if method.startswith("sqrt") else np.asarray
    for a, b in ((mt, mj), (nt, nj), (mst, msj)):
        npt.assert_allclose(_np(a), np.asarray(b), **F64)
    for a, b in ((Pt, Pj), (Pst, Psj)):
        npt.assert_allclose(second(_np(a)), second(b), **F64)


@pytest.mark.parametrize("method", ["sqrt_sgp", "sqrt_ekf"])
def test_sqrt_forms_match_jax_float32(method):
    ((mj, Lj, nj), (msj, Lsj)), ((mt, Lt, nt), (mst, Lst)) = \
        _run(method, "float32")
    assert mt.dtype == torch.float32 and mst.dtype == torch.float32
    for a, b in ((mt, mj), (mst, msj)):
        npt.assert_allclose(_np(a), np.asarray(b), atol=5e-5, rtol=0)
    for a, b in ((Lt, Lj), (Lst, Lsj)):
        npt.assert_allclose(_gram(_np(a)), _gram(b), atol=1e-4, rtol=0)
    npt.assert_allclose(_np(nt)[-1], np.asarray(nj)[-1], rtol=1e-5, atol=0)


def test_kf_rts_and_sqrt_kf_match_jax():
    """A small LGSSM (d=3, damped rotation + random walk), float64."""
    rng = np.random.default_rng(11)
    th = 0.3
    F = np.array([[0.98 * np.cos(th), -0.98 * np.sin(th), 0.0],
                  [0.98 * np.sin(th), 0.98 * np.cos(th), 0.0],
                  [0.0, 0.0, 1.0]])
    A = rng.standard_normal((3, 3))
    Sigma = 0.05 * A @ A.T + 1e-3 * np.eye(3)
    H = np.array([1.0, 0.0, 0.5])
    m0, P0 = np.zeros(3), np.eye(3)
    ys = rng.standard_normal(40)
    argsj = [jnp.asarray(a) for a in (F, Sigma, H)]
    argst = [torch.tensor(a) for a in (F, Sigma, H)]
    mj, Pj, nj = ji.kf(*argsj, 0.2, jnp.asarray(m0), jnp.asarray(P0),
                       jnp.asarray(ys))
    mt, Pt, nt = ti.kf(*argst, 0.2, torch.tensor(m0), torch.tensor(P0),
                       torch.tensor(ys))
    for a, b in ((mt, mj), (Pt, Pj), (nt, nj)):
        npt.assert_allclose(_np(a), np.asarray(b), **F64)
    msj, Psj = ji.rts(argsj[0], argsj[1], mj, Pj)
    mst, Pst = ti.rts(argst[0], argst[1], mt, Pt)
    npt.assert_allclose(_np(mst), np.asarray(msj), **F64)
    npt.assert_allclose(_np(Pst), np.asarray(Psj), **F64)
    mqj, Lqj, nqj = ji.sqrt_kf(*argsj, 0.2, jnp.asarray(m0),
                               jnp.asarray(P0), jnp.asarray(ys))
    mqt, Lqt, nqt = ti.sqrt_kf(*argst, 0.2, torch.tensor(m0),
                               torch.tensor(P0), torch.tensor(ys))
    npt.assert_allclose(_np(mqt), np.asarray(mqj), **F64)
    npt.assert_allclose(_np(nqt), np.asarray(nqj), **F64)
    npt.assert_allclose(_gram(_np(Lqt)), _gram(Lqj), **F64)
    # The square-root form is the same filter.
    npt.assert_allclose(_np(mqt), _np(mt), **F64)
    npt.assert_allclose(_gram(_np(Lqt)), _np(Pt), **F64)


@pytest.mark.parametrize("method", ["hh", "qr", "chol"])
@pytest.mark.parametrize("shape", [(9, 4), (2, 12, 5)])
def test_tria_matches_jax(method, shape):
    M = np.random.default_rng(sum(shape)).standard_normal(shape)
    Rt = _np(ti.tria(torch.tensor(M), method))
    Rj = np.asarray(ji.tria(jnp.asarray(M), method))
    d = shape[-1]
    assert Rt.shape == shape[:-2] + (d, d)
    assert np.all(np.tril(Rt, k=-1) == 0)
    gram = lambda R: np.swapaxes(R, -1, -2) @ R  # noqa: E731
    npt.assert_allclose(gram(Rt), np.swapaxes(M, -1, -2) @ M, **F64)
    if method == "qr":   # R is unique up to the signs of its rows
        npt.assert_allclose(np.abs(Rt), np.abs(Rj), **F64)
    else:
        npt.assert_allclose(Rt, Rj, **F64)
    with pytest.raises(ValueError):
        ti.tria(torch.tensor(M), "svd")


def test_tria_hh_is_differentiable():
    M = torch.tensor(np.random.default_rng(2).standard_normal((7, 3)),
                     requires_grad=True)
    grad, = torch.autograd.grad(ti.tria(M).sum(), M)
    gj = jax.grad(lambda x: ji.tria(x).sum())(jnp.asarray(_np(M)))
    npt.assert_allclose(_np(grad), np.asarray(gj), **F64)


def test_psd_solve_matches_jax():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((4, 4))
    P = A @ A.T + 0.1 * np.eye(4)
    for B in (rng.standard_normal(4), rng.standard_normal((4, 3))):
        Xt = _np(tn.psd_solve(torch.tensor(P), torch.tensor(B)))
        npt.assert_allclose(Xt, np.asarray(jn.psd_solve(jnp.asarray(P),
                                                        jnp.asarray(B))), **F64)
        npt.assert_allclose(P @ Xt, B, **F64)
    # Singular: the pseudo-inverse on the degenerate block, no NaNs.
    S = np.diag([2.0, 0.0, 1.0, 4.0])
    b = np.array([1.0, 0.0, 2.0, 3.0])
    npt.assert_allclose(_np(tn.psd_solve(torch.tensor(S), torch.tensor(b))),
                        [0.5, 0.0, 2.0, 0.75], **F64)


def test_gaussian_expectations_match_jax():
    rng = np.random.default_rng(4)
    ms = 8.0 + rng.standard_normal(30)
    stds = 0.1 + rng.random(30)
    npt.assert_allclose(
        _np(tq.gaussian_expectation_1d(torch.tensor(ms), torch.tensor(stds))),
        np.asarray(jq.gaussian_expectation_1d(jnp.asarray(ms),
                                              jnp.asarray(stds))), atol=1e-12)
    npt.assert_allclose(
        _np(tq.gaussian_expectation(torch.tensor(ms), torch.tensor(stds),
                                    force_shape=True)),
        np.asarray(jq.gaussian_expectation(jnp.asarray(ms), jnp.asarray(stds),
                                           force_shape=True)), atol=1e-12)
    m2 = rng.standard_normal((30, 2))
    L2 = np.tril(rng.standard_normal((30, 2, 2))) * 0.3
    npt.assert_allclose(
        _np(tq.gaussian_expectation(torch.tensor(m2), torch.tensor(L2),
                                    func=torch.sin, d=2, order=5)),
        np.asarray(jq.gaussian_expectation(jnp.asarray(m2), jnp.asarray(L2),
                                           func=jnp.sin, d=2, order=5)),
        atol=1e-12)


def test_jacfwd_of_the_chirp_mean_keeps_nothing_wrapped():
    """The LCD mean's step-constant cache: a fresh transition whose first
    call is inside ``torch.func.jacfwd`` must not keep the transform's
    wrapped tensors.  Afterwards a plain call and reverse mode through
    both still work, and the Jacobian matches ``jax.jacfwd``."""
    lam = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    tt = tm.disc_chirp_lcd(lam, 0.1, 1.0, 1.0)
    u = np.array([0.2, 0.9, 1.5, -0.4])
    Jt = torch.func.jacfwd(lambda x: tt.mean(x, DT))(torch.tensor(u))
    Jj = jax.jacfwd(lambda x: jm.disc_chirp_lcd(0.3, 0.1, 1.0, 1.0)
                    .mean(x, DT))(jnp.asarray(u))
    npt.assert_allclose(_np(Jt), np.asarray(Jj), atol=1e-12)
    plain = tt.mean(torch.tensor(u), DT)
    Jt2 = torch.func.jacfwd(lambda x: tt.mean(x, DT))(torch.tensor(u))
    grad, = torch.autograd.grad(plain.sum() + Jt2.sum(), lam)
    gj = jax.grad(lambda lm: (
        jm.disc_chirp_lcd(lm, 0.1, 1.0, 1.0).mean(jnp.asarray(u), DT).sum()
        + jax.jacfwd(lambda x: jm.disc_chirp_lcd(lm, 0.1, 1.0, 1.0)
                     .mean(x, DT))(jnp.asarray(u)).sum()))(0.3)
    npt.assert_allclose(float(grad), float(gj), atol=1e-12)


def test_filters_accept_reference_style_closures():
    """``as_transition`` wraps an ``m_and_cov(u, dt)`` closure (vmap over
    the sigma points): the filter gives what it gives with the
    Transition."""
    _, pt = _packs("float64")
    trans = pt.m_and_cov
    closure = lambda u, dt: (trans.mean(u, dt), trans.cov(u, dt))  # noqa: E731
    yt = torch.tensor(_ys())[:20]
    rt = tq.cubature(4)
    want = ti.sgp_filter(trans, rt, pt.H, XI, pt.m0, pt.P0, DT, yt)
    got = ti.sgp_filter(closure, rt, pt.H, XI, pt.m0, pt.P0, DT, yt)
    for a, b in zip(got, want):
        npt.assert_allclose(_np(a), _np(b), **F64)
    with pytest.raises(ValueError, match="nonnegative"):
        ti.sqrt_sgp_filter(trans, tq.unscented(4), pt.H, XI, pt.m0, pt.P0,
                           DT, yt)
