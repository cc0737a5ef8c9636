"""PyTorch port vs the JAX package: the Kalman pitch tracker (KPT)
baseline -- the model, ``ekf_for_kpt``, ``apps/kpt.py`` -- in float64 on
the committed data of ``results/data/``.

Tolerances: the model 1e-12; the measurement's closed-form Jacobian
against ``torch.func.jacfwd`` 1e-12; the EKF, the IF estimate and the NLL
1e-9 relative; the objective's gradient 1e-9 of max |grad|; a few L-BFGS
iterations 1e-8 in theta."""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.apps as ja
import chirpgp_tpu.infer as ji
import chirpgp_tpu.models as jm
import chirpgp_tpu_torch.apps as ta
import chirpgp_tpu_torch.infer as ti
import chirpgp_tpu_torch.models as tm
from chirpgp_tpu_torch.toymodels import affine_freq, constant_mag, gen_chirp
from chirpgp_tpu_torch.utils import rmse

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FS, XI, T = 1000.0, 0.1, 200
F64 = dict(atol=1e-12, rtol=1e-12)
COLUMNS = {"kpt": ("toydata_const", 1), "harmonic_kpt": ("toydata_h3_const", 3)}


def _np(x):
    return x.detach().cpu().numpy()


def _column(name, T=T):
    """(measurements (T,), true IF (T,), reference params (5,)) of seed 0."""
    data, K = COLUMNS[name]
    d = np.load(ROOT / f"results/data/{data}.npz")
    params = np.load(ROOT / f"results/reference/{name}_const.npz")["params"][0]
    return d["ys"][0, :T].astype(np.float64), d["true_freqs"][:T], params, K


def _rel(a, b):
    return dict(rtol=1e-9, atol=1e-9 * float(np.abs(b).max()))


@pytest.mark.parametrize("K", [1, 3])
def test_kpt_model_matches_jax(K):
    params = np.array([0.09, 1e-4, 1e-3, 7.2, 0.95])
    Fj, Sj, m0j, P0j, hj = jm.build_kpt_chirp_model(jnp.asarray(params), FS,
                                                     num_harmonics=K)
    Ft, St, m0t, P0t, ht = tm.build_kpt_chirp_model(torch.tensor(params), FS,
                                                     num_harmonics=K)
    for a, b in ((Ft, Fj), (St, Sj), (m0t, m0j), (P0t, P0j)):
        npt.assert_allclose(_np(a), np.asarray(b), **F64)
    x = np.random.default_rng(K).standard_normal((6, K + 2))
    npt.assert_allclose(_np(ht(torch.tensor(x))), np.asarray(hj(jnp.asarray(x))),
                        **F64)


@pytest.mark.parametrize("K", [1, 3])
def test_kpt_measurement_jacobian_matches_jacfwd(K):
    h = tm.build_kpt_chirp_model([0.1, 1e-4, 1e-3, 7.0, 1.0], FS,
                                 num_harmonics=K).h
    x = torch.tensor(np.random.default_rng(10 + K).standard_normal((8, K + 2)))
    auto = torch.func.vmap(torch.func.jacfwd(h))(x)
    assert h.jac(x).shape == (8, K + 2)
    npt.assert_allclose(_np(h.jac(x)), _np(auto), **F64)
    npt.assert_allclose(_np(h.jac(x[0])), _np(auto[0]), **F64)


@pytest.mark.parametrize("closed_form", [True, False], ids=["jac", "jacfwd"])
@pytest.mark.parametrize("name", list(COLUMNS))
def test_ekf_for_kpt_matches_jax(name, closed_form):
    """The EKF at the reference optimum, with the measurement's closed-form
    Jacobian and, for a plain callable, with ``torch.func.jacfwd``."""
    ys, _, params, K = _column(name)
    Fj, Sj, m0j, P0j, hj = jm.build_kpt_chirp_model(jnp.asarray(params), FS,
                                                     num_harmonics=K)
    Ft, St, m0t, P0t, ht = tm.build_kpt_chirp_model(torch.tensor(params), FS,
                                                     num_harmonics=K)
    h = ht if closed_form else (lambda x: ht(x))
    out_j = ji.ekf_for_kpt(Fj, Sj, hj, XI, m0j, P0j, 1.0 / FS, jnp.asarray(ys))
    out_t = ti.ekf_for_kpt(Ft, St, h, XI, m0t, P0t, 1.0 / FS,
                           torch.tensor(ys))
    assert out_t[0].shape == (T, K + 2) and out_t[1].shape == (T, K + 2, K + 2)
    for a, b, key in zip(out_t, out_j, ("mfs", "Pfs", "nll")):
        b = np.asarray(b)
        npt.assert_allclose(_np(a), b, **_rel(a, b), err_msg=key)


@pytest.mark.parametrize("name", list(COLUMNS))
def test_kpt_if_estimate_matches_jax(name):
    """Seed 0, T=200, at the column's reference optimum: IF mean and nll
    1e-9 relative; the smoother too."""
    ys, tf, params, K = _column(name)
    if_j, nell_j = ja.kpt_if_estimate(jnp.asarray(params), FS, XI,
                                      jnp.asarray(ys), num_harmonics=K)
    if_t, nell_t = ta.kpt_if_estimate(params, FS, XI, ys, num_harmonics=K,
                                      device="cpu")
    assert if_t.dtype == torch.float64 and if_t.device.type == "cpu"
    npt.assert_allclose(_np(if_t), np.asarray(if_j), **_rel(None, if_j))
    npt.assert_allclose(_np(nell_t), np.asarray(nell_j), rtol=1e-9, atol=0)
    mfs, Pfs, _ = ta.kpt_filter(params, FS, XI, ys, num_harmonics=K,
                                device="cpu")
    fj = ja.kpt_filter(jnp.asarray(params), FS, XI, jnp.asarray(ys),
                       num_harmonics=K)
    sj = ja.kpt_smooth(jnp.asarray(params), FS, fj[0], fj[1], num_harmonics=K)
    st = ta.kpt_smooth(params, FS, mfs, Pfs, num_harmonics=K)
    for a, b in zip(st, sj):
        npt.assert_allclose(_np(a), np.asarray(b), **_rel(None, b))
    assert np.isfinite(float(rmse(torch.tensor(tf), if_t)))


@pytest.mark.parametrize("name", list(COLUMNS))
def test_kpt_objective_value_and_grad_match_jax(name):
    """The KPT MLE objective, theta -> final EKF NLL, and its
    ``torch.autograd`` gradient against ``jax.grad``, at the reference
    optimum and at the sweep's init."""
    ys, _, params, K = _column(name, 120)

    def nll_j(theta):
        return ja.kpt_filter(jm.g(theta), FS, XI, jnp.asarray(ys),
                             num_harmonics=K)[2][-1]

    for theta in (np.asarray(jm.g_inv(jnp.asarray(params))),
                  np.asarray(jm.g_inv(jnp.asarray(ja.KPT_INIT_PARAMS)))):
        vj, gj = jax.value_and_grad(nll_j)(jnp.asarray(theta))
        th = torch.tensor(theta, requires_grad=True)
        vt = ta.kpt_filter(tm.g(th), FS, XI, ys, num_harmonics=K,
                           device="cpu")[2][-1]
        gt, = torch.autograd.grad(vt, th)
        npt.assert_allclose(float(vt.detach()), float(vj), rtol=1e-9)
        npt.assert_allclose(_np(gt), np.asarray(gj), rtol=0,
                            atol=1e-9 * float(np.abs(np.asarray(gj)).max()))


def test_kpt_mle_matches_jax():
    """Three L-BFGS iterations from the reference init (K=1, T=100): the
    same iterate."""
    ys, _, _, _ = _column("kpt", 100)
    oj = ja.kpt_mle(FS, XI, jnp.asarray(ys), max_iters=3)
    ot = ta.kpt_mle(FS, XI, ys, max_iters=3, device="cpu")
    assert int(ot.num_iters) == int(oj.num_iters) == 3
    npt.assert_allclose(_np(ot.params), np.asarray(oj.params), atol=1e-8,
                        rtol=0)
    npt.assert_allclose(float(ot.fun_val), float(oj.fun_val), rtol=1e-10)
    assert bool(ot.success)
    with pytest.raises(ValueError, match="optimizer"):
        ta.kpt_mle(FS, XI, ys, optimizer="adam", device="cpu")


def test_kpt_scipy_mle_matches_jax():
    """SciPy L-BFGS-B to its own stopping rule (K=1, T=60): the same
    optimum, 1e-7 relative in the NLL."""
    ys, _, _, _ = _column("kpt", 60)
    oj = ja.kpt_mle(FS, XI, jnp.asarray(ys), optimizer="scipy")
    ot = ta.kpt_mle(FS, XI, ys, optimizer="scipy", device="cpu")
    assert bool(ot.success) == bool(oj.success)
    npt.assert_allclose(float(ot.fun_val), float(oj.fun_val), rtol=1e-7)
    npt.assert_allclose(_np(ot.params), np.asarray(oj.params), atol=1e-3,
                        rtol=0)


def test_kpt_tracks_pure_tone():
    """KPT EKF+RTS tracks a constant-frequency tone (port of
    ``tests/test_kpt_sweeps.py::test_kpt_tracks_pure_tone``; the noise is
    NumPy's, since torch cannot replay JAX's keys)."""
    dt, n = 1e-3, 2000
    ts = torch.linspace(dt, dt * n, n, dtype=torch.float64)
    f0, Xi = 25.0, 0.01
    _, phase = affine_freq(0.0, f0)
    ys = gen_chirp(ts, constant_mag(1.0), phase) + math.sqrt(Xi) * \
        torch.tensor(np.random.default_rng(0).standard_normal(n))
    params = torch.tensor([0.5, 1e-4, 0.1, 24.0, 1.0], dtype=torch.float64)
    if_mean, _ = ta.kpt_if_estimate(params, 1.0 / dt, Xi, ys)
    npt.assert_allclose(float(if_mean[500:].mean()), f0, rtol=0.05)


def test_ekf_for_kpt_under_vmap():
    """Two records under ``torch.func.vmap`` equal each record alone (the
    sweep's batched objective)."""
    ys, _, params, K = _column("harmonic_kpt", 80)
    yss = torch.tensor(np.stack([ys, ys[::-1].copy()]))
    theta = tm.g_inv(torch.tensor(params)).expand(2, 5) \
        + torch.tensor([[0.0], [0.1]], dtype=torch.float64)

    def nll(th, y):
        return ta.kpt_filter(tm.g(th), FS, XI, y, num_harmonics=K)[2][-1]

    batched = torch.func.vmap(nll)(theta, yss)
    for i in range(2):
        npt.assert_allclose(float(batched[i]), float(nll(theta[i], yss[i])),
                            rtol=1e-12)
