"""PyTorch port vs the JAX package: the continuous-discrete methods
(``quad/integrators.py``, the drifts' closed-form Jacobians,
``cd_sgp_moment_odes``, ``cd_ekf``, ``cd_sgp_filter``, ``cd_eks``,
``cd_sgp_smoother``) and the ``cd_ghfs`` / ``cd_ekfs`` pipeline and sweep.

The same NumPy inputs go to both packages, on seed 0 of
``results/data/toydata_const.npz`` at the reference's learnt optimum
``results/reference/cd_{ghfs,ekfs}_const.npz["params"][0]``.  Tolerances:
the RK4 steps 1e-13; the Jacobians and the moment ODEs 1e-12; filters,
smoothers and ``estimate_if`` in float64 1e-9, in float32 5e-5 on means
and NLL; the objective's value 1e-9 relative and its gradient 1e-8 of
max |grad|; the sweep the same ``success``, params within 1e-5 and
IF-RMSE within 1e-6 relative."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.apps.pipeline as jp
import chirpgp_tpu.apps.sweeps as js
import chirpgp_tpu.infer as ji
import chirpgp_tpu.models as jm
import chirpgp_tpu.quad as jq
import chirpgp_tpu_torch.apps.pipeline as tp
import chirpgp_tpu_torch.apps.sweeps as ts
import chirpgp_tpu_torch.infer as ti
import chirpgp_tpu_torch.models as tm
import chirpgp_tpu_torch.quad as tq
from chirpgp_tpu_torch.fit import batched_value_and_grad

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DT, XI = 1e-3, 0.1
F64 = dict(atol=1e-9, rtol=0)


def _np(x):
    return x.detach().cpu().numpy()


def _ys(T, dtype="float64", seed=0, mag="const"):
    return np.load(ROOT / f"results/data/toydata_{mag}.npz")["ys"][seed, :T] \
        .astype(dtype)


def _params(method):
    return np.load(ROOT / f"results/reference/{method}_const.npz")["params"][0]


# ---------------------------------------------------------------------------
# RK4, Jacobians, moment ODEs
# ---------------------------------------------------------------------------

def _odes(A):
    """A nonlinear mean/covariance ODE pair and a smoothing pair around it,
    in the package of ``A`` (a JAX or a torch array)."""
    tanh = jnp.tanh if isinstance(A, jax.Array) else torch.tanh

    def fwd(m, P):
        return tanh(m) @ A.T, P @ A.T + A @ P + 0.1 * P @ P

    def bwd(m, P, mf, Pf):
        dm, dP = fwd(m, P)
        return dm - mf, dP + Pf

    def scaled(y, s):
        dm, dP = fwd(*y)
        return dm * s, dP

    return fwd, bwd, scaled


def test_rk4_steps_match_jax():
    rng = np.random.default_rng(0)
    A, M = rng.standard_normal((3, 3)), rng.standard_normal((3, 3))
    m, mf = rng.standard_normal(3), rng.standard_normal(3)
    args = (m, M @ M.T, mf, M.T @ M + np.eye(3))
    jf, jb, js_ = _odes(jnp.asarray(A))
    tf, tb, ts_ = _odes(torch.tensor(A))
    j, t = [jnp.asarray(x) for x in args], [torch.tensor(x) for x in args]
    cases = [
        (jq.rk4(js_, (j[0], j[1]), 0.01, 2.0),
         tq.rk4(ts_, (t[0], t[1]), 0.01, 2.0)),
        (jq.rk4_m_cov(jf, j[0], j[1], 0.01),
         tq.rk4_m_cov(tf, t[0], t[1], 0.01)),
        (jq.rk4_m_cov_backward(jb, *j, -0.01),
         tq.rk4_m_cov_backward(tb, *t, -0.01)),
    ]
    for outj, outt in cases:
        for a, b in zip(outj, outt):
            npt.assert_allclose(_np(b), np.asarray(a), atol=1e-13, rtol=0)


PRIORS = {
    "chirp": lambda lib: lib.model_chirp(0.3, 0.2, 1.5, 0.7, 0.4),
    "harmonic": lambda lib: lib.model_harmonic_chirp(
        0.3, 0.2, 1.5, 0.7, 0.4, num_harmonics=3, freq_scale=2.0),
    "lascala": lambda lib: lib.model_lascala(1.5, 0.7, 0.4),
}


@pytest.mark.parametrize("kind", list(PRIORS))
def test_drift_jacobian_matches_jacfwd(kind):
    drift = PRIORS[kind](tm).drift
    d = 8 if kind == "harmonic" else 4
    u = torch.tensor(np.random.default_rng(2).standard_normal((5, d)))
    auto = torch.func.vmap(torch.func.jacfwd(drift))(u)
    npt.assert_allclose(_np(drift.jac(u)), _np(auto), atol=1e-12, rtol=1e-12)
    npt.assert_allclose(_np(drift(u)), np.asarray(
        PRIORS[kind](jm).drift(jnp.asarray(u.numpy()))), atol=1e-12,
        rtol=1e-12)


@pytest.mark.parametrize("rule", ["gh3", "cubature"])
def test_cd_sgp_moment_odes_match_jax(rule):
    from chirpgp_tpu.infer.common import cd_sgp_moment_odes as jodes
    from chirpgp_tpu_torch.infer.common import cd_sgp_moment_odes as todes
    make = (lambda q: q.gauss_hermite(4, 3)) if rule == "gh3" \
        else (lambda q: q.cubature(4))
    pj, pt = jm.build_chirp_model(jnp.asarray(_params("cd_ghfs"))), \
        tm.build_chirp_model(torch.tensor(_params("cd_ghfs")))
    rng = np.random.default_rng(3)
    m, M = rng.standard_normal(4), rng.standard_normal((4, 4))
    P = M @ M.T + 0.1 * np.eye(4)
    out_j = jodes(make(jq), jax.vmap(pj.drift), pj.dispersion(pj.m0),
                  jnp.asarray(m), jnp.asarray(P))
    out_t = todes(make(tq), pt.drift, pt.dispersion(pt.m0), torch.tensor(m),
                  torch.tensor(P))
    for a, b in zip(out_j, out_t):
        npt.assert_allclose(_np(b), np.asarray(a), atol=1e-12, rtol=1e-12)


# ---------------------------------------------------------------------------
# Filters and smoothers
# ---------------------------------------------------------------------------

def _run_cd(lib, infer, quad, method, dtype, T=64):
    """The cd filter and smoother of ``method`` on seed 0 at the reference
    optimum, in package ``lib`` (models), ``infer``, ``quad``."""
    if lib is jm:
        pack = lib.build_chirp_model(jnp.asarray(_params(method), dtype))
        ys = jnp.asarray(_ys(T, dtype))
    else:
        pack = lib.build_chirp_model(torch.tensor(_params(method),
                                                  dtype=getattr(torch, dtype)))
        ys = torch.tensor(_ys(T, dtype))
    if method == "cd_ghfs":
        rule, b = quad.gauss_hermite(4, 3), pack.dispersion(pack.m0)
        mfs, Pfs, nll = infer.cd_sgp_filter(pack.drift, b, rule, pack.H, XI,
                                            pack.m0, pack.P0, DT, ys)
        mss, Pss = infer.cd_sgp_smoother(pack.drift, b, rule, mfs, Pfs, DT)
    else:
        mfs, Pfs, nll = infer.cd_ekf(pack.drift, pack.dispersion, pack.H, XI,
                                     pack.m0, pack.P0, DT, ys)
        mss, Pss = infer.cd_eks(pack.drift, pack.dispersion, mfs, Pfs, DT)
    return mfs, Pfs, nll, mss, Pss


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("method", ["cd_ghfs", "cd_ekfs"])
def test_cd_filter_and_smoother_match_jax(method, dtype):
    """The port in ``dtype`` against the JAX package in float64 (under
    x64 the JAX package's cd filters promote a float32 carry to float64,
    which ``lax.scan`` refuses)."""
    out_j = _run_cd(jm, ji, jq, method, "float64")
    out_t = _run_cd(tm, ti, tq, method, dtype)
    for name, a, b in zip(("mfs", "Pfs", "nll", "mss", "Pss"), out_j, out_t):
        assert b.dtype == getattr(torch, dtype), name
        a, b = np.asarray(a, np.float64), _np(b).astype(np.float64)
        if dtype == "float64":
            npt.assert_allclose(b, a, **F64, err_msg=name)
        elif name in ("mfs", "mss"):
            npt.assert_allclose(b, a, atol=5e-5, rtol=0, err_msg=name)
        elif name == "nll":
            npt.assert_allclose(b, a, atol=0, rtol=5e-5, err_msg=name)


def test_cd_ekf_without_closed_form_jacobian_matches():
    """A drift without ``jac`` is linearized by ``torch.func.jacfwd``, to
    the same values."""
    pack = tm.build_chirp_model(torch.tensor(_params("cd_ekfs")))
    ys = torch.tensor(_ys(20))
    bare = lambda u: pack.drift(u)  # noqa: E731
    out_a = ti.cd_ekf(pack.drift, pack.dispersion, pack.H, XI, pack.m0,
                      pack.P0, DT, ys)
    out_b = ti.cd_ekf(bare, pack.dispersion, pack.H, XI, pack.m0, pack.P0,
                      DT, ys)
    for a, b in zip(out_a, out_b):
        npt.assert_allclose(_np(b), _np(a), atol=1e-12, rtol=0)
    sa = ti.cd_eks(pack.drift, pack.dispersion, *out_a[:2], DT)
    sb = ti.cd_eks(bare, pack.dispersion, *out_b[:2], DT)
    for a, b in zip(sa, sb):
        npt.assert_allclose(_np(b), _np(a), atol=1e-12, rtol=0)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["cd_ghfs", "cd_ekfs"])
def test_make_nll_fn_value_and_grad_match_jax(method):
    ys = _ys(40)
    theta = np.asarray(jm.g_inv(jnp.asarray(_params(method)))) + 0.05
    vj, gj = jax.value_and_grad(jp.make_nll_fn(
        jp.IFEstimationConfig(method=method), jnp.asarray(ys)))(
            jnp.asarray(theta))
    th = torch.tensor(theta, requires_grad=True)
    vt = tp.make_nll_fn(tp.IFEstimationConfig(method=method),
                        torch.tensor(ys))(th)
    gt, = torch.autograd.grad(vt, th)
    npt.assert_allclose(float(vt), float(vj), rtol=1e-9)
    npt.assert_allclose(_np(gt), np.asarray(gj), rtol=0,
                        atol=1e-8 * float(np.abs(gj).max()))


@pytest.mark.parametrize("method", ["cd_ghfs", "cd_ekfs"])
def test_estimate_if_matches_jax(method):
    ys = _ys(64)
    ej = jp.estimate_if(jp.IFEstimationConfig(method=method),
                        jnp.asarray(_params(method)), jnp.asarray(ys))
    et = tp.estimate_if(tp.IFEstimationConfig(method=method),
                        torch.tensor(_params(method)), torch.tensor(ys))
    for key in ("mfs", "Pfs", "nell", "mss", "Pss", "if_mean", "if_lower",
                "if_upper"):
        npt.assert_allclose(_np(et[key]), np.asarray(ej[key]), **F64,
                            err_msg=key)


def test_chip_smoke_cd_gates_are_the_jax_package_values():
    """``chip_smoke.py`` phase 9a holds the card to these float64 values of
    the JAX package on seed 0 at T=3141 (IF-RMSE x10, final NLL)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    data = np.load(ROOT / "results/data/toydata_const.npz")
    ys = jnp.asarray(data["ys"][0].astype(np.float64))
    tf = data["true_freqs"].astype(np.float64)
    for method, (r10, nll, ref) in smoke.CD_GATES.items():
        est = jp.estimate_if(jp.IFEstimationConfig(method=method),
                             jnp.asarray(_params(method)), ys)
        got = 10.0 * np.sqrt(np.mean((np.asarray(est["if_mean"]) - tf) ** 2))
        npt.assert_allclose(got, r10, rtol=0, atol=1e-12)
        npt.assert_allclose(float(est["nell"][-1]), nll, rtol=1e-14)
        npt.assert_allclose(ref, 10.0 * np.load(
            ROOT / f"results/reference/{method}_const.npz")["rmse"][0],
            atol=1e-6)


def test_sqrt_form_rejects_cd_methods():
    ys = torch.zeros(8, dtype=torch.float64)
    for method in ("cd_ghfs", "cd_ekfs"):
        for fn in (lambda c: tp.make_nll_fn(c, ys),
                   lambda c: tp.estimate_if(c, [0.1] * 6, ys)):
            with pytest.raises(ValueError, match="form='sqrt' supports"):
                fn(tp.IFEstimationConfig(method=method, form="sqrt"))
            with pytest.raises(ValueError, match="form='sqrt' supports"):
                jp.make_nll_fn(jp.IFEstimationConfig(method=method,
                                                     form="sqrt"), ys.numpy())


@pytest.mark.parametrize("method", ["cd_ghfs", "cd_ekfs"])
def test_remat_on_and_off_agree(method):
    """``remat`` is the JAX scan's step checkpointing; the value and the
    gradient are the same either way."""
    ys = torch.tensor(_ys(20))
    outs = []
    for remat in (False, True):
        th = torch.tensor(_params(method), requires_grad=True)
        pack = tm.build_chirp_model(th)
        if method == "cd_ghfs":
            nll = ti.cd_sgp_filter(pack.drift, pack.dispersion(pack.m0),
                                   tq.gauss_hermite(4, 3), pack.H, XI,
                                   pack.m0, pack.P0, DT, ys, remat=remat)[2]
        else:
            nll = ti.cd_ekf(pack.drift, pack.dispersion, pack.H, XI, pack.m0,
                            pack.P0, DT, ys, remat=remat)[2]
        grad, = torch.autograd.grad(nll[-1], th)
        outs.append((_np(nll), _np(grad)))
    for a, b in zip(*outs):
        npt.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["cd_ghfs", "cd_ekfs"])
def test_one_bad_lane_leaves_the_others(method):
    """A vmapped float32 batch with one lane whose measurements hold a NaN
    and whose theta blows the moment ODEs up: that lane is NaN, without a
    raise, and every other lane equals the objective on that lane alone."""
    cfg = tp.IFEstimationConfig(method=method)
    yss = torch.tensor(np.stack([_ys(24, "float32", s) for s in range(3)]))
    yss[1, 5] = float("nan")
    theta = cfg.default_init_theta(torch.float32).expand(3, -1).clone()
    theta[1, 0] = -60.0
    theta[1, 4] = 60.0

    def nll(th, y):
        return tp.make_nll_fn(cfg, y)(th)

    values, grads = batched_value_and_grad(nll, (yss,))(theta)
    assert torch.isnan(values[1])
    for i in (0, 2):
        th = theta[i].clone().requires_grad_(True)
        v = nll(th, yss[i])
        g, = torch.autograd.grad(v, th)
        npt.assert_allclose(float(values[i]), float(v), rtol=1e-6)
        npt.assert_allclose(_np(grads[i]), _np(g), rtol=0,
                            atol=1e-5 * float(g.abs().max()))


def test_cd_methods_run():
    """Port of ``tests/test_pipeline.py::test_cd_methods_run``: both cd
    methods give a finite IF at the default init on a T=200 toy record."""
    from chirpgp_tpu_torch.toymodels import gen_chirp, constant_mag, meow_freq
    T = 200
    ts_ = torch.linspace(DT, DT * T, T, dtype=torch.float64)
    _, phase = meow_freq(offset=8.0)
    noise = np.random.default_rng(555).standard_normal(T)
    ys = gen_chirp(ts_, constant_mag(1.0), phase) \
        + np.sqrt(XI) * torch.tensor(noise)
    for method in ("cd_ghfs", "cd_ekfs"):
        cfg = tp.IFEstimationConfig(method=method)
        est = tp.estimate_if(cfg, tm.g(cfg.default_init_theta(torch.float64)),
                             ys)
        assert bool(torch.isfinite(est["if_mean"]).all())


def test_sweep_on_measurements_matches_jax(monkeypatch):
    """The whole ``mle_sweep_on_measurements(cd_ghfs)`` (stepped L-BFGS,
    rescue, float64 polish, estimate) on seed 0 of each magnitude, T=40,
    5 iterations.
    Lane 2 is rescued.  The JAX package's rescue writes into a read-only
    view of a float64 ``fun_val`` (ROADMAP Queue 3), so its stepped result
    reaches the rescue with a writable copy of ``fun_val``."""
    stepped = js.lbfgs_minimize_stepped

    def writable(*args, **kwargs):
        opt = stepped(*args, **kwargs)
        return opt._replace(fun_val=np.array(opt.fun_val))

    monkeypatch.setattr(js, "lbfgs_minimize_stepped", writable)
    T = 40
    tf = np.load(ROOT / "results/data/toydata_const.npz")["true_freqs"][:T] \
        .astype(np.float64)
    ys = np.stack([_ys(T, mag=m) for m in ts.MAGNITUDES])
    rj = js.mle_sweep_on_measurements(
        jp.IFEstimationConfig(method="cd_ghfs", max_iters=5),
        jnp.asarray(np.broadcast_to(tf, ys.shape)), jnp.asarray(ys))
    rt = ts.mle_sweep_on_measurements(
        tp.IFEstimationConfig(method="cd_ghfs", max_iters=5), tf, ys,
        device="cpu")
    npt.assert_array_equal(rt["success"], rj["success"])
    npt.assert_allclose(rt["params"], rj["params"], atol=1e-5, rtol=0)
    npt.assert_allclose(rt["rmse"], rj["rmse"], rtol=1e-6, atol=0)
