"""PyTorch port vs the JAX package: the Table-I Monte-Carlo sweeps
(``apps/sweeps.py``: the chirp, harmonic and La Scala columns and the KPT
baseline), the toy models and the SDE simulator, in float64 on the
committed data of ``results/data/`` and on the JAX package's keys, whose
records the port remakes without JAX.  Tolerances: the whole
``mle_sweep_on_measurements`` (stepped L-BFGS, rescue, float64 polish,
estimate), the key-driven ``mc_mle_sweep`` and the KPT sweeps the same
``success``, the learnt params within 1e-5 and the IF-RMSE within 1e-6
relative; the records of a key 1e-10; the toy models and the simulator from JAX's own draws 1e-12;
the vmapped objective against one lane alone 1e-12 relative."""

import concurrent.futures
from pathlib import Path

import numpy as np
import numpy.testing as npt
import jax
import jax.numpy as jnp
import pytest
import torch

import chirpgp_tpu.apps.kpt as jk
import chirpgp_tpu.apps.pipeline as jp
import chirpgp_tpu.apps.sweeps as js
import chirpgp_tpu.toymodels as jt
import chirpgp_tpu.utils.sim as jsim
from chirpgp_tpu.fit.mle import MLEResult as JMLEResult
from chirpgp_tpu.models import g as jm_g, g_inv as jm_g_inv
import chirpgp_tpu_torch.apps.kpt as tk
import chirpgp_tpu_torch.apps.pipeline as tp
import chirpgp_tpu_torch.apps.sweeps as ts
import chirpgp_tpu_torch.toymodels as tt
import chirpgp_tpu_torch.utils.sim as tsim
from chirpgp_tpu_torch.fit import MLEResult, batched_value_and_grad
from chirpgp_tpu_torch.models import g

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

F64 = dict(atol=1e-12, rtol=0)


def _seed0(T, prefix=""):
    """Seed 0 of each magnitude's Table-I data (``toydata_h3_*`` with
    ``prefix="h3_"``): (true_freqs (T,), ys (3, T))."""
    ys = []
    for mag in ts.MAGNITUDES:
        data = np.load(ROOT / f"results/data/toydata_{prefix}{mag}.npz")
        ys.append(data["ys"][0, :T])
    return data["true_freqs"][:T].astype(np.float64), \
        np.stack(ys).astype(np.float64)


@pytest.mark.parametrize("method", ["ekfs", "ghfs"])
def test_sweep_on_measurements_matches_jax(method):
    tf, ys = _seed0(60)
    rj = js.mle_sweep_on_measurements(
        jp.IFEstimationConfig(method=method, max_iters=15),
        jnp.asarray(np.broadcast_to(tf, ys.shape)), jnp.asarray(ys))
    rt = ts.mle_sweep_on_measurements(
        tp.IFEstimationConfig(method=method, max_iters=15), tf, ys,
        device="cpu")
    assert rt["params"].shape == (3, 6) and rt["rmse"].shape == (3,)
    npt.assert_array_equal(rt["success"], rj["success"])
    npt.assert_allclose(rt["params"], rj["params"], atol=1e-5, rtol=0)
    npt.assert_allclose(rt["rmse"], rj["rmse"], rtol=1e-6, atol=0)


def _jax_kpt_sweep(tf, ys, K, max_iters):
    """The stepped body of ``chirpgp_tpu.apps.sweeps.mc_kpt_sweep`` on
    given measurements (the JAX package has no such entry point; this is
    its code with the data passed in)."""
    fs, Xi = 1000.0, 0.1

    def nll(theta, ys_i):
        return jk.kpt_filter(jm_g(theta), fs, Xi, ys_i,
                             num_harmonics=K)[2][-1]

    init_theta = jm_g_inv(jnp.asarray(jk.KPT_INIT_PARAMS))
    theta0 = jnp.broadcast_to(init_theta, (ys.shape[0],) + init_theta.shape)
    opt = js.lbfgs_minimize_stepped(nll, theta0, batch_args=(ys,),
                                    max_iters=max_iters, ftol_rel=1e-9,
                                    patience=10, tail_iters=30)
    opt = js._rescue_stuck_lanes(nll, init_theta, theta0, ys, opt,
                                 max_iters=max_iters)
    opt = js._polish_lanes_f64(nll, init_theta, opt, ys, max_iters=max_iters)

    def est(theta, tf_i, ys_i, success):
        params = jm_g(theta)
        if_mean, _ = jk.kpt_if_estimate(params, fs, Xi, ys_i, num_harmonics=K)
        err = jnp.sqrt(jnp.mean((tf_i - if_mean) ** 2))
        return dict(rmse=jnp.where(success, err, jnp.nan), params=params,
                    success=success)

    out = jax.jit(jax.vmap(est))(opt.params, tf, ys, opt.success)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("K,T", [(1, 60), (3, 40)])
def test_kpt_sweep_on_measurements_matches_jax(K, T):
    """The stepped KPT sweep (stepped L-BFGS, rescue, float64 polish,
    estimate) on seed 0 of each magnitude, 5 iterations.  The K=3
    objective is ill-conditioned near the init: from inputs equal to
    1e-15 the 5-iteration polish drifts apart beyond T=40 (1e-3 in params
    at T=60, with the objective and its gradient equal to 1e-15 at its
    start), so the comparison runs at T=40."""
    tf, ys = _seed0(T, "h3_" if K == 3 else "")
    rj = _jax_kpt_sweep(jnp.asarray(np.broadcast_to(tf, ys.shape)),
                        jnp.asarray(ys), K, 5)
    rt = ts._kpt_sweep_on_measurements(tf, ys, num_harmonics=K, max_iters=5,
                                       device="cpu")
    assert rt["params"].shape == (3, 5)
    npt.assert_array_equal(rt["success"], rj["success"])
    npt.assert_allclose(rt["params"], rj["params"], atol=1e-5, rtol=0)
    npt.assert_allclose(rt["rmse"], rj["rmse"], rtol=1e-6, atol=0)


def test_objectives_on_two_threads():
    """The float64 polish evaluates lanes on host threads: the harmonic
    EKF's, the continuous-discrete EKF's and the KPT EKF's objectives,
    value and gradient, on two threads at once equal each alone.
    Forward-mode AD (``torch.func.jacfwd``) is process-wide and fails
    here; the closed-form Jacobians (``jac`` of the LCD, ``drift.jac``,
    ``h.jac``) do not."""
    tf, ys = _seed0(60, "h3_")
    _, ys1 = _seed0(40)
    ekf_cfg = tp.IFEstimationConfig(method="ekfs", model="harmonic",
                                    num_harmonics=3, form="sqrt")
    cd_cfg = tp.IFEstimationConfig(method="cd_ekfs")
    theta_ekf = ekf_cfg.default_init_theta(torch.float64)
    theta_kpt = tk._kpt_init_theta(torch.tensor(ys))
    kpt_nll = tk._kpt_nll(1000.0, 0.1, 3)

    def vg(which, i):
        if which == "ekf":
            th = theta_ekf.clone().requires_grad_(True)
            value = tp.make_nll_fn(ekf_cfg, torch.tensor(ys[i]))(th)
        elif which == "cd":
            th = theta_ekf.clone().requires_grad_(True)
            value = tp.make_nll_fn(cd_cfg, torch.tensor(ys1[i]))(th)
        else:
            th = theta_kpt.clone().requires_grad_(True)
            value = kpt_nll(th, torch.tensor(ys[i]))
        grad, = torch.autograd.grad(value, th)
        return float(value.detach()), grad.numpy()

    jobs = [(w, i) for w in ("ekf", "cd", "kpt") for i in range(3)]
    alone = [vg(*job) for job in jobs]
    # Two lanes of one objective start together on the two threads.
    order = [j for j in jobs if j[1] < 2] + [j for j in jobs if j[1] == 2]
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
        together = dict(zip(order, ex.map(lambda j: vg(*j), order)))
    for job, (v, gr) in zip(jobs, alone):
        assert together[job][0] == v
        npt.assert_array_equal(together[job][1], gr)


def _nll_pair(cfg_kw):
    cj, ct = jp.IFEstimationConfig(**cfg_kw), tp.IFEstimationConfig(**cfg_kw)
    return (lambda th, y: jp.make_nll_fn(cj, y)(th),
            lambda th, y: tp.make_nll_fn(ct, y)(th))


def test_rescue_of_a_stuck_lane_matches_jax():
    """Lane 1 reports no progress from the init, so it alone is re-run by
    the per-lane SciPy L-BFGS-B; the others pass through.  The reported
    NLLs are float32, as from the float32 stepped stage on the card (the
    JAX function writes into its float64 copy of them)."""
    _, ys = _seed0(60)
    nj, nt = _nll_pair(dict(method="ekfs"))
    init = np.asarray(jp.IFEstimationConfig().default_init_theta(),
                      np.float64)
    theta0 = np.tile(init, (3, 1))
    f0 = np.asarray(jax.vmap(nj)(jnp.asarray(theta0), jnp.asarray(ys)))
    params = theta0 + np.array([[0.1], [0.0], [-0.1]])
    fun = (f0 - np.array([100.0, 0.0, 100.0])).astype(np.float32)
    iters, succ = np.array([7, 7, 7]), np.array([True, True, True])
    oj = js._rescue_stuck_lanes(
        nj, jnp.asarray(init), jnp.asarray(theta0), jnp.asarray(ys),
        JMLEResult(jnp.asarray(params), jnp.asarray(fun), jnp.asarray(iters),
                   jnp.asarray(succ)), max_iters=5)
    ot = ts._rescue_stuck_lanes(
        nt, torch.tensor(init), torch.tensor(theta0), torch.tensor(ys),
        MLEResult(torch.tensor(params), torch.tensor(fun),
                  torch.tensor(iters), torch.tensor(succ)), max_iters=5)
    npt.assert_array_equal(ot.num_iters.numpy(), np.asarray(oj.num_iters))
    assert int(ot.num_iters[1]) != 7
    npt.assert_array_equal(ot.success.numpy(), np.asarray(oj.success))
    npt.assert_allclose(ot.params.numpy(), np.asarray(oj.params), atol=1e-8,
                        rtol=0)
    assert ot.fun_val.dtype == torch.float32
    npt.assert_allclose(ot.fun_val.numpy(), np.asarray(oj.fun_val),
                        rtol=1e-6, atol=0)
    npt.assert_array_equal(ot.params.numpy()[[0, 2]], params[[0, 2]])


def test_f64_polish_never_worse():
    """The polish is a warm-started float64 L-BFGS-B: it never returns a
    lane above its incoming NLL, and two lanes on the same record from
    nearby starts reach the same optimum."""
    _, ys = _seed0(100)
    cfg = tp.IFEstimationConfig(method="ekfs")
    _, nt = _nll_pair(dict(method="ekfs"))
    yss = torch.tensor(np.stack([ys[0], ys[0]]))
    init = cfg.default_init_theta(torch.float64)
    theta0 = torch.stack([init, init + 0.05])
    with torch.no_grad():
        v0 = torch.func.vmap(nt)(theta0, yss)
    fake = MLEResult(theta0, v0, torch.zeros(2, dtype=torch.int64),
                     torch.ones(2, dtype=torch.bool))
    out = ts._polish_lanes_f64(nt, init, fake, yss, max_iters=40)
    assert bool((out.fun_val <= v0 + 1e-3).all())
    assert bool(out.success.all())
    npt.assert_allclose(float(out.fun_val[0]), float(out.fun_val[1]),
                        rtol=0.02)


def test_minimize_lanes_equals_one_scipy_run_per_lane():
    """The rescue's and the polish's driver: each lane's L-BFGS-B run, its
    evaluations batched with the other lanes', ends where SciPy ends on
    that lane alone, whatever number of evaluations each lane takes."""
    from scipy.optimize import minimize

    _, ys = _seed0(60)
    _, nt = _nll_pair(dict(method="ekfs"))
    init = tp.IFEstimationConfig().default_init_theta(torch.float64)
    yss = torch.tensor(np.stack([ys[0], ys[0][::-1].copy(), ys[0] * 0.5]))

    def scipy_alone(i, x0):
        def f_np(x):
            value, grad = batched_value_and_grad(nt, (yss[i:i + 1],))(
                torch.tensor(x)[None])
            return float(value[0]), grad[0].numpy()

        return minimize(f_np, x0, method="L-BFGS-B", jac=True,
                        options={"maxiter": 8})

    # Lane 0 starts where 8 iterations from the init end: its line
    # searches take more evaluations than the other lanes'.
    x0s = [scipy_alone(0, init.numpy()).x, init.numpy() + 0.05,
           init.numpy() - 0.05]
    got = ts._minimize_lanes(nt, yss, torch.float64, x0s, max_iters=8)
    assert len({res.nfev for res in got}) > 1
    for i, res in enumerate(got):
        want = scipy_alone(i, x0s[i])
        assert (res.nit, res.nfev, res.success) == \
            (want.nit, want.nfev, want.success)
        npt.assert_allclose(res.x, want.x, atol=1e-10, rtol=0)
        npt.assert_allclose(res.fun, want.fun, rtol=1e-12, atol=0)


def test_minimize_lanes_raises_what_the_objective_raises():
    """A failing batched evaluation ends every lane's run and is raised
    on the calling thread; nothing hangs."""
    def nll(theta, ys_i):
        raise ValueError("objective failed")

    with pytest.raises(ValueError, match="objective failed"):
        ts._minimize_lanes(nll, torch.zeros(3, 5, dtype=torch.float64),
                           torch.float64, [np.zeros(2)] * 3, max_iters=3)


def test_print_rmse_table_matches_jax(capsys):
    rng = np.random.default_rng(0)
    r = rng.uniform(0.05, 0.2, 6)
    r[2] = np.nan
    results = {"ghfs": {"const": {"rmse": r[:3]}, "damped": {"rmse": r[3:]}},
               "ekfs_harmonic_long_name": {
                   "random": {"rmse": np.full(4, np.nan)}}}
    tj = js.print_rmse_table(results)
    tt_ = ts.print_rmse_table(results)
    assert tt_ == tj
    assert capsys.readouterr().out == tj + "\n" + tj + "\n"


def test_toymodels_match_jax():
    t = np.linspace(1e-3, 0.3, 300)
    tj, tx = jnp.asarray(t), torch.tensor(t)
    for fam in (lambda m: m.meow_freq(offset=8.0),
                lambda m: m.affine_freq(2.0, 5.0),
                lambda m: m.polynomial_freq([1.0, -2.0, 3.0])):
        (fj, pj), (ft, pt) = fam(jt), fam(tt)
        npt.assert_allclose(ft(tx).numpy(), np.asarray(fj(tj)), **F64)
        npt.assert_allclose(pt(tx).numpy(), np.asarray(pj(tj)), **F64)
    phase_j, phase_t = jt.meow_freq(offset=8.0)[1], tt.meow_freq(offset=8.0)[1]
    mags = lambda m: [m.constant_mag(1.0), m.damped_exp_mag(0.3)]  # noqa: E731
    npt.assert_allclose(
        tt.gen_chirp(tx, tt.damped_exp_mag(0.3), phase_t, 0.2).numpy(),
        np.asarray(jt.gen_chirp(tj, jt.damped_exp_mag(0.3), phase_j, 0.2)),
        **F64)
    npt.assert_allclose(
        tt.gen_harmonic_chirp(tx, mags(tt), phase_t).numpy(),
        np.asarray(jt.gen_harmonic_chirp(tj, mags(jt), phase_j)), **F64)
    npt.assert_allclose(
        tt.gen_chirp_envelope(tx, tt.constant_mag(2.0), phase_t).numpy(),
        np.asarray(jt.gen_chirp_envelope(tj, jt.constant_mag(2.0), phase_j)),
        **F64)


def test_simulators_match_jax_from_its_draws():
    """``random_ou_mag`` and ``simulate_sde_init`` from JAX's own normal
    draws, in the key and split order of ``chirpgp_tpu.utils.sim``."""
    T, dt = 200, 1e-3
    key = jax.random.PRNGKey(3)
    ts_ = jnp.linspace(dt, dt * T, T)
    ou_j = jt.random_ou_mag(1.0, 1.0, key)(ts_)
    z0 = jax.random.normal(key, (1,), dtype=jnp.float64)
    dws = jax.random.normal(jax.random.split(key)[0], (T, 1),
                            dtype=jnp.float64)
    ou_t = tsim._simulate_from_noise(
        tt._ou_transition(1.0, 1.0), torch.tensor(np.asarray(z0)),
        torch.tensor(np.asarray(dws)), dt, const_diag_cov=True)[:, 0]
    npt.assert_allclose(ou_t.numpy(), np.asarray(ou_j), **F64)

    A = np.array([[0.9, 0.2], [-0.1, 0.8]])
    Q = np.array([[0.5, 0.1], [0.1, 0.3]])
    x0 = np.array([1.0, -0.5])
    traj_j = jsim.simulate_sde_init(
        lambda x, _dt: (jnp.asarray(A) @ x, jnp.asarray(Q)),
        jnp.asarray(x0), dt, T, key)
    dws = jax.random.normal(jax.random.split(key)[0], (T, 2),
                            dtype=jnp.float64)
    traj_t = tsim._simulate_from_noise(
        lambda x, _dt: (torch.tensor(A) @ x, torch.tensor(Q)),
        torch.tensor(x0), torch.tensor(np.asarray(dws)), dt)
    npt.assert_allclose(traj_t.numpy(), np.asarray(traj_j), **F64)


def test_lgssm_and_conditioned_simulators_match_jax_from_its_draws():
    """``simulate_lgssm`` and ``simulate_function_parametrised_sde`` from
    JAX's own normal draws, in the key and split order of
    ``chirpgp_tpu.utils.sim``; the port's seeded draws replay."""
    T, dt = 50, 1e-2
    key = jax.random.PRNGKey(7)
    A = np.array([[0.9, 0.2], [-0.1, 0.8]])
    Q = np.array([[0.5, 0.1], [0.1, 0.3]])
    x0 = np.array([1.0, -0.5])
    traj_j = jsim.simulate_lgssm(jnp.asarray(A), jnp.asarray(Q),
                                 jnp.asarray(x0), T, key)
    rnds = jax.random.normal(key, (T, 2), dtype=jnp.float64)
    traj_t = tsim._lgssm_from_noise(torch.tensor(A), torch.tensor(Q),
                                    torch.tensor(x0),
                                    torch.tensor(np.asarray(rnds)))
    npt.assert_allclose(traj_t.numpy(), np.asarray(traj_j), **F64)
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    npt.assert_array_equal(
        tsim.simulate_lgssm(torch.tensor(A), torch.tensor(Q),
                            torch.tensor(x0), T, gen()).numpy(),
        tsim.simulate_lgssm(torch.tensor(A), torch.tensor(Q),
                            torch.tensor(x0), T, gen()).numpy())

    vs = np.linspace(-1.0, 2.0, T)
    P0 = np.diag([0.2, 0.1])

    def mc_j(x, v, dt_):
        return jnp.asarray(A) @ x * jnp.cos(v), dt_ * jnp.asarray(Q)

    def mc_t(x, v, dt_):
        return torch.tensor(A) @ x * torch.cos(v), dt_ * torch.tensor(Q)

    traj_j = jsim.simulate_function_parametrised_sde(
        mc_j, jnp.asarray(vs), jnp.asarray(x0), jnp.asarray(P0), dt, T, key)
    z0 = jax.random.normal(key, (2,), dtype=jnp.float64)
    dws = jax.random.normal(jax.random.split(key)[0], (T, 2),
                            dtype=jnp.float64)
    start = torch.tensor(x0) + torch.linalg.cholesky(torch.tensor(P0)) \
        @ torch.tensor(np.asarray(z0))
    traj_t = tsim._conditioned_from_noise(mc_t, torch.tensor(vs), start,
                                          torch.tensor(np.asarray(dws)), dt)
    npt.assert_allclose(traj_t.numpy(), np.asarray(traj_j), **F64)
    assert tsim.simulate_function_parametrised_sde(
        mc_t, torch.tensor(vs), torch.tensor(x0), torch.tensor(P0), dt, T,
        gen()).shape == (T, 2)


def test_metric_helpers_match_jax():
    import chirpgp_tpu.utils.metrics as jmet
    import chirpgp_tpu_torch.utils.metrics as tmet
    from chirpgp_tpu.models import g_inv as j_ginv
    from chirpgp_tpu_torch.models import g_inv as t_ginv
    ys = np.linspace(0.1, 4.0, 9)
    pdf_j = jmet.fwd_transformed_pdf(
        lambda x: jnp.exp(-0.5 * x ** 2) / np.sqrt(2 * np.pi), j_ginv)
    pdf_t = tmet.fwd_transformed_pdf(
        lambda x: torch.exp(-0.5 * x ** 2) / np.sqrt(2 * np.pi), t_ginv)
    npt.assert_allclose(pdf_t(torch.tensor(ys)).numpy(),
                        np.asarray(pdf_j(jnp.asarray(ys))), **F64)
    M = np.random.default_rng(4).standard_normal((3, 3))
    a = np.zeros((5, 5))
    a[:2, :2] = np.diag([0.5, 2.0])
    a[2:, 2:] = M @ M.T + np.eye(3)
    for kw in ({}, {"lower": True}):
        npt.assert_allclose(
            tmet.chol_partial_const_diag(torch.tensor(a), 2, **kw).numpy(),
            np.asarray(jmet.chol_partial_const_diag(jnp.asarray(a), 2, **kw)),
            **F64)


@pytest.fixture
def float64_default():
    """torch's default dtype float64 for the test (the records are made in
    it, as JAX's are under x64), restored after it."""
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


def test_generate_rnd_keys_are_jax_keys():
    """``generate_rnd_keys`` is ``split(PRNGKey(999), num)`` bit for bit,
    as (num, 2) int64 words, and splits along its leading axis."""
    from chirpgp_tpu_torch.parallel import make_mesh, pad_to_multiple, \
        shard_keys
    got = ts.generate_rnd_keys(1000)
    assert got.shape == (1000, 2) and got.dtype == torch.int64
    npt.assert_array_equal(got.numpy(),
                           np.asarray(js.generate_rnd_keys(1000)))
    padded, n = pad_to_multiple(got[:7], 4)
    assert n == 7 and padded.shape == (8, 2)
    npt.assert_array_equal(padded[7].numpy(), got[6].numpy())
    npt.assert_array_equal(shard_keys(got[:8], make_mesh(device="cpu")
                                      ).numpy(), got[:8].numpy())


def test_port_draws_replay_and_split(float64_default):
    """The port's records of JAX's keys: a key makes the same record twice,
    another key another record, and each equals the JAX package's
    ``toymodel_measurements`` of that key in float64 (1e-10): the key's
    first split drives the noise, its second the OU magnitude."""
    ts_ = torch.linspace(1e-3, 0.5, 500, dtype=torch.float64)
    ou = tt.random_ou_mag(1.0, 1.0, torch.Generator().manual_seed(5))
    npt.assert_array_equal(ou(ts_).numpy(), ou(ts_).numpy())
    keys = ts.generate_rnd_keys(3)
    kw = dict(T=300, device="cpu")
    _, _, yc = ts.toymodel_measurements(keys[0], "const", **kw)
    _, _, yc2 = ts.toymodel_measurements(keys[0], "const", **kw)
    _, _, y1 = ts.toymodel_measurements(keys[1], "const", **kw)
    npt.assert_array_equal(yc.numpy(), yc2.numpy())
    assert not np.allclose(yc.numpy(), y1.numpy())
    jkeys = js.generate_rnd_keys(3)
    for mag in ts.MAGNITUDES:
        got = ts.toymodel_measurements(keys[0], mag, **kw)
        want = js.toymodel_measurements(jkeys[0], mag, T=300)
        assert all(x.dtype == torch.float64 for x in got)
        for a, b in zip(got, want):
            npt.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="JAX keys"):
        ts.toymodel_measurements(torch.arange(3), "const", **kw)


def test_mc_mle_sweep_matches_jax(float64_default):
    """``mc_mle_sweep`` (sqrt GHFS, 2 seeds, T=40, 3 iterations) on the
    JAX package's keys against the JAX package's ``mc_mle_sweep`` on the
    same keys: the same ``success``, params 1e-5, rmse 1e-6 relative."""
    cfg_kw = dict(method="ghfs", form="sqrt", max_iters=3)
    rj = js.mc_mle_sweep(jp.IFEstimationConfig(**cfg_kw),
                         js.generate_rnd_keys(2), "random", T=40)
    rt = ts.mc_mle_sweep(tp.IFEstimationConfig(**cfg_kw),
                         ts.generate_rnd_keys(2), "random", T=40,
                         device="cpu")
    assert rt["params"].shape == (2, 6) and rt["rmse"].shape == (2,)
    npt.assert_array_equal(rt["success"], rj["success"])
    npt.assert_allclose(rt["params"], rj["params"], atol=1e-5, rtol=0)
    npt.assert_allclose(rt["rmse"], rj["rmse"], rtol=1e-6, atol=0)


def test_mc_kpt_sweep_matches_jax(float64_default):
    """``mc_kpt_sweep`` (the stepped sweep, 2 seeds, T=40, 5 iterations) on
    the JAX package's keys against the JAX package's on the same keys:
    the same ``success``, params 1e-5, rmse 1e-6 relative."""
    rj = js.mc_kpt_sweep(js.generate_rnd_keys(2), "damped", T=40,
                         max_iters=5)
    rt = ts.mc_kpt_sweep(ts.generate_rnd_keys(2), "damped", T=40,
                         max_iters=5, device="cpu")
    assert rt["params"].shape == (2, 5) and rt["rmse"].shape == (2,)
    npt.assert_array_equal(rt["success"], rj["success"])
    npt.assert_allclose(rt["params"], rj["params"], atol=1e-5, rtol=0)
    npt.assert_allclose(rt["rmse"], rj["rmse"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("cfg_kw", [dict(method="ghfs", form="sqrt"),
                                    dict(method="ghfs"), dict(method="ekfs")],
                         ids=["ghfs-sqrt", "ghfs-cov", "ekfs-cov"])
def test_vmapped_objective_twice_matches_each_lane(cfg_kw):
    """Two vmapped value-and-grads in a row at different theta: each lane
    equals ``make_nll_fn`` on that lane alone (the LCD constants cached in
    one call do not leak into the next).  In the second call lane 1's P0
    is singular (delta = softplus(-800) = 0): the square-root filter's
    Cholesky gives that lane NaN, as JAX's does, without raising for the
    batch; the covariance form factors it like any other."""
    _, ys = _seed0(30)
    cfg = tp.IFEstimationConfig(**cfg_kw)
    _, nt = _nll_pair(cfg_kw)
    yss = torch.tensor(ys)
    vg = batched_value_and_grad(nt, (yss,))
    base = cfg.default_init_theta(torch.float64)
    for shift in (0.0, 0.3):
        theta = base + shift + 0.05 * torch.arange(3.0, dtype=torch.float64
                                                   )[:, None]
        if shift:
            theta[1, 2] = -800.0
        values, grads = vg(theta)
        if shift and cfg.form == "sqrt":
            assert torch.isnan(values[1])
            assert bool(torch.isfinite(values[[0, 2]]).all())
        for i in range(3):
            th = theta[i].clone().requires_grad_(True)
            v = tp.make_nll_fn(cfg, yss[i])(th)
            if not torch.isfinite(v):
                assert torch.isnan(values[i])
                continue
            gr, = torch.autograd.grad(v, th)
            npt.assert_allclose(float(values[i]), float(v.detach()),
                                rtol=1e-12)
            npt.assert_allclose(grads[i].numpy(), gr.numpy(), rtol=0,
                                atol=1e-12 * float(gr.abs().max()))


def test_lcd_closed_form_jacobian_matches_jacfwd():
    from chirpgp_tpu_torch.models import disc_chirp_lcd
    trans = disc_chirp_lcd(*torch.tensor([0.3, 0.2, 1.5, 0.7],
                                         dtype=torch.float64))
    u = torch.tensor(np.random.default_rng(1).standard_normal((5, 4)))
    auto = torch.func.vmap(torch.func.jacfwd(lambda x: trans.mean(x, 1e-3)))(u)
    npt.assert_allclose(trans.jac(u, 1e-3).numpy(), auto.numpy(), **F64)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_host_data_goes_to_the_card_unless_cpu_is_asked():
    """NumPy data go to ``device``, the card by default: without one they
    raise instead of running on the CPU; ``device="cpu"`` runs here."""
    tf, ys = _seed0(20)
    cfg = tp.IFEstimationConfig(max_iters=1)
    params = np.asarray(g(cfg.default_init_theta(torch.float64)))
    calls = [(tp.estimate_if, (cfg, params, ys[0])),
             (tp.estimate_if_batched, (cfg, params, ys)),
             (tp.fit_mle, (cfg, ys[0])),
             (tp.run_pipeline, (cfg, ys[0])),
             (ts.mle_sweep_on_measurements, (cfg, tf, ys)),
             (tk.kpt_if_estimate, (tk.KPT_INIT_PARAMS, 1000.0, 0.1, ys[0])),
             (tk.kpt_mle, (1000.0, 0.1, ys[0])),
             (ts._kpt_sweep_on_measurements, (tf, ys))]
    for fn, args in calls:
        with pytest.raises((AssertionError, RuntimeError)):
            fn(*args)
    est = tp.estimate_if(cfg, params, ys[0], device="cpu")
    assert est["if_mean"].device.type == "cpu"
    # A mesh's device is the card unless the caller asks for the CPU; the
    # sharded sweeps run there, whatever ``device`` says.
    from chirpgp_tpu_torch.parallel import make_mesh
    for fn, kwargs in ((ts.mc_mle_sweep, dict(cfg=cfg)),
                       (ts.mc_kpt_sweep, dict(stepped=False))):
        with pytest.raises((AssertionError, RuntimeError)):
            fn(keys=ts.generate_rnd_keys(1), mag_name="const", T=20,
               mesh=make_mesh(), device="cpu", **kwargs)


def test_mc_sweeps_run_on_port_draws():
    """The key-driven sweeps on the JAX package's records of its keys,
    float32 as torch's default dtype makes them: the batched
    ``lbfgs_minimize`` sweep and the stepped one, finite and of the
    documented shapes."""
    cfg = tp.IFEstimationConfig(method="ekfs", max_iters=3)
    keys = ts.generate_rnd_keys(2)
    for sweep in (ts.mc_mle_sweep, ts.mc_mle_sweep_stepped):
        res = sweep(cfg, keys, "random", T=40, device="cpu")
        assert res["params"].shape == (2, 6) and res["rmse"].shape == (2,)
        assert np.all(np.isfinite(res["params"]))
        assert res["success"].dtype == bool


@pytest.mark.parametrize("stepped", [True, False], ids=["stepped", "batched"])
def test_mc_kpt_sweep_runs_on_port_draws(stepped):
    """``mc_kpt_sweep`` on the JAX package's records of its keys (float32),
    K=3: finite, of the
    documented shapes; the batched form's lanes equal ``kpt_mle`` on each
    record alone (each lane stops on its own rule)."""
    keys = ts.generate_rnd_keys(2)
    res = ts.mc_kpt_sweep(keys, "damped", T=40, num_harmonics=3, max_iters=3,
                          stepped=stepped, device="cpu")
    assert res["params"].shape == (2, 5) and res["rmse"].shape == (2,)
    assert np.all(np.isfinite(res["params"])) and res["success"].dtype == bool
    if not stepped:
        _, _, y0 = ts.toymodel_measurements(keys[0], "damped", T=40,
                                            num_harmonics=3, device="cpu")
        alone = tk.kpt_mle(1000.0, 0.1, y0, num_harmonics=3, max_iters=3)
        npt.assert_allclose(res["params"][0], g(alone.params).numpy(),
                            rtol=1e-6)
