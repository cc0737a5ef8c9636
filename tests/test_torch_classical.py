"""PyTorch port vs the JAX package: the classical baselines
(``baselines/classical.py``: Hilbert transform, spectrogram, polynomial
MLE, adaptive notch filter) and the Gauss--Newton / Levenberg--Marquardt
solvers (``fit/gauss_newton.py``), in float64.

The known-answer cases of ``tests/test_classical.py`` and
``tests/test_gauss_newton.py`` are ported with NumPy draws.  Parity with
the JAX package on the same NumPy inputs: the Hilbert IF and the ANF
1e-9, the spectrogram 1e-12, the solvers' params 1e-9 with equal
per-lane ``num_iters`` and ``obj_trace`` (NaN padding included) to 1e-9
relative.  The Table-I columns' seed-0 values are held to
``results/reference/*_const.npz`` on the record the reference used: the
float64 draw of ``toydata_const.npz``'s key 0, made here with the JAX
package (``toydata_*`` hold float32 draws of the same keys, a different
noise realization)."""

import importlib
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import scipy.signal
import torch

import chirpgp_tpu.baselines.classical as jc
import chirpgp_tpu_torch.baselines as tb
import chirpgp_tpu_torch.baselines.classical as tc
from chirpgp_tpu_torch.toymodels import (
    gen_chirp, gen_chirp_envelope, constant_mag, affine_freq,
    polynomial_freq, meow_freq)

# The packages' ``fit`` export functions named like the module.
jg = importlib.import_module("chirpgp_tpu.fit.gauss_newton")
tg = importlib.import_module("chirpgp_tpu_torch.fit.gauss_newton")

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DT, XI = 1e-3, 0.1


def _np(x):
    return x.detach().cpu().numpy()


def _ts(T):
    return torch.linspace(DT, DT * T, T, dtype=torch.float64)


def _noise(shape, seed):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape))


# ---------------------------------------------------------------------------
# Ports of tests/test_classical.py
# ---------------------------------------------------------------------------

def test_hilbert_matches_scipy():
    ys = _noise(512, 0)
    npt.assert_allclose(_np(tc.hilbert_transform(ys)),
                        scipy.signal.hilbert(ys.numpy()), atol=1e-10)
    yss = _noise((3, 511), 1)
    npt.assert_allclose(_np(tc.hilbert_transform(yss)),
                        scipy.signal.hilbert(yss.numpy()), atol=1e-10)


def test_hilbert_method_pure_tone():
    ts = _ts(2000)
    _, phase = affine_freq(0.0, 20.0)
    est = tc.hilbert_method(ts, gen_chirp(ts, constant_mag(1.0), phase))
    npt.assert_allclose(_np(est[200:-200]), 20.0, rtol=1e-2)


def test_tukey_matches_scipy():
    npt.assert_allclose(_np(tc.tukey_window(256, 0.25)),
                        scipy.signal.windows.tukey(256, 0.25), atol=1e-12)
    npt.assert_allclose(_np(tc.cosine_window(450)),
                        scipy.signal.windows.cosine(450), atol=1e-12)


def test_spectrogram_matches_scipy_firstmoment():
    ts = _ts(4000)
    _, phase = affine_freq(20.0, 30.0)
    ys = gen_chirp(ts, constant_mag(1.0), phase) + 0.1 * _noise(4000, 1)
    _, est = tc.mean_power_spectrum(ts, ys)
    freqs_s, _, Sxx = scipy.signal.spectrogram(ys.numpy(), 1000.0)
    est_s = np.sum(freqs_s[:, None] * Sxx, axis=0) / np.sum(Sxx, axis=0)
    assert est.shape == est_s.shape
    npt.assert_allclose(_np(est), est_s, rtol=1e-3)


def test_spectrogram_tracks_affine_chirp():
    ts = _ts(4000)
    freq, phase = affine_freq(20.0, 30.0)
    new_ts, est = tc.mean_power_spectrum(
        ts, gen_chirp(ts, constant_mag(1.0), phase))
    npt.assert_allclose(_np(est), _np(freq(new_ts)), rtol=0.1)


def test_mle_polynomial_recovers_coeffs():
    ts = _ts(1000)
    _, phase = polynomial_freq([10.0, 4.0])
    ys = gen_chirp(ts, constant_mag(1.0), phase)
    params, obj_vals = tc.mle_polynomial(
        ts, ys, 0.01, torch.tensor([1.1, 9.5, 4.3], dtype=torch.float64),
        method="levenberg_marquardt")
    npt.assert_allclose(float(params[0]), 1.0, rtol=1e-2)
    npt.assert_allclose(_np(params[1:]), [10.0, 4.0], rtol=1e-2)
    assert obj_vals.dim() == 1 and bool(torch.isfinite(obj_vals).all())


def test_anf_tracks_affine_if():
    ts = _ts(3000)
    freq, phase = affine_freq(10.0, 20.0)
    ys = gen_chirp_envelope(ts, constant_mag(1.0), phase)
    mu = 0.015
    gamma_w = mu ** 2 / 2
    est, _, _ = tc.adaptive_notch_filter(ts, ys, 0.0, 20.0, 0.1 + 0.0j, mu,
                                         mu * gamma_w / 4, gamma_w)
    npt.assert_allclose(_np(est[1500:]), _np(freq(ts)[1500:]), rtol=0.05)


# ---------------------------------------------------------------------------
# unwrap
# ---------------------------------------------------------------------------

def test_unwrap_matches_numpy():
    rng = np.random.default_rng(4)
    cases = [
        np.cumsum(rng.uniform(-4.0, 4.0, (3, 200)), axis=-1),
        # Jumps of exactly pi, both signs, and of exactly 2 pi.
        np.cumsum(np.array([0.0, np.pi, -np.pi, np.pi, 2 * np.pi, 0.5,
                            -np.pi, -2 * np.pi, 3 * np.pi, np.pi])),
        np.array([0.0, np.pi, 0.0, -np.pi, 0.0]),
        np.angle(np.exp(1j * np.linspace(0.0, 40.0, 300))),
        np.zeros(1),
    ]
    for p in cases:
        # Equal but for the order of the running sum's additions.
        npt.assert_allclose(_np(tc.unwrap(torch.tensor(p))), np.unwrap(p),
                            atol=1e-12, rtol=0)
    # Exact on jumps of pi: the sign rule, not a rounding, decides them.
    p = np.array([0.0, np.pi, 0.0, -np.pi, 0.0, np.pi, 2 * np.pi])
    npt.assert_array_equal(_np(tc.unwrap(torch.tensor(p))), np.unwrap(p))


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

def _meow_records(T, n, seed):
    ts = _ts(T)
    _, phase = meow_freq(offset=8.0)
    return ts, gen_chirp(ts, constant_mag(1.0), phase) \
        + math.sqrt(XI) * _noise((n, T), seed)


def test_hilbert_and_spectrogram_match_jax():
    ts, ys = _meow_records(1200, 2, 5)
    yf = tb.butter_lowpass(ys, 18.0, 1000.0)
    for i in range(2):
        yj = jc.butter_lowpass(jnp.asarray(ys[i].numpy()), 18.0, 1000.0)
        npt.assert_allclose(_np(yf[i]), np.asarray(yj), atol=1e-13, rtol=0)
        npt.assert_allclose(_np(tc.hilbert_method(ts, yf)[i]), np.asarray(
            jc.hilbert_method(jnp.asarray(ts.numpy()), yj)), atol=1e-9,
            rtol=0)
        for kw in (dict(), dict(nperseg=450, noverlap=449, window="cosine")):
            tt, et = tc.mean_power_spectrum(ts, yf, **kw)
            tj, ej = jc.mean_power_spectrum(jnp.asarray(ts.numpy()), yj, **kw)
            npt.assert_allclose(_np(tt), np.asarray(tj), atol=1e-12, rtol=0)
            npt.assert_allclose(_np(et[i]), np.asarray(ej), atol=1e-12,
                                rtol=0)


@pytest.mark.parametrize("form", ["complex", "pairs"])
def test_adaptive_notch_filter_matches_jax(form):
    ts = _ts(800)
    _, phase = meow_freq(offset=8.0)
    env = gen_chirp_envelope(ts, constant_mag(1.0), phase) \
        + math.sqrt(XI) * _noise((2, 800), 6)
    ys = env if form == "complex" else torch.stack([env.real, env.imag], -1)
    mu = 0.015
    args = (0.0, 8.0, 1.0 + 0.0j, mu, mu ** 3 / 8, mu ** 2 / 2)
    out_t = tc.adaptive_notch_filter(ts, ys, *args)
    for i in range(2):
        out_j = jc.adaptive_notch_filter(jnp.asarray(ts.numpy()),
                                         jnp.asarray(ys[i].numpy()), *args)
        assert out_t[2].is_complex() == (form == "complex")
        for a, b in zip(out_j, out_t):
            npt.assert_allclose(_np(b[i]), np.asarray(a), atol=1e-9, rtol=0)


def _quadratic_problem(n=4, seed=666):
    """The JAX package's quadratic regression problem on ``n`` records."""
    xs = torch.linspace(0.0, 1.0, 100, dtype=torch.float64)
    true = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)

    def f(p):
        return p[0] + p[1] * xs + p[2] * xs ** 2

    def fj(p):
        x = jnp.asarray(xs.numpy())
        return p[0] + p[1] * x + p[2] * x ** 2

    ys = f(true) + 0.01 * _noise((n, 100), seed)
    return f, fj, ys, true


def _decay_problem(n=4, seed=667):
    """A nonlinear one, ``a exp(-k x) + c``, where the lanes take different
    numbers of steps."""
    xs = torch.linspace(0.0, 3.0, 100, dtype=torch.float64)
    true = torch.tensor([2.0, 1.5, 0.5], dtype=torch.float64)

    def f(p):
        return p[0] * torch.exp(-p[1] * xs) + p[2]

    def fj(p):
        return p[0] * jnp.exp(-p[1] * jnp.asarray(xs.numpy())) + p[2]

    ys = f(true) + 0.01 * _noise((n, 100), seed)
    return f, fj, ys, true


def _assert_nls_equal(rt, rj, P):
    npt.assert_array_equal(_np(rt.num_iters), np.asarray(rj.num_iters))
    npt.assert_array_equal(_np(rt.converged), np.asarray(rj.converged))
    npt.assert_allclose(_np(rt.params), np.asarray(rj.params), atol=1e-9,
                        rtol=0)
    tj, tt = np.asarray(rj.obj_trace), _np(rt.obj_trace)
    npt.assert_array_equal(np.isnan(tt), np.isnan(tj))
    npt.assert_allclose(tt, tj, rtol=1e-9, atol=0)
    assert rt.params.shape[-1] == P


@pytest.mark.parametrize("solver", ["gauss_newton_while",
                                    "levenberg_marquardt_while"])
def test_nls_solvers_over_lanes_match_vmapped_jax(solver):
    """Lanes with different inits and data stop at different iterations;
    each equals the JAX package's vmapped while_loop."""
    f, fj, ys, true = _decay_problem()
    inits = torch.tensor([[1.5, 1.0, 0.0], [2.0, 1.5, 0.5], [3.0, 2.5, 1.0],
                          [1.0, 0.8, 0.2]], dtype=torch.float64)
    rt = getattr(tg, solver)(f, inits, ys, 1.0, max_iters=30)
    rj = jax.jit(jax.vmap(lambda p0, y: getattr(jg, solver)(
        fj, p0, y, 1.0, max_iters=30)))(jnp.asarray(inits.numpy()),
                                        jnp.asarray(ys.numpy()))
    assert len(set(_np(rt.num_iters).tolist())) > 1
    _assert_nls_equal(rt, rj, 3)
    npt.assert_allclose(_np(rt.params), _np(true.expand(4, -1)), rtol=5e-2)


def test_nls_host_wrappers_match_jax():
    f, fj, ys, _ = _quadratic_problem(1)
    for name, init in (("gauss_newton", [0.5, 1.5, 2.5]),
                       ("levenberg_marquardt", [0.0, 0.0, 0.0])):
        pt, trace_t = getattr(tg, name)(f, torch.tensor(init), ys[0], 1.0)
        pj, trace_j = getattr(jg, name)(fj, jnp.asarray(init),
                                        jnp.asarray(ys[0].numpy()), 1.0)
        npt.assert_allclose(_np(pt), np.asarray(pj), atol=1e-9, rtol=0)
        npt.assert_allclose(_np(trace_t), np.asarray(trace_j), rtol=1e-9)
    # LM's trajectory never rises (a rejected step keeps the objective).
    assert bool((torch.diff(trace_t) <= 1e-9).all())


def _poly_case(T):
    """Three records of a degree-2 polynomial-IF chirp with noise, and
    inits off the truth."""
    ts = _ts(T)
    _, phase = polynomial_freq([10.0, 4.0, 3.0])
    ys = gen_chirp(ts, constant_mag(1.0), phase) + 0.1 * _noise((3, T), 7)
    inits = torch.tensor([[1.1, 9.5, 4.3, 2.5], [0.9, 10.4, 3.5, 3.3],
                          [1.0, 10.0, 4.0, 3.0]], dtype=torch.float64)
    return ts, ys, inits


@pytest.mark.parametrize("method", ["levenberg_marquardt", "gauss_newton"])
def test_mle_polynomial_batched_matches_jax(method):
    ts, ys, inits = _poly_case(300)
    rt = tc.mle_polynomial_batched(ts, ys, 0.01, inits, method=method,
                                   max_iters=20)
    rj = jc.mle_polynomial_batched(jnp.asarray(ts.numpy()),
                                   jnp.asarray(ys.numpy()), 0.01,
                                   jnp.asarray(inits.numpy()), method=method,
                                   max_iters=20)
    _assert_nls_equal(rt, rj, 4)


def test_mle_polynomial_matches_jax():
    ts, ys, inits = _poly_case(300)
    tsj, yj, ij = (jnp.asarray(x.numpy()) for x in (ts, ys[0], inits[0]))
    for method in ("gauss_newton", "levenberg_marquardt", "L-BFGS-B"):
        pt, vt = tc.mle_polynomial(ts, ys[0], 0.01, inits[0], method=method)
        pj, vj = jc.mle_polynomial(tsj, yj, 0.01, ij, method=method)
        tol = 1e-9 if method != "L-BFGS-B" else 1e-6
        npt.assert_allclose(_np(pt), np.asarray(pj), atol=tol, rtol=0)
        npt.assert_allclose(_np(vt), np.asarray(vj), rtol=tol)
    with pytest.raises(ValueError, match="does not exist"):
        tc.mle_polynomial(ts, ys[0], 0.01, inits[0], method="newton")


# ---------------------------------------------------------------------------
# Table I, seed 0, on the reference's record
# ---------------------------------------------------------------------------

def _reference_seed0():
    """Seed 0's const-magnitude record of Table I's classical columns (the
    float64 draw of key 0, made with the JAX package), its complex envelope
    with the same noise, the times and the true IF."""
    from chirpgp_tpu.apps.sweeps import toymodel_measurements
    key = jnp.asarray(np.load(ROOT / "results/data/toydata_const.npz")
                      ["keys"][0])
    ts_j, tf, ys = toymodel_measurements(key, "const")
    noise = jax.random.normal(jax.random.split(key)[0], (3141,))
    ts = torch.tensor(np.asarray(ts_j))
    _, phase = meow_freq(offset=8.0)
    env = gen_chirp_envelope(ts, constant_mag(1.0), phase) \
        + math.sqrt(XI) * torch.tensor(np.asarray(noise))
    return ts, torch.tensor(np.asarray(ys)), env, torch.tensor(np.asarray(tf))


def _ref(name):
    return np.load(ROOT / f"results/reference/{name}_const.npz")["rmse"][0]


def test_seed0_columns_match_the_reference():
    ts, ys, env, tf = _reference_seed0()
    freq, _ = meow_freq(offset=8.0)
    yf = tb.butter_lowpass(ys, 18.0, 1000.0)
    est = tc.hilbert_method(ts, yf)
    hil = float(torch.sqrt(((est - tf[1:]) ** 2).mean()))
    npt.assert_allclose(hil, _ref("hilbert"), rtol=1e-6)
    new_ts, est = tc.mean_power_spectrum(ts, yf, nperseg=450, noverlap=449,
                                         window="cosine")
    spec = float(torch.sqrt(((est - freq(new_ts)) ** 2).mean()))
    # The JAX package's column; the reference's own spectrogram differs
    # from both by 0.3% here (up to 2% over the 100 seeds).
    npt.assert_allclose(spec, np.load(ROOT / "results/spectrogram_const.npz")
                        ["rmse"][0], rtol=1e-6)
    npt.assert_allclose(spec, _ref("spectrogram"), rtol=0.01)
    mu = 0.015
    est, _, _ = tc.adaptive_notch_filter(ts, env, 0.0, float(freq(ts[:1])[0]),
                                         1.0 + 0.0j, mu, mu ** 3 / 8,
                                         mu ** 2 / 2)
    anf = float(torch.sqrt(((est - tf) ** 2).mean()))
    npt.assert_allclose(anf, _ref("anf"), rtol=1e-9)


def test_chip_smoke_replays_the_jax_draws():
    """``chip_smoke.py`` phase 9d makes the reference's records on the card
    machine, without JAX, from ``toydata``'s keys, through the package's
    NumPy Threefry (``utils/jax_keys.py``; the script keeps no copy of
    its own): its split and float64 normal draw against the JAX
    package's."""
    from chirpgp_tpu_torch.utils.jax_keys import jax_normal, split
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert not hasattr(smoke, "threefry2x32")
    assert "from chirpgp_tpu_torch.utils.jax_keys import" in \
        (ROOT / "chip_smoke.py").read_text()
    keys = np.load(ROOT / "results/data/toydata_const.npz")["keys"][:4]
    for key in keys:
        keys_j = np.asarray(jax.random.split(jnp.asarray(key)))
        npt.assert_array_equal(split(key), keys_j)
        npt.assert_allclose(jax_normal(keys_j[0], 3141),
                            np.asarray(jax.random.normal(
                                jnp.asarray(keys_j[0]), (3141,))),
                            atol=1e-11, rtol=0)


def test_demo_poly_lm_float32_is_decided_by_round_off():
    """The classical demo's float32 polynomial LM (``demos/
    classical_methods.py --method poly``: a 7th-order fit of the
    spectrogram's first moment as the init) on the ``PRNGKey(555)``
    record.  It prints 41.7401 on the host CPU, and 70.3604 on the card
    every time.  The fit is flat: moving each moment by float32's machine
    epsilon (one or two ulps), as another FFT's round-off does, spreads
    the IF RMSE over more than 10 Hz in six tries while the final
    objective stays within 1e-4 of itself.  So the card's value is its
    round-off's, not a fault (ROADMAP Queue 3)."""
    from chirpgp_tpu_torch.experiments.print_time import toy_record
    ts, ys = toy_record(3141, DT, XI, dtype=torch.float32)
    true_if = meow_freq(offset=8.0)[0](ts)
    new_ts, rough = tc.mean_power_spectrum(ts, ys)
    rough = _np(rough)

    def fit(moment):
        coeffs = np.polyfit(_np(new_ts), moment, 7)
        init = torch.as_tensor(np.concatenate([[1.0], coeffs[::-1]]),
                               dtype=torch.float32)
        params, traj = tb.mle_polynomial(ts, ys, XI, init)
        poly_if, _ = polynomial_freq(list(_np(params[1:])))
        rmse = float(torch.sqrt(torch.mean((true_if - poly_if(ts)) ** 2)))
        return rmse, float(traj[-1])

    rmse, obj = fit(rough)
    npt.assert_allclose(rmse, 41.7401, atol=5e-4)
    eps = np.finfo(np.float32).eps
    rng = np.random.default_rng(0)
    moved = [fit(rough * (1 + rng.choice([-1, 1], rough.shape)
                          .astype(np.float32) * eps)) for _ in range(6)]
    rmses = [r for r, _ in moved]
    assert max(rmses) - min(rmses) > 10.0, rmses
    assert all(abs(o - obj) <= 1e-4 * obj for _, o in moved)
