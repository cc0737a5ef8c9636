"""The port's paper figures (``chirpgp_tpu_torch/experiments/plots.py``)
against the JAX library calls that the JAX package's
``experiments/plots.py`` makes, on the same keys, at a small size on the
CPU: each ``<figure>_arrays`` function in float64 (sample paths T=200, the
covariance surface 20x20, the conditional covariance 30 points and 50
paths, the estimation records T=300), the ``crlb*`` arrays against the
committed files, the float32 estimation against JAX without x64, and the
two drivers' PNG files.

Tolerances, of each array's largest magnitude: the sample paths and the
two covariance surfaces 1e-10; the IF mean and band 1e-8 (float64); the
float32 IF 1e-4.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from chirpgp_tpu_torch.experiments import plots

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EST_T = 300


@pytest.fixture(autouse=True)
def _float64():
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


def _close(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    npt.assert_allclose(got, want, rtol=0,
                        atol=tol * float(np.max(np.abs(want))))


def test_samples_match_jax():
    from chirpgp_tpu.models import disc_chirp_lcd, g, model_chirp
    from chirpgp_tpu.utils import simulate_sde
    T, dt = 200, 1e-3
    got = plots.samples_arrays(T=T, dt=dt, device="cpu")
    lam, b, ell, sigma, delta = plots.SAMPLES_PRIOR
    _, _, m0, P0, _ = model_chirp(lam, b, ell, sigma, delta)
    trans = disc_chirp_lcd(lam, b, ell, sigma)
    trajs = [simulate_sde(trans, m0, P0, dt, T, k)
             for k in jax.random.split(jax.random.PRNGKey(0), 4)]
    npt.assert_array_equal(got["ts"], np.arange(1, T + 1) * dt)
    _close(got["x2"], np.stack([t[:, 1] for t in trajs]), 1e-10)
    _close(got["if"], np.stack([g(t[:, 2]) for t in trajs]), 1e-10)


def test_cov_matches_jax():
    from chirpgp_tpu.models.cov_funcs import vmap_cov_harmonic_sde
    got = plots.cov_arrays(n=20, device="cpu")
    ts = jnp.linspace(0.01, 2.0, 20)
    npt.assert_array_equal(got["ts"], np.asarray(ts))
    _close(got["surf"], vmap_cov_harmonic_sde(ts, ts, 0.1 * jnp.eye(2),
                                              *plots.COV_ARGS), 1e-10)


def test_cond_cov_matches_jax():
    from chirpgp_tpu.models.cov_funcs import approx_cond_cov_chirp_sde
    got = plots.cond_cov_arrays(n=30, num_mcs=50, device="cpu")
    ts = jnp.linspace(0.01, 1.0, 30)
    vs, surf = approx_cond_cov_chirp_sde(ts, *plots.COND_COV_PRIOR,
                                         num_mcs=50,
                                         key=jax.random.PRNGKey(1))
    # jax_linspace parts from jnp.linspace by one ulp at one of these 30
    # points (bit for bit at the script's 100).
    _close(got["ts"], ts, 1e-15)
    _close(got["vs"], vs, 1e-10)
    _close(got["surf"], surf, 1e-10)


def _jax_estimation(K):
    """The JAX script's estimation figure (``K=1``) or its harmonic one,
    at T=EST_T: (if_mean, if_lower, if_upper, true_if)."""
    import math
    from chirpgp_tpu.apps import IFEstimationConfig, estimate_if
    from chirpgp_tpu.models import g
    from chirpgp_tpu.toymodels import (
        constant_mag, gen_chirp, gen_harmonic_chirp, meow_freq)
    dt, Xi = 1e-3, 0.1
    ts = jnp.linspace(dt, dt * EST_T, EST_T)
    freq, phase = meow_freq(offset=8.0)
    noise = math.sqrt(Xi) * jax.random.normal(jax.random.PRNGKey(555),
                                              (EST_T,))
    if K == 1:
        ys = gen_chirp(ts, constant_mag(1.0), phase) + noise
        cfg = IFEstimationConfig(dt=dt, Xi=Xi, method="ghfs")
    else:
        ys = gen_harmonic_chirp(ts, [constant_mag(1.0 / (k + 1))
                                     for k in range(K)], phase) + noise
        cfg = IFEstimationConfig(dt=dt, Xi=Xi, method="ghfs",
                                 model="harmonic", num_harmonics=K,
                                 quadrature="cubature")
    est = estimate_if(cfg, g(cfg.default_init_theta()), ys)
    return [np.asarray(est[k]) for k in ("if_mean", "if_lower",
                                         "if_upper")] + [freq(ts)]


@pytest.mark.parametrize("K", [1, 3], ids=["estimation",
                                            "estimation_harmonic"])
def test_estimation_matches_jax(K):
    got = plots.estimation_arrays(T=EST_T, device="cpu") if K == 1 else \
        plots.estimation_harmonic_arrays(T=EST_T, K=K, device="cpu")
    *want, true_if = _jax_estimation(K)
    _close(got["true_if"], true_if, 1e-12)
    for name, w in zip(("if_mean", "if_lower", "if_upper"), want):
        _close(got[name], w, 1e-8)


_JAX_F32 = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[2])
import tests.test_torch_plots as t
np.save(sys.argv[1], np.stack(t._jax_estimation(1)[:3]))
"""


def test_estimation_float32_matches_jax_without_x64(tmp_path):
    """The figure as both scripts run it, float32: the JAX calls in a child
    without x64 against the port's float32 arrays, 1e-4 of max |IF|."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="0")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_F32, str(tmp_path / "jax.npy"),
         str(ROOT)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    torch.set_default_dtype(torch.float32)
    got = plots.estimation_arrays(T=EST_T, device="cpu")
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    want = np.load(tmp_path / "jax.npy")
    assert want.dtype == np.float32
    for name, w in zip(("if_mean", "if_lower", "if_upper"), want):
        assert got[name].dtype == np.float32
        _close(got[name], w, 1e-4)


@pytest.mark.parametrize("name,methods", [
    ("crlb", ("ekf",)), ("crlb_ghf", ("ghf",)), ("crlb_ekf", ("ekf",)),
    ("crlb_both", ("ghf", "ekf"))])
def test_crlb_arrays_are_the_committed_files(name, methods):
    got = plots.PLOTS[name][0]("cpu", EST_T, str(ROOT / "results"))
    lams = bs = (0.1, 0.4, 0.7, 1.0)
    npt.assert_array_equal(got["lams"], lams)
    npt.assert_array_equal(got["bs"], bs)
    for method in methods:
        for lam in lams:
            for b in bs:
                d = np.load(ROOT / f"results/crlb_{method}_lam{lam}_b{b}.npz")
                cell = f"{method}_lam{lam}_b{b}"
                npt.assert_array_equal(got[f"{cell}_mean_err_v"],
                                       d["mean_err_v"])
                npt.assert_array_equal(got[f"{cell}_ts"],
                                       np.arange(1, 501) * float(d["dt"]))
                if "pcrlb_v" in d:
                    npt.assert_array_equal(got[f"{cell}_pcrlb_v"],
                                           d["pcrlb_v"])
                else:
                    assert f"{cell}_pcrlb_v" not in got
    assert plots.crlb_arrays(methods, str(ROOT / "results/data")) is None


def test_drivers_write_the_same_files(tmp_path):
    """``experiments/plots.py --which cov samples`` (JAX) and the port's
    driver write the same PNG files; the port's ``--save-arrays`` writes
    one ``.npz`` per figure, and ``--from-arrays`` draws them."""
    which = ["--which", "cov", "samples"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "experiments/plots.py"), *which,
         "--out", str(tmp_path / "jax")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    plots.main([*which, "--out", str(tmp_path / "port"), "--device", "cpu"])
    plots.main([*which, "--save-arrays", str(tmp_path / "arrays"),
                "--device", "cpu"])
    plots.main([*which, "--from-arrays", str(tmp_path / "arrays"), "--out",
                str(tmp_path / "drawn")])
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    pngs = sorted(os.listdir(tmp_path / "jax"))
    assert pngs == ["chirp_samples.png", "cov_harmonic_sde.png"]
    assert sorted(os.listdir(tmp_path / "port")) == pngs
    assert sorted(os.listdir(tmp_path / "drawn")) == pngs
    assert sorted(os.listdir(tmp_path / "arrays")) == ["cov.npz",
                                                       "samples.npz"]


_NO_MATPLOTLIB = """
import sys
sys.modules["matplotlib"] = None
from chirpgp_tpu_torch.experiments import plots
plots.main(["--which", "cov", "--save-arrays", sys.argv[1],
            "--device", "cpu"])
assert "matplotlib.pyplot" not in sys.modules
plots.main(["--which", "cov", "--out", sys.argv[1], "--device", "cpu"])
"""


def test_save_arrays_needs_no_matplotlib(tmp_path):
    """Without matplotlib ``--save-arrays`` writes its files, and drawing
    stops at once with ``require_matplotlib``'s message."""
    proc = subprocess.run([sys.executable, "-c", _NO_MATPLOTLIB,
                           str(tmp_path)], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 2, proc.stderr[-3000:]
    assert "needs matplotlib, which is not installed" in proc.stderr
    assert os.listdir(tmp_path) == ["cov.npz"]


def test_cuda_is_the_default_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        plots.main(["--which", "cov", "--save-arrays", str(tmp_path)])
