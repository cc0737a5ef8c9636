"""The PyTorch port's real-data pipelines against the JAX package, on
synthetic stand-ins (the wav and strain files are not in the repository).

The Myotis configuration (harmonic model, d=10, freq_scale=1e4, cubature,
covariance form) amplifies round-off by about 3x per step before the
filter locks on: from the same float64 inputs the two packages' filter
means part by 1e-15 at step 0, 7e-12 at step 10 and O(1) by step 50 (the
round-off of two implementations, not a formula: the growth is smooth
from the first step).  So the bat pipeline is held to the JAX package on a
12-sample record, within 1e-9 relative; the LIGO pipeline (chirp model,
locked) on a 200-sample record with the MLE capped at 3 iterations, within
1e-9.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.apps.realdata as jrd
from chirpgp_tpu.apps.pipeline import estimate_if as jax_estimate_if
from chirpgp_tpu.apps.pipeline import fit_mle as jax_fit_mle
from chirpgp_tpu.models import g as jax_g

from chirpgp_tpu_torch.apps import (
    EPTESICUS, MYOTIS, BatCallConfig, analyze_bat_call, analyze_ligo,
    ligo_config, load_ligo_strain, load_wav, standardize)

torch.set_num_threads(1)

RTOL = 1e-9


def test_standardize_and_configs_match_jax():
    ys = np.array([1.0, 2.0, 3.0, 4.0, 10.0])
    z = standardize(torch.as_tensor(ys))
    npt.assert_allclose(z.numpy(), np.asarray(jrd.standardize(
        jnp.asarray(ys))), rtol=0, atol=1e-15)
    npt.assert_allclose(float(z.mean()), 0.0, atol=1e-12)
    npt.assert_allclose(float(z.std(correction=0)), 1.0, rtol=1e-12)
    for ours, theirs in ((MYOTIS, jrd.MYOTIS), (EPTESICUS, jrd.EPTESICUS)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    cfg, th = ligo_config(1 / 4096.0)
    cfg_j, th_j = jrd.ligo_config(1 / 4096.0)
    for field in ("dt", "Xi", "method", "model", "gh_order", "max_iters"):
        assert getattr(cfg, field) == getattr(cfg_j, field)
    npt.assert_allclose(th.numpy(), np.asarray(th_j), rtol=1e-15)
    assert ligo_config(1e-3, max_iters=2)[0].max_iters == 2


def test_loaders(tmp_path):
    from scipy.io import wavfile
    data = (1000 * np.sin(np.arange(64) / 3.0)).astype(np.int16)
    wavfile.write(tmp_path / "mono.wav", 8000, data)
    wavfile.write(tmp_path / "stereo.wav", 8000, np.stack([data, -data], 1))
    fs, ys = load_wav(str(tmp_path / "mono.wav"), device="cpu")
    assert fs == 8000 and ys.dtype == torch.float64
    npt.assert_array_equal(ys.numpy(), data.astype(np.float64))
    fs, ys = load_wav(str(tmp_path / "stereo.wav"), crop=(4, 20),
                      device="cpu")
    npt.assert_array_equal(ys.numpy(), data[4:20].astype(np.float64))
    fs_j, ys_j = jrd.load_wav(str(tmp_path / "stereo.wav"), crop=(4, 20))
    npt.assert_array_equal(ys.numpy(), np.asarray(ys_j))

    arr = np.stack([np.arange(10) / 4096.0, np.cos(np.arange(10))], 1)
    np.savetxt(tmp_path / "H.txt", arr)
    (ts, ys), = load_ligo_strain([str(tmp_path / "H.txt")], device="cpu")
    npt.assert_allclose(ts.numpy(), arr[:, 0], rtol=1e-15)
    npt.assert_allclose(ys.numpy(), arr[:, 1], rtol=1e-15)


def test_host_data_goes_to_the_card_unless_cpu_is_asked(tmp_path):
    """The new entry points put host data, and their draws, on the card by
    default: without one they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the calls would run on it")
    from scipy.io import wavfile
    from chirpgp_tpu_torch.apps import (
        filter_error_mc, filter_error_mc_chunked, pcrlb_chirp_mc)
    from chirpgp_tpu_torch.baselines import fhc_pitch_track
    from chirpgp_tpu_torch.models.cov_funcs import approx_cov_chirp_sde
    wavfile.write(tmp_path / "a.wav", 8000, np.zeros(16, np.int16))
    np.savetxt(tmp_path / "H.txt", np.ones((4, 2)))
    ys = np.random.default_rng(0).standard_normal(400)
    args = (0.1, 0.1, 0.1, 1.0, 1.0, 0.1, 4)
    calls = [(load_wav, (str(tmp_path / "a.wav"),)),
             (load_ligo_strain, ([str(tmp_path / "H.txt")],)),
             (analyze_bat_call, (ys[:12], 250e3, MYOTIS)),
             (analyze_ligo, (np.arange(12) / 4096.0, ys[:12])),
             (filter_error_mc, args), (filter_error_mc_chunked, args),
             (pcrlb_chirp_mc, args), (fhc_pitch_track, (ys, 1000.0, 1)),
             (approx_cov_chirp_sde, (np.linspace(0.01, 0.1, 10),
                                     *args[:5], 4))]
    for fn, a in calls:
        with pytest.raises((AssertionError, RuntimeError)):
            fn(*a)


def test_bat_pipeline_matches_jax():
    fs, T = 250_000.0, 12
    n = np.arange(1, T + 1) / fs
    phase = 80e3 * n - 0.5 * 4e8 * n ** 2
    ys = sum(np.sin(2 * np.pi * (k + 1) * phase) / (k + 1) for k in range(4))
    ys = ys + 0.01 * np.random.default_rng(0).standard_normal(T)
    y = standardize(torch.as_tensor(ys))
    est, wall = analyze_bat_call(y, fs, MYOTIS, time_it=True)
    assert wall > 0
    want, _ = jrd.analyze_bat_call(jrd.standardize(jnp.asarray(ys)), fs,
                                   jrd.MYOTIS)
    for key in ("if_mean", "if_lower", "if_upper", "nell"):
        w = np.asarray(want[key])
        npt.assert_allclose(est[key].numpy(), w, rtol=0,
                            atol=RTOL * np.abs(w).max(), err_msg=key)
    assert isinstance(MYOTIS, BatCallConfig)


def test_ligo_pipeline_matches_jax():
    fs, T = 4096.0, 200
    ts = np.arange(1, T + 1) / fs
    ys = np.sin(2 * math.pi * (40.0 * ts + 0.5 * 500.0 * ts ** 2)) \
        + 0.3 * np.random.default_rng(1).standard_normal(T)
    opt, params, est = analyze_ligo(ts, ys, max_iters=3, device="cpu")
    cfg, th = jrd.ligo_config(1 / fs)
    cfg = dataclasses.replace(cfg, max_iters=3)
    yj = jrd.standardize(jnp.asarray(ys))
    opt_j = jax_fit_mle(cfg, yj, th)
    est_j = jax_estimate_if(cfg, jax_g(opt_j.params), yj)
    assert int(opt.num_iters) == int(opt_j.num_iters) == 3
    npt.assert_allclose(opt.params.numpy(), np.asarray(opt_j.params),
                        rtol=RTOL)
    w = np.asarray(est_j["if_mean"])
    npt.assert_allclose(est["if_mean"].numpy(), w, rtol=0,
                        atol=RTOL * np.abs(w).max())
    assert np.all(np.isfinite(est["if_mean"].numpy()))
