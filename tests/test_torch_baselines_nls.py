"""The PyTorch port's last Table-I baselines against the JAX package: the
harmonic-chirp grid NLS (FHC) and the fast harmonic-NLS pitch tracker
(fastF0NLS, host C++).

FHC runs both packages on the same float64 windows and must agree per
window within 1e-10 Hz; fastF0NLS is the same C++ source (the port's copy
is held byte-equal to the JAX package's), built by the port's own loader,
and must agree exactly.
"""

import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.baselines.fastnls as jnls
import chirpgp_tpu.baselines.fhc as jfhc

from chirpgp_tpu_torch.baselines import (
    fhc_pitch_track, fhc_pitch_track_batch, force_odd, harmonic_chirp_nls,
    median_smooth, pitch_track, single_pitch)
from chirpgp_tpu_torch.ops import native

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FS = 1000.0
# Per-window f0 agreement with the JAX package at float64, in Hz.
FHC_ATOL = 1e-10


def _records():
    """Two short records of the Table-I data: seed 0 of the const and the
    random magnitude of the 3-harmonic set, float64."""
    return np.stack([
        np.load(ROOT / f"results/data/toydata_h3_{m}.npz")["ys"][0, :340]
        for m in ("const", "random")]).astype(np.float64)


@pytest.mark.parametrize("K", [1, 3])
def test_fhc_per_window_matches_jax(K):
    ys = _records()
    times, f0 = fhc_pitch_track_batch(ys, FS, K, window_chunk=8,
                                      device="cpu")
    tj, fj = jfhc.fhc_pitch_track_batch(ys, FS, K, window_chunk=8)
    assert f0.shape == (2, 9)
    npt.assert_array_equal(times, tj)
    npt.assert_allclose(f0, fj, rtol=0, atol=FHC_ATOL)
    # One record alone, a tensor, and the batch agree.
    t1, f1 = fhc_pitch_track(torch.as_tensor(ys[1]), FS, K)
    npt.assert_array_equal(t1, times)
    npt.assert_allclose(f1, f0[1], rtol=0, atol=FHC_ATOL)


def test_harmonic_chirp_nls_linear_chirp():
    """Recovers (w, alpha) of a clean linear harmonic chirp
    (``tests/test_fhc.py::test_harmonic_chirp_nls_linear_chirp``), as the
    JAX package does."""
    N = 400
    n = np.arange(N)
    f0, rate = 10.0, 8.0
    w_true = 2 * math.pi * f0 / FS
    a_true = 2 * math.pi * rate / FS ** 2
    phase = w_true * n + 0.5 * a_true * n ** 2
    y = np.sin(phase) + 0.5 * np.sin(2 * phase + 0.2)
    bounds = ((2 * math.pi * 5 / FS, 2 * math.pi * 20 / FS),
              (-2 * math.pi * 20 / FS ** 2, 2 * math.pi * 20 / FS ** 2))
    w, a = harmonic_chirp_nls(torch.as_tensor(y), 2, *bounds)
    npt.assert_allclose(float(w), w_true, rtol=2e-2)
    npt.assert_allclose(float(a), a_true, rtol=0.3, atol=2e-7)
    wj, aj = jfhc.harmonic_chirp_nls(jnp.asarray(y), 2, *bounds)
    npt.assert_allclose([float(w), float(a)], [float(wj), float(aj)],
                        rtol=1e-12)


def test_fast_nls_source_is_the_jax_packages():
    assert native.SOURCE.read_bytes() == (
        ROOT / "chirpgp_tpu/ops/native/fast_nls.cpp").read_bytes()
    lib = native.build_fast_nls()
    assert lib.parent == ROOT / "chirpgp_tpu_torch/ops/_build"
    assert native.GXX_FLAGS == ("-O3", "-march=native", "-shared", "-fPIC",
                                "-std=c++17")


@pytest.mark.parametrize("K,overlap", [(1, 299), (3, 295)])
def test_pitch_track_equals_jax(K, overlap):
    y = _records()[0] if K == 1 else _records()[1]
    t, f0 = pitch_track(torch.as_tensor(y), FS, K, window_overlap=overlap)
    tj, fj = jnls.pitch_track(y, FS, K, window_overlap=overlap)
    npt.assert_array_equal(t, tj)
    npt.assert_array_equal(f0, fj)
    sm = median_smooth(f0, force_odd(round(300 / 2)))
    npt.assert_array_equal(sm, jnls.median_smooth(fj, force_odd(150)))


def test_single_pitch_recovers_tone_and_order():
    """``tests/test_fastnls.py``: a noisy pure tone and a 3-harmonic
    signal, pitch and order, fast and exact paths."""
    n = np.arange(400)
    rng = np.random.default_rng(0)
    for f0, amps in ((10.0, [1.0]), (8.0, [1.0, 0.6, 0.4])):
        y = sum(a * np.sin(2 * np.pi * (k + 1) * f0 / FS * n + 0.1 * k)
                for k, a in enumerate(amps)) + 0.02 * rng.standard_normal(400)
        sp = single_pitch(400, 5, np.array([2.0 / FS, 30.0 / FS]))
        w = sp.est(y, eps=1e-7, method=1)
        npt.assert_allclose(w * FS / (2 * math.pi), f0, rtol=2e-2)
        assert sp.modelOrder() == len(amps)
        npt.assert_allclose(sp.est(y, eps=1e-7, method=0), w, rtol=1e-3)
    assert force_odd(4) == 5 and force_odd(5) == 5
