"""PyTorch port vs the JAX package: the harmonic CKFS and La Scala GHFS
columns of the Table-I sweep (``apps/sweeps.py::mle_sweep_on_measurements``
on the K=3 harmonic model, cubature, d=8, and on the La Scala model, cov
form), in float64 on ``results/data/``.  A file of its own: the JAX
package compiles four programs for each sweep, which takes most of its
three minutes.  Tolerances as ``tests/test_torch_sweeps.py``: the same
``success``, params within 1e-5, IF-RMSE within 1e-6 relative."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import torch

import chirpgp_tpu.apps.pipeline as jp
import chirpgp_tpu.apps.sweeps as js
import chirpgp_tpu_torch.apps.pipeline as tp
import chirpgp_tpu_torch.apps.sweeps as ts

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _seed0(T, prefix):
    ys = [np.load(ROOT / f"results/data/toydata_{prefix}{mag}.npz")["ys"][0, :T]
          for mag in ts.MAGNITUDES]
    tf = np.load(ROOT / f"results/data/toydata_{prefix}const.npz")[
        "true_freqs"][:T]
    return tf.astype(np.float64), np.stack(ys).astype(np.float64)


def test_sweep_on_measurements_harmonic_matches_jax():
    """The harmonic CKFS column (K=3, cubature, d=8) of the sweep, seed 0
    of each magnitude of ``toydata_h3_*``, T=30, 5 iterations."""
    kw = dict(method="ghfs", model="harmonic", num_harmonics=3,
              quadrature="cubature", form="sqrt", max_iters=5)
    tf, ys = _seed0(30, "h3_")
    rj = js.mle_sweep_on_measurements(
        jp.IFEstimationConfig(**kw),
        jnp.asarray(np.broadcast_to(tf, ys.shape)), jnp.asarray(ys))
    rt = ts.mle_sweep_on_measurements(tp.IFEstimationConfig(**kw), tf, ys,
                                      device="cpu")
    assert rt["params"].shape == (3, 6)
    npt.assert_array_equal(rt["success"], rj["success"])
    npt.assert_allclose(rt["params"], rj["params"], atol=1e-5, rtol=0)
    npt.assert_allclose(rt["rmse"], rj["rmse"], rtol=1e-6, atol=0)


def test_sweep_on_measurements_lascala_matches_jax():
    """The La Scala GHFS column (cov form, as in Table I), seed 0 of each
    magnitude of ``toydata_*``, T=60, 15 iterations.  (Fewer iterations
    leave a lane that the rescue re-runs, where the JAX package raises
    under x64: ROADMAP Queue 3.)"""
    kw = dict(method="ghfs", model="lascala", form="cov", max_iters=15)
    tf, ys = _seed0(60, "")
    rj = js.mle_sweep_on_measurements(
        jp.IFEstimationConfig(**kw),
        jnp.asarray(np.broadcast_to(tf, ys.shape)), jnp.asarray(ys))
    rt = ts.mle_sweep_on_measurements(tp.IFEstimationConfig(**kw), tf, ys,
                                      device="cpu")
    assert rt["params"].shape == (3, 4)
    npt.assert_array_equal(rt["success"], rj["success"])
    npt.assert_allclose(rt["params"], rj["params"], atol=1e-5, rtol=0)
    npt.assert_allclose(rt["rmse"], rj["rmse"], rtol=1e-6, atol=0)
