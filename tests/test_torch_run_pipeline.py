"""The single-record pipeline of the PyTorch port: ``run_pipeline`` (MLE
with host SciPy L-BFGS-B, then IF estimation) recovers the IF on a short
record, and ``estimate_if`` in float64 at the reference's learnt optimum
reproduces the reference's seed-0 IF-RMSE at full length."""

from pathlib import Path

import numpy as np
import torch

import chirpgp_tpu_torch.apps as tp
from chirpgp_tpu_torch.convert import params_from_jax
from chirpgp_tpu_torch.utils import rmse

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DATA = np.load(ROOT / "results/data/toydata_const.npz")


def test_run_pipeline_recovers_if():
    """T=300 of seed 0: the MLE succeeds and the IF posterior mean tracks
    the true IF (RMSE < 2.0 Hz, the bound of tests/test_pipeline.py)."""
    T = 300
    ys = torch.tensor(DATA["ys"][0, :T].astype(np.float64))
    opt, params, est = tp.run_pipeline(tp.IFEstimationConfig(max_iters=100),
                                       ys)
    assert bool(opt.success)
    assert params.shape == (6,) and bool(torch.all(params > 0))
    assert bool(torch.all(torch.isfinite(est["if_mean"])))
    err = float(rmse(torch.tensor(DATA["true_freqs"][:T]), est["if_mean"]))
    assert err < 2.0, f"IF RMSE too high: {err}"


def test_estimate_if_ghfs_seed0_gate_float64():
    """Full T=3141, cov-form GHFS at the reference's learnt optimum: the
    reference's IF-RMSE x10 (0.7856412) within 0.005, and the final NLL of
    the float64 batched path (906.72448) within 1e-6 relative."""
    ref = np.load(ROOT / "results/reference/ghfs_const.npz")
    est = tp.estimate_if(tp.IFEstimationConfig(),
                         params_from_jax(ref["params"][0]),
                         torch.tensor(DATA["ys"][0].astype(np.float64)))
    r10 = 10.0 * float(rmse(torch.tensor(DATA["true_freqs"]), est["if_mean"]))
    assert abs(r10 - 10.0 * ref["rmse"][0]) <= 0.005
    assert abs(float(est["nell"][-1]) - 906.72448) <= 1e-6 * 906.72448
