"""End-to-end applications: the single-record pipeline (MLE, then IF
estimation), batched IF estimation, the KPT baseline, and the Table-I
Monte-Carlo sweeps."""

from chirpgp_tpu_torch.apps.pipeline import (
    IFEstimationConfig, make_nll_fn, fit_mle, estimate_if, run_pipeline,
    estimate_if_batched)
from chirpgp_tpu_torch.apps.kpt import (
    KPT_INIT_PARAMS, kpt_filter, kpt_smooth, kpt_mle, kpt_if_estimate)
from chirpgp_tpu_torch.apps.sweeps import (
    MAGNITUDES, generate_rnd_keys, toymodel_measurements, mc_mle_sweep,
    mc_mle_sweep_stepped, mc_kpt_sweep, mle_sweep_on_measurements,
    save_results, print_rmse_table)

__all__ = ["IFEstimationConfig", "make_nll_fn", "fit_mle", "estimate_if",
           "run_pipeline", "estimate_if_batched", "KPT_INIT_PARAMS",
           "kpt_filter", "kpt_smooth", "kpt_mle", "kpt_if_estimate",
           "MAGNITUDES",
           "generate_rnd_keys", "toymodel_measurements", "mc_mle_sweep",
           "mc_mle_sweep_stepped", "mc_kpt_sweep",
           "mle_sweep_on_measurements", "save_results", "print_rmse_table"]
