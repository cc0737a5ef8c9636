"""End-to-end applications: the single-record pipeline (MLE, then IF
estimation), batched IF estimation, the KPT baseline, the Table-I
Monte-Carlo sweeps, the filter-error Monte Carlo and PCRLB of paper
Fig. 5, the real-data pipelines (bat calls, LIGO), and the Bayesian
hyperparameter posteriors (NUTS, SMC)."""

from chirpgp_tpu_torch.apps.pipeline import (
    IFEstimationConfig, make_nll_fn, fit_mle, estimate_if, run_pipeline,
    estimate_if_batched)
from chirpgp_tpu_torch.apps.kpt import (
    KPT_INIT_PARAMS, kpt_filter, kpt_smooth, kpt_mle, kpt_if_estimate)
from chirpgp_tpu_torch.apps.sweeps import (
    MAGNITUDES, generate_rnd_keys, toymodel_measurements, mc_mle_sweep,
    mc_mle_sweep_stepped, mc_kpt_sweep, mle_sweep_on_measurements,
    save_results, print_rmse_table)
from chirpgp_tpu_torch.apps.crlb import (
    filter_error_mc, filter_error_mc_chunked, pcrlb_chirp_mc)
from chirpgp_tpu_torch.apps.realdata import (
    BatCallConfig, EPTESICUS, MYOTIS, analyze_bat_call, ligo_config,
    analyze_ligo, standardize, load_wav, load_ligo_strain)
from chirpgp_tpu_torch.apps.posterior import (
    make_logposterior, sample_hyperposterior, sample_hyperposterior_sharded,
    smc_nll)

__all__ = ["IFEstimationConfig", "make_nll_fn", "fit_mle", "estimate_if",
           "run_pipeline", "estimate_if_batched", "KPT_INIT_PARAMS",
           "kpt_filter", "kpt_smooth", "kpt_mle", "kpt_if_estimate",
           "MAGNITUDES",
           "generate_rnd_keys", "toymodel_measurements", "mc_mle_sweep",
           "mc_mle_sweep_stepped", "mc_kpt_sweep",
           "mle_sweep_on_measurements", "save_results", "print_rmse_table",
           "filter_error_mc", "filter_error_mc_chunked", "pcrlb_chirp_mc",
           "BatCallConfig", "EPTESICUS", "MYOTIS", "analyze_bat_call",
           "ligo_config", "analyze_ligo", "standardize", "load_wav",
           "load_ligo_strain", "make_logposterior", "sample_hyperposterior",
           "sample_hyperposterior_sharded",
           "smc_nll"]
