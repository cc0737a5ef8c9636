"""End-to-end applications: the single-record pipeline (MLE, then IF
estimation) and batched IF estimation."""

from chirpgp_tpu_torch.apps.pipeline import (
    IFEstimationConfig, make_nll_fn, fit_mle, estimate_if, run_pipeline,
    estimate_if_batched)

__all__ = ["IFEstimationConfig", "make_nll_fn", "fit_mle", "estimate_if",
           "run_pipeline", "estimate_if_batched"]
