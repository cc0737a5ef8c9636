"""Inference engine (ported so far: the batched square-root filter and
smoother)."""

from chirpgp_tpu_torch.infer.batched import (
    tria_cf, sqrt_sgp_filter_batched, sqrt_sgp_smoother_batched,
    gaussian_expectation_batched)

__all__ = ["tria_cf", "sqrt_sgp_filter_batched", "sqrt_sgp_smoother_batched",
           "gaussian_expectation_batched"]
