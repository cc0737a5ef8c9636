"""Inference engine: sequential Gaussian filters and smoothers (discrete-
time and continuous-discrete), their square-root forms, and the batched
channels-first Monte-Carlo path."""

from chirpgp_tpu_torch.infer.filters import (
    kf, ekf, ekf_for_kpt, sgp_filter, cd_ekf, cd_sgp_filter)
from chirpgp_tpu_torch.infer.smoothers import (
    rts, eks, sgp_smoother, cd_eks, cd_sgp_smoother)
from chirpgp_tpu_torch.infer.sqrt import (
    sqrt_kf, sqrt_ekf, sqrt_eks, sqrt_sgp_filter, sqrt_sgp_smoother, tria)
from chirpgp_tpu_torch.infer.batched import (
    tria_cf, sqrt_sgp_filter_batched, sqrt_sgp_smoother_batched,
    sqrt_sgp_filter_smoother_batched, cov_sgp_filter_smoother_batched,
    gaussian_expectation_batched)

__all__ = [
    "kf", "ekf", "ekf_for_kpt", "sgp_filter", "rts", "eks", "sgp_smoother",
    "cd_ekf", "cd_sgp_filter", "cd_eks", "cd_sgp_smoother",
    "sqrt_kf", "sqrt_ekf", "sqrt_eks", "sqrt_sgp_filter",
    "sqrt_sgp_smoother", "tria",
    "tria_cf", "sqrt_sgp_filter_batched", "sqrt_sgp_smoother_batched",
    "sqrt_sgp_filter_smoother_batched", "cov_sgp_filter_smoother_batched",
    "gaussian_expectation_batched",
]
