"""Inference engine: sequential Gaussian filters and smoothers (discrete-
time and continuous-discrete), their square-root forms, the batched
channels-first Monte-Carlo path, the parallel-in-time (associative-scan)
filters and smoothers and their time-sharded forms, the bootstrap
particle filter and NUTS (each with a rank-sharded form)."""

from chirpgp_tpu_torch.infer.filters import (
    kf, ekf, ekf_for_kpt, sgp_filter, cd_ekf, cd_sgp_filter)
from chirpgp_tpu_torch.infer.smoothers import (
    rts, eks, sgp_smoother, cd_eks, cd_sgp_smoother)
from chirpgp_tpu_torch.infer.parallel_kf import (
    kf_parallel, rts_parallel, kf_rts_parallel)
from chirpgp_tpu_torch.infer.sqrt import (
    sqrt_kf, sqrt_ekf, sqrt_eks, sqrt_sgp_filter, sqrt_sgp_smoother, tria)
from chirpgp_tpu_torch.infer.nuts import (
    nuts_sample, nuts_sample_sharded, NUTSResult)
from chirpgp_tpu_torch.infer.smc import (
    bootstrap_filter, bootstrap_filter_sharded, systematic_resample,
    effective_sample_size)
from chirpgp_tpu_torch.infer.parallel_sgp import (
    kf_parallel_tv, rts_parallel_tv, slr_transitions, psgp_filter_smoother)
from chirpgp_tpu_torch.infer.batched import (
    tria_cf, sqrt_sgp_filter_batched, sqrt_sgp_smoother_batched,
    sqrt_sgp_filter_smoother_batched, cov_sgp_filter_smoother_batched,
    gaussian_expectation_batched)
from chirpgp_tpu_torch.infer.parallel_sharded import (
    kf_parallel_time_sharded, rts_parallel_time_sharded)

__all__ = [
    "kf", "ekf", "ekf_for_kpt", "sgp_filter", "rts", "eks", "sgp_smoother",
    "cd_ekf", "cd_sgp_filter", "cd_eks", "cd_sgp_smoother",
    "kf_parallel", "rts_parallel", "kf_rts_parallel",
    "sqrt_kf", "sqrt_ekf", "sqrt_eks", "sqrt_sgp_filter",
    "sqrt_sgp_smoother", "tria",
    "nuts_sample", "nuts_sample_sharded", "NUTSResult",
    "bootstrap_filter", "bootstrap_filter_sharded", "systematic_resample",
    "effective_sample_size",
    "kf_parallel_tv", "rts_parallel_tv", "slr_transitions",
    "psgp_filter_smoother",
    "tria_cf", "sqrt_sgp_filter_batched", "sqrt_sgp_smoother_batched",
    "sqrt_sgp_filter_smoother_batched", "cov_sgp_filter_smoother_batched",
    "gaussian_expectation_batched",
    "kf_parallel_time_sharded", "rts_parallel_time_sharded",
]
