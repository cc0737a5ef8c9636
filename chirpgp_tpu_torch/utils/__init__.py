"""Shared numerical utilities and metrics."""

from chirpgp_tpu_torch.utils.metrics import rmse
from chirpgp_tpu_torch.utils.numerics import (
    as_real_tensor, phi1, ou_variance, psd_cholesky)

__all__ = ["rmse", "as_real_tensor", "phi1", "ou_variance", "psd_cholesky"]
