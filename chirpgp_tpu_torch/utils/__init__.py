"""Shared numerical utilities and metrics."""

from chirpgp_tpu_torch.utils.metrics import (
    rmse, fwd_transformed_pdf, chol_partial_const_diag)
from chirpgp_tpu_torch.utils.numerics import (
    as_real_tensor, phi1, ou_variance, psd_cholesky, cholesky_or_nan,
    psd_solve)

__all__ = ["rmse", "fwd_transformed_pdf", "chol_partial_const_diag",
           "as_real_tensor", "phi1", "ou_variance", "psd_cholesky",
           "cholesky_or_nan", "psd_solve"]
