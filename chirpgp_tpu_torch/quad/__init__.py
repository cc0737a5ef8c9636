"""Sigma-point rules and batched Gaussian expectations."""

from chirpgp_tpu_torch.quad.sigma_points import (
    SigmaPoints, cubature, gauss_hermite, unscented)
from chirpgp_tpu_torch.quad.expectations import (
    gaussian_expectation, gaussian_expectation_1d)
from chirpgp_tpu_torch.quad.integrators import (
    rk4, rk4_m_cov, rk4_m_cov_backward)

__all__ = ["SigmaPoints", "cubature", "gauss_hermite", "unscented",
           "gaussian_expectation", "gaussian_expectation_1d",
           "rk4", "rk4_m_cov", "rk4_m_cov_backward"]
