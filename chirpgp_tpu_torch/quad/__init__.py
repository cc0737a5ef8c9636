"""Sigma-point rules."""

from chirpgp_tpu_torch.quad.sigma_points import (
    SigmaPoints, cubature, gauss_hermite, unscented)

__all__ = ["SigmaPoints", "cubature", "gauss_hermite", "unscented"]
