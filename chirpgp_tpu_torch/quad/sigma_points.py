"""Sigma-point quadrature rules for Gaussian integrals.

Approximates :math:`\\int z(x) N(x | m, P) dx \\approx \\sum_i w_i z(m + L \\xi_i)`
with ``L`` the lower Cholesky factor of ``P``.

The rules are host NumPy arrays, identical to ``chirpgp_tpu.quad.sigma_points``;
they become tensors (with the dtype and device of the data) at the point
of use.
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["SigmaPoints", "cubature", "gauss_hermite", "unscented"]


class SigmaPoints(NamedTuple):
    """A sigma-point rule.

    Attributes
    ----------
    d : int
        Dimension of the Gaussian.
    n_points : int
        Number of sigma points ``S``.
    w : np.ndarray (S,)
        Mean weights.
    wc : np.ndarray (S,) or None
        Covariance weights if they differ from ``w`` (unscented rule),
        otherwise ``None`` and ``w`` is used for covariances too.
    xi : np.ndarray (S, d)
        Unit sigma points (for the standard normal).
    """

    d: int
    n_points: int
    w: np.ndarray
    wc: Optional[np.ndarray]
    xi: np.ndarray

    @classmethod
    def cubature(cls, d: int) -> "SigmaPoints":
        return cubature(d)

    @classmethod
    def gauss_hermite(cls, d: int, order: int = 3) -> "SigmaPoints":
        return gauss_hermite(d, order)

    @classmethod
    def unscented(cls, d: int, alpha: float = 1.0, beta: float = 0.0,
                  kappa: Optional[float] = None) -> "SigmaPoints":
        return unscented(d, alpha, beta, kappa)

    @property
    def w_cov(self) -> np.ndarray:
        return self.w if self.wc is None else self.wc

    def gen_sigma_points(self, m: torch.Tensor,
                         chol_of_P: torch.Tensor) -> torch.Tensor:
        r"""Sigma points :math:`\chi_i = m + L \xi_i`: ``m (..., d)`` and
        ``chol_of_P (..., d, d)`` give ``(..., S, d)``."""
        xi = torch.as_tensor(self.xi, dtype=chol_of_P.dtype,
                             device=chol_of_P.device)
        return m[..., None, :] + torch.einsum("...ij,sj->...si", chol_of_P, xi)

    def _weights(self, like: torch.Tensor, cov: bool = False) -> torch.Tensor:
        return torch.as_tensor(self.w_cov if cov else self.w,
                               dtype=like.dtype, device=like.device)

    def expectation(self, evals: torch.Tensor) -> torch.Tensor:
        """Weighted mean over the leading sigma-point axis of ``evals``."""
        return torch.tensordot(self._weights(evals), evals, dims=1)

    def expectation_from_nodes(self, v_f, chi: torch.Tensor) -> torch.Tensor:
        """Weighted mean of ``v_f(chi)`` with the sigma axis leading."""
        return self.expectation(v_f(chi))

    def mean_and_cov(self, evals: torch.Tensor):
        """Weighted mean ``(..., d)`` and covariance ``(..., d, d)`` of
        propagated points ``evals (..., S, d)`` (deviation form)."""
        mean = torch.einsum("s,...sd->...d", self._weights(evals), evals)
        dev = evals - mean[..., None, :]
        return mean, torch.einsum("s,...si,...sj->...ij",
                                  self._weights(evals, cov=True), dev, dev)

    def cross_cov(self, evals_a: torch.Tensor, evals_b: torch.Tensor,
                  mean_a: torch.Tensor, mean_b: torch.Tensor) -> torch.Tensor:
        """Weighted cross-covariance ``E[(a - ma)(b - mb)^T]`` over points;
        evals ``(..., S, d)``, means ``(..., d)``."""
        dev_a = evals_a - mean_a[..., None, :]
        dev_b = evals_b - mean_b[..., None, :]
        return torch.einsum("s,...si,...sj->...ij",
                            self._weights(dev_a, cov=True), dev_a, dev_b)


def cubature(d: int) -> SigmaPoints:
    """Spherical cubature rule: ``2d`` points at ``±sqrt(d) e_i`` with equal
    weights ``1/(2d)``."""
    n_points = 2 * d
    w = np.full((n_points,), 1.0 / n_points)
    xi = math.sqrt(d) * np.concatenate([np.eye(d), -np.eye(d)], axis=0)
    return SigmaPoints(d=d, n_points=n_points, w=w, wc=None, xi=xi)


def gauss_hermite(d: int, order: int = 3) -> SigmaPoints:
    """Tensor-grid Gauss--Hermite rule with ``order**d`` points, scaled for
    standard-normal expectations (nodes ``sqrt(2) r``, weights
    ``w / sqrt(pi)`` per dimension)."""
    roots, weights = np.polynomial.hermite.hermgauss(order)
    nodes_1d = math.sqrt(2.0) * roots
    w_1d = weights / math.sqrt(math.pi)

    grids = np.meshgrid(*([nodes_1d] * d), indexing="ij")
    xi = np.stack([g.reshape(-1) for g in grids], axis=-1)  # (order**d, d)
    wgrids = np.meshgrid(*([w_1d] * d), indexing="ij")
    w = np.prod(np.stack([g.reshape(-1) for g in wgrids], axis=-1), axis=-1)

    return SigmaPoints(d=d, n_points=order ** d, w=w, wc=None, xi=xi)


def unscented(d: int, alpha: float = 1.0, beta: float = 0.0,
              kappa: Optional[float] = None) -> SigmaPoints:
    """Unscented transform (Julier--Uhlmann scaled form), ``2d + 1`` points.
    With the default ``kappa = 3 - d < 0`` the center weight is negative,
    so the square-root forms reject this rule."""
    if kappa is None:
        kappa = 3.0 - d
    lam = alpha ** 2 * (d + kappa) - d
    c = d + lam
    xi0 = np.zeros((1, d))
    xs = math.sqrt(c) * np.eye(d)
    xi = np.concatenate([xi0, xs, -xs], axis=0)
    w0m = lam / c
    w0c = lam / c + (1.0 - alpha ** 2 + beta)
    wi = 1.0 / (2.0 * c)
    w = np.concatenate([[w0m], np.full((2 * d,), wi)])
    wc = np.concatenate([[w0c], np.full((2 * d,), wi)])
    return SigmaPoints(d=d, n_points=2 * d + 1, w=w, wc=wc, xi=xi)
