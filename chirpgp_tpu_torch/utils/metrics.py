"""Metrics and small math utilities (counterpart of
``chirpgp_tpu.utils.metrics``)."""

from typing import Callable

import torch

__all__ = ["rmse", "fwd_transformed_pdf", "chol_partial_const_diag"]


def rmse(x1: torch.Tensor, x2: torch.Tensor,
         reduce_sum: bool = True) -> torch.Tensor:
    """Per-dimension RMSE over the time axis; summed over dimensions when
    ``reduce_sum``."""
    val = torch.sqrt(torch.mean((x1 - x2) ** 2, dim=0))
    return val.sum() if reduce_sum else val


def fwd_transformed_pdf(pdf_x: Callable, g_inv: Callable) -> Callable:
    r"""PDF of ``Y = g(X)`` by change of variables:
    ``p_Y(y) = p_X(g^{-1}(y)) |d g^{-1}/dy|``, evaluated elementwise over
    a 1-D tensor of ``y`` (the derivative by ``torch.func.grad``)."""
    dg_inv = torch.func.grad(g_inv)

    def pdf_y(y):
        return pdf_x(g_inv(y)) * torch.abs(dg_inv(y))

    return torch.func.vmap(pdf_y)


def chol_partial_const_diag(a: torch.Tensor, n: int,
                            lower: bool = False) -> torch.Tensor:
    """Cholesky factor of a block-diagonal matrix whose top-left ``n x n``
    block is diagonal (square root taken elementwise) and whose remainder
    is factorized normally; upper by default, as
    ``jax.scipy.linalg.cholesky``."""
    rest = torch.linalg.cholesky(a[n:, n:], upper=not lower)
    return torch.block_diag(torch.sqrt(a[:n, :n]), rest)
