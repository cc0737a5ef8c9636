"""Numerical helpers shared across the port (counterpart of
``chirpgp_tpu.utils.numerics``; the batched solvers are not ported yet)."""

import torch

__all__ = ["as_real_tensor", "phi1", "ou_variance", "psd_cholesky"]


def as_real_tensor(x) -> torch.Tensor:
    """Tensors pass through; Python numbers, sequences and NumPy arrays
    become float64 host tensors (the JAX package evaluates such constants
    at x64 on the host)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=torch.float64)


def phi1(x: torch.Tensor) -> torch.Tensor:
    r"""Smooth evaluation of :math:`\phi_1(x) = (1 - e^{-x}) / x`, with a
    Taylor switch at ``|x| < 1e-4`` (no 0/0 at ``x = 0``)."""
    x = as_real_tensor(x)
    small = x.abs() < 1e-4
    x_safe = torch.where(small, torch.ones_like(x), x)
    exact = -torch.expm1(-x_safe) / x_safe
    taylor = 1.0 - x / 2.0 + x * x / 6.0
    return torch.where(small, taylor, exact)


def ou_variance(b, lam, dt) -> torch.Tensor:
    r"""Stationary-increment variance of a damped (OU-like) channel:
    :math:`b^2 (1 - e^{-2\lambda dt}) / (2\lambda)`, smoothly equal to
    ``b^2 dt`` at ``lam = 0``."""
    return b ** 2 * dt * phi1(2.0 * as_real_tensor(lam) * dt)


def psd_cholesky(P: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Lower Cholesky-like factor of a PSD matrix that may be SINGULAR.

    Unrolled Cholesky that zeroes the pivot and its column when the pivot
    falls below ``eps``, so ``L L^T`` still reproduces the nonsingular
    block exactly (``torch.linalg.cholesky`` raises on such inputs).
    Accepts ``(..., d, d)``.
    """
    d = P.shape[-1]
    rows = [[None] * d for _ in range(d)]
    zero = torch.zeros_like(P[..., 0, 0])
    for j in range(d):
        acc = P[..., j, j]
        for k in range(j):
            acc = acc - rows[j][k] * rows[j][k]
        ok = acc > eps
        Ljj = torch.where(ok, torch.sqrt(acc.clamp_min(eps)), zero)
        inv = torch.where(ok, 1.0 / torch.where(ok, Ljj, zero + 1.0), zero)
        rows[j][j] = Ljj
        for i in range(j + 1, d):
            acc2 = P[..., i, j]
            for k in range(j):
                acc2 = acc2 - rows[i][k] * rows[j][k]
            rows[i][j] = acc2 * inv
    return torch.stack(
        [torch.stack([rows[i][j] if j <= i else zero for j in range(d)],
                     dim=-1) for i in range(d)], dim=-2)
