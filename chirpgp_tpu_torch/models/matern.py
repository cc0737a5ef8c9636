"""Matern-3/2 SDE: closed-form transition and stationary covariance
(counterpart of ``chirpgp_tpu.models.matern``).

The IF prior ``V`` is the first component of the 2-D SDE
``d(V, dV) = [[0, 1], [-gamma^2, -2 gamma]] (V, dV) dt +
(0, 2 sigma gamma^{3/2}) dW`` with ``gamma = sqrt(3)/ell``.
"""

import math
from typing import Tuple

import torch

from chirpgp_tpu_torch.models.transitions import Transition
from chirpgp_tpu_torch.utils.numerics import as_real_tensor

__all__ = ["stationary_cov_m32", "m32_solution", "m32_transition_mean",
           "disc_m32"]


def stationary_cov_m32(ell, sigma) -> torch.Tensor:
    """Stationary covariance diag(sigma^2, gamma^2 sigma^2) of the
    Matern-3/2 state."""
    ell, sigma = as_real_tensor(ell), as_real_tensor(sigma)
    s2 = sigma ** 2
    zero = torch.zeros_like(s2)
    return torch.stack([torch.stack([s2, zero]),
                        torch.stack([zero, (3.0 / ell ** 2) * s2])])


def _sigma11_factor(eta: torch.Tensor) -> torch.Tensor:
    r"""``f(eta) = 1 - e^{-2 eta} (1 + 2 eta + 2 eta^2)``.

    The direct expression cancels catastrophically in float32 (``f`` is
    O(eta^3) while both operands are O(1); at dt=1e-3 it loses every
    bit), so below ``eta = 0.15`` the Taylor series
    ``4/3 eta^3 - 2 eta^4 + 8/5 eta^5 - 8/9 eta^6`` is used.
    """
    small = eta < 0.15
    eta_safe = torch.where(small, torch.ones_like(eta), eta)
    direct = 1.0 - torch.exp(-2.0 * eta_safe) \
        * (1.0 + 2.0 * eta_safe + 2.0 * eta_safe ** 2)
    e2, e3 = eta * eta, eta * eta * eta
    taylor = e3 * (4.0 / 3.0 - 2.0 * eta + (8.0 / 5.0) * e2
                   - (8.0 / 9.0) * e3)
    return torch.where(small, taylor, direct)


def m32_solution(ell, sigma, dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact discrete transition matrix ``F`` and noise covariance of the
    Matern-3/2 SDE over ``dt``, in the float32-safe formulation."""
    ell, sigma = as_real_tensor(ell), as_real_tensor(sigma)
    gamma = math.sqrt(3.0) / ell
    eta = dt * gamma
    decay = torch.exp(-eta)
    beta = sigma ** 2 * torch.exp(-2.0 * eta)

    F = torch.stack([
        torch.stack([(1.0 + eta) * decay, dt * decay]),
        torch.stack([-dt * gamma ** 2 * decay, (1.0 - eta) * decay]),
    ])
    off = 2.0 * dt ** 2 * gamma ** 3 * beta
    s11 = sigma ** 2 * _sigma11_factor(eta)
    s22 = gamma ** 2 * (sigma ** 2 + beta * (2.0 * eta - 2.0 * eta ** 2 - 1.0))
    Sigma = torch.stack([torch.stack([s11, off]), torch.stack([off, s22])])
    return F, Sigma


def m32_transition_mean(u: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Apply the 2x2 Matern transition to states ``u`` of shape (..., 2)."""
    return torch.einsum("ij,...j->...i", F.to(dtype=u.dtype, device=u.device), u)


def disc_m32(ell, sigma) -> Transition:
    """Exact discretization of the Matern-3/2 SDE as a :class:`Transition`
    on the state ``(V, dV)``."""
    ell, sigma = as_real_tensor(ell), as_real_tensor(sigma)

    def mean(u, dt):
        F, _ = m32_solution(ell, sigma, dt)
        return m32_transition_mean(u, F)

    def cov(_, dt):
        return m32_solution(ell, sigma, dt)[1]

    def mean_cf(u, dt):
        F, _ = m32_solution(ell, sigma, dt)
        return torch.einsum("ij,...jb->...ib",
                            F.to(dtype=u.dtype, device=u.device), u)

    def jac(u, dt):
        F, _ = m32_solution(ell, sigma, dt)
        return F.to(dtype=u.dtype, device=u.device).expand(
            u.shape[:-1] + (2, 2))

    return Transition(mean=mean, cov=cov, const_cov=True, mean_cf=mean_cf,
                      jac=jac)
