"""Runge--Kutta moment-ODE integrators (counterpart of
``chirpgp_tpu.quad.integrators``).

One classic RK4 step over a tuple of tensors; the continuous-discrete
filters and smoothers advance the mean/covariance ODE system by one
macro step per measurement interval, with no substepping.
"""

from typing import Callable, Tuple

import torch

__all__ = ["rk4", "rk4_m_cov", "rk4_m_cov_backward"]


def _map(fn, *trees):
    """``fn`` over matching leaves of tensors or (nested) tuples/lists."""
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def rk4(ode: Callable, y, dt, *args):
    """One classic RK4 step of ``dy/dt = ode(y, *args)`` over ``y``, a
    tensor or a tuple of tensors; ``ode`` returns the same structure."""
    def add(a, b, s):
        return _map(lambda x, k: x + s * k, a, b)

    k1 = ode(y, *args)
    k2 = ode(add(y, k1, dt / 2), *args)
    k3 = ode(add(y, k2, dt / 2), *args)
    k4 = ode(add(y, k3, dt), *args)
    return _map(lambda x, a, b, c, d: x + dt * (a + 2 * b + 2 * c + d) / 6.0,
                y, k1, k2, k3, k4)


def rk4_m_cov(m_cov_ode: Callable, m: torch.Tensor, P: torch.Tensor,
              dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """RK4 step of the coupled mean/covariance filtering ODEs
    ``m_cov_ode(m, P) -> (dm, dP)``."""
    return rk4(lambda y: m_cov_ode(*y), (m, P), dt)


def rk4_m_cov_backward(m_cov_ode: Callable, m: torch.Tensor, P: torch.Tensor,
                       mf: torch.Tensor, Pf: torch.Tensor,
                       dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """RK4 step of the smoothing ODEs ``m_cov_ode(m, P, mf, Pf)``
    conditioned on fixed filter moments ``(mf, Pf)``.  Pass a negative
    ``dt`` to integrate backwards."""
    return rk4(lambda y: m_cov_ode(*y, mf, Pf), (m, P), dt)
