"""Trajectory simulators for LGSSMs and SDEs, Gaussian-increment scheme
(counterpart of ``chirpgp_tpu.utils.sim``).

The draws come from a ``torch.Generator`` on the host, in float64, and
are moved to the initial state's device and dtype, so one seed gives the
same path on every device.  Torch's generator cannot replay JAX's
threefry streams: :func:`_simulate_from_noise` takes the draws
explicitly, which is how the port is held to the JAX package.
"""

from typing import Callable, Optional

import torch

__all__ = ["simulate_lgssm", "simulate_sde", "simulate_sde_init",
           "simulate_function_parametrised_sde"]


def _normal(shape, generator: Optional[torch.Generator],
            like: torch.Tensor) -> torch.Tensor:
    z = torch.randn(shape, generator=generator, dtype=torch.float64)
    return z.to(dtype=like.dtype, device=like.device)


def _chol_of(cov: torch.Tensor, const_diag_cov: bool) -> torch.Tensor:
    return torch.sqrt(cov) if const_diag_cov else torch.linalg.cholesky(cov)


def _simulate_from_noise(m_and_cov: Callable, x0: torch.Tensor,
                         dws: torch.Tensor, dt,
                         const_diag_cov: bool = False) -> torch.Tensor:
    """``x_k = m(x_{k-1}) + chol(cov(x_{k-1})) dw_k`` for the given
    increments ``dws`` (T, dim); returns (T, dim), ``x0`` excluded."""
    x, traj = x0, []
    for dw in dws:
        m, cov = m_and_cov(x, dt)
        x = m + _chol_of(cov, const_diag_cov) @ dw
        traj.append(x)
    return torch.stack(traj)


def _simulate_batch_from_noise(m_and_cov: Callable, x0: torch.Tensor,
                               dws: torch.Tensor, dt,
                               const_diag_cov: bool = False) -> torch.Tensor:
    """:func:`_simulate_from_noise` for a batch of trajectories: ``x0``
    (N, dim), increments ``dws`` (N, T, dim); returns (N, T, dim).
    ``m_and_cov`` must take a batch of states."""
    x, traj = x0, []
    for k in range(dws.shape[1]):
        m, cov = m_and_cov(x, dt)
        x = m + (_chol_of(cov, const_diag_cov) @ dws[:, k, :, None])[..., 0]
        traj.append(x)
    return torch.stack(traj, dim=1)


def _lgssm_from_noise(F: torch.Tensor, Sigma: torch.Tensor,
                      x0: torch.Tensor, rnds: torch.Tensor) -> torch.Tensor:
    """``x_k = F x_{k-1} + chol(Sigma) eps_k`` for the given ``rnds``
    (T, d); returns (T, d), ``x0`` excluded."""
    chol = torch.linalg.cholesky(Sigma)
    x, traj = x0, []
    for rnd in rnds:
        x = F @ x + chol @ rnd
        traj.append(x)
    return torch.stack(traj)


def simulate_lgssm(F: torch.Tensor, Sigma: torch.Tensor, x0: torch.Tensor,
                   T: int, generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Simulate ``x_k = F x_{k-1} + chol(Sigma) eps_k`` for T steps; the
    trajectory (T, d), ``x0`` excluded."""
    return _lgssm_from_noise(F, Sigma, x0,
                             _normal((T, x0.shape[-1]), generator, x0))


def simulate_sde(m_and_cov: Callable, m0: torch.Tensor, P0: torch.Tensor,
                 dt, T: int, generator: Optional[torch.Generator] = None,
                 const_diag_cov: bool = False) -> torch.Tensor:
    """Simulate an SDE through its conditional discretization
    ``m_and_cov``, drawing ``x0 ~ N(m0, P0)`` first and then the T
    increments.  The noise dimension equals the state dimension."""
    dim = m0.shape[-1]
    x0 = m0 + torch.linalg.cholesky(P0) @ _normal((dim,), generator, m0)
    dws = _normal((T, dim), generator, m0)
    return _simulate_from_noise(m_and_cov, x0, dws, dt, const_diag_cov)


def simulate_sde_init(m_and_cov: Callable, x0: torch.Tensor, dt, T: int,
                      generator: Optional[torch.Generator] = None,
                      const_diag_cov: bool = False) -> torch.Tensor:
    """Like :func:`simulate_sde` but from the fixed ``x0``."""
    dws = _normal((T, x0.shape[-1]), generator, x0)
    return _simulate_from_noise(m_and_cov, x0, dws, dt, const_diag_cov)


def _conditioned_from_noise(m_and_cov: Callable, vs: torch.Tensor,
                            x0: torch.Tensor, dws: torch.Tensor, dt,
                            const_diag_cov: bool = False) -> torch.Tensor:
    """``x_k = m(x_{k-1}, v_k) + chol(cov(x_{k-1}, v_k)) dw_k`` for the
    given path ``vs`` and increments ``dws``; returns (T, dim)."""
    x, traj = x0, []
    for v, dw in zip(vs, dws):
        m, cov = m_and_cov(x, v, dt)
        x = m + _chol_of(cov, const_diag_cov) @ dw
        traj.append(x)
    return torch.stack(traj)


def _conditioned_batch_from_noise(m_and_cov: Callable, vs: torch.Tensor,
                                  x0: torch.Tensor, dws: torch.Tensor, dt,
                                  const_diag_cov: bool = False
                                  ) -> torch.Tensor:
    """:func:`_conditioned_from_noise` for a batch of trajectories along
    one path ``vs`` (T, ...): ``x0`` (N, dim), ``dws`` (N, T, dim);
    returns (N, T, dim)."""
    x, traj = x0, []
    for k in range(dws.shape[1]):
        m, cov = m_and_cov(x, vs[k], dt)
        x = m + (_chol_of(cov, const_diag_cov) @ dws[:, k, :, None])[..., 0]
        traj.append(x)
    return torch.stack(traj, dim=1)


def simulate_function_parametrised_sde(m_and_cov: Callable, vs: torch.Tensor,
                                       m0: torch.Tensor, P0: torch.Tensor, dt,
                                       T: int,
                                       generator: Optional[torch.Generator]
                                       = None,
                                       const_diag_cov: bool = False
                                       ) -> torch.Tensor:
    """Simulate an SDE whose transition ``m_and_cov(x, v, dt)`` is
    conditioned on an exogenous path ``vs`` (T, ...), drawing ``x0 ~ N(m0,
    P0)`` first and then the T increments."""
    dim = m0.shape[-1]
    x0 = m0 + torch.linalg.cholesky(P0) @ _normal((dim,), generator, m0)
    dws = _normal((T, dim), generator, m0)
    return _conditioned_from_noise(m_and_cov, vs, x0, dws, dt,
                                   const_diag_cov)
