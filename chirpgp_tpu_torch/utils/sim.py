"""SDE trajectory simulators, Gaussian-increment scheme (counterpart of
``chirpgp_tpu.utils.sim``; ``simulate_lgssm`` and
``simulate_function_parametrised_sde`` are not ported yet).

The draws come from a ``torch.Generator`` on the host, in float64, and
are moved to the initial state's device and dtype, so one seed gives the
same path on every device.  Torch's generator cannot replay JAX's
threefry streams: :func:`_simulate_from_noise` takes the draws
explicitly, which is how the port is held to the JAX package.
"""

from typing import Callable, Optional

import torch

__all__ = ["simulate_sde", "simulate_sde_init"]


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
