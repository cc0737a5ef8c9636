"""Gaussian expectations of nonlinear transforms, vectorized over time
(counterpart of ``chirpgp_tpu.quad.expectations``).

Used to push the posterior of the latent frequency state ``V`` through the
softplus bijection ``g`` to get ``E[g(V_t)]`` per time step.
"""

from typing import Callable

import torch

from chirpgp_tpu_torch.quad.sigma_points import gauss_hermite

__all__ = ["gaussian_expectation", "gaussian_expectation_1d"]


def gaussian_expectation(ms: torch.Tensor, chol_Ps: torch.Tensor,
                         func: Callable = None, d: int = 1, order: int = 10,
                         force_shape: bool = False) -> torch.Tensor:
    r"""Approximate :math:`E[f(V_t)]` for ``V_t ~ N(ms[t], Ps[t])`` with
    Gauss--Hermite quadrature, batched over ``t``.

    ``ms`` (T, d) means (or (T,) with ``force_shape``); ``chol_Ps``
    (T, d, d) Cholesky factors (or (T,) std-devs with ``force_shape``);
    ``func`` applied elementwise to the sigma points, by default the
    softplus bijection ``g``.  Returns (T, d).
    """
    if func is None:
        from chirpgp_tpu_torch.models.bijections import g as func
    if force_shape:
        ms = ms.reshape(-1, 1)
        chol_Ps = chol_Ps.reshape(-1, 1, 1)
    sgps = gauss_hermite(d=d, order=order).to(ms)
    chi = sgps.gen_sigma_points(ms, chol_Ps)              # (T, S, d)
    return torch.einsum("s,tsd->td", sgps.w, func(chi))


def gaussian_expectation_1d(ms: torch.Tensor, stds: torch.Tensor,
                            func: Callable = None,
                            order: int = 10) -> torch.Tensor:
    """Scalar-state fast path: ``ms`` and ``stds`` of shape ``(T,)``; the
    same as ``gaussian_expectation(..., force_shape=True)[:, 0]``."""
    if func is None:
        from chirpgp_tpu_torch.models.bijections import g as func
    sgps = gauss_hermite(d=1, order=order).to(ms)
    nodes = sgps.xi[:, 0]                                 # (S,)
    chi = ms[:, None] + stds[:, None] * nodes[None, :]    # (T, S)
    return func(chi) @ sgps.w
