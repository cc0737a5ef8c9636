"""Taylor moment expansion (TME) discretization (counterpart of
``chirpgp_tpu.models.tme``).

For ``dX = a(X) dt + B(X) dW`` with generator
``A phi = J_phi a + 1/2 sum_ij Gamma_ij d^2 phi / dx_i dx_j``
(``Gamma = B B^T``), the conditional moments over a step ``dt`` expand as

- mean:  ``m(x, dt) = sum_{r=0}^{p} dt^r / r! A^r id(x)``
- cov:   ``Sigma(x, dt) = sum_{r=1}^{p} dt^r / r! [A^r(x x^T)
  - sum_{k=0}^{r} C(r, k) (A^k x)(A^{r-k} x)^T]``

The generator nests ``torch.func.jvp`` and ``torch.func.jacfwd``, so the
expansions are exact derivatives.  Forward-mode AD keeps process-wide
levels: call these on one thread at a time (never on the sweep polish's
threads).
"""

import math
from typing import Callable

import torch

from chirpgp_tpu_torch.models.transitions import Transition

__all__ = ["generator", "tme_mean_and_cov", "disc_tme", "disc_chirp_tme"]


def generator(phi: Callable, drift: Callable, dispersion: Callable) -> Callable:
    """Infinitesimal generator ``A phi`` of the diffusion, for ``phi`` with
    any output shape."""

    def a_phi(x):
        ax = drift(x)
        jvp_term = torch.func.jvp(phi, (x,), (ax,))[1]
        B = dispersion(x).to(x)
        gamma = B @ B.T
        hess = torch.func.jacfwd(torch.func.jacfwd(phi))(x)   # (out..., d, d)
        return jvp_term + 0.5 * torch.einsum("...ij,ij->...", hess, gamma)

    return a_phi


def tme_mean_and_cov(x: torch.Tensor, dt, drift: Callable,
                     dispersion: Callable, order: int = 3):
    """TME conditional mean and covariance at a single state ``x`` (d,)."""
    phi_m = [lambda u: u]
    phi_p = [lambda u: torch.outer(u, u)]
    for _ in range(order):
        phi_m.append(generator(phi_m[-1], drift, dispersion))
        phi_p.append(generator(phi_p[-1], drift, dispersion))

    m_evals = [f(x) for f in phi_m]
    p_evals = [f(x) for f in phi_p]

    mean = m_evals[0]
    coeff = 1.0
    for r in range(1, order + 1):
        coeff = coeff * dt / r
        mean = mean + coeff * m_evals[r]

    cov = x.new_zeros((x.shape[-1], x.shape[-1]))
    coeff = 1.0
    for r in range(1, order + 1):
        coeff = coeff * dt / r
        cross = sum(math.comb(r, k) * torch.outer(m_evals[k], m_evals[r - k])
                    for k in range(r + 1))
        cov = cov + coeff * (p_evals[r] - cross)
    return mean, cov


def disc_tme(drift: Callable, dispersion: Callable, order: int = 3) -> Transition:
    """TME discretization of an SDE as a :class:`Transition`; states with
    leading batch axes are mapped with ``torch.func.vmap``."""

    def single(u, dt):
        return tme_mean_and_cov(u, dt, drift, dispersion, order)

    def mapped(u, dt, which):
        f = lambda v: single(v, dt)[which]
        for _ in range(u.dim() - 1):
            f = torch.func.vmap(f)
        return f(u)

    return Transition(mean=lambda u, dt: mapped(u, dt, 0),
                      cov=lambda u, dt: mapped(u, dt, 1), const_cov=False)


def disc_chirp_tme(lam, b, ell, sigma, order: int = 3) -> Transition:
    """TME discretization of the chirp model."""
    from chirpgp_tpu_torch.models.chirp import model_chirp
    drift, dispersion, _, _, _ = model_chirp(lam, b, ell, sigma, 1.0)
    return disc_tme(drift, dispersion, order)
