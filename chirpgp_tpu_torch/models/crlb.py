"""Posterior Cramer--Rao lower bound, the Tichavsky et al. (1998)
recursion (counterpart of ``chirpgp_tpu.models.crlb``).

Monte-Carlo estimate of the information recursion
``J_k = D22 - D12^T (J_{k-1} + D11)^{-1} D12`` with the D blocks averaged
over sampled trajectories.
"""

from typing import Callable

import torch

__all__ = ["posterior_cramer_rao"]

# (step, sample) pairs per vmapped Hessian call: bounds its memory (a few
# GiB in float64) while keeping the calls, each ~40 ms of dispatch, few.
SAMPLES_PER_CALL = 2 ** 20


def posterior_cramer_rao(xss: torch.Tensor, yss: torch.Tensor,
                         j0: torch.Tensor, logpdf_transition: Callable,
                         logpdf_likelihood: Callable) -> torch.Tensor:
    """Inverse-PCRLB matrices ``J_k`` for a 1-D measurement model.

    Parameters
    ----------
    xss : (T + 1, N, d) state trajectories (initial samples first).
    yss : (T, N) measurements.
    j0 : (d, d) ``-E[Hess log p(x0)]``.
    logpdf_transition : ``(x_k, x_{k-1}) -> scalar``.
    logpdf_likelihood : ``(y_k, x_k) -> scalar``.

    Returns the (T, d, d) tensor of ``J_k``.  One vmapped
    ``torch.func.hessian`` (``jacfwd(jacrev)``) of the transition density
    in ``(x_k, x_{k-1})`` gives the three blocks D22, D12 and D11 at once;
    the likelihood's Hessian in ``x_k`` is added to D22.  Both are taken
    for as many steps at a time as ``SAMPLES_PER_CALL`` allows, and
    averaged over the N samples of each step; then the recursion runs
    with a pivoted solve.
    """
    T, N = yss.shape
    d = xss.shape[-1]

    def joint(z):
        return logpdf_transition(z[:d], z[d:])

    h_trans = torch.func.vmap(torch.func.hessian(joint))
    h_like = torch.func.vmap(torch.func.hessian(logpdf_likelihood,
                                                argnums=1))
    steps = max(1, SAMPLES_PER_CALL // max(N, 1))
    blocks = []
    for k0 in range(0, T, steps):
        k1 = min(T, k0 + steps)
        xt, xs, ys = xss[k0 + 1:k1 + 1], xss[k0:k1], yss[k0:k1]
        z = torch.cat([xt, xs], dim=-1).reshape(-1, 2 * d)
        hess = h_trans(z).reshape(k1 - k0, N, 2 * d, 2 * d).mean(1)
        like = h_like(ys.reshape(-1), xt.reshape(-1, d)).reshape(
            k1 - k0, N, d, d).mean(1)
        blocks.append((hess, like))
    hess = torch.cat([h for h, _ in blocks])                  # (T, 2d, 2d)
    like = torch.cat([l for _, l in blocks])                  # (T, d, d)
    d11 = -hess[:, d:, d:]
    d12 = -hess[:, d:, :d]
    d22 = -(hess[:, :d, :d] + like)
    j, js = j0, []
    for k in range(T):
        j = d22[k] - d12[k].T @ torch.linalg.solve(j + d11[k], d12[k])
        js.append(j)
    return torch.stack(js)
