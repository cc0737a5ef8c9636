"""Shared building blocks of the Gaussian filters and smoothers
(counterpart of ``chirpgp_tpu.infer.common``).

Linear predict/update with the accumulated Gaussian NLL, the RTS-type
smoother step, the sigma-point prediction through a
:class:`~chirpgp_tpu_torch.models.transitions.Transition`, and the
continuous-time sigma-point moment ODEs.
"""

import dataclasses
import math

import torch

from chirpgp_tpu_torch.models.transitions import as_transition
from chirpgp_tpu_torch.quad.sigma_points import SigmaPoints
from chirpgp_tpu_torch.utils.numerics import psd_cholesky, psd_solve

__all__ = [
    "log_normal_pdf", "linear_predict", "linear_update",
    "gaussian_smoother_step", "sgp_prediction", "cd_sgp_moment_odes",
    "stack_smoothing_results",
]

_LOG_2PI = math.log(2.0 * math.pi)


def log_normal_pdf(x, mu, variance: torch.Tensor) -> torch.Tensor:
    """Scalar Gaussian log-density (the filter marginal likelihood)."""
    return -0.5 * (_LOG_2PI + torch.log(variance) + (x - mu) ** 2 / variance)


def linear_predict(F: torch.Tensor, Sigma: torch.Tensor,
                   m: torch.Tensor, P: torch.Tensor):
    """Moments of ``X_k = F X_{k-1} + q``."""
    return F @ m, F @ P @ F.T + Sigma


def linear_update(mp: torch.Tensor, Pp: torch.Tensor, H: torch.Tensor,
                  Xi, y):
    """1-D-measurement Kalman update: the posterior moments and the
    negative log-likelihood increment."""
    S = H @ Pp @ H + Xi
    K = Pp @ H / S
    pred = H @ mp
    mf = mp + K * (y - pred)
    Pf = Pp - torch.outer(K, K) * S
    return mf, Pf, -log_normal_pdf(y, pred, S)


def gaussian_smoother_step(DT: torch.Tensor,
                           mf: torch.Tensor, Pf: torch.Tensor,
                           mp: torch.Tensor, Pp: torch.Tensor,
                           ms: torch.Tensor, Ps: torch.Tensor):
    """One RTS-type backward step with gain ``G = D Pp^{-1}`` solved by the
    degenerate-safe :func:`psd_solve`; ``DT = D^T``."""
    G = psd_solve(Pp, DT).T
    ms = mf + G @ (ms - mp)
    Ps = Pf + G @ (Ps - Pp) @ G.T
    return ms, Ps


def sgp_prediction(sgps: SigmaPoints, trans, dt,
                   mf: torch.Tensor, Pf: torch.Tensor):
    """Sigma-point prediction through a discretized transition.

    Returns ``(mp, Pp, chi, evals)``; the last two feed the smoother's
    cross-covariance.  The filtered covariance is factored with the
    degenerate-safe :func:`psd_cholesky`; a state-independent transition
    covariance skips the per-point covariance reduction.
    """
    trans = as_transition(trans)
    chol_Pf = psd_cholesky(Pf)
    chi = sgps.gen_sigma_points(mf, chol_Pf)            # (..., S, d)
    evals = trans.mean(chi, dt)                         # (..., S, d)
    mp, Pdev = sgps.mean_and_cov(evals)
    if trans.const_cov:
        Pp = Pdev + trans.cov_const(dt)
    else:
        covs = trans.cov(chi, dt)                       # (..., S, d, d)
        w = torch.as_tensor(sgps.w, dtype=covs.dtype, device=covs.device)
        Pp = Pdev + torch.einsum("s,...sij->...ij", w, covs)
    return mp, Pp, chi, evals


def cd_sgp_moment_odes(sgps: SigmaPoints, drift, dispersion_const,
                       m: torch.Tensor, P: torch.Tensor):
    """Right-hand side of the continuous-time sigma-point moment ODEs
    ``dm/dt = E[a]``, ``dP/dt = E[(x-m)a^T] + sym + BB^T``, with the drift
    evaluated once over all sigma points (the port's drifts take leading
    batch dims).  ``sgps``' arrays may be host NumPy or tensors."""
    chol_P = psd_cholesky(P)
    chi = sgps.gen_sigma_points(m, chol_P)              # (S, d)
    evals = drift(chi)                                  # (S, d)
    w = sgps._weights(evals)
    mp = torch.einsum("s,sd->d", w, evals)
    cross = torch.einsum("s,si,sj->ij", w, chi - m, evals)
    Pp = cross + cross.T + dispersion_const @ dispersion_const.T
    return mp, Pp


def stack_smoothing_results(mfs, Pfs, mss, Pss):
    """Append the final filtering moments to the backward-smoothed stack."""
    return torch.cat([mss, mfs[-1][None]]), torch.cat([Pss, Pfs[-1][None]])


def _loop_constants(trans, sgps, dt, like: torch.Tensor):
    """What a filter or smoother loop would otherwise rebuild at every step:
    the transition with its state-independent covariance evaluated once
    for this ``dt``, and the rule as tensors of ``like``'s dtype and
    device.  Same values; eager PyTorch pays for each rebuilt constant in
    launches, and for each rule conversion in a host-to-device copy."""
    trans = as_transition(trans)
    if trans.const_cov:
        Q = trans.cov_const(dt)
        trans = dataclasses.replace(trans, cov=lambda _u, _dt: Q)
    return trans, None if sgps is None else sgps.to(like)


def _linearization(trans, dt):
    """An EKF step's ``lin(mf) -> (F, mp)``: the conditional mean at
    ``mf`` and its Jacobian, from the transition's closed form where it
    has one, else by ``torch.func.jacfwd``.  Inside jacfwd's vmap, PyTorch
    promotes a 0-dim float32 tensor times a Python float to float64, so
    ``F`` is cast back to ``mf``'s dtype.  (The closed form also keeps
    forward-mode AD, whose levels are process-wide, out of objectives that
    run on several threads at once.)"""
    mean_fn = lambda u: trans.mean(u, dt)  # noqa: E731
    jac = (lambda u: trans.jac(u, dt)) if trans.jac is not None \
        else torch.func.jacfwd(mean_fn)
    return lambda mf: (jac(mf).to(mf.dtype), mean_fn(mf))


def _drift_jacobian(a):
    """``J(m)``, the Jacobian of the drift ``a`` at ``m``: ``a.jac``, the
    closed form the port's priors attach, else ``torch.func.jacfwd(a)``
    (cast back to ``m``'s dtype, as in :func:`_linearization`).  The
    closed form keeps forward-mode AD out of objectives that run on
    several threads at once."""
    jac = getattr(a, "jac", None) or torch.func.jacfwd(a)
    return lambda m: jac(m).to(m.dtype)


def _as_data(ys: torch.Tensor, m0: torch.Tensor) -> torch.Tensor:
    """Measurements in the filter's dtype (its carry's: ``m0``'s) and on
    its device."""
    return torch.as_tensor(ys).to(dtype=m0.dtype, device=m0.device)
