"""Sequential Gaussian filters, discrete-time and continuous-discrete
(counterpart of ``chirpgp_tpu.infer.filters``).

Each filter is a Python loop over the measurement sequence that
accumulates the negative filter-marginal log-likelihood, and returns
``(mfs (T, d), Pfs (T, d, d), nll (T,) cumulative)``.  The loops compute
in ``m0``'s dtype on ``m0``'s device and are differentiable with
``torch.autograd``.
"""

from typing import Callable, Tuple

import torch

from chirpgp_tpu_torch.infer.common import (
    _as_data, _drift_jacobian, _linearization, _loop_constants,
    cd_sgp_moment_odes, linear_predict, linear_update, log_normal_pdf,
    sgp_prediction)
from chirpgp_tpu_torch.quad.integrators import rk4_m_cov
from chirpgp_tpu_torch.quad.sigma_points import SigmaPoints

__all__ = ["kf", "ekf", "ekf_for_kpt", "sgp_filter", "cd_ekf",
           "cd_sgp_filter"]

FilterResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _run_filter(predict, m0, P0, H, Xi, ys,
                remat: bool = False, unroll: int = 1) -> FilterResult:
    """Common loop: predict -> 1-D linear update -> accumulate NLL.

    ``remat`` and ``unroll`` are the JAX scan's knobs (step checkpointing
    for reverse mode, steps per loop iteration); they are accepted for the
    same signature and have no effect on a Python loop.
    """
    ys = _as_data(ys, m0)
    mf, Pf, n_ell = m0, P0, m0.new_zeros(())
    mfs, Pfs, nlls = [], [], []
    for y in ys:
        mp, Pp = predict(mf, Pf)
        mf, Pf, inc = linear_update(mp, Pp, H, Xi, y)
        n_ell = n_ell + inc
        mfs.append(mf)
        Pfs.append(Pf)
        nlls.append(n_ell)
    return torch.stack(mfs), torch.stack(Pfs), torch.stack(nlls)


def kf(F: torch.Tensor, Sigma: torch.Tensor, H: torch.Tensor, Xi,
       m0: torch.Tensor, P0: torch.Tensor, ys: torch.Tensor) -> FilterResult:
    """Kalman filter for LGSSMs with 1-D measurements."""
    return _run_filter(lambda m, P: linear_predict(F, Sigma, m, P),
                       m0, P0, H, Xi, ys)


def ekf(cond_m_cov, H: torch.Tensor, Xi, m0: torch.Tensor, P0: torch.Tensor,
        dt, ys: torch.Tensor) -> FilterResult:
    """Extended Kalman filter: discretize-then-linearize, with the
    Jacobian of the conditional mean from ``torch.func.jacfwd``."""
    trans, _ = _loop_constants(cond_m_cov, None, dt, m0)
    lin = _linearization(trans, dt)

    def predict(mf, Pf):
        F, mp = lin(mf)
        Sigma = trans.cov_const(dt) if trans.const_cov else trans.cov(mf, dt)
        return mp, F @ Pf @ F.T + Sigma

    return _run_filter(predict, m0, P0, H, Xi, ys)


def ekf_for_kpt(F: torch.Tensor, Sigma: torch.Tensor, h: Callable, Xi,
                m0: torch.Tensor, P0: torch.Tensor, dt,
                ys: torch.Tensor) -> FilterResult:
    """EKF with linear dynamics and a nonlinear scalar measurement ``h``
    (the KPT model): linear predict, then the update linearized at the
    prediction.  The measurement's gradient is ``h.jac`` where ``h`` has
    one, else ``torch.func.jacfwd(h)``.  ``dt`` is carried for the JAX
    package's signature; the dynamics are already discrete."""
    jac = getattr(h, "jac", None) or torch.func.jacfwd(h)
    ys = _as_data(ys, m0)
    mf, Pf, n_ell = m0, P0, m0.new_zeros(())
    mfs, Pfs, nlls = [], [], []
    for y in ys:
        mp, Pp = linear_predict(F, Sigma, mf, Pf)
        H = jac(mp).to(mp.dtype)
        S = H @ Pp @ H + Xi
        K = Pp @ H / S
        pred = h(mp)
        mf = mp + K * (y - pred)
        Pf = Pp - torch.outer(K, K) * S
        n_ell = n_ell - log_normal_pdf(y, pred, S)
        mfs.append(mf)
        Pfs.append(Pf)
        nlls.append(n_ell)
    return torch.stack(mfs), torch.stack(Pfs), torch.stack(nlls)


def sgp_filter(cond_m_cov, sgps: SigmaPoints, H: torch.Tensor, Xi,
               m0: torch.Tensor, P0: torch.Tensor, dt,
               ys: torch.Tensor) -> FilterResult:
    """Sigma-point Gaussian filter through a discretized SDE."""
    trans, rule = _loop_constants(cond_m_cov, sgps, dt, m0)

    def predict(mf, Pf):
        mp, Pp, _, _ = sgp_prediction(rule, trans, dt, mf, Pf)
        return mp, Pp

    return _run_filter(predict, m0, P0, H, Xi, ys)


def cd_ekf(a: Callable, b: Callable, H: torch.Tensor, Xi, m0: torch.Tensor,
           P0: torch.Tensor, dt, ys: torch.Tensor, remat: bool = False,
           unroll: int = 1) -> FilterResult:
    """Continuous-discrete EKF: one RK4 step per interval of the linearized
    moment ODEs ``m' = a(m)``, ``P' = P J^T + J P + b(m) b(m)^T``, with
    ``J = a.jac(m)`` where the drift has one, else ``torch.func.jacfwd``."""
    jac = _drift_jacobian(a)

    def odes(m, P):
        J = jac(m)
        B = b(m)
        return a(m), P @ J.T + J @ P + B @ B.T

    return _run_filter(lambda m, P: rk4_m_cov(odes, m, P, dt),
                       m0, P0, H, Xi, ys, remat=remat, unroll=unroll)


def cd_sgp_filter(a: Callable, b: torch.Tensor, sgps: SigmaPoints,
                  H: torch.Tensor, Xi, m0: torch.Tensor, P0: torch.Tensor,
                  dt, ys: torch.Tensor, remat: bool = False,
                  unroll: int = 1) -> FilterResult:
    """Continuous-discrete sigma-point filter: one RK4 step per interval of
    the sigma-point moment ODEs with the constant dispersion matrix ``b``;
    the drift ``a`` is evaluated over all sigma points at once."""
    rule = sgps.to(m0)

    def odes(m, P):
        return cd_sgp_moment_odes(rule, a, b, m, P)

    return _run_filter(lambda m, P: rk4_m_cov(odes, m, P, dt),
                       m0, P0, H, Xi, ys, remat=remat, unroll=unroll)
