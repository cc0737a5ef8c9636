"""Backward Gaussian smoothers matching ``chirpgp_tpu_torch.infer.filters``
(counterpart of ``chirpgp_tpu.infer.smoothers``), discrete-time and
continuous-discrete.

All return ``(mss, Pss)`` over the full sequence, the final filter moments
appended.
"""

from typing import Callable, Tuple

import torch

from chirpgp_tpu_torch.infer.common import (
    _drift_jacobian, _linearization, _loop_constants, cd_sgp_moment_odes,
    gaussian_smoother_step, sgp_prediction, stack_smoothing_results)
from chirpgp_tpu_torch.quad.integrators import rk4_m_cov_backward
from chirpgp_tpu_torch.quad.sigma_points import SigmaPoints
from chirpgp_tpu_torch.utils.numerics import (
    psd_cholesky, psd_solve, psd_solve_factored)

__all__ = ["rts", "eks", "sgp_smoother", "cd_eks", "cd_sgp_smoother"]

SmootherResult = Tuple[torch.Tensor, torch.Tensor]


def _run_smoother(step_fn, mfs, Pfs) -> SmootherResult:
    """Common reverse loop over the filtering results (covariances or
    factors); ``step_fn`` has the JAX scan body's form
    ``(carry, (mf, Pf)) -> (carry, (ms, Ps))``."""
    carry = (mfs[-1], Pfs[-1])
    mss, Pss = [], []
    for t in range(mfs.shape[0] - 2, -1, -1):
        carry, (ms, Ps) = step_fn(carry, (mfs[t], Pfs[t]))
        mss.append(ms)
        Pss.append(Ps)
    if not mss:
        return mfs, Pfs
    return stack_smoothing_results(mfs, Pfs, torch.stack(mss[::-1]),
                                   torch.stack(Pss[::-1]))


def rts(F: torch.Tensor, Sigma: torch.Tensor,
        mfs: torch.Tensor, Pfs: torch.Tensor) -> SmootherResult:
    """RTS smoother for LGSSMs."""

    def step(carry, elem):
        ms, Ps = carry
        mf, Pf = elem
        ms, Ps = gaussian_smoother_step(
            F @ Pf, mf, Pf, F @ mf, F @ Pf @ F.T + Sigma, ms, Ps)
        return (ms, Ps), (ms, Ps)

    return _run_smoother(step, mfs, Pfs)


def eks(cond_m_cov, mfs: torch.Tensor, Pfs: torch.Tensor,
        dt) -> SmootherResult:
    """Extended Kalman smoother (Jacobians by ``torch.func.jacfwd``)."""
    trans, _ = _loop_constants(cond_m_cov, None, dt, mfs)
    lin = _linearization(trans, dt)

    def step(carry, elem):
        ms, Ps = carry
        mf, Pf = elem
        F, mp = lin(mf)
        Sigma = trans.cov_const(dt) if trans.const_cov else trans.cov(mf, dt)
        Pp = F @ Pf @ F.T + Sigma
        ms, Ps = gaussian_smoother_step(F @ Pf, mf, Pf, mp, Pp, ms, Ps)
        return (ms, Ps), (ms, Ps)

    return _run_smoother(step, mfs, Pfs)


def sgp_smoother(cond_m_cov, sgps: SigmaPoints, mfs: torch.Tensor,
                 Pfs: torch.Tensor, dt) -> SmootherResult:
    """Sigma-point smoother: the prediction is recomputed per backward
    step; the cross-covariance uses the centered sigma-point reduction."""
    trans, rule = _loop_constants(cond_m_cov, sgps, dt, mfs)

    def step(carry, elem):
        ms, Ps = carry
        mf, Pf = elem
        mp, Pp, chi, evals = sgp_prediction(rule, trans, dt, mf, Pf)
        D = rule.cross_cov(chi, evals, mf, mp)
        ms, Ps = gaussian_smoother_step(D.T, mf, Pf, mp, Pp, ms, Ps)
        return (ms, Ps), (ms, Ps)

    return _run_smoother(step, mfs, Pfs)


def cd_eks(a: Callable, b: Callable, mfs: torch.Tensor, Pfs: torch.Tensor,
           dt) -> SmootherResult:
    """Continuous-discrete EKS: one backward RK4 step (``-dt``) per
    interval of the smoothing ODEs, conditioned on the filter's moments.
    The Jacobian is ``a.jac`` where the drift has one, else
    ``torch.func.jacfwd``; ``Pf`` is factored once per step for the
    stages' solves."""
    neg_dt = -dt
    jac = _drift_jacobian(a)

    def step(carry, elem):
        ms, Ps = carry
        mf, Pf = elem
        Lf = psd_cholesky(Pf)

        def odes(m, P, mf, _Pf):
            B = b(m)
            gamma = B @ B.T
            J_plus = jac(m) + psd_solve_factored(Lf, gamma.T).T
            dm = a(m) + gamma @ psd_solve_factored(Lf, m - mf)
            dP = J_plus @ P + P @ J_plus.T - gamma
            return dm, dP

        ms, Ps = rk4_m_cov_backward(odes, ms, Ps, mf, Pf, neg_dt)
        return (ms, Ps), (ms, Ps)

    return _run_smoother(step, mfs, Pfs)


def cd_sgp_smoother(a: Callable, b: torch.Tensor, sgps: SigmaPoints,
                    mfs: torch.Tensor, Pfs: torch.Tensor,
                    dt) -> SmootherResult:
    """Continuous-discrete sigma-point smoother: one backward RK4 step
    (``-dt``) per interval of the smoothing ODEs with the constant
    dispersion matrix ``b``.  ``G = Pf^{-1} b b^T`` is the same in the four
    stages of a step, so it is solved once per step."""
    neg_dt = -dt
    rule = sgps.to(mfs)
    gamma = b @ b.T

    def step(carry, elem):
        ms, Ps = carry
        mf, Pf = elem
        G = psd_solve(Pf, gamma)

        def odes(m, P, mf, _Pf):
            _m, _P = cd_sgp_moment_odes(rule, a, b, m, P)
            return _m + G.T @ (m - mf), _P + G.T @ P + P @ G - 2.0 * gamma

        ms, Ps = rk4_m_cov_backward(odes, ms, Ps, mf, Pf, neg_dt)
        return (ms, Ps), (ms, Ps)

    return _run_smoother(step, mfs, Pfs)
