"""Square-root (Cholesky-factor) filters and smoothers (counterpart of
``chirpgp_tpu.infer.sqrt``).

Every covariance is carried as a triangular factor and every update is a
triangularization, so no near-equal PSD matrices are subtracted:

- predict:  tria([sqrt(w_i) (mu_i - mp); Lq^T]) -> Up with Up^T Up = Pp
- update:   tria([[sqrt(Xi), 0]; [Up H^T, Up]]) -> [[sqrt(S), (K sqrt(S))^T];
            [0, Uf]]
- smooth:   tria([sqrt(w_i)(mu_i - mp), sqrt(w_i)(chi_i - mf); [Lq^T, 0]])
            -> R11, gain G = (R11^{-1} R12)^T, and R22 with
            R22^T R22 = Pf - G Pp G^T; then Ps = G Ps' G^T + R22^T R22.

Requires nonnegative sigma-point weights.  Returns ``(mfs, Lfs, nll)`` /
``(mss, Lss)`` with ``L`` lower triangular (up to column signs).  The
loops compute in ``m0``'s dtype on its device and are differentiable.
"""

from typing import Tuple

import numpy as np
import torch

from chirpgp_tpu_torch.infer.common import (
    _as_data, _linearization, _loop_constants, log_normal_pdf)
from chirpgp_tpu_torch.infer.smoothers import _run_smoother
from chirpgp_tpu_torch.quad.sigma_points import SigmaPoints
from chirpgp_tpu_torch.utils.numerics import cholesky_or_nan, psd_cholesky

__all__ = ["tria", "sqrt_sgp_filter", "sqrt_sgp_smoother", "sqrt_ekf",
           "sqrt_eks", "sqrt_kf"]


def _require_nonneg_weights(sgps: SigmaPoints, where: str):
    """Sqrt forms take sqrt(w): negative weights (default unscented rule)
    would silently produce NaNs."""
    if np.any(np.asarray(sgps.w) < 0) or (
            sgps.wc is not None and np.any(np.asarray(sgps.wc) < 0)):
        raise ValueError(
            f"{where} requires nonnegative sigma-point weights "
            "(use cubature or gauss_hermite; the default unscented rule "
            "has a negative center weight -- use the covariance form, or "
            "unscented(d, kappa=0)).")


def _tria_householder(M: torch.Tensor) -> torch.Tensor:
    """Upper-triangular factor of ``M (..., n, d)``, n >= d, by d explicit
    Householder reflections (sign rule ``x_j >= 0 -> alpha = -|x|``;
    reflections with ``|v|^2 <= 1e-30`` skipped).

    Differentiable: nothing autograd saved is written in place.  Row j of
    R is final after reflection j, so each step keeps that row and carries
    only the trailing block to the next."""
    d = M.shape[-1]
    rows = []
    sub = M
    for j in range(d):
        x = sub[..., :, 0]                                  # (..., n-j)
        normx = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        alpha = torch.where(x[..., :1] >= 0, -normx, normx)
        v = torch.cat([x[..., :1] - alpha, x[..., 1:]], dim=-1)
        vnorm2 = torch.sum(v * v, dim=-1, keepdim=True)
        ok = vnorm2 > 1e-30
        beta = torch.where(ok, 2.0 / torch.where(ok, vnorm2, 1.0), 0.0)
        w = torch.einsum("...n,...nd->...d", v, sub)        # v^T sub
        sub = sub - beta[..., None] * v[..., :, None] * w[..., None, :]
        rows.append(torch.cat(
            [sub.new_zeros(sub.shape[:-2] + (j,)), sub[..., 0, :]], dim=-1))
        sub = sub[..., 1:, 1:]
    return torch.stack(rows, dim=-2)


def tria(M: torch.Tensor, method: str = "hh") -> torch.Tensor:
    """Upper-triangular factor R with ``R^T R = M^T M`` for tall ``M`` of
    shape (..., n, d).

    - ``"hh"`` (default): explicit unrolled Householder reflections;
    - ``"qr"``: the library's Householder QR, as a cross-check;
    - ``"chol"``: ``R = chol(M^T M)^T`` with column equilibration.  The
      Gram squares the condition number: float32 breaks on the chirp
      smoother, so use it in float64 or on well-conditioned pre-arrays.
    """
    if method == "qr":
        return torch.linalg.qr(M, mode="reduced")[1]
    if method == "hh":
        return _tria_householder(M)
    if method != "chol":
        raise ValueError(f"Unknown tria method {method!r}")
    # Columns span ~6 orders of magnitude on the chirp models; scale them
    # to unit norm first (chol(D A D) = D chol(A) for diagonal D).
    c = torch.sqrt(torch.sum(M * M, dim=-2, keepdim=True))      # (..., 1, d)
    c = torch.where(c > 0, c, 1.0)
    Mh = M / c
    gram = torch.einsum("...nd,...ne->...de", Mh, Mh)
    L = torch.linalg.cholesky(gram)
    return L.transpose(-1, -2) * c


def _chol_to_lower(R: torch.Tensor) -> torch.Tensor:
    """R upper (R^T R = P) -> lower factor L = R^T (L L^T = P)."""
    return R.transpose(-1, -2)


def _const_factor(trans, dt, like: torch.Tensor):
    """``psd_cholesky`` of a state-independent transition covariance,
    computed once for a loop; None for a state-dependent one."""
    if not trans.const_cov:
        return None
    return psd_cholesky(trans.cov_const(dt)).to(like.dtype)


def _sqrt_predict_sgp(sgps: SigmaPoints, trans, dt,
                      mf: torch.Tensor, Lf: torch.Tensor,
                      tria_method: str = "hh", Lq=None):
    """Sigma-point prediction in sqrt form.  Returns (mp, Up, chi, evals)
    with Up upper-triangular, Up^T Up = Pp.  ``Lq``: the transition
    covariance's factor when the caller has it already (const_cov)."""
    chi = sgps.gen_sigma_points(mf, Lf)                     # (S, d)
    evals = trans.mean(chi, dt)                             # (S, d)
    w = torch.as_tensor(sgps.w, dtype=evals.dtype, device=evals.device)
    mp = torch.einsum("s,sd->d", w, evals)
    dev = torch.sqrt(w)[:, None] * (evals - mp)             # (S, d)
    if Lq is None:
        Lq = psd_cholesky(trans.cov_const(dt)) if trans.const_cov \
            else psd_cholesky(torch.einsum("s,sij->ij", w, trans.cov(chi, dt)))
    Lq = Lq.to(evals.dtype)
    Up = tria(torch.cat([dev, Lq.T], dim=0), tria_method)
    return mp, Up, chi, evals


def _sqrt_update_1d(mp: torch.Tensor, Up: torch.Tensor, H: torch.Tensor,
                    sqrt_Xi, y, tria_method: str = "hh"):
    """1-D-measurement square-root update via one triangularization of
    the (1+d) x (1+d) pre-array ``[[sqrt(Xi), 0], [Up H^T, Up]]`` ->
    ``[[sqrt(S), w^T], [0, Uf]]`` with ``w = K sqrt(S)``."""
    d = mp.shape[-1]
    UpHT = Up @ H                                            # (d,)
    top = torch.cat([sqrt_Xi.reshape(1), mp.new_zeros((d,))])[None, :]
    bottom = torch.cat([UpHT[:, None], Up], dim=1)
    R = tria(torch.cat([top, bottom], dim=0), tria_method)
    sqrt_S = R[0, 0]
    w = R[0, 1:]                                             # K sqrt(S)
    Uf = R[1:, 1:]
    pred = H @ mp
    mf = mp + w * ((y - pred) / sqrt_S)
    nll_inc = -log_normal_pdf(y, pred, sqrt_S ** 2)
    return mf, Uf, nll_inc


def _run_sqrt_filter(predict, H, Xi, m0, P0, ys, tria_method="hh"):
    """Common loop of the sqrt filters: ``predict(mf, Lf) -> (mp, Up)``,
    then the 1-D sqrt update."""
    ys = _as_data(ys, m0)
    sqrt_Xi = torch.sqrt(torch.as_tensor(Xi, dtype=m0.dtype, device=m0.device))
    mf, Lf, n_ell = m0, cholesky_or_nan(P0), m0.new_zeros(())
    mfs, Lfs, nlls = [], [], []
    for y in ys:
        mp, Up = predict(mf, Lf)
        mf, Uf, inc = _sqrt_update_1d(mp, Up, H, sqrt_Xi, y, tria_method)
        Lf = _chol_to_lower(Uf)
        n_ell = n_ell + inc
        mfs.append(mf)
        Lfs.append(Lf)
        nlls.append(n_ell)
    return torch.stack(mfs), torch.stack(Lfs), torch.stack(nlls)


def _sqrt_smoother_step(dev_pred, dev_prev, Lq, mf, mp, ms, Ls,
                        tria_method="hh"):
    """Joint triangularization ``R^T R = [[Pp, D^T], [D, Pf]]`` of
    ``[[dev_pred, dev_prev], [Lq^T, 0]]``, the gain ``G = (R11^{-1}
    R12)^T``, and the smoothed mean and factor."""
    d = mf.shape[-1]
    M = torch.cat([
        torch.cat([dev_pred, dev_prev], dim=1),
        torch.cat([Lq.T, Lq.new_zeros((d, d))], dim=1),
    ], dim=0)
    R = tria(M, tria_method)                                 # (2d, 2d)
    R11, R12, R22 = R[:d, :d], R[:d, d:], R[d:, d:]
    G = torch.linalg.solve_triangular(R11, R12, upper=True).T
    ms = mf + G @ (ms - mp)
    Ls = _chol_to_lower(
        tria(torch.cat([(G @ Ls).T, R22], dim=0), tria_method))
    return ms, Ls


def sqrt_sgp_filter(cond_m_cov, sgps: SigmaPoints, H: torch.Tensor, Xi,
                    m0: torch.Tensor, P0: torch.Tensor, dt,
                    ys: torch.Tensor,
                    tria_method: str = "hh",
                    remat: bool = True,
                    unroll: int = 1) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Square-root sigma-point filter: the counterpart of
    :func:`chirpgp_tpu_torch.infer.filters.sgp_filter` returning Cholesky
    factors ``Lfs`` instead of covariances.  ``remat`` and ``unroll`` are
    the JAX scan's knobs, accepted and without effect on a Python loop."""
    _require_nonneg_weights(sgps, "sqrt_sgp_filter")
    trans, rule = _loop_constants(cond_m_cov, sgps, dt, m0)
    Lq = _const_factor(trans, dt, m0)

    def predict(mf, Lf):
        mp, Up, _, _ = _sqrt_predict_sgp(rule, trans, dt, mf, Lf,
                                         tria_method, Lq)
        return mp, Up

    return _run_sqrt_filter(predict, H, Xi, m0, P0, ys, tria_method)


def sqrt_sgp_smoother(cond_m_cov, sgps: SigmaPoints, mfs: torch.Tensor,
                      Lfs: torch.Tensor, dt,
                      tria_method: str = "hh") -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Square-root sigma-point RTS smoother over the sqrt filter's
    ``(mfs, Lfs)``."""
    _require_nonneg_weights(sgps, "sqrt_sgp_smoother")
    trans, rule = _loop_constants(cond_m_cov, sgps, dt, mfs)
    Lq_const = _const_factor(trans, dt, mfs)
    w = torch.as_tensor(rule.w, dtype=mfs.dtype, device=mfs.device)
    sw = torch.sqrt(w)[:, None]

    def step(carry, elem):
        mf, Lf = elem
        chi = rule.gen_sigma_points(mf, Lf)
        evals = trans.mean(chi, dt)
        mp = torch.einsum("s,sd->d", w, evals)
        Lq = Lq_const if Lq_const is not None else psd_cholesky(
            torch.einsum("s,sij->ij", w, trans.cov(chi, dt))).to(mfs.dtype)
        out = _sqrt_smoother_step(sw * (evals - mp), sw * (chi - mf), Lq,
                                  mf, mp, *carry, tria_method)
        return out, out

    return _run_smoother(step, mfs, Lfs)


def sqrt_kf(F: torch.Tensor, Sigma: torch.Tensor, H: torch.Tensor, Xi,
            m0: torch.Tensor, P0: torch.Tensor, ys: torch.Tensor):
    """Square-root Kalman filter for LGSSMs: predict by
    ``tria([Lf^T F^T; Lq^T])``, update by the shared 1-D sqrt update."""
    Lq = psd_cholesky(Sigma)

    def predict(mf, Lf):
        return F @ mf, tria(torch.cat([(F @ Lf).T, Lq.T], dim=0))

    return _run_sqrt_filter(predict, H, Xi, m0, P0, ys)


def _linearized(cond_m_cov, dt, like):
    """An EKF's per-step linearization: ``lin(mf) -> (F, mp, Lq)``."""
    trans, _ = _loop_constants(cond_m_cov, None, dt, like)
    Lq_const = _const_factor(trans, dt, like)
    mean_and_jac = _linearization(trans, dt)

    def lin(mf):
        Lq = Lq_const if Lq_const is not None else \
            psd_cholesky(trans.cov(mf, dt)).to(mf.dtype)
        return mean_and_jac(mf) + (Lq,)

    return lin


def sqrt_ekf(cond_m_cov, H: torch.Tensor, Xi, m0: torch.Tensor,
             P0: torch.Tensor, dt, ys: torch.Tensor, unroll: int = 1):
    """Square-root EKF: linearize the discretized mean map, triangularize
    ``[Lf^T F^T; Lq^T]``.  ``unroll`` has no effect on a Python loop."""
    lin = _linearized(cond_m_cov, dt, m0)

    def predict(mf, Lf):
        F, mp, Lq = lin(mf)
        return mp, tria(torch.cat([(F @ Lf).T, Lq.T], dim=0))

    return _run_sqrt_filter(predict, H, Xi, m0, P0, ys)


def sqrt_eks(cond_m_cov, mfs: torch.Tensor, Lfs: torch.Tensor,
             dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """Square-root extended Kalman smoother."""
    lin = _linearized(cond_m_cov, dt, mfs)

    def step(carry, elem):
        mf, Lf = elem
        F, mp, Lq = lin(mf)
        out = _sqrt_smoother_step((F @ Lf).T, Lf.T, Lq, mf, mp, *carry)
        return out, out

    return _run_smoother(step, mfs, Lfs)
