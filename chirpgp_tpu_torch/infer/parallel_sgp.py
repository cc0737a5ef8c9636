"""Parallel-in-time nonlinear filtering and smoothing: iterated posterior
statistical linearization over the associative-scan Kalman machinery
(counterpart of ``chirpgp_tpu.infer.parallel_sgp``).

Each iteration linearizes the transition statistically about a nominal
posterior at all T steps at once (one batched sigma-point regression),
solves the resulting time-varying affine-Gaussian SSM with the O(log T)
scans of :mod:`chirpgp_tpu_torch.infer.parallel_kf`, and moves the nominal
to the smoothed posterior (IPLS; the parallel form of Yaghoobi et al.
2021).  On a linear model one iteration is the KF/RTS.
"""

from typing import Tuple

import torch

from chirpgp_tpu_torch.infer.common import _as_data, log_normal_pdf
from chirpgp_tpu_torch.infer.parallel_kf import (
    _FilterElement, _SmootherElement, _first_set, _mv, _scan_filter, _smooth)
from chirpgp_tpu_torch.models.transitions import as_transition
from chirpgp_tpu_torch.quad.sigma_points import SigmaPoints
from chirpgp_tpu_torch.utils.numerics import cholesky_or_nan, psd_solve_batched

__all__ = ["kf_parallel_tv", "rts_parallel_tv", "slr_transitions",
           "psgp_filter_smoother"]


def kf_parallel_tv(Fs, cs, Sigmas, H, Xi, m0, P0, ys, block_size=None):
    """Parallel-in-time Kalman filter for the time-varying affine SSM
    ``x_k = F_k x_{k-1} + c_k + q_k``; the contract of ``kf_parallel``.
    Shapes: Fs (T, d, d), cs (T, d), Sigmas (T, d, d), ys (T,)."""
    ys = _as_data(ys, m0)
    T, d = cs.shape
    I = torch.eye(d, dtype=m0.dtype, device=m0.device)

    S = torch.einsum("i,tij,j->t", H, Sigmas, H) + Xi
    K = Sigmas @ H / S[:, None]
    ImKH = I - K[:, :, None] * H[None, None, :]
    resid = ys - cs @ H
    FTH = Fs.transpose(-1, -2) @ H

    m1p = Fs[0] @ m0 + cs[0]
    P1p = Fs[0] @ P0 @ Fs[0].T + Sigmas[0]
    S1 = H @ P1p @ H + Xi
    K1 = P1p @ H / S1
    b1 = m1p + K1 * (ys[0] - H @ m1p)
    C1 = P1p - torch.outer(K1, K1) * S1

    Z = torch.zeros_like(P0)
    elems = _FilterElement(
        A=_first_set(Z, ImKH @ Fs),
        b=_first_set(b1, cs + K * resid[:, None]),
        C=_first_set(C1, ImKH @ Sigmas),
        eta=_first_set(torch.zeros_like(m0), FTH * (resid / S)[:, None]),
        J=_first_set(Z, FTH[:, :, None] * FTH[:, None, :] / S[:, None, None]))
    scanned = _scan_filter(elems, block_size, m0)
    mfs, Pfs = scanned.b, scanned.C

    prev_m = torch.cat([m0[None], mfs[:-1]])
    prev_P = torch.cat([P0[None], Pfs[:-1]])
    mp = _mv(Fs, prev_m) + cs
    Pp = Fs @ prev_P @ Fs.transpose(-1, -2) + Sigmas
    Spred = torch.einsum("i,tij,j->t", H, Pp, H) + Xi
    nll = -log_normal_pdf(ys, mp @ H, Spred)
    return mfs, Pfs, torch.cumsum(nll, 0)


def rts_parallel_tv(Fs, cs, Sigmas, mfs, Pfs, block_size=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallel-in-time RTS smoother for the time-varying affine SSM;
    ``Fs[k]``, ``cs[k]``, ``Sigmas[k]`` map step k-1 to k, as in the
    filter."""
    Pf = Pfs[:-1]
    mf = mfs[:-1]
    Fn = Fs[1:]
    Pp = Fn @ Pf @ Fn.transpose(-1, -2) + Sigmas[1:]
    E = psd_solve_batched(Pp, Fn @ Pf).transpose(-1, -2)
    g = mf - _mv(E, _mv(Fn, mf) + cs[1:])
    L = Pf - E @ Pp @ E.transpose(-1, -2)
    return _smooth(_SmootherElement(E, g, L), mfs, Pfs, block_size)


def slr_transitions(trans, sgps: SigmaPoints, dt, ms, Ps, jitter=0.0):
    """Statistical linear regression of the transition about T nominal
    Gaussians at once: ``(Fs, cs, Lams)`` with ``x_k ~ N(F_k x_{k-1} + c_k,
    Lam_k)`` the best affine-Gaussian fit at ``N(ms[k], Ps[k])``.  One
    batched sigma-point evaluation over all T steps."""
    trans = as_transition(trans)
    d = ms.shape[-1]
    Pj = Ps + jitter * torch.eye(d, dtype=Ps.dtype, device=Ps.device)
    chi = sgps.gen_sigma_points(ms, cholesky_or_nan(Pj))   # (T, S, d)
    evals = trans.mean(chi, dt)                            # (T, S, d)
    w = sgps._weights(evals)
    mp = torch.einsum("s,tsd->td", w, evals)
    dev_in = chi - ms[:, None, :]
    dev_out = evals - mp[:, None, :]
    D = torch.einsum("s,tsi,tsj->tij", w, dev_in, dev_out)  # Cov[x, f(x)]
    Pout = torch.einsum("s,tsi,tsj->tij", w, dev_out, dev_out)
    Fs = psd_solve_batched(Pj, D).transpose(-1, -2)         # D^T P^{-1}
    cs = mp - _mv(Fs, ms)
    resid = Pout - Fs @ D
    if trans.const_cov:
        Q = trans.cov_const(dt)
    else:
        Q = torch.einsum("s,tsij->tij", w, trans.cov(chi, dt))
    Lams = resid + Q.to(resid)
    # Symmetrize the regression residual (the solve leaves a tiny skew).
    return Fs, cs, 0.5 * (Lams + Lams.transpose(-1, -2))


def psgp_filter_smoother(cond_m_cov, sgps: SigmaPoints, H, Xi, m0, P0, dt,
                         ys, num_iters: int = 8, block_size=None,
                         init_nominal=None):
    """Iterated parallel sigma-point filter and smoother.

    Each iteration: the statistical linearization of the transition about
    the current nominal at all T steps, then the parallel filter and
    smoother on the affine SSM it gives.  The nominal for the transition
    into step k is the posterior at step k-1: the prior, or
    ``init_nominal = (ms (T, d), Ps (T, d, d))`` (a data-informed warm start
    with the same alignment), then the smoothed trajectory shifted right
    by one.  Returns the last iteration's ``(mfs, Pfs, nll, mss, Pss)``.
    """
    trans = as_transition(cond_m_cov)
    ys = _as_data(ys, m0)
    T = ys.shape[0]
    d = m0.shape[0]
    rule = sgps.to(m0)
    if init_nominal is not None:
        ms_nom, Ps_nom = (_as_data(x, m0) for x in init_nominal)
    else:
        ms_nom = m0.expand(T, d)
        Ps_nom = P0.expand(T, d, d)
    out = None
    for _ in range(num_iters):
        Fs, cs, Lams = slr_transitions(trans, rule, dt, ms_nom, Ps_nom)
        mfs, Pfs, nll = kf_parallel_tv(Fs, cs, Lams, H, Xi, m0, P0, ys,
                                       block_size)
        mss, Pss = rts_parallel_tv(Fs, cs, Lams, mfs, Pfs, block_size)
        ms_nom = torch.cat([m0[None], mss[:-1]])
        Ps_nom = torch.cat([P0[None], Pss[:-1]])
        out = (mfs, Pfs, nll, mss, Pss)
    return out
