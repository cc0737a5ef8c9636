"""Batched channels-first square-root filter and smoother -- the
Monte-Carlo path (counterpart of ``chirpgp_tpu.infer.batched``).

The Monte-Carlo batch is the LAST axis: states ``(d, B)``, factors
``(d, d, B)``, sigma tensors ``(S, d, B)``; outputs are ``(T, rows, B)``.
The math is the JAX package's: sigma-point prediction, Householder
triangularization with explicit reflections, 1-D QR measurement update,
joint-factor smoother gain.  The JAX ``lax.scan``s are Python loops; on
the GPU each step launches tens of small kernels, so these loops are
launch-bound.  They are the plain versions the hand-written kernels in
``chirpgp_tpu_torch.ops`` are held against.
"""

import math
from typing import Tuple

import numpy as np
import torch

from chirpgp_tpu_torch.infer.sqrt import _require_nonneg_weights
from chirpgp_tpu_torch.models.transitions import Transition, as_transition
from chirpgp_tpu_torch.quad.sigma_points import SigmaPoints
from chirpgp_tpu_torch.utils.numerics import psd_cholesky

__all__ = ["tria_cf", "sqrt_sgp_filter_batched", "sqrt_sgp_smoother_batched",
           "gaussian_expectation_batched"]

_LOG_2PI = math.log(2.0 * math.pi)


def tria_cf(M: torch.Tensor) -> torch.Tensor:
    """Channels-first Householder triangularization.

    ``M``: (n, d, B) -> upper R (d, d, B) with ``R^T R = M^T M`` per lane.
    Sign convention ``x_j >= 0 -> alpha = -|x|``; reflections with
    ``|v|^2 <= 1e-30`` are skipped.
    """
    d = M.shape[1]
    for j in range(d):
        x = M[j:, j, :]                                   # (n-j, B)
        norm = torch.sqrt(torch.sum(x * x, dim=0, keepdim=True))
        alpha = torch.where(x[:1] >= 0, -norm, norm)      # (1, B)
        v = torch.cat([x[:1] - alpha, x[1:]])
        vn2 = torch.sum(v * v, dim=0, keepdim=True)
        ok = vn2 > 1e-30
        beta = torch.where(ok, 2.0 / torch.where(ok, vn2, 1.0), 0.0)
        sub = M[j:, j:, :]                                # (n-j, d-j, B)
        wv = (v[:, None, :] * sub).sum(0)                 # (d-j, B)
        sub = sub - beta[None] * v[:, None, :] * wv[None]
        # In-place write on a fresh tensor: the j == 0 step makes M a new
        # tensor (``sub``), and later steps write their block into it, so
        # the caller's M is never modified.
        if j == 0:
            M = sub
        else:
            M[j:, j:, :] = sub
    return torch.triu(M[:d].movedim(-1, 0)).movedim(0, -1)


def _rule_tensors(sgps: SigmaPoints, like: torch.Tensor):
    """The rule's ``xi (S, d)``, ``w (S,)`` and ``sqrt(w)`` as tensors with
    the dtype and device of ``like``."""
    xi = torch.as_tensor(sgps.xi, dtype=like.dtype, device=like.device)
    w = torch.as_tensor(sgps.w, dtype=like.dtype, device=like.device)
    return xi, w, torch.sqrt(w)


def _predict_cf(trans: Transition, rule, dt, m, L, LqT):
    """Sigma-point sqrt prediction, channels-first.

    ``rule`` is ``_rule_tensors``'s ``(xi, w, sw)``; m (d, B), L (d, d, B)
    lower.  Returns mp (d, B), Up (d, d, B) upper, and the sigma points,
    propagated points and deviations for smoother reuse.
    """
    xi, w, sw = rule
    chi = m[None] + torch.einsum("sj,ijb->sib", xi, L)    # (S, d, B)
    mu = trans.mean_channels_first(chi, dt)               # (S, d, B)
    mp = torch.einsum("s,sib->ib", w, mu)
    dev = sw[:, None, None] * (mu - mp[None])             # (S, d, B)
    Up = tria_cf(torch.cat([dev, LqT], dim=0))
    return mp, Up, chi, mu, dev


def _update_cf(mp, Up, h_idx: int, sqrt_Xi, y):
    """1-D measurement update, channels-first, for a one-hot measurement
    vector selecting state component ``h_idx``.

    y: (B,).  Returns mf (d, B), Lf (d, d, B) lower, nll increment (B,).
    """
    d, B = mp.shape
    UpH = Up[:, h_idx, :]                                 # (d, B)
    top = torch.cat([sqrt_Xi.expand(1, 1, B), mp.new_zeros((1, d, B))], dim=1)
    bottom = torch.cat([UpH[:, None, :], Up], dim=1)
    R = tria_cf(torch.cat([top, bottom], dim=0))          # (1+d, 1+d, B)
    sS = R[0, 0, :]                                       # (B,)
    wg = R[0, 1:, :]                                      # (d, B)
    Uf = R[1:, 1:, :]
    innov = y - mp[h_idx]
    mf = mp + wg * (innov / sS)[None]
    Lf = Uf.transpose(0, 1)                               # lower
    nll_inc = 0.5 * (_LOG_2PI + torch.log(sS * sS) + innov ** 2 / (sS * sS))
    return mf, Lf, nll_inc


def _one_hot_index(H) -> int:
    h = H.detach().cpu().numpy() if isinstance(H, torch.Tensor) \
        else np.asarray(H)
    nz = np.nonzero(h)[0]
    if len(nz) != 1 or abs(h[nz[0]] - 1.0) > 0:
        raise ValueError(
            "batched kernels require a one-hot measurement vector H "
            f"(got {h}); use the unbatched filters for general H.")
    return int(nz[0])


def sqrt_sgp_filter_batched(cond_m_cov, sgps: SigmaPoints, H, Xi,
                            m0, P0, dt, yss: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Batched sqrt sigma-point filter.

    ``yss``: (B, T) measurement sequences; the model constants are cast to
    its dtype and moved to its device.  Returns mfs (T, d, B),
    Lfs (T, d, d, B) lower, nll (T, B) cumulative.
    """
    _require_nonneg_weights(sgps, "sqrt_sgp_filter_batched")
    trans = as_transition(cond_m_cov)
    h_idx = _one_hot_index(H)
    B, T = yss.shape
    like = dict(dtype=yss.dtype, device=yss.device)
    d = m0.shape[-1]

    rule = _rule_tensors(sgps, yss)
    sqrt_Xi = torch.sqrt(torch.as_tensor(Xi, **like))
    Lq = psd_cholesky(trans.cov_const(dt)).to(**like)
    LqT = Lq.T[:, :, None].expand(d, d, B)
    m = m0.to(**like)[:, None].expand(d, B)
    L = torch.linalg.cholesky(P0).to(**like)[:, :, None].expand(d, d, B)
    nll = yss.new_zeros((B,))

    ys_t = yss.T                                          # (T, B)
    mfs = yss.new_empty((T, d, B))
    Lfs = yss.new_empty((T, d, d, B))
    nlls = yss.new_empty((T, B))
    for t in range(T):
        mp, Up, _, _, _ = _predict_cf(trans, rule, dt, m, L, LqT)
        m, L, inc = _update_cf(mp, Up, h_idx, sqrt_Xi, ys_t[t])
        nll = nll + inc
        mfs[t], Lfs[t], nlls[t] = m, L, nll
    return mfs, Lfs, nlls


def sqrt_sgp_smoother_batched(cond_m_cov, sgps: SigmaPoints,
                              mfs: torch.Tensor, Lfs: torch.Tensor,
                              dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched sqrt sigma-point smoother over the batched filter output.

    Returns mss (T, d, B), Lss (T, d, d, B) lower.
    """
    _require_nonneg_weights(sgps, "sqrt_sgp_smoother_batched")
    trans = as_transition(cond_m_cov)
    T, d, B = mfs.shape
    like = dict(dtype=mfs.dtype, device=mfs.device)
    xi, w, sw = _rule_tensors(sgps, mfs)
    Lq = psd_cholesky(trans.cov_const(dt)).to(**like)
    LqT = Lq.T[:, :, None].expand(d, d, B)
    zeros_dd = mfs.new_zeros((d, d, B))

    mss = mfs.new_empty((T, d, B))
    Lss = mfs.new_empty((T, d, d, B))
    ms, Ls = mfs[-1], Lfs[-1]
    mss[-1], Lss[-1] = ms, Ls
    for t in range(T - 2, -1, -1):
        mf, Lf = mfs[t], Lfs[t]
        chi = mf[None] + torch.einsum("sj,ijb->sib", xi, Lf)
        mu = trans.mean_channels_first(chi, dt)
        mp = torch.einsum("s,sib->ib", w, mu)
        dev_pred = sw[:, None, None] * (mu - mp[None])
        dev_prev = sw[:, None, None] * (chi - mf[None])
        M = torch.cat([
            torch.cat([dev_pred, dev_prev], dim=1),
            torch.cat([LqT, zeros_dd], dim=1),
        ], dim=0)                                         # (S+d, 2d, B)
        R = tria_cf(M)                                    # (2d, 2d, B)
        R11, R12, R22 = R[:d, :d], R[:d, d:], R[d:, d:]
        # G = (R11^{-1} R12)^T per lane.
        G = _backsub_cf(R11, R12, d).transpose(0, 1)      # (d, d, B)
        ms = mf + torch.einsum("ijb,jb->ib", G, ms - mp)
        GLs = torch.einsum("ijb,jkb->ikb", G, Ls)
        Ls = tria_cf(torch.cat([GLs.transpose(0, 1), R22], dim=0)
                     ).transpose(0, 1)
        mss[t], Lss[t] = ms, Ls
    return mss, Lss


def _backsub_cf(R11: torch.Tensor, R12: torch.Tensor, d: int) -> torch.Tensor:
    """Solve R11 X = R12 per lane (R11 (d, d, B) upper, R12 (d, d, B));
    unrolled back-substitution.  The rows of X are built as a list and
    stacked once (no in-place writes)."""
    X = [None] * d
    for i in range(d - 1, -1, -1):
        acc = R12[i]
        for k in range(i + 1, d):
            acc = acc - R11[i, k][None] * X[k]
        X[i] = acc / R11[i, i][None]
    return torch.stack(X)


def gaussian_expectation_batched(ms: torch.Tensor, stds: torch.Tensor,
                                 func=None, order: int = 10) -> torch.Tensor:
    """E[f(V)] for channels-first (T, B) means/stds via Gauss-Hermite."""
    if func is None:
        from chirpgp_tpu_torch.models.bijections import g as func
    from chirpgp_tpu_torch.quad.sigma_points import gauss_hermite
    rule = gauss_hermite(1, order)
    nodes = torch.as_tensor(rule.xi[:, 0], dtype=ms.dtype, device=ms.device)
    ws = torch.as_tensor(rule.w, dtype=ms.dtype, device=ms.device)
    chi = ms[None] + stds[None] * nodes[:, None, None]    # (S, T, B)
    return torch.einsum("s,stb->tb", ws, func(chi))
