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
from chirpgp_tpu_torch.utils.numerics import cholesky_or_nan, psd_cholesky

__all__ = ["tria_cf", "sqrt_sgp_filter_batched", "sqrt_sgp_smoother_batched",
           "sqrt_sgp_filter_smoother_batched", "cov_sgp_filter_smoother_batched",
           "gaussian_expectation_batched", "smoothed_expectation_batched"]

_LOG_2PI = math.log(2.0 * math.pi)


def tria_cf(M: torch.Tensor) -> torch.Tensor:
    """Channels-first Householder triangularization.

    ``M``: (n, d, B), n >= d -> upper R (d, d, B) with ``R^T R = M^T M``
    per lane.  Sign convention ``x_j >= 0 -> alpha = -|x|``; reflections
    with ``|v|^2 <= 1e-30`` are skipped.

    Differentiable: nothing autograd saved is written in place.  Row j of
    R is final after reflection j, so each step keeps that row and carries
    only the trailing block to the next; the rows are stacked once.
    """
    d, B = M.shape[1], M.shape[2]
    rows = []
    sub = M
    for j in range(d):
        x = sub[:, 0, :]                                  # (n-j, B)
        norm = torch.sqrt(torch.sum(x * x, dim=0, keepdim=True))
        alpha = torch.where(x[:1] >= 0, -norm, norm)      # (1, B)
        v = torch.cat([x[:1] - alpha, x[1:]])
        vn2 = torch.sum(v * v, dim=0, keepdim=True)
        ok = vn2 > 1e-30
        beta = torch.where(ok, 2.0 / torch.where(ok, vn2, 1.0), 0.0)
        wv = (v[:, None, :] * sub).sum(0)                 # (d-j, B)
        sub = sub - beta[None] * v[:, None, :] * wv[None]
        rows.append(torch.cat([sub.new_zeros((j, B)), sub[0]]))
        sub = sub[1:, 1:]
    return torch.stack(rows)


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
    L = cholesky_or_nan(P0).to(**like)[:, :, None].expand(d, d, B)
    nll = yss.new_zeros((B,))

    mfs, Lfs, nlls = [], [], []
    for y in yss.T:
        mp, Up, _, _, _ = _predict_cf(trans, rule, dt, m, L, LqT)
        m, L, inc = _update_cf(mp, Up, h_idx, sqrt_Xi, y)
        nll = nll + inc
        mfs.append(m)
        Lfs.append(L)
        nlls.append(nll)
    return torch.stack(mfs), torch.stack(Lfs), torch.stack(nlls)


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

    ms, Ls = mfs[-1], Lfs[-1]
    mss, Lss = [ms], [Ls]
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
        mss.append(ms)
        Lss.append(Ls)
    return torch.stack(mss[::-1]), torch.stack(Lss[::-1])


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


def sqrt_sgp_filter_smoother_batched(cond_m_cov, sgps: SigmaPoints, H, Xi,
                                     m0, P0, dt, yss: torch.Tensor,
                                     return_factors: bool = True,
                                     unroll: int = 1,
                                     out_index: int = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Fused batched sqrt sigma-point filter + smoother.

    The math of ``sqrt_sgp_filter_batched`` followed by
    ``sqrt_sgp_smoother_batched``, restructured so that the smoother's
    sigma-point propagation and joint triangularization happen once, in
    the forward pass: per step the joint pre-array is triangularized, its
    R11 block is the filter's predicted factor, and the step emits the
    smoother gain (as ``X = R11^{-1} R12``) and the conditional factor
    R22.  The backward pass is then a few d x d x B products and one
    2d-row triangularization.

    Returns ``(mss (T, d, B), Lss (T, d, d, B) lower, nll (T, B))``.

    ``return_factors=False`` switches the backward pass to the affine
    covariance recursion ``ms = u + G ms'``, ``Ps = D + G Ps' G^T`` with
    ``u = mf - G mp`` and ``D = R22^T R22`` from the forward pass; it then
    returns ``(mss, Pss, nll)`` with FULL covariances.  The forward pass is
    the same.

    ``out_index`` (requires ``return_factors=False``) returns only the
    smoothed mean and variance of state component ``out_index``:
    ``(v_mean (T, B), v_var (T, B), nll (T, B))``.  The backward carry is
    the full one, so these are bit-equal to ``mss[:, out_index]`` and
    ``Pss[:, out_index, out_index]``.

    ``unroll`` is the JAX scan's knob; it has no effect on a Python loop.
    """
    _require_nonneg_weights(sgps, "sqrt_sgp_filter_smoother_batched")
    if out_index is not None and return_factors:
        raise ValueError("out_index (slim output) requires "
                         "return_factors=False")
    T = yss.shape[1]
    nlls, steps, m, L = _fused_forward(cond_m_cov, sgps, H, Xi, m0, P0, dt,
                                       yss, return_factors)

    # The maps emitted at filter iteration t smooth time t-1 given time t:
    # backward element k pairs step k's filtered mean with step k+1's maps.
    if return_factors:
        ms, Ls = m, L
        mss, Lss = [ms], [Ls]
        for k in range(T - 2, -1, -1):
            mf_prev = steps[k][0]
            _, _, mp, X, R22 = steps[k + 1]
            G = X.transpose(0, 1)
            ms = mf_prev + torch.einsum("ijb,jb->ib", G, ms - mp)
            GLs = torch.einsum("ijb,jkb->ikb", G, Ls)
            Ls = tria_cf(torch.cat([GLs.transpose(0, 1), R22], dim=0)
                         ).transpose(0, 1)
            mss.append(ms)
            Lss.append(Ls)
        return torch.stack(mss[::-1]), torch.stack(Lss[::-1]), nlls

    ms, Ps = _affine_backward(m, torch.einsum("ikb,jkb->ijb", L, L),
                              steps[1:], out_index)
    return ms, Ps, nlls


def _fused_forward(cond_m_cov, sgps: SigmaPoints, H, Xi, m0, P0, dt,
                   yss: torch.Tensor, factors: bool):
    """The forward scan of ``sqrt_sgp_filter_smoother_batched``: per step
    the filter's prediction through the projected joint triangularization,
    its measurement update and nll, and what the backward pass reads.

    Returns ``(nlls (T, B), steps, m, L)``, with ``m``, ``L`` the last
    filtered moments.  ``steps[t]`` is iteration t's ``(mf, Lf, mp, X,
    R22)`` when ``factors``, else the maps ``(u, G, D)`` of the affine
    recursion, which smooth time t-1 given time t (``u = mf_{t-1} - G mp``,
    ``G = X^T``, ``D = R22^T R22``)."""
    trans = as_transition(cond_m_cov)
    h_idx = _one_hot_index(H)
    B = yss.shape[0]
    like = dict(dtype=yss.dtype, device=yss.device)
    d = m0.shape[-1]

    xi, w, sw = _rule_tensors(sgps, yss)
    sqrt_Xi = torch.sqrt(torch.as_tensor(Xi, **like))
    Lq = psd_cholesky(trans.cov_const(dt)).to(**like)
    LqT = Lq.T[:, :, None].expand(d, d, B)
    zeros_dd = yss.new_zeros((d, d, B))
    m = m0.to(**like)[:, None].expand(d, B)
    L = cholesky_or_nan(P0).to(**like)[:, :, None].expand(d, d, B)
    nll = yss.new_zeros((B,))

    # xiw = sqrt(w) xi has orthonormal columns (sum_s w xi xi^T = I for
    # every implemented rule), so dev_prev = xiw L^T exactly and the joint
    # pre-array collapses: project dev_pred onto span(xiw) (coefficients
    # A), triangularize only the orthogonal remainder (S x d), and finish
    # with a (3d, 2d) triangularization.  Same Gram as the (S+d, 2d) one.
    xiw = sw[:, None] * xi                                # (S, d)

    nlls, steps = [], []
    for y in yss.T:
        chi = m[None] + torch.einsum("sj,ijb->sib", xi, L)
        mu = trans.mean_channels_first(chi, dt)
        mp = torch.einsum("s,sib->ib", w, mu)
        dev_pred = sw[:, None, None] * (mu - mp[None])
        A = torch.einsum("sp,sib->pib", xiw, dev_pred)    # (d, d, B)
        dev_perp = dev_pred - torch.einsum("sp,pib->sib", xiw, A)
        E = tria_cf(dev_perp)                             # (d, d, B)
        M = torch.cat([
            torch.cat([E, zeros_dd], dim=1),
            torch.cat([A, L.transpose(0, 1)], dim=1),
            torch.cat([LqT, zeros_dd], dim=1),
        ], dim=0)                                         # (3d, 2d, B)
        R = tria_cf(M)                                    # (2d, 2d, B)
        Up = R[:d, :d]
        X = _backsub_cf(Up, R[:d, d:], d)                 # gain G = X^T
        m_prev = m
        m, L, inc = _update_cf(mp, Up, h_idx, sqrt_Xi, y)
        nll = nll + inc
        nlls.append(nll)
        R22 = R[d:, d:]
        if factors:
            steps.append((m, L, mp, X, R22))
            continue
        G = X.transpose(0, 1)
        u = m_prev - torch.einsum("ijb,jb->ib", G, mp)
        D = torch.einsum("kib,kjb->ijb", R22, R22)
        steps.append((u, G, D))
    return torch.stack(nlls), steps, m, L


def _affine_backward(ms, Ps, maps, out_index=None):
    """The backward recursion of the fused forms, affine in the smoothed
    moments: ``ms_k = u + G ms_{k+1}``, ``Ps_k = D + G Ps_{k+1} G^T``, over
    the per-step maps ``(u, G, D)`` in reverse from the last filtered
    moments.  With ``out_index`` only that component's mean and variance
    are kept; the carry is the full one either way."""
    def emit(ms, Ps):
        if out_index is None:
            return ms, Ps
        return ms[out_index], Ps[out_index, out_index]

    outs = [emit(ms, Ps)]
    for u, G, D in reversed(maps):
        ms = u + torch.einsum("ijb,jb->ib", G, ms)
        Ps = D + torch.einsum(
            "ikb,kjb->ijb", G, torch.einsum("ikb,jkb->ijb", Ps, G))
        outs.append(emit(ms, Ps))
    mss, Pss = zip(*outs[::-1])
    return torch.stack(mss), torch.stack(Pss)


def _chol_cf(P: torch.Tensor, d: int, eps: float = 1e-30) -> torch.Tensor:
    """Channels-first unrolled Cholesky: P (d, d, B) SPD per lane ->
    lower L (d, d, B).  A lane whose pivot has gone non-positive through
    round-off gets a truly degenerate factor: the diagonal is clamped to
    sqrt(eps) and the column below the clamped pivot is zeroed."""
    rows = [[None] * d for _ in range(d)]
    for j in range(d):
        acc = P[j, j]
        for k in range(j):
            acc = acc - rows[j][k] * rows[j][k]
        ok = acc > eps
        Ljj = torch.sqrt(acc.clamp_min(eps))
        rows[j][j] = Ljj
        inv = torch.where(ok, 1.0 / Ljj, 0.0)
        for i in range(j + 1, d):
            acc = P[i, j]
            for k in range(j):
                acc = acc - rows[i][k] * rows[j][k]
            rows[i][j] = acc * inv
    zero = torch.zeros_like(P[0, 0])
    return torch.stack([
        torch.stack([rows[i][j] if j <= i else zero for j in range(d)])
        for i in range(d)])


def _spd_solve_cf(Lp: torch.Tensor, C: torch.Tensor, d: int) -> torch.Tensor:
    """Solve G (Lp Lp^T) = C per lane: G = C Lp^{-T} Lp^{-1} with ``Lp``
    (d, d, B) lower, ``C`` (d, d, B); two unrolled substitutions on the
    columns of C^T."""
    # Y Lp^T = C  ->  forward substitution on the columns of Y.
    Y = [None] * d
    for j in range(d):
        acc = C[:, j]
        for k in range(j):
            acc = acc - Y[k] * Lp[j, k][None]
        Y[j] = acc / Lp[j, j][None]
    # G Lp = Y  ->  back substitution.
    G = [None] * d
    for j in range(d - 1, -1, -1):
        acc = Y[j]
        for k in range(j + 1, d):
            acc = acc - G[k] * Lp[k, j][None]
        G[j] = acc / Lp[j, j][None]
    return torch.stack(G, dim=1)                          # (d, d, B)


def cov_sgp_filter_smoother_batched(cond_m_cov, sgps: SigmaPoints, H, Xi,
                                    m0, P0, dt, yss: torch.Tensor,
                                    unroll: int = 1
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """Fused batched sigma-point filter + smoother in covariance form.

    Per step: one weighted Gram contraction (``Pp = dev^T diag(w) dev +
    Q``, PSD by construction) and an unrolled channels-first Cholesky in
    place of the Householder column updates; plain covariances are
    propagated.  The measurement update ``Pf = Pp - p_h p_h^T / s`` is the
    exact Schur complement.  For ill-conditioned models prefer
    ``sqrt_sgp_filter_smoother_batched``.

    Returns ``(mss (T, d, B), Pss (T, d, d, B) full covariances, nll
    (T, B) cumulative)``.  ``unroll`` has no effect on a Python loop.
    """
    _require_nonneg_weights(sgps, "cov_sgp_filter_smoother_batched")
    trans = as_transition(cond_m_cov)
    h_idx = _one_hot_index(H)
    B, T = yss.shape
    like = dict(dtype=yss.dtype, device=yss.device)
    d = m0.shape[-1]

    xi, w, _ = _rule_tensors(sgps, yss)
    wxi = w[:, None] * xi                                 # (S, d)
    Xi_s = torch.as_tensor(Xi, **like)
    Qc = trans.cov_const(dt).to(**like)[:, :, None]       # (d, d, 1)
    m = m0.to(**like)[:, None].expand(d, B)
    P = P0.to(**like)[:, :, None].expand(d, d, B)
    nll = yss.new_zeros((B,))

    # The forward pass emits each step's backward maps (u, G, D), with
    # u = mf - G mp and D = Pf - G Pp G^T.
    nlls, maps = [], []
    for y in yss.T:
        L = _chol_cf(P, d)
        chi = m[None] + torch.einsum("sj,ijb->sib", xi, L)
        mu = trans.mean_channels_first(chi, dt)
        mp = torch.einsum("s,sib->ib", w, mu)
        dev = mu - mp[None]                               # (S, d, B)
        Pp = torch.einsum("sib,s,sjb->ijb", dev, w, dev) + Qc
        # Cross-covariance C = L A with A = sum_s w xi_s dev_s^T.
        A = torch.einsum("sp,sjb->pjb", wxi, dev)
        C = torch.einsum("ikb,kjb->ijb", L, A)
        Lp = _chol_cf(Pp, d)
        G = _spd_solve_cf(Lp, C, d)                       # C Pp^{-1}
        u = m - torch.einsum("ijb,jb->ib", G, mp)
        W = torch.einsum("ikb,kjb->ijb", G, Lp)
        D = P - torch.einsum("ikb,jkb->ijb", W, W)
        s = Pp[h_idx, h_idx] + Xi_s                       # (B,)
        p_h = Pp[:, h_idx]                                # (d, B)
        innov = y - mp[h_idx]
        m = mp + p_h * (innov / s)[None]
        P = Pp - p_h[:, None, :] * p_h[None, :, :] / s[None, None]
        nll = nll + 0.5 * (_LOG_2PI + torch.log(s) + innov ** 2 / s)
        nlls.append(nll)
        maps.append((u, G, D))

    # Iteration t's maps smooth time t-1 given time t.
    mss, Pss = _affine_backward(m, P, maps[1:])
    return mss, Pss, torch.stack(nlls)


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


def smoothed_expectation_batched(mss: torch.Tensor, Lss: torch.Tensor,
                                 v_index: int, order: int = 10) -> torch.Tensor:
    """E[g(V)] of state ``v_index`` of the smoother's (T, d, B) means and
    (T, d, d, B) factors, V ~ N(mss[v], |row v of Lss|^2): (T, B)."""
    v_std = torch.sqrt(torch.einsum("tkb,tkb->tb", Lss[:, v_index],
                                    Lss[:, v_index]))
    return gaussian_expectation_batched(mss[:, v_index], v_std, order=order)
