"""The Table-I sweep objective on the card: the square-root GHFS filter NLL
of the chirp model (d=4, H = e_1) with one parameter vector per lane, and
its gradient, as two hand-written CUDA kernels behind one
``torch.autograd.Function``.

- :func:`chirp_lane_constants` maps one lane's constrained params
  ``[lam, b, delta, ell, sigma, m0_v]`` to the 43 model constants the
  kernels read (the layout of ``ops/chirp_filter.py::_chirp_constants``:
  F32, Lq^T, L0, m0, exp(-lam dt), sqrt(Xi), dt), differentiably, from the
  port's own model code; ``torch.func.vmap`` maps it over lanes.
- The forward kernel (``csrc/ghfs_chirp_filter.cu``, its per-lane
  instances) runs the filter of ``ops/chirp_filter.py`` with each lane's
  constants read from a ``(B, 43)`` tensor, and writes the filtered means
  ``(T, 4, B)``, factors ``(T, 16, B)`` and the final NLL ``(B,)``.
- The adjoint kernel (``csrc/ghfs_chirp_filter_adjoint.cu``) walks t = T-1
  .. 0, recomputes each step from the forward's outputs (as the JAX
  package's ``jax.checkpoint`` does) and returns dNLL/dconsts ``(B, 43)``;
  autograd carries it to theta through :func:`chirp_lane_constants`.
  :func:`adjoint_geometry` picks its design: producer warps that
  recompute the steps ahead of a chain warp that carries the adjoint
  (while its blocks fit the SMs at once, up to 3 lanes per SM), or a
  team of 32 threads per lane (up to 16 lanes per SM) or of 8 (beyond).

Together they replace ``chirpgp_tpu/infer/sqrt.py::sqrt_sgp_filter`` under
``jax.value_and_grad`` (a compiled scan and XLA's reverse mode of it), not
a Pallas kernel.

The adjoint differentiates the NLL as a function of theta without the
Householder reflections: per step, in reverse, the closed-form adjoint of
the 1-D update (S = P_p[1,1] + Xi, K = P_p e_1 / S, m_f = m_p + K innov,
P_f = P_p - K S K^T, l = (log 2 pi S + innov^2 / S) / 2), then P_p =
sum_s dev_s dev_s^T + Lq Lq^T to each point's LCD mean and to Lq, the LCD
mean to chi_s and the constants, chi_s = m + L xi_s to m and L, and L to
P by the adjoint of the Cholesky factor (Murray 2016, arXiv:1602.07527),
P^bar = L^-T sym(Phi(L^T L^bar)) L^-1, which the factor's column signs
leave unchanged.

:class:`ChirpFilterNLL` runs the kernels for CUDA tensors and their plain
versions :func:`filter_nll_reference` and
:func:`filter_nll_adjoint_reference` (split as the kernel is:
:func:`adjoint_carry_free`, batched over steps, and :func:`adjoint_chain`)
for CPU tensors, lane by lane, so
that a lane's bits do not depend on its batch; there is no third way.  Its ``vmap`` staticmethod receives the physical ``(B, 43)`` and
``(B, T)`` tensors of a ``torch.func.vmap`` and evaluates every lane in
one launch of each kernel.  ``ChirpFilterNLL.launches`` counts the kernel
launches by name; :func:`forward_cost` and :func:`adjoint_cost` count
their work.
"""

import ctypes
import math
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from chirpgp_tpu_torch.infer.batched import _rule_tensors, _update_cf, tria_cf
from chirpgp_tpu_torch.infer.sqrt import _require_nonneg_weights
from chirpgp_tpu_torch.models.matern import m32_solution, stationary_cov_m32
from chirpgp_tpu_torch.ops.chirp_filter import (
    _D, _WARP, MAX_POINTS, FilterCost, _default_team, filter_cost,
    launch_geometry, load_kernel)
from chirpgp_tpu_torch.quad.sigma_points import SigmaPoints
from chirpgp_tpu_torch.utils.numerics import (
    cholesky_or_nan, ou_variance, psd_cholesky)

__all__ = ["NUM_CONSTS", "AdjointGeometry", "CarryFree", "ChirpFilterNLL",
           "adjoint_carry_free", "adjoint_chain", "adjoint_cost",
           "adjoint_geometry", "adjoint_launcher", "chirp_filter_nll",
           "chirp_lane_constants", "filter_nll_adjoint_reference",
           "filter_nll_reference", "forward_cost", "forward_launcher",
           "load_adjoint_kernel"]

_ADJOINT = "ghfs_chirp_filter_adjoint"
# The adjoint kernel's instances (csrc/ghfs_chirp_filter_adjoint.cu): the
# team design's teams and the sigma points per member each is built for
# (cubature's and GH-3's: 2 and 11 for the team of 8, 1 and 3 for 32);
# the chain design's (rows, producer warps) pairs, its team of 32, its
# largest ring and most lanes a block.
TEAM_ROWS = {8: (2, 11), 32: (1, 3)}
CHAIN_PRODUCERS = ((1, 2), (3, 2), (3, 3))
CHAIN_TEAM, CHAIN_MAX_RING, CHAIN_MAX_LANES = 32, 8, 3
# An H100 SM's shared memory (228 KB, of which each resident block
# reserves 1 KB): the chain design's ring is sized for the one block an
# SM holds.
_SMEM_PER_SM, _SMEM_RESERVED = 233472, 1024
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
NUM_CONSTS = 4 + 16 + 16 + 4 + 3
# Offsets of the constants in a lane's row.
_F, _LQT, _L0, _M0, _DECAY, _SQRT_XI, _DT = 0, 4, 20, 36, 40, 41, 42
_H = 1                       # the measured state component


def _pair_and_m32(pair, m32: torch.Tensor) -> torch.Tensor:
    """The 4 x 4 block-diagonal ``diag(pair, pair) (+) m32`` by stacking,
    which ``torch.func.vmap`` maps in one batched call per op
    (``torch.block_diag`` has no batching rule: vmap would loop over the
    lanes)."""
    z = torch.zeros_like(pair)
    return torch.stack([torch.stack([pair, z, z, z]),
                        torch.stack([z, pair, z, z]),
                        torch.stack([z, z, m32[0, 0], m32[0, 1]]),
                        torch.stack([z, z, m32[1, 0], m32[1, 1]])])


def chirp_lane_constants(params: torch.Tensor, Xi, dt) -> torch.Tensor:
    """The 43 model constants of one lane's constrained params ``(6,)``
    ``[lam, b, delta, ell, sigma, m0_v]``, in ``params``' dtype on its
    device: F32 (2x2), Lq^T (4x4), L0 (4x4), m0 (4), exp(-lam dt),
    sqrt(Xi), dt -- what ``_chirp_constants`` computes in float64 on the
    host, here differentiable and mappable by ``torch.func.vmap``.  The
    model is ``models/chirp.py``'s: ``disc_chirp_lcd``'s covariance
    ``blockdiag(q I, Sigma_m32)``, ``q = ou_variance(b, lam, dt)``, and
    ``model_chirp``'s ``P0 = blockdiag(delta I, stationary_cov_m32)``,
    factored by ``psd_cholesky`` and ``cholesky_or_nan`` (NaN where P0 is
    not positive definite, as in the eager filter)."""
    lam, b, delta, ell, sigma, m0_v = params.unbind()
    F32, S32 = m32_solution(ell, sigma, float(dt))
    Lq = psd_cholesky(_pair_and_m32(ou_variance(b, lam, float(dt)), S32))
    L0 = cholesky_or_nan(_pair_and_m32(delta,
                                       stationary_cov_m32(ell, sigma)))
    zero = 0.0 * m0_v
    m0 = torch.stack([zero, zero, m0_v, zero])
    scalars = torch.stack([torch.exp(-lam * float(dt)),
                           torch.full_like(lam, math.sqrt(float(Xi))),
                           torch.full_like(lam, float(dt))])
    return torch.cat([F32.reshape(-1), Lq.T.reshape(-1), L0.reshape(-1),
                      m0, scalars])


class _Consts(NamedTuple):
    """A ``(B, 43)`` row block, channels-first (lanes last)."""
    F: torch.Tensor        # (2, 2, B)
    LqT: torch.Tensor      # (4, 4, B)
    L0: torch.Tensor       # (4, 4, B)
    m0: torch.Tensor       # (4, B)
    decay: torch.Tensor    # (B,)
    sqrt_xi: torch.Tensor  # (B,)
    dt: torch.Tensor       # (B,)


def _unpack(consts: torch.Tensor) -> _Consts:
    c = consts.T
    B = c.shape[1]
    return _Consts(c[_F:_LQT].reshape(2, 2, B), c[_LQT:_L0].reshape(4, 4, B),
                   c[_L0:_M0].reshape(4, 4, B), c[_M0:_DECAY], c[_DECAY],
                   c[_SQRT_XI], c[_DT])


def _softplus(x):
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def _lcd_parts(k: _Consts, chi: torch.Tensor):
    """The chirp-LCD mean of the points ``chi (S, 4, B)`` and what its
    adjoint needs: ``(mu, cos, sin, softplus(V))``, the rotation angle
    pi (2 dt softplus(V)) as the kernel's ``sincospi`` takes it."""
    sp = _softplus(chi[:, 2])
    ang = math.pi * (2.0 * k.dt * sp)
    c, s = torch.cos(ang), torch.sin(ang)
    cs, sn = c * k.decay, s * k.decay
    F = k.F
    mu = torch.stack([cs * chi[:, 0] - sn * chi[:, 1],
                      sn * chi[:, 0] + cs * chi[:, 1],
                      F[0, 0] * chi[:, 2] + F[0, 1] * chi[:, 3],
                      F[1, 0] * chi[:, 2] + F[1, 1] * chi[:, 3]], dim=1)
    return mu, c, s, sp


def filter_nll_reference(consts: torch.Tensor, sgps: SigmaPoints,
                         yss: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel's plain version: the sqrt sigma-point filter of
    ``ops/chirp_filter.py`` (``infer/batched.py``'s predict and update),
    lane b with the constants ``consts[b]``.  ``consts (B, 43)`` and
    ``yss (B, T)`` of one dtype and device.  Returns ``(mfs (T, 4, B),
    lfs (T, 16, B), nll (B,))``, the filtered means, lower factors (row
    major) and the final NLL."""
    B, T = yss.shape
    k = _unpack(consts)
    xi, w, sw = _rule_tensors(sgps, yss)
    m, L = k.m0, k.L0
    nll = yss.new_zeros((B,))
    sqrt_xi = k.sqrt_xi.reshape(1, 1, B)
    mfs, lfs = [], []
    for y in yss.T:
        chi = m[None] + torch.einsum("sj,ijb->sib", xi, L)
        mu = _lcd_parts(k, chi)[0]
        mp = torch.einsum("s,sib->ib", w, mu)
        dev = sw[:, None, None] * (mu - mp[None])
        Up = tria_cf(torch.cat([dev, k.LqT], dim=0))
        m, L, inc = _update_cf(mp, Up, _H, sqrt_xi, y)
        nll = nll + inc
        mfs.append(m)
        lfs.append(L.reshape(_D * _D, B))
    if T == 0:
        return (yss.new_zeros((0, _D, B)), yss.new_zeros((0, _D * _D, B)),
                nll)
    return torch.stack(mfs), torch.stack(lfs), nll


def _lower_inverse(L: torch.Tensor) -> torch.Tensor:
    """Inverse of the lower-triangular ``L (4, 4, ...)`` by forward
    substitution, the kernel's arithmetic."""
    d = L.shape[0]
    inv = [[None] * d for _ in range(d)]
    zero = torch.zeros_like(L[0, 0])
    for i in range(d):
        r = 1.0 / L[i, i]
        inv[i][i] = r
        for j in range(i):
            acc = L[i, j] * inv[j][j]
            for q in range(j + 1, i):
                acc = acc + L[i, q] * inv[q][j]
            inv[i][j] = -acc * r
    return torch.stack([torch.stack([inv[i][j] if j <= i else zero
                                     for j in range(d)]) for i in range(d)])


def _cholesky_adjoint(L: torch.Tensor, inv: torch.Tensor,
                      Lbar: torch.Tensor) -> torch.Tensor:
    """P^bar = L^-T sym(Phi(L^T L^bar)) L^-1 for ``P = L L^T``, ``L (4, 4,
    B)`` lower (any column signs) with ``inv`` = L^-1, ``Lbar`` of which
    only the lower triangle counts; Phi keeps the lower triangle and
    halves the diagonal."""
    X = torch.einsum("kib,kjb->ijb", L, Lbar)
    d = L.shape[0]
    low = torch.tril(torch.ones(d, d, dtype=L.dtype, device=L.device), -1)
    phi = X * (low + 0.5 * torch.eye(d, dtype=L.dtype, device=L.device)
               )[:, :, None]
    sym = 0.5 * (phi + phi.transpose(0, 1))
    return torch.einsum("kib,klb,ljb->ijb", inv, sym, inv)


class CarryFree(NamedTuple):
    """The carry-free part of the adjoint's steps t0 .. t0 + n - 1, step
    first, lanes last: what the kernel's producer warps hand to its chain
    warp."""
    t0: int
    chi: torch.Tensor      # (n, S, 4, B) sigma points m_{t-1} + L_{t-1} xi
    dev: torch.Tensor      # (n, S, 4, B) their LCD means minus m_p
    cos: torch.Tensor      # (n, S, B) the rotation's cos, sin (before the
    sin: torch.Tensor      # (n, S, B)  decay), softplus(chi_V) and
    sp: torch.Tensor       # (n, S, B)  sigmoid(chi_V)
    sig: torch.Tensor      # (n, S, B)
    mp: torch.Tensor       # (n, 4, B) m_p
    Pp: torch.Tensor       # (n, 4, 4, B) P_p, the Gram plus Lq Lq^T
    innov: torch.Tensor    # (n, B) y_t - m_p[1]
    L: torch.Tensor        # (n, 4, 4, B) L_{t-1}
    inv: torch.Tensor      # (n, 4, 4, B) L_{t-1}^-1


def adjoint_carry_free(consts: torch.Tensor, sgps: SigmaPoints,
                       yss: torch.Tensor, mfs: torch.Tensor,
                       lfs: torch.Tensor, t0: int = 0,
                       t1: Optional[int] = None) -> CarryFree:
    """The part of the adjoint's steps ``t0 .. t1-1`` that no carried
    adjoint enters, batched over the steps and the lanes: each step's
    forward recomputed from the previous step's filtered m and L (``mfs
    (T, 4, B)``, ``lfs (T, 16, B)``; m0 and L0 at t = 0), as
    ``jax.checkpoint`` recomputes it, and L^-1."""
    B, T = yss.shape
    t1 = T if t1 is None else t1
    k = _unpack(consts)
    xi, w, _ = _rule_tensors(sgps, yss)
    Lfs = lfs.reshape(T, _D, _D, B)
    if t0 > 0:
        m, L = mfs[t0 - 1:t1 - 1], Lfs[t0 - 1:t1 - 1]
    else:   # m0 and L0 before the first step
        m = torch.cat([k.m0[None], mfs[:t1 - 1]])
        L = torch.cat([k.L0[None], Lfs[:t1 - 1]])
    n, S = t1 - t0, xi.shape[0]
    chi = m[:, None] + torch.einsum("sj,tijb->tsib", xi, L)
    mu, c, sn, sp = _lcd_parts(k, chi.reshape(n * S, _D, B))
    mu = mu.reshape(n, S, _D, B)
    mp = torch.einsum("s,tsib->tib", w, mu)
    dev = mu - mp[:, None]
    LqLqT = torch.einsum("kib,kjb->ijb", k.LqT, k.LqT)
    Pp = torch.einsum("s,tsib,tsjb->tijb", w, dev, dev) + LqLqT
    inv = _lower_inverse(L.permute(1, 2, 0, 3)).permute(2, 0, 1, 3)
    return CarryFree(t0, chi, dev, c.reshape(n, S, B), sn.reshape(n, S, B),
                     sp.reshape(n, S, B), torch.sigmoid(chi[:, :, 2]), mp,
                     Pp, yss.T[t0:t1] - mp[:, _H], L, inv)


def adjoint_chain(consts: torch.Tensor, sgps: SigmaPoints, parts,
                  gbar: torch.Tensor) -> torch.Tensor:
    """The adjoint's carried recursion: dNLL/dconsts ``(B, 43)`` times
    ``gbar (B,)`` from the carry-free parts ``parts`` (:func:`
    adjoint_carry_free`'s, latest steps first, covering t = T-1 .. 0), by
    the closed-form reverse recursion of the module's docstring, the
    kernel's chain: per step the update's adjoint, the points' adjoints
    and the factor's adjoint to the previous step."""
    k = _unpack(consts)
    B = consts.shape[0]
    xi, w, _ = _rule_tensors(sgps, gbar)
    e1 = torch.zeros(_D, dtype=gbar.dtype, device=gbar.device)
    e1[_H] = 1.0
    e1 = e1[:, None]
    mbar = gbar.new_zeros((_D, B))
    Pbar = gbar.new_zeros((_D, _D, B))
    gF = gbar.new_zeros((2, 2, B))
    gLqT = gbar.new_zeros((_D, _D, B))
    g_decay, g_sqrt_xi, g_dt = (gbar.new_zeros((B,)) for _ in range(3))
    gm0, gL0 = gbar.new_zeros((_D, B)), gbar.new_zeros((_D, _D, B))
    Xi = k.sqrt_xi * k.sqrt_xi
    for part in parts:
        for i in range(part.chi.shape[0] - 1, -1, -1):
            chi, dev, c, s, sp = (part.chi[i], part.dev[i], part.cos[i],
                                  part.sin[i], part.sp[i])
            Pp, innov = part.Pp[i], part.innov[i]
            p = Pp[:, _H]
            S = Pp[_H, _H] + Xi
            # The update's adjoint, from (mbar, Pbar) of m_f, P_f and gbar
            # of the NLL increment.
            a = (mbar * p).sum(0)
            Pbp = torch.einsum("ijb,jb->ib", Pbar, p)
            innov_bar = (a + gbar * innov) / S
            mp_bar = mbar - e1 * innov_bar
            p_bar = (mbar * innov - 2.0 * Pbp) / S
            S_bar = ((p * Pbp).sum(0) - a * innov) / (S * S) \
                + gbar * 0.5 * (1.0 - innov * innov / S) / S
            G = Pbar + 0.5 * (p_bar[:, None] * e1.T[:, :, None]
                              + e1[:, :, None] * p_bar[None]) \
                + S_bar * (e1 * e1.T)[:, :, None]
            g_sqrt_xi = g_sqrt_xi + 2.0 * k.sqrt_xi * S_bar
            gLqT = gLqT + 2.0 * torch.einsum("kib,ijb->kjb", k.LqT, G)
            # P_p and m_p to each point's LCD mean, and through it.
            mu_bar = w[:, None, None] * (
                2.0 * torch.einsum("ijb,sjb->sib", G, dev) + mp_bar[None])
            cs, sn = c * k.decay, s * k.decay
            cs_bar = mu_bar[:, 0] * chi[:, 0] + mu_bar[:, 1] * chi[:, 1]
            sn_bar = mu_bar[:, 1] * chi[:, 0] - mu_bar[:, 0] * chi[:, 1]
            # u = 2 dt softplus(V), the angle pi u.
            u_bar = math.pi * (sn_bar * cs - cs_bar * sn)
            g_decay = g_decay + (cs_bar * c + sn_bar * s).sum(0)
            g_dt = g_dt + (u_bar * 2.0 * sp).sum(0)
            F = k.F
            gF = gF + torch.einsum("sib,sjb->ijb", mu_bar[:, 2:], chi[:, 2:])
            chi_bar = torch.stack([
                cs * mu_bar[:, 0] + sn * mu_bar[:, 1],
                cs * mu_bar[:, 1] - sn * mu_bar[:, 0],
                F[0, 0] * mu_bar[:, 2] + F[1, 0] * mu_bar[:, 3]
                + u_bar * 2.0 * k.dt * part.sig[i],
                F[0, 1] * mu_bar[:, 2] + F[1, 1] * mu_bar[:, 3]], dim=1)
            # chi = m + L xi to the previous step's m and L.
            m_bar_prev = chi_bar.sum(0)
            L_bar_prev = torch.einsum("sib,sj->ijb", chi_bar, xi)
            if part.t0 + i == 0:
                gm0, gL0 = m_bar_prev, torch.tril(
                    L_bar_prev.permute(2, 0, 1)).permute(1, 2, 0)
            else:
                mbar = m_bar_prev
                Pbar = _cholesky_adjoint(part.L[i], part.inv[i], L_bar_prev)
    out = torch.cat([gF.reshape(4, B), gLqT.reshape(16, B),
                     gL0.reshape(16, B), gm0, g_decay[None], g_sqrt_xi[None],
                     g_dt[None]])
    return out.T.contiguous()


# Steps of one carry-free part of the plain adjoint: its sigma-point
# tensors hold at most ~2^22 elements each (~0.4 GB at its peak in
# float64), so that 7a's plain version at B=300, T=3141 takes little of
# the card that chip_smoke.py's lanes share.
_CARRY_FREE_ELEMENTS = 1 << 22


def filter_nll_adjoint_reference(consts: torch.Tensor, sgps: SigmaPoints,
                                 yss: torch.Tensor, mfs: torch.Tensor,
                                 lfs: torch.Tensor, gbar: torch.Tensor
                                 ) -> torch.Tensor:
    """The adjoint kernel's plain version: dNLL/dconsts ``(B, 43)`` times
    ``gbar (B,)``, from the forward's ``mfs (T, 4, B)`` and ``lfs (T, 16,
    B)``, split as the kernel splits it: :func:`adjoint_carry_free`
    batched over chunks of steps (latest first) and :func:`adjoint_chain`
    over them."""
    B, T = yss.shape
    n = max(1, _CARRY_FREE_ELEMENTS // (_D * sgps.n_points * max(B, 1)))
    parts = (adjoint_carry_free(consts, sgps, yss, mfs, lfs, max(t1 - n, 0),
                                t1) for t1 in range(T, 0, -n))
    return adjoint_chain(consts, sgps, parts, gbar)


def forward_cost(S: int, T: int, B: int, dtype=torch.float32) -> FilterCost:
    """Work of one forward launch: the filter's flop
    (``ops/chirp_filter.py::filter_cost``); bytes: y read and m, the 16
    factor words written per lane-step, the 43 constants read and the
    final NLL written per lane."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    words = (1 + _D + _D * _D) * T * B + (NUM_CONSTS + 1) * B
    return FilterCost(filter_cost(S, T, B, dtype).flop, itemsize * words)


def adjoint_cost(S: int, T: int, B: int, dtype=torch.float32) -> FilterCost:
    """Work of one adjoint launch, counted as the step needs it (an FMA is
    2 flop; the 3 transcendentals and the sigmoid's exponential per point
    not counted).  Per sigma point: chi = m + L xi with L lower, 20; the
    LCD mean, 17; its weighted mean, 8; the deviation, 4; its Gram
    (lower), 20; mu_bar = w (2 G dev + mp_bar), 40; the LCD mean's
    adjoint (cs_bar, sn_bar, u_bar, the decay's, dt's, F's and chi_bar),
    45; the sums of chi_bar and chi_bar xi^T (lower), 24.  Per step, once
    per lane: P_p, 10; the update's adjoint, 60; the factor's adjoint
    (L^-1, L^T Lbar, the two products), 180; the sums of G, 10.  Bytes:
    per lane-step y, m and the lower factor read (15 words); per lane the
    43 constants and gbar read and 43 adjoints written."""
    per_step = 178 * S + 260
    itemsize = torch.empty((), dtype=dtype).element_size()
    words = (1 + _D + _D * (_D + 1) // 2) * T * B + (2 * NUM_CONSTS + 1) * B
    return FilterCost(per_step * T * B, itemsize * words)


def load_adjoint_kernel():
    """Build (on first use) and load the adjoint kernel's library, with
    the C signatures declared.  Returns ``_build.BuiltLibrary``."""
    from chirpgp_tpu_torch.ops._build import load_library
    built = load_library(_ADJOINT)
    lib = built.lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ghfs_chirp_filter_adjoint_f32,
               lib.ghfs_chirp_filter_adjoint_f64):
        fn.argtypes = [ptr] * 7 + [i32] * 8 + [ptr, ptr]
        fn.restype = i32
    lib.ghfs_chirp_filter_adjoint_num_consts.argtypes = []
    lib.ghfs_chirp_filter_adjoint_num_consts.restype = i32
    if lib.ghfs_chirp_filter_adjoint_num_consts() != NUM_CONSTS:
        raise RuntimeError("the adjoint kernel's layout does not match the "
                           "wrapper's")
    return built


class AdjointGeometry(NamedTuple):
    design: str            # "chain" (producers and a chain warp) or "team"
    team: int              # threads per lane of a team, a producer, a chain
    rows: int              # sigma points per member
    producers: int         # producer warps per lane (0: the team design)
    ring: int              # steps of the hand-off ring (0: the team design)
    lanes_per_block: int
    blocks: int


def _chain_producers(rows: int, dtype) -> int:
    """Producer warps a lane of the chain design gets: 3 for GH-3 in
    float32, whose recompute takes longer than the chain's step; 2 in
    float64 (3 blocks of 3 warps an SM leave 227 registers a thread) and
    for cubature's 8 points."""
    return 3 if rows == 3 and dtype == torch.float32 else 2


def adjoint_geometry(B: int, S: int, num_sms: int = 132,
                     dtype=torch.float32, design: Optional[str] = None,
                     producers: Optional[int] = None,
                     team: Optional[int] = None) -> AdjointGeometry:
    """The adjoint kernel's launch geometry for ``B`` lanes and ``S``
    sigma points of ``dtype`` on a card with ``num_sms`` SMs.

    While the chain design's blocks fit the SMs at once (``B <=
    CHAIN_MAX_LANES * num_sms``), the chain design: per lane a chain warp
    and :func:`_chain_producers` producer warps, ``ceil(B / num_sms)``
    lanes a block up to ``CHAIN_MAX_LANES`` (so that an SM's chain warps
    sit on different schedulers), the ring as many steps (at most
    ``CHAIN_MAX_RING``, at least one per producer) as the shared memory
    of the one block an SM holds leaves (its registers leave room for no
    second).  Beyond that the team design, one warp of lanes a block,
    with the forward's team (``ops/chirp_filter.py::_default_team``): 32
    threads a lane up to 16 lanes per SM (11 blocks an SM, 1452 lanes at
    once on 132 SMs), 8 beyond (B = 4096 in one wave, 8 warps of 255
    registers an SM).  ``design`` (``"chain"`` or ``"team"``),
    ``producers`` and ``team`` choose another (the card tests, the
    timing script)."""
    if not 1 <= S <= MAX_POINTS:
        raise ValueError(f"the adjoint kernel takes 1..{MAX_POINTS} sigma "
                         f"points, got S={S}")
    design = design or ("team" if B > CHAIN_MAX_LANES * max(num_sms, 1)
                        else "chain")
    if design == "team":
        team = team or _default_team(B, num_sms)
        if team not in TEAM_ROWS:
            raise ValueError(f"the team design is built for teams "
                             f"{sorted(TEAM_ROWS)}, got {team}")
        rows = min(r for r in TEAM_ROWS[team] if team * r >= S)
        lanes = _WARP // team
        return AdjointGeometry("team", team, rows, 0, 0, lanes,
                               -(-B // lanes))
    if design != "chain":
        raise ValueError(f"design must be 'chain' or 'team', got {design!r}")
    rows = 1 if S <= CHAIN_TEAM else 3
    K = producers or _chain_producers(rows, dtype)
    if (rows, K) not in CHAIN_PRODUCERS:
        raise ValueError(f"the chain design is built for (rows, producers) "
                         f"in {CHAIN_PRODUCERS}, got ({rows}, {K})")
    itemsize = torch.empty((), dtype=dtype).element_size()
    slot = itemsize * (32 + 12 * CHAIN_TEAM * rows)
    static = (itemsize * (_D + 1) * MAX_POINTS
              + 16 * CHAIN_MAX_LANES * CHAIN_MAX_RING)
    lanes = min(CHAIN_MAX_LANES, -(-B // max(num_sms, 1)))
    ring = (_SMEM_PER_SM - _SMEM_RESERVED - static) // (lanes * slot)
    return AdjointGeometry("chain", CHAIN_TEAM, rows, K,
                           max(K, min(CHAIN_MAX_RING, ring)), lanes,
                           -(-B // lanes))


def _check_lanes(consts: torch.Tensor, sgps: SigmaPoints,
                 yss: torch.Tensor) -> str:
    """Check the inputs of a kernel launch; returns the dtype's suffix."""
    if yss.device.type != "cuda":
        raise ValueError(f"the per-lane filter kernels run on cuda tensors; "
                         f"a cpu tensor takes the plain versions; got "
                         f"{yss.device}")
    _require_nonneg_weights(sgps, "chirp_filter_nll")
    if sgps.d != _D:
        raise ValueError(f"the chirp kernels are d={_D} only, got a "
                         f"d={sgps.d} rule")
    if yss.dim() != 2 or yss.shape[1] < 1:
        raise ValueError(f"yss must be (B, T) with T >= 1, got shape "
                         f"{tuple(yss.shape)}")
    if consts.shape != (yss.shape[0], NUM_CONSTS):
        raise ValueError(f"consts must be (B, {NUM_CONSTS}) for B = "
                         f"{yss.shape[0]}, got {tuple(consts.shape)}")
    if consts.dtype != yss.dtype or consts.device != yss.device:
        raise ValueError("consts and yss must share dtype and device")
    if yss.dtype not in _SUFFIX:
        raise ValueError(f"yss must be float32 or float64, got {yss.dtype}")
    return _SUFFIX[yss.dtype]


def _rule_on(sgps: SigmaPoints, like: torch.Tensor):
    """``(xi (S, 4), w, sqrt(w))`` contiguous on ``like``'s device."""
    xi, w, sw = _rule_tensors(sgps, like)
    return xi.contiguous(), w.contiguous(), sw.contiguous()


def _num_sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def forward_launcher(consts: torch.Tensor, sgps: SigmaPoints,
                     yss: torch.Tensor):
    """Check the inputs of the forward kernel (CUDA tensors ``consts (B,
    43)``, ``yss (B, T)``), build it and its outputs, and return
    ``(launch, (mfs (T, 4, B), lfs (T, 16, B), nll (B,)))``: each
    ``launch()`` runs the kernel once on the current stream, writes the
    outputs and counts the launch in ``ChirpFilterNLL.launches``."""
    suffix = _check_lanes(consts, sgps, yss)
    B, T = yss.shape
    S = sgps.n_points
    geo = launch_geometry(B, S, _num_sms(yss.device))
    entry = getattr(load_kernel().lib, f"ghfs_chirp_filter_lanes_{suffix}")
    like = dict(dtype=yss.dtype, device=yss.device)
    ys_t = yss.T.contiguous()
    c = consts.contiguous()
    xi, w, sw = _rule_on(sgps, yss)
    mfs = torch.empty((T, _D, B), **like)
    lfs = torch.empty((T, _D * _D, B), **like)
    nll = torch.empty((B,), **like)
    inputs, outputs = (ys_t, xi, w, sw, c), (mfs, lfs, nll)

    def launch():
        with torch.cuda.device(yss.device):
            rc = entry(*[x.data_ptr() for x in inputs], S, T, B, geo.team,
                       geo.rows, geo.lanes_per_block,
                       *[x.data_ptr() for x in outputs],
                       torch.cuda.current_stream(yss.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"per-lane ghfs_chirp_filter launch failed: "
                               f"CUDA error {rc}")
        ChirpFilterNLL._count("forward")

    return launch, outputs


def adjoint_launcher(consts: torch.Tensor, sgps: SigmaPoints,
                     yss: torch.Tensor, mfs: torch.Tensor, lfs: torch.Tensor,
                     gbar: torch.Tensor,
                     geometry: Optional[AdjointGeometry] = None):
    """Check the inputs of the adjoint kernel (the forward's inputs and
    outputs and the upstream gradient ``gbar (B,)`` of the final NLL, all
    CUDA tensors), build it and its output, and return ``(launch, dconsts
    (B, 43))``: each ``launch()`` runs the kernel once on the current
    stream, in ``geometry`` (default :func:`adjoint_geometry`'s), and
    counts the launch."""
    suffix = _check_lanes(consts, sgps, yss)
    B, T = yss.shape
    S = sgps.n_points
    if mfs.shape != (T, _D, B) or lfs.shape != (T, _D * _D, B) \
            or gbar.shape != (B,):
        raise ValueError("mfs, lfs and gbar must be the forward's (T, 4, B), "
                         "(T, 16, B) and (B,)")
    geo = geometry or adjoint_geometry(B, S, _num_sms(yss.device),
                                       yss.dtype)
    entry = getattr(load_adjoint_kernel().lib,
                    f"ghfs_chirp_filter_adjoint_{suffix}")
    ys_t = yss.T.contiguous()
    xi, w, _ = _rule_on(sgps, yss)
    inputs = (ys_t, xi, w, consts.contiguous(), mfs.contiguous(),
              lfs.contiguous(), gbar.to(yss.dtype).contiguous())
    dconsts = torch.empty((B, NUM_CONSTS), dtype=yss.dtype, device=yss.device)

    def launch():
        with torch.cuda.device(yss.device):
            rc = entry(*[x.data_ptr() for x in inputs], S, T, B, geo.team,
                       geo.rows, geo.producers, geo.ring,
                       geo.lanes_per_block, dconsts.data_ptr(),
                       torch.cuda.current_stream(yss.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ghfs_chirp_filter_adjoint launch failed: "
                               f"CUDA error {rc}")
        ChirpFilterNLL._count("adjoint")

    return launch, dconsts


def _lane_by_lane(fn, *lanes):
    """``fn`` on each lane alone (row i of each argument of ``lanes``, a
    ``(B, ...)`` tensor or, for lanes-last outputs, ``(..., B)`` by the
    caller), the outputs joined on their lane axis: a lane's bits then do
    not depend on the batch it is in, as a vmapped loop's do not (the
    plain versions' contractions go through BLAS, whose paths change with
    the batch width).  Each argument is ``(tensor, lane_axis)``."""
    B = lanes[0][0].shape[lanes[0][1]]
    outs = [fn(*(x.narrow(ax, i, 1) for x, ax in lanes)) for i in range(B)]
    if not isinstance(outs[0], tuple):
        return torch.cat(outs, 0)
    return tuple(torch.cat(parts, -1 if parts[0].dim() > 1 else 0)
                 for parts in zip(*outs))


def _forward(consts, sgps, yss):
    if yss.device.type == "cpu":
        if yss.shape[0] == 0:
            return filter_nll_reference(consts, sgps, yss)
        return _lane_by_lane(
            lambda c, y: filter_nll_reference(c, sgps, y),
            (consts, 0), (yss, 0))
    if yss.device.type != "cuda":
        raise ValueError(f"chirp_filter_nll runs on cpu or cuda tensors, got "
                         f"{yss.device}")
    launch, outputs = forward_launcher(consts, sgps, yss)
    launch()
    return outputs


def _adjoint(consts, sgps, yss, mfs, lfs, gbar):
    if yss.device.type == "cpu":
        if yss.shape[0] == 0:
            return filter_nll_adjoint_reference(consts, sgps, yss, mfs, lfs,
                                                gbar)
        return _lane_by_lane(
            lambda c, y, m, l, g: filter_nll_adjoint_reference(
                c, sgps, y, m, l, g),
            (consts, 0), (yss, 0), (mfs, 2), (lfs, 2), (gbar, 0))
    launch, dconsts = adjoint_launcher(consts, sgps, yss, mfs, lfs, gbar)
    launch()
    return dconsts


def _lanes_first(x: torch.Tensor, dim, size: int) -> torch.Tensor:
    """A vmapped input with its lane axis first (expanded if unbatched)."""
    if dim is None:
        return x.expand((size,) + x.shape)
    return x.movedim(dim, 0)


class ChirpFilterNLL(torch.autograd.Function):
    """``apply(consts, yss, sgps) -> (nll, mfs, lfs)``: the final filter
    NLL of one lane (``consts (43,)``, ``yss (T,)``: ``nll ()``, ``mfs (T,
    4)``, ``lfs (T, 16)``) or of B lanes (``(B, 43)``, ``(B, T)``: ``(B,)``,
    ``(T, 4, B)``, ``(T, 16, B)``), differentiable in ``consts``; ``mfs``
    and ``lfs`` (the filtered means and factors) are kept for the
    adjoint and carry no gradient.  ``torch.func.vmap`` over lanes calls
    the ``vmap`` staticmethod, which evaluates all lanes at once.  CUDA
    tensors launch the kernels, CPU tensors run the plain versions lane by
    lane.
    ``ChirpFilterNLL.launches`` counts kernel launches by name
    (``forward``, ``adjoint``), from any thread."""

    launches = {"forward": 0, "adjoint": 0}
    _lock = threading.Lock()

    @classmethod
    def _count(cls, name: str):
        with cls._lock:
            cls.launches[name] += 1

    @classmethod
    def reset_launches(cls):
        with cls._lock:
            for name in cls.launches:
                cls.launches[name] = 0

    @staticmethod
    def forward(consts, yss, sgps):
        if consts.dim() == 1:
            mfs, lfs, nll = _forward(consts[None], sgps, yss[None])
            return nll[0], mfs[..., 0], lfs[..., 0]
        mfs, lfs, nll = _forward(consts, sgps, yss)
        return nll, mfs, lfs

    @staticmethod
    def setup_context(ctx, inputs, output):
        consts, yss, sgps = inputs
        _, mfs, lfs = output
        ctx.sgps = sgps
        ctx.save_for_backward(consts, yss, mfs, lfs)
        ctx.mark_non_differentiable(mfs, lfs)

    @staticmethod
    def backward(ctx, gnll, _gmfs, _glfs):
        consts, yss, mfs, lfs = ctx.saved_tensors
        if consts.dim() == 1:
            d = _adjoint(consts[None], ctx.sgps, yss[None], mfs[..., None],
                         lfs[..., None], gnll.reshape(1))
            return d[0], None, None
        return _adjoint(consts, ctx.sgps, yss, mfs, lfs,
                        gnll.contiguous()), None, None

    @staticmethod
    def vmap(info, in_dims, consts, yss, sgps):
        c_dim, y_dim, _ = in_dims
        consts = _lanes_first(consts, c_dim, info.batch_size)
        yss = _lanes_first(yss, y_dim, info.batch_size)
        if consts.dim() != 2 or yss.dim() != 2:
            raise ValueError("ChirpFilterNLL maps over one lane axis: "
                             "consts (43,) and yss (T,) per lane")
        return ChirpFilterNLL.apply(consts, yss, sgps), (0, 2, 2)


def chirp_filter_nll(consts: torch.Tensor, yss: torch.Tensor,
                     sgps: SigmaPoints) -> torch.Tensor:
    """The final square-root GHFS filter NLL of the chirp model at the
    constants ``consts`` (:func:`chirp_lane_constants`) over ``yss``: one
    lane (``(43,)``, ``(T,)``) or a batch (``(B, 43)``, ``(B, T)``), of
    one dtype on one device; differentiable in ``consts`` and mappable by
    ``torch.func.vmap``.  CUDA tensors launch the forward kernel (and,
    for the gradient, the adjoint kernel); CPU tensors run the plain
    versions."""
    return ChirpFilterNLL.apply(consts, yss, sgps)[0]
