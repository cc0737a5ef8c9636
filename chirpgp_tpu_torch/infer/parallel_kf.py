"""Parallel-in-time Kalman filtering and RTS smoothing by associative scans
(counterpart of ``chirpgp_tpu.infer.parallel_kf``).

The LGSSM filter and smoother are an associative prefix operation over
conditional-Gaussian elements (Sarkka & Garcia-Fernandez 2021, *Temporal
parallelization of Bayesian smoothers*): O(log T) depth, each level one
batched combine over all pairs of (T, d, d) elements.

:func:`associative_scan` is the port of ``jax.lax.associative_scan`` (its
odd/even recursion, so that the association order and the rounding are
JAX's); :func:`blocked_scan` scans sequentially within blocks with the
block index on the combine's batch axis, and associatively across the
block totals.  Elements are ``NamedTuple``s of tensors with time leading;
everything computes in the elements' dtype and on their device, and is
differentiable with ``torch.autograd`` (no in-place writes).
"""

from typing import Callable, NamedTuple, Tuple

import torch

from chirpgp_tpu_torch.infer.common import _as_data, log_normal_pdf
from chirpgp_tpu_torch.utils.numerics import psd_solve_batched, solve_small

__all__ = ["kf_parallel", "rts_parallel", "kf_rts_parallel",
           "associative_scan", "blocked_scan", "filter_identity",
           "smoother_identity"]


def _rebuild(tree, leaves):
    return type(tree)(*leaves) if hasattr(tree, "_fields") \
        else type(tree)(leaves)


def _tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of a tensor or a (named) tuple of tensors."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return _rebuild(tree, [fn(*xs) for xs in zip(tree, *rest)])


def _stack(trees, dim: int):
    """``torch.stack`` leaf by leaf over a list of like trees."""
    if isinstance(trees[0], torch.Tensor):
        return torch.stack(trees, dim)
    return _rebuild(trees[0], [torch.stack(ls, dim) for ls in zip(*trees)])


def _first_leaf(tree) -> torch.Tensor:
    return tree if isinstance(tree, torch.Tensor) else tree[0]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``[even0, odd0, even1, odd1, ...]`` along axis 0 (``len(even)`` is
    ``len(odd)`` or one more)."""
    n = odd.shape[0]
    pairs = torch.stack([even[:n], odd], dim=1).flatten(0, 1)
    return torch.cat([pairs, even[n:]]) if even.shape[0] > n else pairs


def associative_scan(combine: Callable, elems, reverse: bool = False):
    """Inclusive scan of ``elems`` (time on axis 0) under the associative
    ``combine``, batched on axis 0: ``jax.lax.associative_scan``'s odd/even
    recursion, any length.  Each level is two batched combines over all
    pairs.  ``reverse=True`` scans from the end, with JAX's operand
    convention: the first operand of ``combine`` is the suffix aggregate
    (later steps), the second the earlier element."""
    if reverse:
        elems = _tree_map(lambda e: e.flip(0), elems)

    def scan(elems):
        n = _first_leaf(elems).shape[0]
        if n < 2:
            return elems
        reduced = combine(_tree_map(lambda e: e[0:-1:2], elems),
                          _tree_map(lambda e: e[1::2], elems))
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine(_tree_map(lambda e: e[:-1], odd),
                           _tree_map(lambda e: e[2::2], elems))
        else:
            even = combine(odd, _tree_map(lambda e: e[2::2], elems))
        even = _tree_map(lambda e, r: torch.cat([e[:1], r]), elems, even)
        return _tree_map(_interleave, even, odd)

    out = scan(elems)
    if reverse:
        out = _tree_map(lambda e: e.flip(0), out)
    return out


def blocked_scan(combine: Callable, elems, identity, block_size: int,
                 reverse: bool = False):
    """Blocked prefix scan: a sequential scan of depth ``block_size`` whose
    every step combines the ``nb`` blocks at once (the block index rides
    the combine's batch axis), an associative scan over the block totals
    (``nb`` padded to a power of two with the identity), and one T-wide
    combine with the exclusive block offsets.

    ``identity`` holds per-element identity leaves (no time axis), used to
    pad the tail and as the first block's offset.  ``reverse=True`` gives
    suffix aggregates under :func:`associative_scan`'s operand convention.
    """
    T = _first_leaf(elems).shape[0]
    if reverse:
        elems = _tree_map(lambda e: e.flip(0), elems)
    C = min(int(block_size), T)
    nb = -(-T // C)
    pad = nb * C - T
    if pad:
        elems = _tree_map(
            lambda e, i: torch.cat([e, i.expand((pad,) + i.shape)]),
            elems, identity)
    # (T, ...) -> (C, nb, ...): step over the within-block index.
    blk = _tree_map(lambda e: e.reshape((nb, C) + e.shape[1:]).transpose(0, 1),
                    elems)
    carry = _tree_map(lambda i: i.expand((nb,) + i.shape), identity)
    prefixes = []
    for c in range(C):
        carry = combine(carry, _tree_map(lambda e: e[c], blk))
        prefixes.append(carry)
    totals = carry
    nb2 = 1 << (nb - 1).bit_length()
    if nb2 != nb:
        totals = _tree_map(
            lambda t, i: torch.cat([t, i.expand((nb2 - nb,) + i.shape)]),
            totals, identity)
    inc = associative_scan(combine, totals)
    offsets = _tree_map(lambda i, s: torch.cat([i[None], s[:nb - 1]]),
                        identity, inc)
    # (nb, C, ...) -> (T_padded, ...)
    flat_p = _tree_map(lambda p: p.reshape((nb * C,) + p.shape[2:]),
                       _stack(prefixes, 1))
    flat_o = _tree_map(
        lambda o: o[:, None].expand((nb, C) + o.shape[1:]).reshape(
            (nb * C,) + o.shape[1:]), offsets)
    out = _tree_map(lambda x: x[:T], combine(flat_o, flat_p))
    if reverse:
        out = _tree_map(lambda x: x.flip(0), out)
    return out


class _FilterElement(NamedTuple):
    A: torch.Tensor    # (T, d, d)
    b: torch.Tensor    # (T, d)
    C: torch.Tensor    # (T, d, d)
    eta: torch.Tensor  # (T, d)
    J: torch.Tensor    # (T, d, d)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _combine_filter(a: _FilterElement, b: _FilterElement) -> _FilterElement:
    """Associative combination of filtering elements (batched on axis 0),
    with the JAX package's unrolled no-pivot solves."""
    d = a.A.shape[-1]
    I = torch.eye(d, dtype=a.A.dtype, device=a.A.device)
    M = solve_small(I + a.C @ b.J, I.expand(a.C.shape))
    AjM = b.A @ M
    A = AjM @ a.A
    bb = _mv(AjM, a.b + _mv(a.C, b.eta)) + b.b
    C = AjM @ a.C @ b.A.transpose(-1, -2) + b.C
    N = solve_small(I + b.J @ a.C, I.expand(a.C.shape))
    AiTN = a.A.transpose(-1, -2) @ N
    eta = _mv(AiTN, b.eta - _mv(b.J, a.b)) + a.eta
    J = AiTN @ b.J @ a.A + a.J
    return _FilterElement(A, bb, C, eta, J)


def _first_set(first: torch.Tensor, rest: torch.Tensor) -> torch.Tensor:
    """``rest`` with its element 0 replaced by ``first`` (JAX's
    ``.at[0].set``), as a concatenation."""
    return torch.cat([first[None], rest[1:]])


def _filter_elements(F, Sigma, H, Xi, m0, P0, ys) -> _FilterElement:
    """Per-step conditional-Gaussian elements of a time-invariant LGSSM;
    the first absorbs the prior."""
    T = ys.shape[0]
    d = m0.shape[0]
    I = torch.eye(d, dtype=m0.dtype, device=m0.device)
    S = H @ Sigma @ H + Xi
    K = Sigma @ H / S
    ImKH = I - torch.outer(K, H)
    A_g = ImKH @ F
    C_g = ImKH @ Sigma
    FTH = F.T @ H
    J_g = torch.outer(FTH, FTH) / S

    m1p = F @ m0
    P1p = F @ P0 @ F.T + Sigma
    S1 = H @ P1p @ H + Xi
    K1 = P1p @ H / S1
    b1 = m1p + K1 * (ys[0] - H @ m1p)
    C1 = P1p - torch.outer(K1, K1) * S1

    Z = torch.zeros_like(A_g)
    z = torch.zeros_like(m0)
    return _FilterElement(
        A=_first_set(Z, A_g.expand(T, d, d)),
        b=_first_set(b1, ys[:, None] * K[None, :]),
        C=_first_set(C1, C_g.expand(T, d, d)),
        eta=_first_set(z, ys[:, None] * (FTH / S)[None, :]),
        J=_first_set(Z, J_g.expand(T, d, d)))


def filter_identity(d: int, dtype, device=None) -> _FilterElement:
    """Two-sided identity of :func:`_combine_filter`: the element of a
    deterministic identity transition with no observation."""
    I = torch.eye(d, dtype=dtype, device=device)
    z = torch.zeros(d, dtype=dtype, device=device)
    Z = torch.zeros(d, d, dtype=dtype, device=device)
    return _FilterElement(I, z, Z, z, Z)


def _scan_filter(elems: _FilterElement, block_size, like: torch.Tensor):
    if block_size is not None:
        return blocked_scan(_combine_filter, elems,
                            filter_identity(like.shape[-1], like.dtype,
                                            like.device), block_size)
    return associative_scan(_combine_filter, elems)


def kf_parallel(F, Sigma, H, Xi, m0, P0, ys, block_size=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Parallel-in-time Kalman filter; the contract of
    :func:`chirpgp_tpu_torch.infer.filters.kf` (means, covariances,
    cumulative NLL).  ``block_size`` selects :func:`blocked_scan`; ``None``
    the flat :func:`associative_scan`.  Computes in ``m0``'s dtype on its
    device."""
    ys = _as_data(ys, m0)
    scanned = _scan_filter(_filter_elements(F, Sigma, H, Xi, m0, P0, ys),
                           block_size, m0)
    mfs, Pfs = scanned.b, scanned.C
    # NLL from one batched predicted-moment pass.
    prev_m = torch.cat([m0[None], mfs[:-1]])
    prev_P = torch.cat([P0[None], Pfs[:-1]])
    mp = prev_m @ F.T
    Pp = F @ prev_P @ F.T + Sigma
    S = torch.einsum("i,tij,j->t", H, Pp, H) + Xi
    nll = -log_normal_pdf(ys, mp @ H, S)
    return mfs, Pfs, torch.cumsum(nll, 0)


class _SmootherElement(NamedTuple):
    E: torch.Tensor   # (T-1, d, d)
    g: torch.Tensor   # (T-1, d)
    L: torch.Tensor   # (T-1, d, d)


def smoother_identity(d: int, dtype, device=None) -> _SmootherElement:
    """Two-sided identity of :func:`_combine_smoother`."""
    return _SmootherElement(torch.eye(d, dtype=dtype, device=device),
                            torch.zeros(d, dtype=dtype, device=device),
                            torch.zeros(d, d, dtype=dtype, device=device))


def _combine_smoother(a: _SmootherElement,
                      b: _SmootherElement) -> _SmootherElement:
    """Composition of affine-Gaussian backward maps.  Under a reverse scan
    ``a`` is the suffix aggregate (later steps) and ``b`` the earlier
    element absorbed, so the result is ``f_b o f_a``."""
    E = b.E @ a.E
    g = _mv(b.E, a.g) + b.g
    L = b.E @ a.L @ b.E.transpose(-1, -2) + b.L
    return _SmootherElement(E, g, L)


def _smooth(elems: _SmootherElement, mfs, Pfs, block_size):
    """The backward scan over the smoother elements, applied to the last
    filtering moments; the final filtering moments appended."""
    if block_size is not None:
        scanned = blocked_scan(
            _combine_smoother, elems,
            smoother_identity(mfs.shape[-1], mfs.dtype, mfs.device),
            block_size, reverse=True)
    else:
        scanned = associative_scan(_combine_smoother, elems, reverse=True)
    mss = _mv(scanned.E, mfs[-1]) + scanned.g
    Pss = scanned.E @ Pfs[-1] @ scanned.E.transpose(-1, -2) + scanned.L
    return torch.cat([mss, mfs[-1][None]]), torch.cat([Pss, Pfs[-1][None]])


def rts_parallel(F, Sigma, mfs, Pfs, block_size=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallel-in-time RTS smoother; the contract of
    :func:`chirpgp_tpu_torch.infer.smoothers.rts`.  ``block_size`` as in
    :func:`kf_parallel`."""
    Pf = Pfs[:-1]
    mf = mfs[:-1]
    Pp = F @ Pf @ F.T + Sigma
    # Gain E = Pf F^T Pp^{-1}: E^T = Pp^{-1} F Pf, an unrolled SPD solve.
    E = psd_solve_batched(Pp, F @ Pf).transpose(-1, -2)
    g = mf - _mv(E, mf @ F.T)
    L = Pf - E @ Pp @ E.transpose(-1, -2)
    return _smooth(_SmootherElement(E, g, L), mfs, Pfs, block_size)


def kf_rts_parallel(F, Sigma, H, Xi, m0, P0, ys, block_size=None):
    """Parallel filter and smoother: ``(mfs, Pfs, nll, mss, Pss)``."""
    mfs, Pfs, nll = kf_parallel(F, Sigma, H, Xi, m0, P0, ys, block_size)
    mss, Pss = rts_parallel(F, Sigma, mfs, Pfs, block_size)
    return mfs, Pfs, nll, mss, Pss
