"""Time-axis-sharded parallel Kalman filtering and smoothing (counterpart
of ``chirpgp_tpu.infer.parallel_sharded``).

The time axis is split over a mesh of ranks: each rank scans its chunk of
filtering (or smoothing) elements, the ranks all-gather their chunks'
totals (one tiny element each), each folds the totals before its own into
a prefix, and one batched combine applies it.  Associativity makes the
decomposition exact: the results match the unsharded scan to float
tolerance.  Every rank returns the full-length outputs.
"""

from typing import Tuple

import torch

from chirpgp_tpu_torch.infer.common import log_normal_pdf
from chirpgp_tpu_torch.infer.parallel_kf import (
    _SmootherElement, _combine_filter, _combine_smoother, _filter_elements,
    _mv, _tree_map, associative_scan, blocked_scan, filter_identity,
    smoother_identity)
from chirpgp_tpu_torch.parallel.mesh import Mesh, _local_rows, all_gather
from chirpgp_tpu_torch.utils.numerics import psd_solve_batched

__all__ = ["kf_parallel_time_sharded", "rts_parallel_time_sharded"]


def _sharded_assoc_scan(combine, local, mesh: Mesh, reverse: bool = False,
                        identity=None, block_size=None):
    """Inclusive scan of the whole time axis, of which ``local`` is this
    rank's chunk.  The local scan (blocked when ``block_size`` is given),
    an all-gather of the chunks' totals (the first element for a reverse
    scan), the exclusive fold of the totals before this chunk (after it,
    reversed) in scan order with ``combine(acc, elem)`` in both
    directions, and one combine of that prefix, first operand, into the
    chunk; the first chunk (last, reversed) keeps its local scan."""
    if block_size is not None:
        scanned = blocked_scan(combine, local, identity, block_size,
                               reverse=reverse)
    else:
        scanned = associative_scan(combine, local, reverse=reverse)
    edge = 0 if reverse else -1
    totals = all_gather(_tree_map(lambda x: x[edge][None], scanned), mesh)
    before = range(mesh.size - 1, mesh.rank, -1) if reverse \
        else range(mesh.rank)
    prefix = None
    for pos in before:
        elem = _tree_map(lambda x: x[pos:pos + 1], totals)
        prefix = elem if prefix is None else combine(prefix, elem)
    if prefix is None:
        return scanned
    n_local = scanned[0].shape[0]
    return combine(_tree_map(lambda x: x.expand((n_local,) + x.shape[1:]),
                             prefix), scanned)


def _check_mesh(T: int, mesh: Mesh, axis: str):
    if axis not in mesh.axis_names:
        axis = mesh.axis_names[0]
    if T % mesh.shape[axis]:
        raise ValueError(f"T={T} is not a multiple of the mesh size "
                         f"{mesh.shape[axis]}")


def kf_parallel_time_sharded(F, Sigma, H, Xi, m0, P0, ys, mesh: Mesh,
                             axis: str = "time", block_size=None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Parallel-in-time KF with the time axis sharded over ``mesh``; the
    contract of :func:`~chirpgp_tpu_torch.infer.parallel_kf.kf_parallel`.
    ``ys`` (T,), T a multiple of the mesh size.  Computes in ``m0``'s dtype
    on the mesh's device; ``block_size`` selects the blocked local scan.
    The mesh has one axis; ``axis`` names it, as in the JAX package."""
    dev = mesh.device
    m0 = torch.as_tensor(m0).to(dev)
    F, Sigma, H, P0, ys = (torch.as_tensor(x).to(device=dev, dtype=m0.dtype)
                           for x in (F, Sigma, H, P0, ys))
    _check_mesh(ys.shape[0], mesh, axis)
    elems = _filter_elements(F, Sigma, H, Xi, m0, P0, ys)
    local = _tree_map(lambda x: _local_rows(x, mesh), elems)
    scanned = _sharded_assoc_scan(
        _combine_filter, local, mesh,
        identity=filter_identity(m0.shape[0], m0.dtype, dev),
        block_size=block_size)
    mfs, Pfs = all_gather((scanned.b, scanned.C), mesh)

    prev_m = torch.cat([m0[None], mfs[:-1]])
    prev_P = torch.cat([P0[None], Pfs[:-1]])
    mp = prev_m @ F.T
    Pp = F @ prev_P @ F.T + Sigma
    S = torch.einsum("i,tij,j->t", H, Pp, H) + Xi
    nll = -log_normal_pdf(ys, mp @ H, S)
    return mfs, Pfs, torch.cumsum(nll, 0)


def rts_parallel_time_sharded(F, Sigma, mfs, Pfs, mesh: Mesh,
                              axis: str = "time", block_size=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-sharded parallel RTS smoother; the contract of
    :func:`~chirpgp_tpu_torch.infer.parallel_kf.rts_parallel`.  The T-1
    smoothing elements get one identity element at the end, so that the
    sharded axis keeps T's length."""
    dev = mesh.device
    mfs = torch.as_tensor(mfs).to(dev)
    F, Sigma, Pfs = (torch.as_tensor(x).to(device=dev, dtype=mfs.dtype)
                     for x in (F, Sigma, Pfs))
    T, d = mfs.shape
    _check_mesh(T, mesh, axis)
    Pf, mf = Pfs[:-1], mfs[:-1]
    Pp = F @ Pf @ F.T + Sigma
    E = psd_solve_batched(Pp, F @ Pf).transpose(-1, -2)
    g = mf - _mv(E, mf @ F.T)
    L = Pf - E @ Pp @ E.transpose(-1, -2)
    ident = smoother_identity(d, mfs.dtype, dev)
    elems = _SmootherElement(*(torch.cat([x, i[None]])
                               for x, i in zip((E, g, L), ident)))
    local = _tree_map(lambda x: _local_rows(x, mesh), elems)
    scanned = _sharded_assoc_scan(_combine_smoother, local, mesh,
                                  reverse=True, identity=ident,
                                  block_size=block_size)
    E_s, g_s, L_s = (x[:-1] for x in all_gather(tuple(scanned), mesh))
    mss = _mv(E_s, mfs[-1]) + g_s
    Pss = E_s @ Pfs[-1] @ E_s.transpose(-1, -2) + L_s
    return torch.cat([mss, mfs[-1][None]]), torch.cat([Pss, Pfs[-1][None]])
