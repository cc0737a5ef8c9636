"""Square-root GHFS smoother for the chirp model (d=4), with the
Gauss-Hermite expectation of ``g(V)`` of every step: the hand-written CUDA
kernels of ``csrc/ghfs_chirp_smoother.cu``, the plain PyTorch version, and
the plain twin of the kernels' split.

It replaces no Pallas kernel: on the JAX package's main path
(``chirpgp_tpu.apps.pipeline.estimate_if_batched``) the smoother is an
XLA-compiled reverse ``lax.scan`` (``chirpgp_tpu.infer.batched.
sqrt_sgp_smoother_batched``) followed by ``gaussian_expectation_batched``;
the port's plain versions of both are eager loops of small launches.
:func:`ghfs_chirp_smoother` runs the plain versions for tensors on the
CPU and the kernels for tensors on a CUDA device; there is no fallback
from one to the other, and no gradient.  It reads the filter's outputs
(:func:`~chirpgp_tpu_torch.ops.chirp_filter.ghfs_chirp_filter`) as they
are, takes the filter's params (La Scala through
:func:`~chirpgp_tpu_torch.ops.chirp_filter.lascala_chirp_params`) and its
model constants.  :func:`smoother_cost` counts the least work of the call.

The kernels split a step where the carry enters.  Phase A computes, for
every t < T-1 and lane at once, what depends on the filter's (mf_t, Lf_t)
alone: ``ROW_WORDS`` = 30 words, m_p (4), the gain's ``X = R11^-1 R12``
(16, row-major; G = X^T) and R22's upper triangle (10, row by row), into
a ``(T-1, 30, B)`` scratch.  Phase B runs the short recursion over them,
``ms <- mf + X^T (ms - m_p)``, ``Ls <- tria([(X^T Ls)^T; R22])^T``, as a
chunked scan over time (:class:`BackwardKernels`): the T-1 steps of a lane
split into C chunks (:func:`backward_chunks`, :func:`chunk_starts`);
Compose folds each chunk but the first into one step of the same packing,
parallel over (chunk, lane); Carry runs the recursion over those C-1
aggregates, one thread per lane, for the carry at each chunk's later end;
Apply runs every chunk's steps from its carry, parallel over (chunk,
lane).  With C = 1, Apply alone runs the whole recursion.  Phase E takes
the expectation of every step at once.  :func:`smoother_rows_reference`
and :func:`smoother_backward_reference` are the plain twins of phases A
and B, :func:`smoother_backward_chunked_reference` that of phase B's
chunked form (:func:`smoother_compose_reference`,
:func:`smoother_carry_reference`, :func:`smoother_apply_reference`), and
:func:`smoother_expect_reference` that of phase E, which sums the GH nodes
in symmetric pairs with one logarithm a pair (:func:`gh_pairs_reference`;
``smoothed_expectation_batched`` is the plain version the wrapper runs on
the CPU).  Phase E takes the GH rule in the kernel's parameters, from the
host's float64 nodes and weights (``_gh_rule``).

:func:`gaussian_expectation_g` is phase E's second input mode: the same
expectation from a ``(T, B)`` mean and variance of V, as the fused
filter+smoother's slim output gives them (``ops/chirp_fused.py``); on the
CPU it is ``gaussian_expectation_batched(v_mean, sqrt(max(v_var, 0)), g)``,
bench.py's pipeline, and on a CUDA device the kernel
``smoother_expect_var``, whose twin is
:func:`smoother_expect_var_reference`.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from chirpgp_tpu_torch.infer.batched import (
    _backsub_cf, _rule_tensors, gaussian_expectation_batched,
    smoothed_expectation_batched, sqrt_sgp_smoother_batched, tria_cf)
from chirpgp_tpu_torch.infer.sqrt import _require_nonneg_weights
from chirpgp_tpu_torch.models.bijections import g
from chirpgp_tpu_torch.ops.chirp_filter import (
    MAX_POINTS, _chirp_constants, _chirp_pack)
from chirpgp_tpu_torch.quad.sigma_points import SigmaPoints, gauss_hermite
from chirpgp_tpu_torch.utils.numerics import psd_cholesky

__all__ = ["BACKWARD_KERNELS", "BACK_WARPS_PER_SM", "BackwardKernels",
           "CARRY_STEP_WEIGHT", "CARRY_WORDS", "KERNELS", "ROWS", "ROW_WORDS",
           "SCRATCH_CAP",
           "STEP_WORDS", "SmootherKernels", "TEAM", "backward_chunks",
           "chunk_starts", "expect_flop", "expect_mufu",
           "expectation_g_cost", "expectation_launcher",
           "gaussian_expectation_g", "gh_pairs_reference",
           "ghfs_chirp_smoother",
           "ghfs_chirp_smoother_kernel",
           "ghfs_chirp_smoother_reference", "ghfs_chirp_smoother_split",
           "load_smoother_kernel", "rows_per_member",
           "smoother_apply_reference", "smoother_backward_chunked_reference",
           "smoother_backward_reference", "smoother_carry_reference",
           "smoother_compose_reference", "smoother_cost",
           "smoother_expect_reference", "smoother_expect_var_reference",
           "smoother_kernel_launcher", "smoother_phase_costs",
           "smoother_rows_reference", "smoother_slabs"]

_D = 4
_V = 2   # the state V whose g is the frequency (kV in csrc/chirp_lcd.cuh)
_KERNEL = "ghfs_chirp_smoother"
# The expectation's cap on Gauss-Hermite nodes (csrc/ghfs_chirp_smoother.cu).
MAX_NODES = 32
# Words of phase A's row per lane-step: m_p, X, R22's upper triangle.
ROW_WORDS = _D + _D * _D + _D * (_D + 1) // 2
# Phase A's threads per lane-step (kTeam in csrc/ghfs_chirp_smoother.cu)
# and the pre-array rows per member it is built for (those of cubature and
# GH-3 at d = 4, the rules of Table I).
TEAM = 8
ROWS = (2, 11)
# The CUDA kernels of csrc/ghfs_chirp_smoother.cu: phase A, phase B's
# Compose, Carry and Apply (``smoother_backward``), and phase E.
BACKWARD_KERNELS = ("smoother_compose", "smoother_carry", "smoother_backward")
KERNELS = ("smoother_rows",) + BACKWARD_KERNELS + ("smoother_expect",)
# Words of a step of phase B's recursion (mf, then the row), of a chunk's
# aggregate (the same packing), and of the carry at a chunk boundary (ms,
# then Ls's lower triangle row by row).
STEP_WORDS = _D + ROW_WORDS
CARRY_WORDS = _D + _D * (_D + 1) // 2
# The (chunk, lane) warps per SM that backward_chunks aims at: two on each
# of an SM's four schedulers, whose one-warp blocks of 26 KB (float64,
# kStages = 3) the SM holds at once.
BACK_WARPS_PER_SM = 8
# What one step of Carry (one thread per lane, in series over the chunks)
# costs in steps of Compose or Apply (parallel over (chunk, lane)) in
# backward_chunks' chain: chunks shorter than ~50 steps no longer shorten
# Compose and Apply.  Measured on an H100 (time_smoother.py, B=100,
# T=3141, float32): C=64 0.158 ms, C=79 (a weight of 1) 0.176 ms.
CARRY_STEP_WEIGHT = 1.5
# Bytes of phase A's scratch per slab of lanes: past it, phases A and B run
# over slabs of lanes, one scratch reused.  A slab more runs phase B, which
# is bound by its recursion's latency, once more in sequence; 4 GiB holds
# the benchmark's B=4096 x T=3141 in one slab in float64 (3.09 GB).
SCRATCH_CAP = 4 << 30
_WARP = 32
# Lane-steps per chunk of smoother_rows_reference.
_TWIN_LANE_STEPS = 1 << 18


def ghfs_chirp_smoother_reference(params, dt, sgps: SigmaPoints,
                                  mfs: torch.Tensor, Lfs: torch.Tensor,
                                  if_order: int):
    """The plain version: ``sqrt_sgp_smoother_batched`` on the chirp model
    built from ``params`` in float64 on the host (constants cast to
    ``mfs.dtype``), then ``smoothed_expectation_batched`` of ``g(V)``.
    Same contract as :func:`ghfs_chirp_smoother`."""
    pack = _chirp_pack(params, None)
    mss, Lss = sqrt_sgp_smoother_batched(pack.m_and_cov, sgps, mfs, Lfs,
                                         float(dt))
    return mss, Lss, smoothed_expectation_batched(mss, Lss, _V, if_order)


def smoother_rows_reference(params, dt, sgps: SigmaPoints, mfs: torch.Tensor,
                            Lfs: torch.Tensor) -> torch.Tensor:
    """Phase A's plain twin: for every t < T-1 and lane at once, the step of
    ``sqrt_sgp_smoother_batched`` up to the gain, as ``(T-1, ROW_WORDS, B)``
    rows of m_p (4), X = R11^-1 R12 (16, row-major) and R22's upper
    triangle (10, row by row)."""
    trans = _chirp_pack(params, None).m_and_cov
    T, d, B = mfs.shape
    like = dict(dtype=mfs.dtype, device=mfs.device)
    xi, w, sw = _rule_tensors(sgps, mfs)
    LqT = psd_cholesky(trans.cov_const(float(dt))).to(**like).T[:, :, None]
    iu = torch.triu_indices(d, d)

    def chunk(t0, t1):
        """Rows t0..t1-1; its lane-steps (t, b) as one batch, b minor."""
        n = (t1 - t0) * B
        mf = mfs[t0:t1].permute(1, 0, 2).reshape(d, n)
        Lf = Lfs[t0:t1].permute(1, 2, 0, 3).reshape(d, d, n)
        chi = mf[None] + torch.einsum("sj,ijb->sib", xi, Lf)
        mu = trans.mean_channels_first(chi, float(dt))
        mp = torch.einsum("s,sib->ib", w, mu)
        dev_pred = sw[:, None, None] * (mu - mp[None])
        dev_prev = sw[:, None, None] * (chi - mf[None])
        M = torch.cat([
            torch.cat([dev_pred, dev_prev], dim=1),
            torch.cat([LqT.expand(d, d, n), mfs.new_zeros((d, d, n))], dim=1),
        ], dim=0)                                         # (S+d, 2d, n)
        R = tria_cf(M)
        X = _backsub_cf(R[:d, :d], R[:d, d:], d)
        rows = torch.cat([mp, X.reshape(d * d, n), R[d:, d:][iu[0], iu[1]]])
        return rows.reshape(ROW_WORDS, t1 - t0, B).permute(1, 0, 2)

    # Time in chunks of about _TWIN_LANE_STEPS lane-steps, to bound memory.
    steps = max(1, _TWIN_LANE_STEPS // max(B, 1))
    return torch.cat([chunk(t0, min(t0 + steps, T - 1))
                      for t0 in range(0, T - 1, steps)]
                     or [mfs.new_empty((0, ROW_WORDS, B))]).contiguous()


def _bstep(mf, row, ms, Ls):
    """Phase B's step on lanes (the last axis): ``ms <- mf + X^T (ms -
    m_p)``, ``Ls <- tria([(X^T Ls)^T; R22])^T`` with the words of ``row``
    (30, N): m_p, X (row-major), R22's upper triangle.  Returns ``(ms, Ls,
    X)``."""
    d, N = mf.shape
    iu = torch.triu_indices(d, d)
    mp, X = row[:d], row[d:d + d * d].reshape(d, d, N)
    R22 = row.new_zeros((d, d, N))
    R22[iu[0], iu[1]] = row[d + d * d:]
    G = X.transpose(0, 1)
    ms = mf + torch.einsum("ijb,jb->ib", G, ms - mp)
    GLs = torch.einsum("ijb,jkb->ikb", G, Ls)
    Ls = tria_cf(torch.cat([GLs.transpose(0, 1), R22], dim=0)).transpose(0, 1)
    return ms, Ls, X


def smoother_backward_reference(mfs: torch.Tensor, Lfs: torch.Tensor,
                                rows: torch.Tensor):
    """Phase B's plain twin: the recursion over phase A's ``rows`` (the
    fused form's ``bstep``), from the filter's row T-1.  Returns ``(mss,
    Lss)``."""
    T = mfs.shape[0]
    ms, Ls = mfs[-1], Lfs[-1]
    mss, Lss = [ms], [Ls]
    for t in range(T - 2, -1, -1):
        ms, Ls, _ = _bstep(mfs[t], rows[t], ms, Ls)
        mss.append(ms)
        Lss.append(Ls)
    return torch.stack(mss[::-1]), torch.stack(Lss[::-1])


def backward_chunks(T: int, B: int, num_sms: int = 132) -> int:
    """Phase B's chunks C for ``B`` lanes of ``T`` steps on a card of
    ``num_sms`` SMs: enough (chunk, lane) warps to give each SM
    ``BACK_WARPS_PER_SM`` (B / 32 warps per chunk), and no more than the
    C ~ sqrt(2 (T-1) / w) that makes the chain of Compose, Carry and
    Apply, ~2 (T-1) / C + w C steps with w = ``CARRY_STEP_WEIGHT``,
    shortest; at most T-1, and 1 below two steps (Apply alone, the plain
    recursion)."""
    steps = T - 1
    if steps < 2 or B < 1:
        return 1
    fill = max(1, BACK_WARPS_PER_SM * max(num_sms, 1) // -(-B // _WARP))
    chain = max(1, round(math.sqrt(2 * steps / CARRY_STEP_WEIGHT)))
    return min(fill, chain, steps)


def chunk_starts(T: int, chunks: int) -> list:
    """The first step of each of ``chunks`` chunks of the T-1 steps, and
    T-1: chunk k covers steps ``starts[k] .. starts[k+1] - 1`` (the
    kernels' ``chunk_start``)."""
    if not 1 <= chunks <= max(T - 1, 1):
        raise ValueError(f"phase B takes 1..{max(T - 1, 1)} chunks at T={T}, "
                         f"got {chunks}")
    return [k * (T - 1) // chunks for k in range(chunks)] + [T - 1]


def _walk_chunks(starts, ks, mfs, rows, carry, visit):
    """Chunks ``ks`` of ``starts`` walked at once, their lanes side by side
    (chunk-major, N = len(ks) B): step j of chunk k is t = starts[k+1] - 1
    - j, and a chunk whose steps are done keeps its carry.  ``carry`` is a
    tuple of (..., N) tensors whose first two are (ms, Ls); each step
    calls ``visit(j, t, valid, carry, X)`` with the stepped (ms, Ls) and
    X, and takes the tuple it returns."""
    B = mfs.shape[2]
    ends = torch.tensor([starts[k + 1] for k in ks])
    lens = ends - torch.tensor([starts[k] for k in ks])
    for j in range(int(lens.max()) if len(ks) else 0):
        valid = j < lens
        t = (ends - 1 - j).clamp_min(0)
        mf = mfs[t].permute(1, 0, 2).reshape(-1, len(ks) * B)
        row = rows[t].permute(1, 0, 2).reshape(-1, len(ks) * B)
        ms, Ls, X = _bstep(mf, row, carry[0], carry[1])
        new = visit(j, t, valid, (ms, Ls) + tuple(carry[2:]), X)
        if not bool(valid.all()):
            keep = valid.repeat_interleave(B).to(mfs.device)
            new = tuple(torch.where(keep, a, b) for a, b in zip(new, carry))
        carry = new
    return carry


def smoother_compose_reference(mfs: torch.Tensor, rows: torch.Tensor,
                               chunks: int) -> torch.Tensor:
    """Compose's plain twin: for each chunk k >= 1 of ``chunk_starts``, from
    x_ref = mf at its later end t1, the mean c from x_ref, the factor S
    from 0 and A <- X^T A from I over its steps t1-1 .. t0, as phase B's
    step ``(chunks-1, STEP_WORDS, B)``: mf := c, m_p := x_ref, X := A^T,
    R22 := S^T's upper triangle."""
    T, d, B = mfs.shape
    starts = chunk_starts(T, chunks)
    ks = list(range(1, chunks))
    N = len(ks) * B
    x_ref = mfs[[starts[k + 1] for k in ks]].permute(1, 0, 2).reshape(d, N)
    eye = torch.eye(d, dtype=mfs.dtype, device=mfs.device)[:, :, None]

    def visit(j, t, valid, carry, X):
        c, S, A = carry
        return c, S, torch.einsum("jib,jkb->ikb", X, A)

    c, S, A = _walk_chunks(starts, ks, mfs, rows,
                           (x_ref, mfs.new_zeros((d, d, N)),
                            eye.expand(d, d, N).contiguous()), visit)
    iu = torch.triu_indices(d, d)
    agg = torch.cat([c, x_ref, A.transpose(0, 1).reshape(d * d, N),
                     S.transpose(0, 1)[iu[0], iu[1]]])
    return agg.reshape(STEP_WORDS, len(ks), B).permute(1, 0, 2).contiguous()


def smoother_carry_reference(mfs: torch.Tensor, Lfs: torch.Tensor,
                             agg: torch.Tensor, chunks: int) -> torch.Tensor:
    """Carry's plain twin: phase B's step over the aggregates of chunks
    C-1 .. 1 from the filter's row T-1; the carry after chunk k, at the
    later end of chunk k-1, as ``(chunks-1, CARRY_WORDS, B)``: ms, then
    Ls's lower triangle row by row."""
    T, d, B = mfs.shape
    il = torch.tril_indices(d, d)
    ms, Ls = mfs[-1], Lfs[-1]
    out = [None] * (chunks - 1)
    for k in range(chunks - 2, -1, -1):
        ms, Ls, _ = _bstep(agg[k, :d], agg[k, d:], ms, Ls)
        out[k] = torch.cat([ms, Ls[il[0], il[1]]])
    return (torch.stack(out) if out
            else mfs.new_empty((0, CARRY_WORDS, B)))


def smoother_apply_reference(mfs: torch.Tensor, Lfs: torch.Tensor,
                             rows: torch.Tensor, bounds: torch.Tensor,
                             chunks: int):
    """Apply's plain twin: every chunk's steps from its carry, the last
    chunk from the filter's row T-1 and the others from ``bounds``
    (Carry's).  Returns ``(mss, Lss)``; with one chunk it is
    :func:`smoother_backward_reference`'s recursion, bit for bit."""
    T, d, B = mfs.shape
    starts = chunk_starts(T, chunks)
    il = torch.tril_indices(d, d)
    Ls0 = bounds.new_zeros((chunks - 1, d, d, B))
    Ls0[:, il[0], il[1]] = bounds[:, d:]
    ms = torch.cat([bounds[:, :d], mfs[-1:]]).permute(1, 0, 2)
    Ls = torch.cat([Ls0, Lfs[-1:]]).permute(1, 2, 0, 3)
    mss, Lss = torch.empty_like(mfs), torch.empty_like(Lfs)
    mss[-1], Lss[-1] = mfs[-1], Lfs[-1]

    def visit(j, t, valid, carry, X):
        ms, Ls = carry
        ks = valid.nonzero()[:, 0]
        mss[t[ks]] = ms.reshape(d, chunks, B)[:, ks].permute(1, 0, 2)
        Lss[t[ks]] = Ls.reshape(d, d, chunks, B)[:, :, ks].permute(2, 0, 1, 3)
        return carry

    _walk_chunks(starts, list(range(chunks)), mfs, rows,
                 (ms.reshape(d, chunks * B), Ls.reshape(d, d, chunks * B)),
                 visit)
    return mss, Lss


def smoother_backward_chunked_reference(mfs: torch.Tensor, Lfs: torch.Tensor,
                                        rows: torch.Tensor, chunks: int):
    """Phase B's chunked form, plain: Compose, Carry and Apply
    (:func:`smoother_compose_reference`, :func:`smoother_carry_reference`,
    :func:`smoother_apply_reference`) over phase A's ``rows`` in
    ``chunks`` chunks of :func:`chunk_starts`.  Returns ``(mss, Lss)``, the
    recursion's to round-off; with one chunk, bit for bit."""
    agg = smoother_compose_reference(mfs, rows, chunks)
    bounds = smoother_carry_reference(mfs, Lfs, agg, chunks)
    return smoother_apply_reference(mfs, Lfs, rows, bounds, chunks)


def ghfs_chirp_smoother_split(params, dt, sgps: SigmaPoints,
                              mfs: torch.Tensor, Lfs: torch.Tensor,
                              if_order: int):
    """The plain twin of the kernels: :func:`smoother_rows_reference`, then
    :func:`smoother_backward_reference`, then phase E's plain version,
    ``smoothed_expectation_batched``.  Same contract as
    :func:`ghfs_chirp_smoother`."""
    _check(sgps, mfs, Lfs, if_order)
    rows = smoother_rows_reference(params, dt, sgps, mfs, Lfs)
    mss, Lss = smoother_backward_reference(mfs, Lfs, rows)
    return mss, Lss, smoothed_expectation_batched(mss, Lss, _V, if_order)


def _check(sgps: SigmaPoints, mfs, Lfs, if_order):
    """The inputs both versions take; raises ``ValueError`` otherwise."""
    _require_nonneg_weights(sgps, "ghfs_chirp_smoother")
    if sgps.d != _D:
        raise ValueError(f"the chirp smoother is d={_D} only, got a "
                         f"d={sgps.d} rule")
    if sgps.n_points > MAX_POINTS:
        raise ValueError(f"the smoother takes 1..{MAX_POINTS} sigma points, "
                         f"got S={sgps.n_points}")
    if mfs.requires_grad or Lfs.requires_grad:
        raise ValueError("ghfs_chirp_smoother has no gradient; pass filter "
                         "outputs that do not require grad")
    if mfs.dtype not in (torch.float32, torch.float64) \
            or Lfs.dtype != mfs.dtype:
        raise ValueError(f"mfs and Lfs must both be float32 or float64, got "
                         f"{mfs.dtype} and {Lfs.dtype}")
    if mfs.device != Lfs.device:
        raise ValueError(f"mfs on {mfs.device}, Lfs on {Lfs.device}")
    if mfs.dim() != 3 or mfs.shape[1] != _D or mfs.shape[0] < 1:
        raise ValueError(f"mfs must be (T, {_D}, B) with T >= 1, got shape "
                         f"{tuple(mfs.shape)}")
    T, _, B = mfs.shape
    if tuple(Lfs.shape) != (T, _D, _D, B):
        raise ValueError(f"Lfs must be (T, {_D}, {_D}, B) = "
                         f"{(T, _D, _D, B)}, got {tuple(Lfs.shape)}")
    if not 1 <= if_order <= MAX_NODES:
        raise ValueError(f"if_order must be in 1..{MAX_NODES}, got {if_order}")


def ghfs_chirp_smoother(params, dt, sgps: SigmaPoints, mfs: torch.Tensor,
                        Lfs: torch.Tensor, if_order: int):
    """Sqrt GHFS smoother for the chirp model (d=4) over the filter's
    outputs, with the IF expectation ``E[g(V)]`` of each smoothed step.

    Parameters
    ----------
    params : 6 constrained values ``[lam, b, delta, ell, sigma, m0_v]``,
        those the filter ran with.
    dt : float.
    sgps : sigma-point rule for d=4 with nonnegative weights, S <= 81.
    mfs, Lfs : the filter's ``(T, 4, B)`` means and ``(T, 4, 4, B)`` lower
        factors, float32 or float64, T >= 1.
    if_order : the order K <= 32 of the Gauss-Hermite rule of ``E[g(V)]``,
        ``V ~ N(ms[2], |row 2 of Ls|^2)``: V is the chirp model's state 2,
        whose ``g`` is the frequency.

    Returns ``(mss (T, 4, B), Lss (T, 4, 4, B) lower, if_mean (T, B))`` in
    ``mfs.dtype`` on ``mfs.device``: the contract of
    ``sqrt_sgp_smoother_batched`` and ``smoothed_expectation_batched``.
    Row T-1 is the filter's.  CPU tensors run the plain version; CUDA
    tensors launch the kernels (built on first use) or raise.
    ``ghfs_chirp_smoother.launches`` counts the calls that launched them,
    ``ghfs_chirp_smoother.kernel_launches`` each kernel's launches.
    """
    _check(sgps, mfs, Lfs, if_order)
    if mfs.device.type == "cpu":
        return ghfs_chirp_smoother_reference(params, dt, sgps, mfs, Lfs,
                                             if_order)
    if mfs.device.type != "cuda":
        raise ValueError(f"ghfs_chirp_smoother runs on cpu or cuda tensors, "
                         f"got {mfs.device}")
    return ghfs_chirp_smoother_kernel(params, dt, sgps, mfs, Lfs, if_order)


def ghfs_chirp_smoother_kernel(params, dt, sgps: SigmaPoints,
                               mfs: torch.Tensor, Lfs: torch.Tensor,
                               if_order: int):
    """The kernels alone, for CUDA tensors: :func:`ghfs_chirp_smoother`
    without the plain route."""
    launch, outputs = smoother_kernel_launcher(params, dt, sgps, mfs, Lfs,
                                               if_order)
    launch()
    return outputs


def rows_per_member(S: int) -> int:
    """Phase A's pre-array rows per team member for ``S`` sigma points: the
    fewest of ``ROWS`` that hold the S + 4 rows of the pre-array."""
    if not 1 <= S <= MAX_POINTS:
        raise ValueError(f"the kernel takes 1..{MAX_POINTS} sigma points, "
                         f"got S={S}")
    return min(r for r in ROWS if TEAM * r >= S + _D)


def smoother_slabs(T: int, B: int, itemsize: int, cap: int | None = None):
    """The slabs ``(first lane, lanes)`` over which phases A and B run, so
    that the ``(T-1, ROW_WORDS, lanes)`` scratch stays within ``cap`` bytes
    (``SCRATCH_CAP`` by default): as few as that allows, each a whole
    number of warps of lanes but the last (one lane at least, whatever the
    cap)."""
    cap = SCRATCH_CAP if cap is None else cap
    per_lane = max(T - 1, 1) * ROW_WORDS * itemsize
    lanes = min(B, max(1, cap // per_lane))
    if _WARP <= lanes < B:
        lanes -= lanes % _WARP
    return [(b0, min(lanes, B - b0)) for b0 in range(0, B, max(lanes, 1))]


@functools.lru_cache(maxsize=None)
def _gh_rule(order: int):
    """The order-``order`` Gauss-Hermite rule of the expectation
    (``gauss_hermite(1, order)``) as two float64 ctypes arrays, nodes and
    weights, which phase E's launcher packs into the kernel's parameters."""
    gh = gauss_hermite(1, order)
    array = ctypes.c_double * order
    return array(*gh.xi[:, 0].tolist()), array(*np.asarray(gh.w).tolist())


def load_smoother_kernel():
    """Build (on first use) and load the kernel library, with the C
    signatures declared.  Returns ``_build.BuiltLibrary``."""
    from chirpgp_tpu_torch.ops._build import load_library
    built = load_library(_KERNEL)
    lib = built.lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dptr = ctypes.POINTER(ctypes.c_double)
    for dt in ("f32", "f64"):
        rows = getattr(lib, f"smoother_rows_{dt}")
        rows.argtypes = [ptr] * 5 + [dptr] + [i32] * 5 + [ptr] * 2
        compose = getattr(lib, f"smoother_compose_{dt}")
        compose.argtypes = [ptr] * 2 + [i32] * 4 + [ptr] * 2
        carry = getattr(lib, f"smoother_carry_{dt}")
        carry.argtypes = [ptr] * 3 + [i32] * 4 + [ptr] * 2
        back = getattr(lib, f"smoother_backward_{dt}")
        back.argtypes = [ptr] * 4 + [i32] * 4 + [ptr] * 3
        # Phase E in its two input modes takes the GH rule as the host's
        # float64 nodes and weights (``_gh_rule``).
        expect = getattr(lib, f"smoother_expect_{dt}")
        expect.argtypes = [ptr] * 2 + [dptr] * 2 + [i32] * 3 + [ptr] * 2
        expect_var = getattr(lib, f"smoother_expect_var_{dt}")
        expect_var.argtypes = expect.argtypes
        for fn in (rows, compose, carry, back, expect, expect_var):
            fn.restype = i32
    for fn in (lib.ghfs_chirp_smoother_max_points,
               lib.ghfs_chirp_smoother_max_nodes,
               lib.ghfs_chirp_smoother_num_consts,
               lib.ghfs_chirp_smoother_row_words,
               lib.ghfs_chirp_smoother_carry_words):
        fn.argtypes = []
        fn.restype = i32
    if (lib.ghfs_chirp_smoother_max_points() != MAX_POINTS
            or lib.ghfs_chirp_smoother_max_nodes() != MAX_NODES
            or lib.ghfs_chirp_smoother_row_words() != ROW_WORDS
            or lib.ghfs_chirp_smoother_carry_words() != CARRY_WORDS):
        raise RuntimeError("the smoother kernel's limits do not match the "
                           "wrapper's")
    return built


def _at(x, b0):
    """The address of lane ``b0`` of a lanes-minor tensor."""
    return x.data_ptr() + b0 * x.element_size()


class BackwardKernels:
    """Phase B's CUDA kernels (Compose, Carry, Apply) for one dtype and
    device, built on first use; each launch is counted in
    ``owner.kernel_launches`` (the wrapper function whose kernels they
    are, looked up at the launch).  Each method launches one kernel on the
    current stream and does no host work besides the ctypes call, so CUDA
    events around it time the kernel alone.  The tensors are contiguous,
    on ``device``, in ``dtype``; a slab is the lanes ``b0 .. b0 + nb - 1``
    of the filter's B, with ``nb = rows.shape[2]``."""

    def __init__(self, dtype: torch.dtype, device: torch.device, owner):
        self.lib = load_smoother_kernel().lib
        self.device, self.dtype, self.owner = device, dtype, owner
        self.num_sms = torch.cuda.get_device_properties(
            device).multi_processor_count
        suffix = "f32" if dtype == torch.float32 else "f64"
        self._fns = {k: getattr(self.lib, f"{k}_{suffix}")
                     for k in BACKWARD_KERNELS}

    def _run(self, kernel, *args):
        rc = self._fns[kernel](
            *args, torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"phase B kernel {kernel} launch failed: CUDA "
                               f"error {rc}")
        self.owner.kernel_launches[kernel] += 1

    def chunks(self, T: int, B: int) -> int:
        """:func:`backward_chunks` on this card."""
        return backward_chunks(T, B, self.num_sms)

    def scratch(self, nb: int, chunks: int, flat=None):
        """``(agg (chunks-1, STEP_WORDS, nb), bounds (chunks-1,
        CARRY_WORDS, nb))`` as views of ``flat`` (allocated where None; it
        may hold more), phase B's scratch for a slab of nb lanes."""
        n = chunks - 1
        words = n * (STEP_WORDS + CARRY_WORDS) * nb
        if flat is None:
            flat = torch.empty(words, dtype=self.dtype, device=self.device)
        return (flat[:n * STEP_WORDS * nb].view(n, STEP_WORDS, nb),
                flat[n * STEP_WORDS * nb:words].view(n, CARRY_WORDS, nb))

    def compose(self, mfs, rows, agg, chunks, b0=0):
        """Compose: the slab's aggregates of chunks 1.. into ``agg``."""
        T, _, B = mfs.shape
        if chunks > 1 and rows.shape[2]:
            self._run("smoother_compose", _at(mfs, b0), rows.data_ptr(), T, B,
                      rows.shape[2], chunks, agg.data_ptr())

    def carry(self, mfs, Lfs, agg, bounds, chunks, b0=0):
        """Carry: the slab's carries at the chunks' later ends into
        ``bounds``."""
        T, _, B = mfs.shape
        if chunks > 1 and agg.shape[2]:
            self._run("smoother_carry", _at(mfs, b0), _at(Lfs, b0),
                      agg.data_ptr(), T, B, agg.shape[2], chunks,
                      bounds.data_ptr())

    def apply(self, mfs, Lfs, rows, bounds, mss, lss, chunks, b0=0):
        """Apply: the slab's recursion in its chunks, into ``mss`` (T, 4, B)
        and ``lss`` (T, 16, B)."""
        T, _, B = mfs.shape
        self._run("smoother_backward", _at(mfs, b0), _at(Lfs, b0),
                  rows.data_ptr(), bounds.data_ptr() if bounds.numel() else 0,
                  T, B, rows.shape[2], chunks, _at(mss, b0), _at(lss, b0))

    def run(self, mfs, Lfs, rows, mss, lss, b0=0, chunks=None, scratch=None):
        """Phase B on a slab: Compose, Carry and Apply in ``chunks`` chunks
        (by default :meth:`chunks` of the filter's T and B, whatever the
        slab, so that slabs keep the bits of one), or Apply alone at one;
        ``scratch`` as :meth:`scratch` gives it (allocated if None)."""
        T, _, B = mfs.shape
        chunks = self.chunks(T, B) if chunks is None else chunks
        agg, bounds = scratch or self.scratch(rows.shape[2], chunks)
        if chunks > 1:
            self.compose(mfs, rows, agg, chunks, b0)
            self.carry(mfs, Lfs, agg, bounds, chunks, b0)
        self.apply(mfs, Lfs, rows, bounds, mss, lss, chunks, b0)


class SmootherKernels:
    """The smoother's CUDA kernels for one model (``params``, ``dt``),
    rule, IF order, dtype and device, built on first use.  Each method
    launches on the tensors it is given, on the current stream, and counts
    each kernel in ``ghfs_chirp_smoother.kernel_launches``; it does no
    host work besides the ctypes calls, so CUDA events around it time the
    kernels alone.  The tensors are contiguous, on ``device``, in
    ``dtype``; a slab is the lanes ``b0 .. b0 + nb - 1`` of the filter's B,
    with ``nb = rows.shape[2]``.  ``back`` holds phase B's kernels."""

    def __init__(self, params, dt, sgps: SigmaPoints, if_order: int,
                 dtype: torch.dtype, device: torch.device):
        self.lib = load_smoother_kernel().lib
        # Xi is not read by the smoother: the filter's layout, sqrt(Xi) = 1.
        consts = _chirp_constants(params, 1.0, dt)
        if consts.size != self.lib.ghfs_chirp_smoother_num_consts():
            raise RuntimeError("model constants do not match the kernel's "
                               "layout")
        self.consts = (ctypes.c_double * consts.size)(*consts.tolist())
        like = dict(dtype=dtype, device=device)
        self.device, self.S, self.if_order = device, sgps.n_points, if_order
        self.rows_per_member = rows_per_member(self.S)
        self.xi = torch.as_tensor(np.ascontiguousarray(sgps.xi), **like)
        self.w = torch.as_tensor(np.asarray(sgps.w), **like)
        self.sw = torch.sqrt(self.w)
        self.ghx, self.ghw = _gh_rule(if_order)
        suffix = "f32" if dtype == torch.float32 else "f64"
        self._fns = {k: getattr(self.lib, f"{k}_{suffix}")
                     for k in ("smoother_rows", "smoother_expect")}
        self.back = BackwardKernels(dtype, device, ghfs_chirp_smoother)

    def _run(self, kernel, *args):
        rc = self._fns[kernel](
            *args, torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ghfs_chirp_smoother kernel {kernel} launch "
                               f"failed: CUDA error {rc}")
        ghfs_chirp_smoother.kernel_launches[kernel] += 1

    def rows(self, mfs, Lfs, rows, b0=0):
        """Phase A: the slab's ``(T-1, ROW_WORDS, nb)`` rows of the filter's
        ``mfs`` (T, 4, B) and ``Lfs`` (T, 4, 4, B) into ``rows``."""
        T, _, B = mfs.shape
        if T > 1 and rows.shape[2]:
            self._run("smoother_rows", _at(mfs, b0), _at(Lfs, b0),
                      self.xi.data_ptr(), self.w.data_ptr(),
                      self.sw.data_ptr(), self.consts, self.S, T, B,
                      rows.shape[2], self.rows_per_member, rows.data_ptr())

    def backward(self, mfs, Lfs, rows, mss, lss, b0=0, chunks=None,
                 scratch=None):
        """Phase B: the slab's recursion over its ``rows``, into ``mss``
        (T, 4, B) and ``lss`` (T, 16, B) (:meth:`BackwardKernels.run`).
        The launcher passes the whole B's ``chunks`` and its ``scratch``;
        another ``chunks`` is for the tests and ``time_smoother.py``'s
        sweep."""
        self.back.run(mfs, Lfs, rows, mss, lss, b0, chunks, scratch)

    def expect(self, mss, lss, if_mean):
        """Phase E: the IF mean (T, B) of every step of ``mss``, ``lss``."""
        T, _, B = mss.shape
        if B:
            self._run("smoother_expect", mss.data_ptr(), lss.data_ptr(),
                      self.ghx, self.ghw, self.if_order, T, B,
                      if_mean.data_ptr())


def smoother_kernel_launcher(params, dt, sgps: SigmaPoints,
                             mfs: torch.Tensor, Lfs: torch.Tensor,
                             if_order: int):
    """Check the inputs of :func:`ghfs_chirp_smoother_kernel`, build the
    kernels (:class:`SmootherKernels`), the scratch and the outputs, and
    return ``(launch, outputs)``: each ``launch()`` runs phase A and phase
    B's kernels over each slab of lanes (:func:`smoother_slabs`), one
    scratch reused and phase B in the chunks of :func:`backward_chunks` at
    the whole B, then phase E, on the current stream, writes the outputs
    and counts one launch.  It does no host work besides the ctypes calls,
    so CUDA events around it time the kernels alone."""
    _check(sgps, mfs, Lfs, if_order)
    if mfs.device.type != "cuda":
        raise ValueError(f"the ghfs_chirp_smoother kernel runs on cuda "
                         f"tensors; a cpu tensor takes the plain version; "
                         f"got {mfs.device}")
    if not (mfs.is_contiguous() and Lfs.is_contiguous()):
        raise ValueError("the smoother kernel takes contiguous mfs and Lfs")
    T, _, B = mfs.shape
    kernels = SmootherKernels(params, dt, sgps, if_order, mfs.dtype,
                              mfs.device)
    like = dict(dtype=mfs.dtype, device=mfs.device)
    mss = torch.empty((T, _D, B), **like)
    lss = torch.empty((T, _D * _D, B), **like)
    if_mean = torch.empty((T, B), **like)
    slabs = smoother_slabs(T, B, mfs.element_size())
    most = max([nb for _, nb in slabs], default=0)
    scratch = torch.empty((T - 1) * ROW_WORDS * most, **like)
    chunks = kernels.back.chunks(T, B)
    chain = torch.empty((chunks - 1) * (STEP_WORDS + CARRY_WORDS) * most,
                        **like)
    # The closure holds every tensor a kernel reads or writes, so that they
    # live as long as ``launch``, whatever the caller keeps.
    views = [(b0, scratch[:(T - 1) * ROW_WORDS * nb].view(T - 1, ROW_WORDS,
                                                           nb),
              kernels.back.scratch(nb, chunks, chain))
             for b0, nb in slabs]

    def launch():
        with torch.cuda.device(mfs.device):
            for b0, rows, slab_chain in views:
                kernels.rows(mfs, Lfs, rows, b0)
                kernels.backward(mfs, Lfs, rows, mss, lss, b0, chunks,
                                 slab_chain)
            kernels.expect(mss, lss, if_mean)
        ghfs_chirp_smoother.launches += 1

    return launch, (mss, lss.reshape(T, _D, _D, B), if_mean)


class SmootherCost(NamedTuple):
    flop: int    # floating-point operations of the whole call
    bytes: int   # each input read once, each output written once


def _householder_column_flop(n: int, c: int) -> int:
    """Flop of one Householder column as the kernels do it, over its n live
    rows with c columns left: the Gram row, 2nc; alpha, |v|^2, beta, M_jj -
    alpha, 6; w_k, 2c; row j of R, 1 + 2c; beta w_k and the rank-one update
    of the columns k > j of the rows below j, (c-1)(1 + 2(n-1))."""
    return 2 * n * c + 6 + 4 * c + 1 + (c - 1) * (1 + 2 * (n - 1))


def _householder_flop(n: int, m: int) -> int:
    """Flop of the Householder triangularization of a dense n x m array
    (n >= m): column j over n - j rows with m - j columns left."""
    return sum(_householder_column_flop(n - j, m - j) for j in range(m))


def smoother_cost(S: int, T: int, B: int, dtype=torch.float32,
                  if_order: int = 10) -> SmootherCost:
    """Least work of one smoother call on ``B`` lanes of ``T`` steps with
    ``S`` sigma points: over the T - 1 smoothing steps, the lesser of the
    two square-root forms of the step below (an FMA is 2 flop; the 3
    transcendentals per sigma point and 3 per pair of GH nodes are not
    counted).

    Both forms: per sigma point chi = mf + xi Lf with Lf lower, 10 FMA,
    20; the chirp-LCD mean, 17 (as ``filter_cost``); its weighted mean, 8;
    dev_pred = sqrt(w)(mu - mp), 8.  Then the gain by back-substitution,
    per column of R12 and row i, 2(3-i) + 1: 64; the mean update (ms - mp,
    G times it, + mf), 4 + 32 + 4; G Ls with Ls lower, 80; the dense 8 x 4
    triangularization, column j over m = 8 - j rows and c = 4 - j columns:
    the norm 2m, alpha and v_j 2, |v|^2 2m, beta 1, and per column w_k and
    the update 4m, m + 4m: 4m + 3 + c(6m).

    The kernel's form: dev_prev = sqrt(w)(chi - mf), 8 per point, and the
    Householder of the (S + 4) x 8 pre-array ``[[dev_pred, dev_prev],
    [Lq^T, 0]]``.  The projected form: a rule exact to degree two has
    ``sum w xi xi^T = I``, so Q = sqrt(w) xi has orthonormal columns and
    dev_prev = Q Lf^T; the same R comes from C = Q^T dev_pred, 32 per
    point, E = dev_pred - Q C, 32 per point, the Householder of the S x 4
    array E to R_E, and that of the 12 x 8 array ``[[C, Lf^T], [R_E, 0],
    [Lq^T, 0]]``.  The projected form is the lesser from S = 30 on (GH-3,
    S = 81: 14251 flop per step against 16433); the kernel's at cubature's
    S = 8 (2636 against 3374).

    The expectation, per step (T of them): the variance of V from row 2
    of Ls, 5, its sqrt, 1, and the pair form's :func:`expect_flop` (60 at
    GH-10, so 66 a step).  Bytes: 4 + 16 words read and 4 + 16 + 1 written per seed-step."""
    phases = smoother_phase_costs(S, T, B, dtype, if_order)
    itemsize = torch.empty((), dtype=dtype).element_size()
    words = (_D + _D * _D) * 2 + 1
    return SmootherCost(sum(c.flop for c in phases.values()),
                        itemsize * words * T * B)


def smoother_phase_costs(S: int, T: int, B: int, dtype=torch.float32,
                         if_order: int = 10, chunks: int = 1) -> dict:
    """Each kernel's work (``KERNELS``), with the bytes of its own inputs
    and outputs, phase A's rows included; at ``chunks`` = 1 the flop split
    :func:`smoother_cost`'s.  ``smoother_rows``, the lesser form's step up
    to the gain X, reading 4 + 16 words and writing ``ROW_WORDS`` per
    seed-step but the last; ``smoother_backward`` (Apply), the mean
    update, G Ls and the 8 x 4 triangularization, ``step`` flop, reading 4
    + ``ROW_WORDS`` words per step, the filter's last row and the
    ``CARRY_WORDS`` of each chunk but the last, writing 4 + 16 per
    seed-step; ``smoother_expect``, the expectation (6 +
    :func:`expect_flop` per seed-step), reading ms[2] and Ls[2, :3] and
    writing one word per seed-step.  With chunks > 1 the
    chunked scan's own work (none at one chunk): ``smoother_compose``, per
    step of the chunks but the first the step and A <- X^T A (128 flop),
    reading ``STEP_WORDS`` and per chunk x_ref, writing ``STEP_WORDS``;
    ``smoother_carry``, the step per chunk but the first, reading its
    ``STEP_WORDS`` and the filter's last row, writing ``CARRY_WORDS``."""
    d = _D
    tria = sum(4 * (8 - j) + 3 + (4 - j) * 6 * (8 - j) for j in range(d))
    step = 40 + 80 + tria
    full = 61 * S + _householder_flop(S + d, 2 * d)
    projected = (117 * S + _householder_flop(S, d)
                 + _householder_flop(3 * d, 2 * d))
    itemsize = torch.empty((), dtype=dtype).element_size()
    steps = (T - 1) * B
    starts = chunk_starts(T, chunks)
    folded = (T - 1 - starts[1]) * B   # steps of the chunks but the first
    n = (chunks - 1) * B
    return {
        "smoother_rows": SmootherCost(
            (min(full, projected) + 64) * steps,
            itemsize * (d + d * d + ROW_WORDS) * steps),
        "smoother_compose": SmootherCost(
            (step + 128) * folded,
            itemsize * (STEP_WORDS * folded + (d + STEP_WORDS) * n)),
        "smoother_carry": SmootherCost(
            step * n, itemsize * ((STEP_WORDS + CARRY_WORDS) * n
                                  + (d + d * d) * B if n else 0)),
        "smoother_backward": SmootherCost(
            step * steps,
            itemsize * ((d + ROW_WORDS) * steps + (d + d * d) * (1 + T) * B
                        + CARRY_WORDS * n)),
        "smoother_expect": SmootherCost(
            (6 + expect_flop(if_order)) * T * B, itemsize * 5 * T * B)}


def _check_expectation(v_mean, v_var, order):
    """The inputs both versions of :func:`gaussian_expectation_g` take;
    raises ``ValueError`` otherwise."""
    if v_mean.dtype not in (torch.float32, torch.float64) \
            or v_var.dtype != v_mean.dtype:
        raise ValueError(f"v_mean and v_var must both be float32 or float64, "
                         f"got {v_mean.dtype} and {v_var.dtype}")
    if v_mean.dim() != 2 or v_var.shape != v_mean.shape:
        raise ValueError(f"v_mean and v_var must be (T, B) of one shape, got "
                         f"{tuple(v_mean.shape)} and {tuple(v_var.shape)}")
    if v_mean.device != v_var.device:
        raise ValueError(f"v_mean on {v_mean.device}, v_var on {v_var.device}")
    if v_mean.requires_grad or v_var.requires_grad:
        raise ValueError("gaussian_expectation_g has no gradient; pass inputs "
                         "that do not require grad")
    if not 1 <= order <= MAX_NODES:
        raise ValueError(f"order must be in 1..{MAX_NODES}, got {order}")


def gaussian_expectation_g(v_mean: torch.Tensor, v_var: torch.Tensor,
                           order: int = 10) -> torch.Tensor:
    """E[g(V)], V ~ N(v_mean, max(v_var, 0)), by the order-K Gauss-Hermite
    rule, for ``(T, B)`` means and variances (the fused filter+smoother's
    slim output): the counterpart of bench.py's
    ``gaussian_expectation_batched(v_mean, sqrt(max(v_var, 0)), g)``.
    Returns ``(T, B)`` in ``v_mean.dtype`` on its device.  CPU tensors run
    that plain expression; CUDA tensors launch phase E's kernel in its
    second input mode (built on first use) or raise;
    ``gaussian_expectation_g.launches`` counts the launches."""
    _check_expectation(v_mean, v_var, order)
    if v_mean.device.type == "cpu":
        return gaussian_expectation_batched(v_mean, v_var.clamp_min(0.0).sqrt(),
                                            g, order)
    if v_mean.device.type != "cuda":
        raise ValueError(f"gaussian_expectation_g runs on cpu or cuda tensors, "
                         f"got {v_mean.device}")
    launch, out = expectation_launcher(v_mean, v_var, order)
    launch()
    return out


def expectation_launcher(v_mean: torch.Tensor, v_var: torch.Tensor,
                         order: int = 10):
    """Check the inputs of :func:`gaussian_expectation_g` for the kernel,
    build it and the output, and return ``(launch, if_mean)``: each
    ``launch()`` runs ``smoother_expect_var`` once on the current stream
    (the GH rule in the kernel's parameters) and counts it; it does no host
    work besides the ctypes call."""
    _check_expectation(v_mean, v_var, order)
    if v_mean.device.type != "cuda":
        raise ValueError(f"the smoother_expect_var kernel runs on cuda "
                         f"tensors; a cpu tensor takes the plain version; got "
                         f"{v_mean.device}")
    if not (v_mean.is_contiguous() and v_var.is_contiguous()):
        raise ValueError("the expectation kernel takes contiguous v_mean and "
                         "v_var")
    lib = load_smoother_kernel().lib
    T, B = v_mean.shape
    ghx, ghw = _gh_rule(order)
    if_mean = torch.empty((T, B), dtype=v_mean.dtype, device=v_mean.device)
    entry = getattr(lib, "smoother_expect_var_"
                    + ("f32" if v_mean.dtype == torch.float32 else "f64"))

    def launch():
        with torch.cuda.device(v_mean.device):
            rc = entry(v_mean.data_ptr(), v_var.data_ptr(), ghx, ghw, order,
                       T, B, if_mean.data_ptr(),
                       torch.cuda.current_stream(v_mean.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"smoother_expect_var kernel launch failed: "
                               f"CUDA error {rc}")
        gaussian_expectation_g.launches += 1

    return launch, if_mean


def gh_pairs_reference(m: torch.Tensor, sd: torch.Tensor,
                       order: int) -> torch.Tensor:
    """Phase E's sum in the kernels' pair form, their plain twin: E[g(V)],
    V ~ N(m, sd^2), by the order-K Gauss-Hermite rule (``gauss_hermite(1,
    K)``, symmetric bit for bit), in ``m``'s dtype with the exact ``exp``
    and ``log1p``.  Per pair of nodes +-x_q, outermost first, with a = sd
    x_q, t = exp(-|m + a|), u = exp(-|m - a|): w_q [max(m + a, 0) + max(m
    - a, 0) + log1p(t u + (t + u))], one logarithm for the two nodes; then
    the centre node where K is odd.  NaN and +-inf go where
    ``gaussian_expectation_batched`` takes them."""
    gh = gauss_hermite(1, order)
    x, w = gh.xi[:, 0], np.asarray(gh.w)
    if not (np.array_equal(x, -x[::-1]) and np.array_equal(w, w[::-1])):
        raise ValueError(f"the order-{order} rule is not symmetric")
    like = dict(dtype=m.dtype, device=m.device)
    acc = torch.zeros_like(m)
    for q in range(order // 2):
        a = sd * torch.tensor(x[order - 1 - q], **like)
        p, r = m + a, m - a
        t, u = torch.exp(-p.abs()), torch.exp(-r.abs())
        acc = acc + torch.tensor(w[order - 1 - q], **like) * (
            (p.clamp_min(0.0) + r.clamp_min(0.0)) + torch.log1p(t * u + (t + u)))
    if order % 2:
        c = m + sd * torch.tensor(x[order // 2], **like)
        acc = acc + torch.tensor(w[order // 2], **like) * (
            c.clamp_min(0.0) + torch.log1p(torch.exp(-c.abs())))
    return acc


def smoother_expect_reference(mss: torch.Tensor, Lss: torch.Tensor,
                              order: int) -> torch.Tensor:
    """The plain twin of ``smoother_expect``: :func:`gh_pairs_reference`
    of V ~ N(mss[t, 2], sum_{j <= 2} Lss[t, 2, j]^2) for the smoother's
    ``(T, 4, B)`` means and ``(T, 4, 4, B)`` lower factors: ``(T, B)``."""
    L = Lss[:, _V]
    var = L[:, 0] * L[:, 0] + L[:, 1] * L[:, 1] + L[:, 2] * L[:, 2]
    return gh_pairs_reference(mss[:, _V], var.sqrt(), order)


def smoother_expect_var_reference(v_mean: torch.Tensor, v_var: torch.Tensor,
                                  order: int) -> torch.Tensor:
    """The plain twin of ``smoother_expect_var``: :func:`gh_pairs_reference`
    of V ~ N(v_mean, max(v_var, 0)) (a NaN variance stays NaN)."""
    sd = torch.where(v_var < 0, torch.zeros_like(v_var), v_var).sqrt()
    return gh_pairs_reference(v_mean, sd, order)


def expect_flop(order: int) -> int:
    """Flop of phase E's pair form per element, after the standard
    deviation: per pair of nodes a = sd x, 1; m + a and m - a, 2; 1 + t
    and the product's FMA, 3; the two max, 2; their sum and the
    logarithm's, 2; the weighted sum, 2: 12; the centre node, 7 (its point
    2, 1 + t 1, the max 1, the sum 1, the weighted sum 2)."""
    return 12 * (order // 2) + 7 * (order % 2)


def expect_mufu(order: int) -> int:
    """Special-function-unit operations (MUFU) per element of phase E's
    float32 kernels: ex2, ex2 and lg2 per pair of nodes, ex2 and lg2 for
    the centre node, and the square root's reciprocal square root."""
    return 3 * (order // 2) + 2 * (order % 2) + 1


def expectation_g_cost(T: int, B: int, dtype=torch.float32,
                       order: int = 10) -> SmootherCost:
    """Least work of one :func:`gaussian_expectation_g` call: per element
    the clamp and sqrt, 2, and the pair form's :func:`expect_flop` (its
    transcendentals are not counted: :func:`expect_mufu`); the mean and
    variance read and the expectation written, 3 words."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return SmootherCost((2 + expect_flop(order)) * T * B,
                        itemsize * 3 * T * B)


gaussian_expectation_g.launches = 0
ghfs_chirp_smoother.launches = 0
# Launches of each CUDA kernel of the smoother (phases A and B once per
# slab, phase E once per call).
ghfs_chirp_smoother.kernel_launches = dict.fromkeys(KERNELS, 0)
