"""Bootstrap particle filter (sequential Monte Carlo) for the chirp SSMs
(counterpart of ``chirpgp_tpu.infer.smc``).

N particles live on the device as an (N, d) batch; propagation samples the
model's conditional discretization (the ``Transition`` the Gaussian
filters use), weighting is the 1-D Gaussian measurement likelihood, and
resampling is systematic and adaptive.  The log marginal likelihood is an
unbiased SMC counterpart of the Gaussian filters' ``-nll``.

Torch cannot replay JAX's threefry streams, so the filter runs on
:class:`SMCDraws`, the random numbers as tensors: drawn from a
``torch.Generator`` by default, or given by the caller (the tests feed the
JAX package's draws).
"""

import math
from typing import NamedTuple, Optional

import torch

from chirpgp_tpu_torch.infer.common import _as_data
from chirpgp_tpu_torch.models.transitions import as_transition
from chirpgp_tpu_torch.parallel.mesh import (
    Mesh, all_gather, all_reduce, rank_stream)

__all__ = ["bootstrap_filter", "bootstrap_filter_sharded",
           "systematic_resample", "effective_sample_size", "SMCResult",
           "SMCDraws", "smc_draws", "smc_draws_sharded"]


class SMCResult(NamedTuple):
    means: torch.Tensor    # (T, d) weighted filtering means
    log_ml: torch.Tensor   # (T,) cumulative log marginal likelihood
    ess: torch.Tensor      # (T,) effective sample size before resampling


class SMCDraws(NamedTuple):
    """Every random number of one filter run: the JAX package's
    ``normal(sub, (N, d))`` of the initial cloud, and per step its
    proposal ``normal(k_prop, (N, d))`` and resampling ``uniform(k_res)``."""
    z0: torch.Tensor   # (N, d)
    z: torch.Tensor    # (T, N, d)
    u: torch.Tensor    # (T,)


def smc_draws(generator: torch.Generator, T: int, N: int, d: int,
              dtype=torch.float64) -> SMCDraws:
    """:class:`SMCDraws` from ``generator``, on its device."""
    dev = generator.device
    return SMCDraws(
        z0=torch.randn((N, d), generator=generator, dtype=dtype, device=dev),
        z=torch.randn((T, N, d), generator=generator, dtype=dtype, device=dev),
        u=torch.rand((T,), generator=generator, dtype=dtype, device=dev))


def smc_draws_sharded(generator: torch.Generator, T: int, n_local: int,
                      d: int, rank: int, dtype=torch.float64) -> SMCDraws:
    """One rank's :class:`SMCDraws` for :func:`bootstrap_filter_sharded`,
    on ``generator``'s device: the resampling uniforms ``u`` (T,) from
    ``generator`` itself, the same on every rank whose generator was
    seeded alike, and the normals ``z0`` (n_local, d) and ``z`` (T,
    n_local, d) from a stream of this rank's own, seeded from
    ``generator`` and ``rank`` (the JAX package's ``fold_in(key,
    shard)``)."""
    dev = generator.device
    u = torch.rand((T,), generator=generator, dtype=dtype, device=dev)
    local = rank_stream(generator, rank)
    return SMCDraws(
        z0=torch.randn((n_local, d), generator=local, dtype=dtype, device=dev),
        z=torch.randn((T, n_local, d), generator=local, dtype=dtype,
                      device=dev),
        u=u)


def _resample_indices(u: torch.Tensor, log_weights: torch.Tensor):
    n = log_weights.shape[0]
    cdf = torch.cumsum(torch.softmax(log_weights, 0), 0)
    positions = (torch.arange(n, dtype=cdf.dtype, device=cdf.device)
                 + u.to(cdf)) / n
    # torch's right=False is numpy's and JAX's side='left'.
    return torch.searchsorted(cdf, positions).clamp(0, n - 1)


def systematic_resample(generator: Optional[torch.Generator],
                        log_weights: torch.Tensor,
                        u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Systematic resampling: indices (N,) from the positions
    ``(i + u) / N`` inverted through the weight CDF, with one uniform ``u``
    drawn from ``generator`` (or given)."""
    if u is None:
        u = torch.rand((), generator=generator, dtype=log_weights.dtype,
                       device=generator.device)
    return _resample_indices(u.to(log_weights.device), log_weights)


def effective_sample_size(log_weights: torch.Tensor) -> torch.Tensor:
    """ESS = 1 / sum(w_i^2) of the normalized weights."""
    return 1.0 / torch.sum(torch.softmax(log_weights, -1) ** 2, -1)


def bootstrap_filter(cond_m_cov, H: torch.Tensor, Xi, m0: torch.Tensor,
                     P0: torch.Tensor, dt, ys,
                     generator: Optional[torch.Generator] = None,
                     num_particles: int = 1024, ess_threshold: float = 0.5,
                     draws: Optional[SMCDraws] = None) -> SMCResult:
    """Bootstrap particle filter with adaptive systematic resampling.

    Parameters mirror :func:`chirpgp_tpu_torch.infer.filters.sgp_filter`;
    the transition (state-independent covariance) is sampled instead of
    moment-matched.  The random numbers are ``draws``, or else drawn from
    ``generator``; one of the two is required.  Computes in ``m0``'s dtype
    on its device, with no host synchronization inside the loop.  Returns
    the weighted filtering means, the cumulative log marginal likelihood
    and the pre-resampling ESS.
    """
    trans = as_transition(cond_m_cov)
    if not trans.const_cov:
        raise NotImplementedError(
            "bootstrap_filter requires a state-independent transition "
            "covariance (true for the chirp family).")
    ys = _as_data(ys, m0)
    N, d = num_particles, m0.shape[-1]
    if draws is None:
        if generator is None:
            raise ValueError("bootstrap_filter needs a torch.Generator or "
                             "draws")
        draws = smc_draws(generator, ys.shape[0], N, d, m0.dtype)
    z0, zs, us = (x.to(dtype=m0.dtype, device=m0.device) for x in draws)

    Lq = torch.linalg.cholesky(trans.cov_const(dt)).to(m0)
    L0 = torch.linalg.cholesky(P0)
    log_xi_norm = -0.5 * math.log(2.0 * math.pi) \
        - 0.5 * torch.log(torch.as_tensor(Xi, dtype=m0.dtype, device=m0.device))
    identity = torch.arange(N, device=m0.device)

    particles = m0 + z0 @ L0.T
    log_w = m0.new_zeros(N)
    log_ml = m0.new_zeros(())
    means, log_mls, esss = [], [], []
    for y, z, u in zip(ys, zs, us):
        particles = trans.mean(particles, dt) + z @ Lq.T
        log_like = log_xi_norm - 0.5 * (y - particles @ H) ** 2 / Xi
        log_w_new = log_w + log_like
        # Log-marginal-likelihood increment (normalized-weights form).
        log_ml = log_ml + torch.logsumexp(log_w_new, 0) \
            - torch.logsumexp(log_w, 0)
        w_norm = torch.softmax(log_w_new, 0)
        ess = 1.0 / torch.sum(w_norm ** 2)
        means.append(w_norm @ particles)
        log_mls.append(log_ml)
        esss.append(ess)
        # Adaptive resampling, branchless (no host synchronization).
        do_resample = ess < ess_threshold * N
        idx = torch.where(do_resample, _resample_indices(u, log_w_new),
                          identity)
        particles = particles[idx]
        log_w = torch.where(do_resample, torch.zeros_like(log_w_new),
                            log_w_new)
    return SMCResult(means=torch.stack(means), log_ml=torch.stack(log_mls),
                     ess=torch.stack(esss))


def bootstrap_filter_sharded(cond_m_cov, H: torch.Tensor, Xi,
                             m0: torch.Tensor, P0: torch.Tensor, dt, ys,
                             generator: Optional[torch.Generator],
                             mesh: Mesh, num_particles: int = 1024,
                             ess_threshold: float = 0.5, axis: str = None,
                             draws: Optional[SMCDraws] = None) -> SMCResult:
    """:func:`bootstrap_filter` with the particles split over ``mesh``'s
    ranks; every rank returns the global :class:`SMCResult`.

    Each rank propagates and weights its ``num_particles / size``
    particles.  The global logsumexp is a MAX then a SUM all-reduce; the
    ESS and the weighted mean are SUM all-reduces; the log-ML increment is
    :func:`bootstrap_filter`'s.  Resampling is global: the ranks
    all-gather the log-weights and particles, invert the global CDF with
    one shared uniform, and each keeps its own slice.  ``draws`` are this
    rank's (:func:`smc_draws_sharded`, from ``generator`` by default: seed
    it alike on every rank).  Requires a state-independent transition
    covariance.  Computes in ``m0``'s dtype on the mesh's device.
    """
    axis = axis or mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    if num_particles % n_dev:
        raise ValueError(f"num_particles={num_particles} must be a "
                         f"multiple of the mesh axis size {n_dev}")
    n_loc = num_particles // n_dev
    trans = as_transition(cond_m_cov)
    if not trans.const_cov:
        raise NotImplementedError(
            "bootstrap_filter_sharded requires a state-independent "
            "transition covariance (true for the chirp family).")
    dev = mesh.device
    m0 = torch.as_tensor(m0).to(dev)
    H, P0 = (torch.as_tensor(x).to(device=dev, dtype=m0.dtype)
             for x in (H, P0))
    ys = _as_data(ys, m0)
    N, d = num_particles, m0.shape[-1]
    if draws is None:
        if generator is None:
            raise ValueError("bootstrap_filter_sharded needs a "
                             "torch.Generator or draws")
        draws = smc_draws_sharded(generator, ys.shape[0], n_loc, d,
                                  mesh.rank, m0.dtype)
    z0, zs, us = (x.to(dtype=m0.dtype, device=dev) for x in draws)

    Lq = torch.linalg.cholesky(trans.cov_const(dt)).to(m0)
    L0 = torch.linalg.cholesky(P0)
    log_xi_norm = -0.5 * math.log(2.0 * math.pi) \
        - 0.5 * torch.log(torch.as_tensor(Xi, dtype=m0.dtype, device=dev))
    mine = slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)

    particles = m0 + z0 @ L0.T
    log_w = m0.new_zeros(n_loc)
    log_ml = m0.new_zeros(())
    means, log_mls, esss = [], [], []
    for y, z, u in zip(ys, zs, us):
        particles = trans.mean(particles, dt) + z @ Lq.T
        log_like = log_xi_norm - 0.5 * (y - particles @ H) ** 2 / Xi
        log_w_new = log_w + log_like
        # The distributed logsumexp of the new and the old weights: one MAX
        # and one SUM all-reduce for both.
        both = torch.stack([log_w_new, log_w])
        top = all_reduce(both.max(1).values, mesh, "max")
        lse_new, lse_old = top + torch.log(all_reduce(
            torch.exp(both - top[:, None]).sum(1), mesh))
        log_ml = log_ml + lse_new - lse_old
        w_norm = torch.exp(log_w_new - lse_new)
        # The ESS's sum of squares and the weighted mean in one SUM.
        sums = all_reduce(torch.cat([(w_norm ** 2).sum()[None],
                                     w_norm @ particles]), mesh)
        ess = 1.0 / sums[0]
        means.append(sums[1:])
        log_mls.append(log_ml)
        esss.append(ess)
        # Global systematic resampling; this rank keeps its slice.
        cloud = all_gather(torch.cat([log_w_new[:, None], particles], 1),
                           mesh)
        idx = _resample_indices(u, cloud[:, 0])[mine]
        do_resample = ess < ess_threshold * N
        particles = torch.where(do_resample, cloud[idx, 1:], particles)
        log_w = torch.where(do_resample, torch.zeros_like(log_w_new),
                            log_w_new)
    return SMCResult(means=torch.stack(means), log_ml=torch.stack(log_mls),
                     ess=torch.stack(esss))
