"""Covariance functions of the chirp SDEs: closed forms for the harmonic
SDE and Monte-Carlo estimates for the chirp SDE (counterpart of
``chirpgp_tpu.models.cov_funcs``; paper Figs 1-3).

The Monte-Carlo functions draw their normals from an explicit
``torch.Generator`` on the data's device; each has a core
``_*_from_noise`` that takes the drawn normals instead, which is how the
port is held to the JAX package.  ``ts`` as a tensor keeps its dtype and
device; anything else becomes float64 on ``device``, the card unless the
caller passes ``device="cpu"``.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch

from chirpgp_tpu_torch.models.chirp import (
    disc_chirp_lcd, disc_chirp_lcd_cond_v, model_chirp)
from chirpgp_tpu_torch.models.matern import disc_m32
from chirpgp_tpu_torch.utils.numerics import as_real_tensor, ou_variance
from chirpgp_tpu_torch.utils.sim import (
    _conditioned_batch_from_noise, _simulate_batch_from_noise)

__all__ = [
    "transition_harmonic_sde", "marginal_cov_harmonic_sde", "cov_harmonic_sde",
    "vmap_marginal_cov_harmonic_sde", "vmap_cov_harmonic_sde",
    "approx_cov_chirp_sde", "approx_cond_cov_chirp_sde", "psd_chirp_sde",
]


def transition_harmonic_sde(t, s, lam, w) -> torch.Tensor:
    """Transition semigroup of the damped harmonic SDE over ``t - s``."""
    dt = as_real_tensor(t) - as_real_tensor(s)
    c, sn = torch.cos(dt * w), torch.sin(dt * w)
    return torch.stack([torch.stack([c, -sn]), torch.stack([sn, c])]) \
        * torch.exp(-lam * dt)


def marginal_cov_harmonic_sde(t, s, cov_xs, lam, b, w) -> torch.Tensor:
    """Marginal covariance ``F cov_xs F^T + Sigma(t - s)`` of the harmonic
    SDE, smooth at ``lam = 0``."""
    F = transition_harmonic_sde(t, s, lam, w)
    cov_xs = as_real_tensor(cov_xs).to(F)
    q = ou_variance(b, lam, as_real_tensor(t) - as_real_tensor(s))
    return F @ cov_xs @ F.T + q * torch.eye(2, dtype=F.dtype, device=F.device)


def cov_harmonic_sde(t1, t2, cov_xs, f, lam, b) -> torch.Tensor:
    """Two-sided covariance function ``Cov[X(t1), X(t2)]``.  Both branches
    are computed and one is selected, so the function maps under
    ``torch.func.vmap``."""
    w = 2.0 * math.pi * f
    t1, t2 = as_real_tensor(t1), as_real_tensor(t2)
    # The origin in the times' dtype: a float64 0.0 would promote float32
    # times to float64 in one branch only.
    zero = torch.zeros((), dtype=t1.dtype, device=t1.device)
    lt = marginal_cov_harmonic_sde(t1, zero, cov_xs, lam, b, w) \
        @ transition_harmonic_sde(t2, t1, lam, w).T
    ge = transition_harmonic_sde(t1, t2, lam, w) \
        @ marginal_cov_harmonic_sde(t2, zero, cov_xs, lam, b, w)
    return torch.where(t1 < t2, lt, ge)


vmap_marginal_cov_harmonic_sde = torch.func.vmap(
    marginal_cov_harmonic_sde, in_dims=(0, None, None, None, None, None))
vmap_cov_harmonic_sde = torch.func.vmap(
    torch.func.vmap(cov_harmonic_sde, in_dims=(0, None, None, None, None, None)),
    in_dims=(None, 0, None, None, None, None))


def _times(ts, device) -> torch.Tensor:
    if isinstance(ts, torch.Tensor):
        return ts
    return torch.as_tensor(np.asarray(ts, np.float64), device=device)


def _monte_carlo_cov(trajs: torch.Tensor) -> torch.Tensor:
    """Full (T, T, d, d) covariance surface from MC trajectories (N, T, d):
    one einsum over all time pairs, normalized by ``T - 1`` as the
    reference does."""
    T = trajs.shape[1]
    devs = trajs - trajs.mean(0)
    return torch.einsum("nki,nlj->lkij", devs, devs) / (T - 1)


def _chirp_prior(ts, lam, b, ell, sigma, delta):
    _, _, m0, P0, _ = model_chirp(lam, b, ell, sigma, delta)
    like = dict(dtype=ts.dtype, device=ts.device)
    return m0.to(**like), P0.to(**like), float(ts[1] - ts[0])


def _chirp_trajectories(ts, lam, b, ell, sigma, delta, z0, dws):
    """``simulate_sde``'s scheme for the chirp LCD over a batch: ``x0 = m0
    + chol(P0) z0`` (N, 4), increments ``dws`` (N, T, 4)."""
    m0, P0, dt = _chirp_prior(ts, lam, b, ell, sigma, delta)
    x0 = m0 + z0.to(m0) @ torch.linalg.cholesky(P0).T
    return _simulate_batch_from_noise(disc_chirp_lcd(lam, b, ell, sigma), x0,
                                      dws.to(m0), dt)


def _chirp_noise(ts, num_mcs, generator, d=4):
    if generator is None:
        generator = torch.Generator(device=ts.device).manual_seed(0)
    draw = lambda *shape: torch.randn(
        shape, generator=generator, dtype=ts.dtype,
        device=generator.device).to(ts.device)
    return draw(num_mcs, d), draw(num_mcs, ts.shape[0], d)


def _approx_cov_chirp_sde_from_noise(ts, lam, b, ell, sigma, delta, z0, dws):
    """:func:`approx_cov_chirp_sde` on the given normals: ``z0`` (N, 4) for
    the initial states and ``dws`` (N, T, 4) for the increments."""
    return _monte_carlo_cov(_chirp_trajectories(ts, lam, b, ell, sigma,
                                                delta, z0, dws))


def approx_cov_chirp_sde(ts, lam, b, ell, sigma, delta, num_mcs,
                         generator: Optional[torch.Generator] = None,
                         device="cuda") -> torch.Tensor:
    """MC estimate (T, T, 4, 4) of the chirp-SDE covariance function from
    ``num_mcs`` trajectories of the LCD (normals from ``generator``,
    default seeded with 0 on the data's device)."""
    ts = _times(ts, device)
    z0, dws = _chirp_noise(ts, num_mcs, generator)
    return _approx_cov_chirp_sde_from_noise(ts, lam, b, ell, sigma, delta,
                                            z0, dws)


def _approx_cond_cov_chirp_sde_from_noise(ts, lam, b, ell, sigma, delta,
                                          z0_v, dws_v, z0, dws):
    """:func:`approx_cond_cov_chirp_sde` on the given normals: ``z0_v`` (2,)
    and ``dws_v`` (T, 2) for the V path, ``z0`` (N, 2) and ``dws`` (N, T,
    2) for the trajectories of X given V."""
    m0, P0, dt = _chirp_prior(ts, lam, b, ell, sigma, delta)
    v0 = m0[2:] + torch.linalg.cholesky(P0[2:, 2:]) @ z0_v.to(m0)
    vs = _simulate_batch_from_noise(disc_m32(ell, sigma), v0[None],
                                    dws_v.to(m0)[None], dt)[0]
    x0 = m0[:2] + z0.to(m0) @ torch.linalg.cholesky(P0[:2, :2]).T
    trajs = _conditioned_batch_from_noise(
        disc_chirp_lcd_cond_v(lam, b), vs[:, 0], x0, dws.to(m0), dt,
        const_diag_cov=True)
    return vs, _monte_carlo_cov(trajs)


def approx_cond_cov_chirp_sde(ts, lam, b, ell, sigma, delta, num_mcs,
                              generator: Optional[torch.Generator] = None,
                              device="cuda"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simulate one V path of the Matern-3/2 prior, then the MC covariance
    (T, T, 2, 2) of the chirp pair given V.  Returns ``(vs (T, 2),
    cov)``."""
    ts = _times(ts, device)
    if generator is None:
        generator = torch.Generator(device=ts.device).manual_seed(0)
    z0_v, dws_v = _chirp_noise(ts, 1, generator, d=2)
    z0, dws = _chirp_noise(ts, num_mcs, generator, d=2)
    return _approx_cond_cov_chirp_sde_from_noise(
        ts, lam, b, ell, sigma, delta, z0_v[0], dws_v[0], z0, dws)


def _psd_chirp_sde_from_noise(ts, lam, b, ell, sigma, delta, z0, dws):
    """:func:`psd_chirp_sde` on the given normals, as
    :func:`_approx_cov_chirp_sde_from_noise`."""
    trajs = _chirp_trajectories(ts, lam, b, ell, sigma, delta, z0, dws)
    T = ts.shape[0]
    dt = float(ts[1] - ts[0])
    xs = trajs[:, :, 0]
    n = torch.arange(T, dtype=xs.dtype, device=xs.device)
    window = 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / T))       # Hann
    spec = torch.fft.rfft(xs * window, dim=-1)                    # (N, T//2+1)
    scale = dt / torch.sum(window ** 2)
    psd = scale * torch.mean(spec.abs() ** 2, dim=0)
    bins = torch.arange(psd.shape[0], device=psd.device)
    doubling = torch.where((bins > 0) & (bins < psd.shape[0] - 1 + (T % 2)),
                           2.0, 1.0).to(psd.dtype)
    freqs = torch.fft.rfftfreq(T, d=dt, dtype=psd.dtype, device=psd.device)
    return freqs, psd * doubling


def psd_chirp_sde(ts, lam, b, ell, sigma, delta, num_mcs,
                  generator: Optional[torch.Generator] = None,
                  device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """MC power-spectral-density estimate of the chirp-SDE signal component
    X1: a Hann-windowed periodogram of each of ``num_mcs`` simulated
    trajectories through ``torch.fft.rfft``, averaged.  Returns ``(freqs
    (T//2+1,), psd (T//2+1,))``, one-sided (interior bins doubled), in
    power per Hz."""
    ts = _times(ts, device)
    z0, dws = _chirp_noise(ts, num_mcs, generator)
    return _psd_chirp_sde_from_noise(ts, lam, b, ell, sigma, delta, z0, dws)
