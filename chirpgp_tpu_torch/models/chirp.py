"""The chirp SDE prior and its locally conditional discretization (LCD)
(counterpart of ``chirpgp_tpu.models.chirp``; the harmonic and La Scala
models are not ported yet).

Model: a harmonic pair ``(X1, X2)`` rotating at angular rate ``2 pi g(V)``
with damping ``lam`` and dispersion ``b``, coupled to a Matern-3/2 prior on
the latent frequency state ``(V, dV)``.  The measurement reads ``X2``.
"""

import math
from typing import Callable, NamedTuple

import torch
from torch._C._functorch import is_functorch_wrapped_tensor

from chirpgp_tpu_torch.models.bijections import g
from chirpgp_tpu_torch.models.matern import stationary_cov_m32, m32_solution
from chirpgp_tpu_torch.models.transitions import Transition
from chirpgp_tpu_torch.utils.numerics import as_real_tensor, ou_variance

__all__ = ["StateSpaceModel", "model_chirp", "disc_chirp_lcd",
           "ChirpModelPack", "build_chirp_model"]

_TWO_PI = 2.0 * math.pi


class StateSpaceModel(NamedTuple):
    """Continuous-time prior: drift ``a``, dispersion ``B``, initial moments,
    and 1-D linear measurement vector ``H``."""
    drift: Callable
    dispersion: Callable
    m0: torch.Tensor
    P0: torch.Tensor
    H: torch.Tensor


def _rotate_pair(x0, x1, c, s):
    """Apply the 2-D rotation-with-decay [[c, -s], [s, c]] elementwise."""
    return c * x0 - s * x1, s * x0 + c * x1


def model_chirp(lam, b, ell, sigma, delta) -> StateSpaceModel:
    """The chirp + IF prior, d=4: state ``(X1, X2, V, dV)``."""
    lam, b, ell, sigma, delta = map(as_real_tensor, (lam, b, ell, sigma, delta))
    gamma = math.sqrt(3.0) / ell

    def drift(u):
        w = _TWO_PI * g(u[..., 2])
        a0 = -lam * u[..., 0] - w * u[..., 1]
        a1 = w * u[..., 0] - lam * u[..., 1]
        a2 = u[..., 3]
        a3 = -(gamma ** 2) * u[..., 2] - 2.0 * gamma * u[..., 3]
        return torch.stack([a0, a1, a2, a3], dim=-1)

    def dispersion(_):
        return torch.diag(torch.stack(
            [b, b, torch.zeros_like(b), 2.0 * sigma * gamma ** 1.5]))

    like = dict(dtype=delta.dtype, device=delta.device)
    m0 = torch.tensor([0.0, 1.0, 0.0, 0.0], **like)
    P0 = torch.block_diag(delta * torch.eye(2, **like),
                          stationary_cov_m32(ell, sigma))
    H = torch.tensor([0.0, 1.0, 0.0, 0.0], **like)
    return StateSpaceModel(drift, dispersion, m0, P0, H)


def disc_chirp_lcd(lam, b, ell, sigma) -> Transition:
    """LCD of the chirp model: rotation-with-decay on the harmonic pair
    (frequency frozen at the conditioning state's ``g(V)``) + exact
    Matern-3/2 step.  The covariance is state-independent:
    ``blockdiag(q, q, Sigma_m32)`` with ``q = b^2 (1 - e^{-2 lam dt}) / (2 lam)``.

    The means keep their per-``dt`` constants after the first call.  Built
    from parameters that require grad, those constants are part of the
    graph, so one transition serves one backward pass; build a new one
    (as ``make_nll_fn`` does per call) for the next.
    """
    lam, b, ell, sigma = map(as_real_tensor, (lam, b, ell, sigma))
    step_consts = {}

    def _step_consts(dt):
        # exp(-lam dt) and the Matern-3/2 F entries, computed once per dt:
        # eager PyTorch would otherwise rebuild them at every filter step.
        key = float(dt)
        if key in step_consts:
            return step_consts[key]
        F32, _ = m32_solution(ell, sigma, dt)
        consts = (torch.exp(-lam * dt), F32[0, 0], F32[0, 1], F32[1, 0],
                  F32[1, 1])
        # Constants first computed inside a torch.func transform (the
        # jacfwd of an EKF step) are wrapped for that transform and must
        # not outlive it, so they are not kept.
        if not any(is_functorch_wrapped_tensor(c) for c in consts):
            step_consts[key] = consts
        return consts

    def mean(u, dt):
        decay, F00, F01, F10, F11 = _step_consts(dt)
        w = _TWO_PI * g(u[..., 2])
        c, s = torch.cos(dt * w) * decay, torch.sin(dt * w) * decay
        m0_, m1_ = _rotate_pair(u[..., 0], u[..., 1], c, s)
        m2_ = F00 * u[..., 2] + F01 * u[..., 3]
        m3_ = F10 * u[..., 2] + F11 * u[..., 3]
        return torch.stack([m0_, m1_, m2_, m3_], dim=-1)

    def jac(u, dt):
        # d/du of ``mean``: the rotation block, its derivative through
        # w = 2 pi g(V) (g' = sigmoid), and the Matern-3/2 F.
        decay, F00, F01, F10, F11 = _step_consts(dt)
        w = _TWO_PI * g(u[..., 2])
        c, s = torch.cos(dt * w) * decay, torch.sin(dt * w) * decay
        dw = _TWO_PI * torch.sigmoid(u[..., 2]) * dt
        zero = torch.zeros_like(c)
        rows = [[c, -s, -s * dw * u[..., 0] - c * dw * u[..., 1], zero],
                [s, c, c * dw * u[..., 0] - s * dw * u[..., 1], zero],
                [zero, zero, zero + F00, zero + F01],
                [zero, zero, zero + F10, zero + F11]]
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    def cov(_, dt):
        q = ou_variance(b, lam, dt)
        _, S32 = m32_solution(ell, sigma, dt)
        return torch.block_diag(q * torch.eye(2, dtype=q.dtype,
                                              device=q.device), S32)

    def mean_cf(u, dt):
        # Channels-first: u (..., 4, B).  The model scalars stay 0-dim
        # tensors, so they may live on the host while u is on the card.
        decay, F00, F01, F10, F11 = _step_consts(dt)
        w = _TWO_PI * g(u[..., 2, :])
        c, sn = torch.cos(dt * w) * decay, torch.sin(dt * w) * decay
        m0_ = c * u[..., 0, :] - sn * u[..., 1, :]
        m1_ = sn * u[..., 0, :] + c * u[..., 1, :]
        m2_ = F00 * u[..., 2, :] + F01 * u[..., 3, :]
        m3_ = F10 * u[..., 2, :] + F11 * u[..., 3, :]
        return torch.stack([m0_, m1_, m2_, m3_], dim=-2)

    return Transition(mean=mean, cov=cov, const_cov=True, mean_cf=mean_cf,
                      jac=jac)


class ChirpModelPack(NamedTuple):
    """Everything a filter/smoother needs; iterable for reference-style
    unpacking ``drift, dispersion, m_and_cov, m0, P0, H = pack``."""
    drift: Callable
    dispersion: Callable
    m_and_cov: Transition
    m0: torch.Tensor
    P0: torch.Tensor
    H: torch.Tensor


def build_chirp_model(params) -> ChirpModelPack:
    """Chirp model from packed params ``[lam, b, delta, ell, sigma, m0_v]``
    (constrained space).  A tensor keeps its dtype and device; anything
    else becomes a float64 host tensor."""
    lam, b, delta, ell, sigma, m0_v = as_real_tensor(params).unbind()
    drift, dispersion, _, P0, H = model_chirp(lam, b, ell, sigma, delta)
    m0 = torch.stack([0.0 * m0_v, 0.0 * m0_v, m0_v, 0.0 * m0_v])
    m_and_cov = disc_chirp_lcd(lam, b, ell, sigma)
    return ChirpModelPack(drift, dispersion, m_and_cov, m0, P0, H)
