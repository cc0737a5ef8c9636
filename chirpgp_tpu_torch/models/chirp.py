"""Chirp / harmonic-chirp / La Scala SDE priors and their locally
conditional discretizations (LCD) (counterpart of
``chirpgp_tpu.models.chirp``).

Model: a harmonic pair ``(X1, X2)`` rotating at angular rate ``2 pi g(V)``
with damping ``lam`` and dispersion ``b``, coupled to a Matern-3/2 prior on
the latent frequency state ``(V, dV)``.  The measurement reads ``X2``.  The
harmonic model has K such pairs at rates ``k w``; La Scala's is the chirp
model without damping and without noise on the pair.

Every LCD transition has a closed-form ``jac``, and every prior's drift
its Jacobian as ``drift.jac``, so the extended filters, discrete and
continuous-discrete, need no forward-mode AD.
"""

import math
from typing import Callable, NamedTuple

import torch
from torch._C._functorch import is_functorch_wrapped_tensor

from chirpgp_tpu_torch.models.bijections import g
from chirpgp_tpu_torch.models.matern import stationary_cov_m32, m32_solution
from chirpgp_tpu_torch.models.transitions import Transition
from chirpgp_tpu_torch.utils.numerics import as_real_tensor, ou_variance

__all__ = ["StateSpaceModel", "model_chirp", "model_harmonic_chirp",
           "model_lascala", "disc_chirp_lcd", "disc_chirp_lcd_cond_v",
           "disc_harmonic_chirp_lcd", "disc_model_lascala_lcd",
           "disc_chirp_euler_maruyama", "ChirpModelPack", "build_chirp_model",
           "build_harmonic_chirp_model", "build_lascala_model"]

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

    def jac(u):
        # d drift / du: the rotation-with-decay block, its column through
        # w = 2 pi g(V) (g' = sigmoid), and the Matern-3/2 block.
        w = _TWO_PI * g(u[..., 2])
        dw = _TWO_PI * torch.sigmoid(u[..., 2])
        zero = torch.zeros_like(w)
        rows = [[zero - lam, -w, -dw * u[..., 1], zero],
                [w, zero - lam, dw * u[..., 0], zero],
                [zero, zero, zero, zero + 1.0],
                [zero, zero, zero - gamma ** 2, zero - 2.0 * gamma]]
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    drift.jac = jac

    def dispersion(_):
        return torch.diag(torch.stack(
            [b, b, torch.zeros_like(b), 2.0 * sigma * gamma ** 1.5]))

    like = dict(dtype=delta.dtype, device=delta.device)
    m0 = torch.tensor([0.0, 1.0, 0.0, 0.0], **like)
    P0 = torch.block_diag(delta * torch.eye(2, **like),
                          stationary_cov_m32(ell, sigma))
    H = torch.tensor([0.0, 1.0, 0.0, 0.0], **like)
    return StateSpaceModel(drift, dispersion, m0, P0, H)


def model_harmonic_chirp(lam, b, ell, sigma, delta, num_harmonics: int = 1,
                         freq_scale: float = 1.0) -> StateSpaceModel:
    """Harmonic chirp prior, d = 2K + 2: K harmonic pairs at rates
    ``k w`` with shared ``lam``/``b``/``delta``; frequency ``freq_scale *
    g(V)``."""
    lam, b, ell, sigma, delta = map(as_real_tensor, (lam, b, ell, sigma, delta))
    K = num_harmonics
    gamma = math.sqrt(3.0) / ell

    def drift(u):
        w = _TWO_PI * g(u[..., -2]) * freq_scale
        pairs = u[..., : 2 * K].reshape(u.shape[:-1] + (K, 2))
        wk = w[..., None] * torch.arange(1, K + 1, dtype=u.dtype,
                                         device=u.device)
        a_even = -lam * pairs[..., 0] - wk * pairs[..., 1]
        a_odd = wk * pairs[..., 0] - lam * pairs[..., 1]
        a_pairs = torch.stack([a_even, a_odd], dim=-1).reshape(
            u.shape[:-1] + (2 * K,))
        a_v = u[..., -1]
        a_dv = -(gamma ** 2) * u[..., -2] - 2.0 * gamma * u[..., -1]
        return torch.cat([a_pairs, torch.stack([a_v, a_dv], dim=-1)], dim=-1)

    def jac(u):
        # d drift / du: pair k is the rotation-with-decay block at rate
        # k w, differentiated through w = 2 pi freq_scale g(V) (g' =
        # sigmoid) in column d-2; the Matern-3/2 block on the last two rows.
        d = 2 * K + 2
        w = _TWO_PI * g(u[..., -2]) * freq_scale
        dw = _TWO_PI * freq_scale * torch.sigmoid(u[..., -2])
        zero = torch.zeros_like(w)
        rows = []
        for k in range(1, K + 1):
            x0, x1 = u[..., 2 * k - 2], u[..., 2 * k - 1]
            even, odd = [zero] * d, [zero] * d
            even[2 * k - 2], even[2 * k - 1] = zero - lam, -k * w
            odd[2 * k - 2], odd[2 * k - 1] = k * w, zero - lam
            even[d - 2] = -(k * dw) * x1
            odd[d - 2] = (k * dw) * x0
            rows += [even, odd]
        rows.append([zero] * (d - 1) + [zero + 1.0])
        rows.append([zero] * (d - 2) + [zero - gamma ** 2,
                                        zero - 2.0 * gamma])
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    drift.jac = jac

    def dispersion(_):
        return torch.diag(torch.stack(
            [b, b] * K + [torch.zeros_like(b), 2.0 * sigma * gamma ** 1.5]))

    like = dict(dtype=delta.dtype, device=delta.device)
    m0 = torch.tensor([0.0, 1.0] * K + [0.0, 0.0], **like)
    P0 = torch.block_diag(delta * torch.eye(2 * K, **like),
                          stationary_cov_m32(ell, sigma))
    H = torch.tensor([0.0, 1.0] * K + [0.0, 0.0], **like)
    return StateSpaceModel(drift, dispersion, m0, P0, H)


def model_lascala(ell, sigma, delta) -> StateSpaceModel:
    """Snyder / La Scala baseline prior: the chirp prior with an undamped,
    dispersion-free pair (``lam = b = 0``), d=4."""
    delta = as_real_tensor(delta)
    zero = torch.zeros_like(delta)
    return model_chirp(zero, zero, ell, sigma, delta)


def _step_constants(lam, ell, sigma):
    """``consts(dt) -> (exp(-lam dt), F00, F01, F10, F11)`` of the
    Matern-3/2 step, computed once per ``dt``: eager PyTorch would
    otherwise rebuild them at every filter step.  Built from parameters
    that require grad, the constants are part of the graph, so the
    transition that holds them serves one backward pass."""
    cache = {}

    def consts(dt):
        key = float(dt)
        if key in cache:
            return cache[key]
        F32, _ = m32_solution(ell, sigma, dt)
        out = (torch.exp(-lam * dt), F32[0, 0], F32[0, 1], F32[1, 0],
               F32[1, 1])
        # Constants first computed inside a torch.func transform (the
        # jacfwd of an EKF step) are wrapped for that transform and must
        # not outlive it, so they are not kept.
        if not any(is_functorch_wrapped_tensor(c) for c in out):
            cache[key] = out
        return out

    return consts


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
    _step_consts = _step_constants(lam, ell, sigma)

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


def disc_chirp_lcd_cond_v(lam, b):
    """LCD of the chirp pair conditioned on an exogenous ``V`` value:
    ``m_and_cov(u, v, dt) -> (mean (..., 2), cov (2, 2))``."""
    lam, b = as_real_tensor(lam), as_real_tensor(b)

    def m_and_cov(u, v, dt):
        w = _TWO_PI * g(as_real_tensor(v))
        decay = torch.exp(-lam * dt)
        c, s = torch.cos(dt * w) * decay, torch.sin(dt * w) * decay
        m0_, m1_ = _rotate_pair(u[..., 0], u[..., 1], c, s)
        q = ou_variance(b, lam, dt)
        return (torch.stack([m0_, m1_], dim=-1),
                q * torch.eye(2, dtype=q.dtype, device=q.device))

    return m_and_cov


def disc_harmonic_chirp_lcd(lam, b, ell, sigma, num_harmonics: int = 1,
                            freq_scale: float = 1.0) -> Transition:
    """LCD of the harmonic chirp model: K rotation blocks at rates ``k w``,
    ``w = 2 pi freq_scale g(V)``, + exact Matern-3/2 step on the last two
    components; state-independent covariance ``blockdiag(q I_2K,
    Sigma_m32)``.  The per-``dt`` constants are kept as in
    :func:`disc_chirp_lcd`."""
    lam, b, ell, sigma = map(as_real_tensor, (lam, b, ell, sigma))
    K = num_harmonics
    d = 2 * K + 2
    _step_consts = _step_constants(lam, ell, sigma)

    def mean(u, dt):
        decay, F00, F01, F10, F11 = _step_consts(dt)
        w = _TWO_PI * g(u[..., -2]) * freq_scale
        ks = torch.arange(1, K + 1, dtype=u.dtype, device=u.device)
        angles = (dt * w)[..., None] * ks                   # (..., K)
        c, s = torch.cos(angles) * decay, torch.sin(angles) * decay
        pairs = u[..., : 2 * K].reshape(u.shape[:-1] + (K, 2))
        m_even, m_odd = _rotate_pair(pairs[..., 0], pairs[..., 1], c, s)
        m_pairs = torch.stack([m_even, m_odd], dim=-1).reshape(
            u.shape[:-1] + (2 * K,))
        m_v = F00 * u[..., -2] + F01 * u[..., -1]
        m_dv = F10 * u[..., -2] + F11 * u[..., -1]
        return torch.cat([m_pairs, torch.stack([m_v, m_dv], dim=-1)], dim=-1)

    def jac(u, dt):
        # d/du of ``mean``: pair k is the rotation block at angle k dt w,
        # differentiated through w = 2 pi freq_scale g(V) (g' = sigmoid)
        # in column d-2; the Matern-3/2 F sits on the last two rows.
        decay, F00, F01, F10, F11 = _step_consts(dt)
        w = _TWO_PI * g(u[..., -2]) * freq_scale
        dw = _TWO_PI * freq_scale * torch.sigmoid(u[..., -2]) * dt
        zero = torch.zeros_like(w)
        rows = []
        for k in range(1, K + 1):
            c = torch.cos(dt * w * k) * decay
            s = torch.sin(dt * w * k) * decay
            x0, x1 = u[..., 2 * k - 2], u[..., 2 * k - 1]
            even, odd = [zero] * d, [zero] * d
            even[2 * k - 2], even[2 * k - 1] = c, -s
            odd[2 * k - 2], odd[2 * k - 1] = s, c
            even[d - 2] = -(s * x0 + c * x1) * (k * dw)
            odd[d - 2] = (c * x0 - s * x1) * (k * dw)
            rows += [even, odd]
        rows.append([zero] * (d - 2) + [zero + F00, zero + F01])
        rows.append([zero] * (d - 2) + [zero + F10, zero + F11])
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    def cov(_, dt):
        q = ou_variance(b, lam, dt)
        _, S32 = m32_solution(ell, sigma, dt)
        return torch.block_diag(q * torch.eye(2 * K, dtype=q.dtype,
                                              device=q.device), S32)

    def mean_cf(u, dt):
        # Channels-first: u (..., d, B); the model scalars may live on the
        # host while u is on the card, as in disc_chirp_lcd.
        decay, F00, F01, F10, F11 = _step_consts(dt)
        w = _TWO_PI * g(u[..., -2, :]) * freq_scale
        outs = []
        for k in range(1, K + 1):
            ang = dt * k * w
            c, sn = torch.cos(ang) * decay, torch.sin(ang) * decay
            x0, x1 = u[..., 2 * k - 2, :], u[..., 2 * k - 1, :]
            outs += [c * x0 - sn * x1, sn * x0 + c * x1]
        outs.append(F00 * u[..., -2, :] + F01 * u[..., -1, :])
        outs.append(F10 * u[..., -2, :] + F11 * u[..., -1, :])
        return torch.stack(outs, dim=-2)

    return Transition(mean=mean, cov=cov, const_cov=True, mean_cf=mean_cf,
                      jac=jac)


def disc_model_lascala_lcd(ell, sigma) -> Transition:
    """LCD of the La Scala model: pure rotation (no damping, no noise on
    the pair) + exact Matern-3/2 step.  This is :func:`disc_chirp_lcd` at
    ``lam = b = 0`` exactly: the decay is ``exp(0) = 1`` and the pair's
    variance ``ou_variance(0, 0, dt) = 0``, so the covariance is
    ``blockdiag(0, 0, Sigma_m32)`` and ``jac`` the chirp Jacobian with
    decay 1 -- which is why the chirp filter kernel runs this model with
    params ``[0, 0, delta, ell, sigma, m0_v]``."""
    ell = as_real_tensor(ell)
    zero = torch.zeros_like(ell)
    return disc_chirp_lcd(zero, zero, ell, sigma)


def disc_chirp_euler_maruyama():
    """Euler--Maruyama is not recommended for this stiff model; kept for
    the JAX package's API."""
    return NotImplemented


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


def build_harmonic_chirp_model(params, num_harmonics: int = 1,
                               freq_scale: float = 1.0) -> ChirpModelPack:
    """Harmonic chirp model, d = 2K + 2, from packed params ``[lam, b,
    delta, ell, sigma, m0_v]``; dtypes and devices as
    :func:`build_chirp_model`."""
    lam, b, delta, ell, sigma, m0_v = as_real_tensor(params).unbind()
    drift, dispersion, _, P0, H = model_harmonic_chirp(
        lam, b, ell, sigma, delta, num_harmonics=num_harmonics,
        freq_scale=freq_scale)
    zero = 0.0 * m0_v
    one = zero + 1.0
    m0 = torch.stack([zero, one] * num_harmonics + [m0_v, zero])
    m_and_cov = disc_harmonic_chirp_lcd(
        lam, b, ell, sigma, num_harmonics=num_harmonics, freq_scale=freq_scale)
    return ChirpModelPack(drift, dispersion, m_and_cov, m0, P0, H)


def build_lascala_model(params) -> ChirpModelPack:
    """La Scala model from packed params ``[delta, ell, sigma, m0_v]``;
    dtypes and devices as :func:`build_chirp_model`."""
    delta, ell, sigma, m0_v = as_real_tensor(params).unbind()
    drift, dispersion, _, P0, H = model_lascala(ell, sigma, delta)
    m0 = torch.stack([0.0 * m0_v, 0.0 * m0_v, m0_v, 0.0 * m0_v])
    m_and_cov = disc_model_lascala_lcd(ell, sigma)
    return ChirpModelPack(drift, dispersion, m_and_cov, m0, P0, H)
