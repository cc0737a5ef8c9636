"""Synthetic chirp generators and IF function families (counterpart of
``chirpgp_tpu.toymodels``)."""

import math
from typing import Callable, List, Tuple

import torch

from chirpgp_tpu_torch.utils.sim import simulate_sde

__all__ = [
    "gen_chirp", "gen_harmonic_chirp", "gen_chirp_envelope",
    "constant_mag", "damped_exp_mag", "random_ou_mag",
    "affine_freq", "polynomial_freq", "meow_freq",
]


def gen_chirp(ts: torch.Tensor, magnitude_func, phase_func,
              base_phase: float = 0.0) -> torch.Tensor:
    r"""``y(t) = alpha(t) sin(phi_0 + 2 pi phi(t))``."""
    return magnitude_func(ts) * torch.sin(
        base_phase + 2.0 * math.pi * phase_func(ts))


def gen_harmonic_chirp(ts: torch.Tensor, magnitude_funcs: List[Callable],
                       fundamental_phase_func: Callable,
                       base_phase: float = 0.0) -> torch.Tensor:
    r"""``y(t) = sum_i alpha_i(t) sin(phi_0 + i 2 pi phi(t))``."""
    ys = torch.zeros_like(ts)
    for i, mag_func in enumerate(magnitude_funcs):
        ys = ys + mag_func(ts) * torch.sin(
            base_phase + (i + 1) * 2.0 * math.pi * fundamental_phase_func(ts))
    return ys


def gen_chirp_envelope(ts: torch.Tensor, magnitude_func, phase_func,
                       base_phase: float = 0.0) -> torch.Tensor:
    r"""Complex envelope ``alpha(t) exp(i (phi_0 + 2 pi phi(t)))``."""
    return magnitude_func(ts) * torch.exp(
        (base_phase + 2.0 * math.pi * phase_func(ts)) * 1.0j)


def constant_mag(b: float) -> Callable:
    return lambda ts: torch.ones_like(ts) * b


def damped_exp_mag(damp_rate: float) -> Callable:
    return lambda ts: torch.exp(-damp_rate * ts)


def _ou_transition(ell: float, sigma: float) -> Callable:
    """The exact step of the OU process with length scale ``ell`` and
    stationary std ``sigma``: ``m_and_cov(x, dt)``."""

    def m_and_cov(x, dt):
        return math.exp(-dt / ell) * x, torch.full(
            (1, 1), sigma ** 2 * (1.0 - math.exp(-2.0 * dt / ell)),
            dtype=x.dtype, device=x.device)

    return m_and_cov


def random_ou_mag(ell: float, sigma: float,
                  generator: torch.Generator) -> Callable:
    """A fixed OU-process realization as the magnitude, drawn from a host
    ``generator``: every call replays the generator's state as it was
    when this was made."""
    seed_state = generator.get_state()
    m_and_cov = _ou_transition(ell, sigma)

    def generate_ou(ts):
        gen = torch.Generator()
        gen.set_state(seed_state)
        dt = float(ts[1] - ts[0])
        like = dict(dtype=ts.dtype, device=ts.device)
        return simulate_sde(m_and_cov, torch.zeros(1, **like),
                            torch.full((1, 1), sigma ** 2, **like), dt,
                            ts.shape[0], gen, const_diag_cov=True).squeeze()

    return generate_ou


def affine_freq(a: float, b: float) -> Tuple[Callable, Callable]:
    """``f(t) = a t + b`` and its phase."""
    return (lambda ts: a * ts + b,
            lambda ts: 0.5 * a * ts ** 2 + b * ts)


def polynomial_freq(coeffs: List[float]) -> Tuple[Callable, Callable]:
    """Polynomial frequency (coeffs low-to-high order) and its phase."""

    def freq_func(ts):
        f = torch.zeros_like(ts)
        for k, c in enumerate(coeffs):
            f = f + c * ts ** k
        return f

    def phase_func(ts):
        p = torch.zeros_like(ts)
        for k, c in enumerate(coeffs):
            p = p + c / (k + 1) * ts ** (k + 1)
        return p

    return freq_func, phase_func


def meow_freq(mag: float = 500.0, scale: float = 5.0,
              offset: float = 5.5) -> Tuple[Callable, Callable]:
    r"""The canonical hard test IF: phase ``a e^{-b/sin(t)} + c t`` with
    frequency ``a b cot(t) csc(t) e^{-b csc(t)} + c``, valid on ``(0, pi)``."""

    def freq_func(ts):
        return mag * scale * torch.cos(ts) / torch.sin(ts) ** 2 \
            * torch.exp(-scale / torch.sin(ts)) + offset

    def phase_func(ts):
        return mag * torch.exp(-scale / torch.sin(ts)) + offset * ts

    return freq_func, phase_func
