"""Synthetic chirp generators and IF function families (counterpart of
``chirpgp_tpu.toymodels``; the harmonic, envelope and random-magnitude
generators are not ported yet)."""

import math
from typing import Callable, Tuple

import torch

__all__ = ["gen_chirp", "constant_mag", "meow_freq"]


def gen_chirp(ts: torch.Tensor, magnitude_func, phase_func,
              base_phase: float = 0.0) -> torch.Tensor:
    r"""``y(t) = alpha(t) sin(phi_0 + 2 pi phi(t))``."""
    return magnitude_func(ts) * torch.sin(
        base_phase + 2.0 * math.pi * phase_func(ts))


def constant_mag(b: float) -> Callable:
    return lambda ts: torch.ones_like(ts) * b


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
