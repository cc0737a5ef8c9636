"""Kalman pitch tracker (KPT) model of Shi et al. 2017 (counterpart of
``chirpgp_tpu.models.kpt``).

Linear phase-accumulator dynamics with a nonlinear harmonic measurement
``h(x) = sum_k a_k sin(k g(omega + phi))``, used as a baseline through the
nonlinear-measurement EKF (``infer.filters.ekf_for_kpt``).  The
measurement carries its Jacobian in closed form, so that EKF needs no
forward-mode AD.
"""

import math
from typing import NamedTuple, Sequence

import torch

from chirpgp_tpu_torch.models.bijections import g
from chirpgp_tpu_torch.utils.numerics import as_real_tensor

__all__ = ["KPTModel", "KPTMeasurement", "build_kpt_chirp_model"]


class KPTMeasurement:
    """``h(x) = sum_k a_k sin(k g(omega + phi))`` over states ``x (...,
    K + 2) = (omega, a_1..a_K, phi)``, and its gradient ``jac(x)``:
    ``dh/d omega = dh/d phi = sum_k a_k k cos(k g(omega + phi))
    sigmoid(omega + phi)`` and ``dh/d a_k = sin(k g(omega + phi))``."""

    def __init__(self, num_harmonics: int):
        self.num_harmonics = num_harmonics

    def _ks(self, x):
        return torch.arange(1, self.num_harmonics + 1, dtype=x.dtype,
                            device=x.device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        amps = x[..., 1:-1]
        phase = g(x[..., 0] + x[..., -1])
        return torch.sum(amps * torch.sin(phase[..., None] * self._ks(x)),
                         dim=-1)

    def jac(self, x: torch.Tensor) -> torch.Tensor:
        arg = x[..., 0] + x[..., -1]
        ks = self._ks(x)
        angles = g(arg)[..., None] * ks                     # (..., K)
        dphase = torch.sum(x[..., 1:-1] * ks * torch.cos(angles), dim=-1) \
            * torch.sigmoid(arg)
        return torch.cat([dphase[..., None], torch.sin(angles),
                          dphase[..., None]], dim=-1)


class KPTModel(NamedTuple):
    """Iterable as ``F, Sigma, m0, P0, h = model`` for reference parity."""
    F: torch.Tensor
    Sigma: torch.Tensor
    m0: torch.Tensor
    P0: torch.Tensor
    h: KPTMeasurement


def build_kpt_chirp_model(params: Sequence, fs: float,
                          num_harmonics: int = 1) -> KPTModel:
    """The KPT state-space model from ``params = [q1, q2, p0, f0, a0]``:
    process noise of the frequency and of the amplitudes, initial
    covariance scale, initial frequency (Hz), initial amplitude.  State
    ``(omega, a_1..a_K, phi)`` with the phase accumulator ``phi_k =
    phi_{k-1} + omega_{k-1}``.  A tensor keeps its dtype and device;
    anything else becomes a float64 host tensor."""
    q1, q2, p0, f0, a0 = as_real_tensor(params).unbind()
    K = num_harmonics
    dim_x = K + 2
    like = dict(dtype=q1.dtype, device=q1.device)

    P0 = p0 * torch.eye(dim_x, **like)
    m0 = torch.cat([(2.0 * math.pi * f0 / fs)[None],
                    a0 * torch.ones(K, **like), torch.zeros(1, **like)])
    F = torch.eye(dim_x, **like)
    F[-1, 0] = 1.0
    # Process noise enters the frequency and the amplitudes, not the phase.
    Sigma = torch.diag(torch.cat([((2.0 * math.pi * q1 / fs) ** 2)[None],
                                  q2 * torch.ones(K, **like),
                                  torch.zeros(1, **like)]))
    return KPTModel(F, Sigma, m0, P0, KPTMeasurement(K))
