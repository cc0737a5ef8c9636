"""Kalman pitch tracker (KPT) baseline pipeline (counterpart of
``chirpgp_tpu.apps.kpt``).

Build the KPT model, run the nonlinear-measurement EKF
(``infer.filters.ekf_for_kpt``) and the *linear* RTS smoother over its
output, learn ``[q1, q2, p0, f0, a0]`` by filter-marginal MLE from
``g^{-1}(KPT_INIT_PARAMS)``, and estimate the IF as the Gauss-Hermite
expectation of ``g`` over the smoothed ``omega`` posterior scaled by
``fs / (2 pi)``.

Measurements given as tensors stay where they are; anything else becomes
a tensor on ``device``, the card unless the caller passes
``device="cpu"``.  Params go to the measurements' device.
"""

import math
from typing import Tuple

import torch

from chirpgp_tpu_torch.apps.pipeline import _measurements, _on_data
from chirpgp_tpu_torch.fit.mle import MLEResult, lbfgs_minimize, scipy_minimize
from chirpgp_tpu_torch.infer import ekf_for_kpt, rts
from chirpgp_tpu_torch.models.bijections import g, g_inv
from chirpgp_tpu_torch.models.kpt import build_kpt_chirp_model
from chirpgp_tpu_torch.quad.expectations import gaussian_expectation_1d

__all__ = ["KPT_INIT_PARAMS", "kpt_filter", "kpt_smooth", "kpt_mle",
           "kpt_if_estimate"]

# The reference's init for the toymodel sweep.
KPT_INIT_PARAMS = (0.02, 1e-5, 1e-5, 8.0, 1.0)


def kpt_filter(params, fs: float, Xi, ys, num_harmonics: int = 1,
               device="cuda"):
    """Run the KPT EKF at fixed (constrained) params: ``(mfs (T, K+2),
    Pfs (T, K+2, K+2), nll (T,) cumulative)``."""
    ys = _measurements(ys, device)
    F, Sigma, m0, P0, h = build_kpt_chirp_model(
        _on_data(params, ys), fs, num_harmonics=num_harmonics)
    return ekf_for_kpt(F, Sigma, h, Xi, m0, P0, 1.0 / fs, ys)


def kpt_smooth(params, fs: float, mfs, Pfs, num_harmonics: int = 1):
    """Linear RTS smoothing over the KPT EKF output (the KPT dynamics are
    linear; only the measurement is nonlinear)."""
    F, Sigma, _, _, _ = build_kpt_chirp_model(
        _on_data(params, mfs), fs, num_harmonics=num_harmonics)
    return rts(F, Sigma, mfs, Pfs)


def _kpt_nll(fs: float, Xi, num_harmonics: int = 1):
    """The MLE objective ``(theta, ys) -> final EKF NLL`` over
    softplus-reparametrized params."""

    def nll(theta, ys):
        return kpt_filter(g(theta), fs, Xi, ys,
                          num_harmonics=num_harmonics)[2][-1]

    return nll


def _kpt_init_theta(ys: torch.Tensor, init_params=KPT_INIT_PARAMS):
    """``g^{-1}(init_params)`` in the dtype torch's default and the data
    promote to, on the data's device."""
    dtype = torch.promote_types(torch.get_default_dtype(), ys.dtype)
    return g_inv(torch.tensor(init_params, dtype=dtype, device=ys.device))


def kpt_mle(fs: float, Xi, ys, init_params=KPT_INIT_PARAMS,
            num_harmonics: int = 1, optimizer: str = "lbfgs",
            max_iters: int = 200, device="cuda") -> MLEResult:
    """Learn the KPT params by maximizing the EKF marginal likelihood over
    softplus-reparametrized ``theta``: :func:`lbfgs_minimize` (``"lbfgs"``,
    at most ``max_iters`` iterations, the result on the data's device) or
    host SciPy L-BFGS-B with its own default iteration limit
    (``"scipy"``, the result on the host).  Returns the result in theta
    space."""
    if optimizer not in ("scipy", "lbfgs"):
        raise ValueError(f"Unknown optimizer {optimizer!r}")
    ys = _measurements(ys, device)
    objective = _kpt_nll(fs, Xi, num_harmonics)

    def nll(theta):
        return objective(theta, ys)

    init_theta = _kpt_init_theta(ys, init_params)
    if optimizer == "lbfgs":
        return lbfgs_minimize(nll, init_theta, max_iters=max_iters)
    return scipy_minimize(nll, init_theta)


def kpt_if_estimate(params, fs: float, Xi, ys, num_harmonics: int = 1,
                    expectation_order: int = 10, device="cuda"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The KPT pipeline at fixed params: EKF, RTS, and the IF posterior
    mean ``E[g(omega)] fs / (2 pi)``.  Returns ``(if_mean (T,), nell (T,)
    cumulative)``."""
    ys = _measurements(ys, device)
    mfs, Pfs, nell = kpt_filter(params, fs, Xi, ys,
                                num_harmonics=num_harmonics)
    mss, Pss = kpt_smooth(params, fs, mfs, Pfs, num_harmonics=num_harmonics)
    scale = fs / (2.0 * math.pi)
    if_mean = gaussian_expectation_1d(mss[:, 0] * scale,
                                      torch.sqrt(Pss[:, 0, 0]) * scale,
                                      order=expectation_order)
    return if_mean, nell
