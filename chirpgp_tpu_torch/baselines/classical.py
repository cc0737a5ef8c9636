"""Classical (non-state-space) IF estimators (counterpart of
``chirpgp_tpu.baselines.classical``): the Hilbert transform, the
spectrogram's first moment, the polynomial-IF MLE and the adaptive notch
filter.

Every estimator takes leading batch dims (records along the leading
axes, samples along the last), so that a Table-I column is one call;
they compute in the dtype and on the device of the measurements.  Only
the Butterworth pre-filter runs on the host (SciPy), as in the JAX
package.
"""

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from chirpgp_tpu_torch.fit.gauss_newton import (
    gauss_newton, gauss_newton_while, levenberg_marquardt,
    levenberg_marquardt_while)

__all__ = ["unwrap", "hilbert_transform", "hilbert_method",
           "mean_power_spectrum", "mle_polynomial", "mle_polynomial_batched",
           "adaptive_notch_filter", "tukey_window", "cosine_window",
           "butter_lowpass"]


def butter_lowpass(ys, cutoff_hz: float, fs: float,
                   order: int = 8) -> torch.Tensor:
    """Zero-phase Butterworth lowpass along the last axis (host SciPy
    ``filtfilt``): the pre-filter of the Hilbert and spectrogram jobs.
    Returns a tensor on ``ys``' device (the host for NumPy input)."""
    import scipy.signal
    device = ys.device if isinstance(ys, torch.Tensor) else torch.device("cpu")
    host = ys.cpu().numpy() if isinstance(ys, torch.Tensor) else np.asarray(ys)
    b, a = scipy.signal.butter(order, cutoff_hz, fs=fs, btype="low")
    return torch.as_tensor(np.ascontiguousarray(
        scipy.signal.filtfilt(b, a, host)), device=device)


def _mod(x: torch.Tensor, period: float) -> torch.Tensor:
    """``numpy.mod`` for floats: ``fmod`` (exact) moved to the sign of the
    divisor."""
    r = torch.fmod(x, period)
    return torch.where((r != 0) & ((r < 0) != (period < 0)), r + period, r)


def unwrap(p: torch.Tensor, discont: Optional[float] = None,
           period: float = 2.0 * math.pi) -> torch.Tensor:
    """``numpy.unwrap`` along the last axis: a jump larger than ``discont``
    (default ``period / 2``) between neighbours is replaced by its
    remainder modulo ``period``; a jump of exactly ``period / 2`` keeps its
    sign."""
    if p.shape[-1] == 0:
        return p
    if discont is None:
        discont = period / 2
    interval = period / 2
    dd = torch.diff(p, dim=-1)
    ddmod = _mod(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0),
                        torch.full_like(ddmod, interval), ddmod)
    ph_correct = torch.where(dd.abs() < discont, torch.zeros_like(dd),
                             ddmod - dd)
    return torch.cat([p[..., :1], p[..., 1:] + torch.cumsum(ph_correct, -1)],
                     dim=-1)


def hilbert_transform(ys: torch.Tensor) -> torch.Tensor:
    """Analytic signal along the last axis via FFT (``scipy.signal.hilbert``)."""
    n = ys.shape[-1]
    X = torch.fft.fft(ys, dim=-1)
    h = torch.zeros(n, dtype=ys.dtype, device=ys.device)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    return torch.fft.ifft(X * h, dim=-1)


def hilbert_method(ts: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """IF from the phase derivative of the analytic signal: ``T - 1``
    values per record."""
    fs = 1.0 / (ts[1] - ts[0])
    phase = unwrap(torch.angle(hilbert_transform(ys)))
    return torch.diff(phase, dim=-1) / (2.0 * math.pi) * fs


def tukey_window(n: int, alpha: float = 0.25, dtype=torch.float64,
                 device=None) -> torch.Tensor:
    """Tukey (tapered cosine) window, ``scipy.signal.windows.tukey``."""
    if alpha <= 0:
        return torch.ones(n, dtype=dtype, device=device)
    x = torch.linspace(0.0, 1.0, n, dtype=dtype, device=device)
    w = torch.ones(n, dtype=dtype, device=device)
    edge = alpha / 2.0
    w = torch.where(x < edge, 0.5 * (1.0 + torch.cos(
        math.pi * (2.0 * x / alpha - 1.0))), w)
    w = torch.where(x >= 1.0 - edge, 0.5 * (1.0 + torch.cos(
        math.pi * (2.0 * x / alpha - 2.0 / alpha + 1.0))), w)
    return w


def cosine_window(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """Cosine (half-sine) window, ``scipy.signal.windows.cosine``."""
    return torch.sin(math.pi / n * (torch.arange(n, dtype=dtype,
                                                 device=device) + 0.5))


def _stft_psd(ys: torch.Tensor, fs, nperseg: int, noverlap: int,
              window: str = "tukey"):
    """One-sided PSD spectrogram along the last axis, with constant detrend
    and density scaling (``scipy.signal.spectrogram``'s defaults): the
    frequencies, the frame centres and the PSD ``(..., nfreq, frames)``."""
    step = nperseg - noverlap
    # A record shorter than one frame has no frames (an empty spectrogram,
    # as the JAX package's).
    n_frames = max(1 + (ys.shape[-1] - nperseg) // step, 0)
    like = dict(dtype=ys.dtype, device=ys.device)
    win = cosine_window(nperseg, **like) if window == "cosine" \
        else tukey_window(nperseg, **like)
    scale = 1.0 / (fs * torch.sum(win ** 2))
    if n_frames:
        frames = ys.unfold(-1, nperseg, step)             # (..., F, nperseg)
        frames = frames - frames.mean(dim=-1, keepdim=True)
        spec = torch.fft.rfft(frames * win, dim=-1)      # (..., F, nfreq)
        psd = (spec.real ** 2 + spec.imag ** 2) * scale
    else:
        psd = ys.new_zeros(ys.shape[:-1] + (0, nperseg // 2 + 1))
    # One-sided doubling (except DC, and Nyquist for even nperseg).
    mult = torch.ones(psd.shape[-1], **like)
    mult[1:] = 2.0
    if nperseg % 2 == 0:
        mult[-1] = 1.0
    psd = psd * mult
    freqs = torch.fft.rfftfreq(nperseg, d=1.0 / fs, **like)
    times = (torch.arange(n_frames, **like) * step + nperseg / 2.0) / fs
    return freqs, times, psd.transpose(-1, -2)


def mean_power_spectrum(ts: torch.Tensor, ys: torch.Tensor,
                        nperseg: int = 256, noverlap: Optional[int] = None,
                        window: str = "tukey") -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """IF as the first moment of the spectrogram PSD: the frame times and,
    per record, the estimate at each frame."""
    if noverlap is None:
        noverlap = nperseg // 8
    fs = float(1.0 / (ts[1] - ts[0]))
    freqs, times, Sxx = _stft_psd(ys, fs, nperseg, noverlap, window)
    est = (freqs[:, None] * Sxx).sum(-2) / Sxx.sum(-2)
    return times + ts[0], est


def _poly_chirp_fn(ts: torch.Tensor, num_params: int) -> Callable:
    """params = [alpha, c_0..c_n] -> alpha * sin(2 pi zeta(t)), with zeta
    the antiderivative of the IF polynomial sum c_k t^k, evaluated by
    Horner's rule as ``jnp.polyval``."""
    n = num_params - 2
    if n < 0:
        raise ValueError("init_params must have at least 2 entries.")
    alien = torch.tensor([1.0 / (j + 1) for j in range(n + 1)],
                         dtype=ts.dtype, device=ts.device)

    def f(params):
        alpha, cs = params[0], params[1:]
        coeffs = torch.cat([torch.zeros_like(cs[:1]), alien * cs])
        zeta = torch.zeros_like(ts)
        for c in torch.flip(coeffs, (0,)):
            zeta = zeta * ts + c
        return alpha * torch.sin(2.0 * math.pi * zeta)

    return f


def mle_polynomial_batched(ts: torch.Tensor, yss: torch.Tensor, Xi,
                           init_params: torch.Tensor,
                           method: str = "levenberg_marquardt",
                           max_iters: int = 100):
    """Monte-Carlo-batched polynomial MLE: LM (or GN with ``method=
    "gauss_newton"``) over records ``yss (B, T)`` with per-record inits
    ``init_params (B, P)``, all records stepping together, each with its
    own stopping rule.  Returns a batched
    :class:`~chirpgp_tpu_torch.fit.gauss_newton.NLSResult`."""
    f = _poly_chirp_fn(ts, init_params.shape[-1])
    solver = (gauss_newton_while if method == "gauss_newton"
              else levenberg_marquardt_while)
    return solver(f, init_params, yss, Xi, max_iters=max_iters)


def mle_polynomial(ts: torch.Tensor, ys: torch.Tensor, Xi,
                   init_params: torch.Tensor,
                   method: str = "levenberg_marquardt", *args, **kwargs):
    r"""MLE of a polynomial-IF chirp ``y = alpha sin(2 pi zeta(t))`` on one
    record.

    ``init_params = [alpha, c_0, ..., c_n]`` with the IF polynomial
    ``f(t) = sum c_k t^k`` and phase ``zeta(t) = sum c_k t^{k+1}/(k+1)``.
    ``"gauss_newton"`` and ``"levenberg_marquardt"`` return ``(params,
    objective trajectory)``; ``"L-BFGS-B"`` (host SciPy) returns
    ``(params, final objective)``.
    """
    f = _poly_chirp_fn(ts, init_params.shape[0])
    if method == "gauss_newton":
        return gauss_newton(f, init_params, ys, Xi, *args, **kwargs)
    if method == "levenberg_marquardt":
        return levenberg_marquardt(f, init_params, ys, Xi, *args, **kwargs)
    if method == "L-BFGS-B":
        from chirpgp_tpu_torch.fit.mle import scipy_minimize

        def obj(params):
            return torch.sum((ys - f(params)) ** 2) / Xi

        res = scipy_minimize(obj, init_params)
        return res.params, res.fun_val
    raise ValueError(f"Method {method!r} does not exist.")


def adaptive_notch_filter(ts: torch.Tensor, ys: torch.Tensor, alpha0: float,
                          w0: float, s0: complex, mu: float,
                          gamma_alpha: float, gamma_w: float):
    """Pilot adaptive notch filter of Niedzwiecki & Meller 2011, Table II.

    ``ys`` is the complex chirp envelope ``(..., T)``, or its real pairs
    ``(..., T, 2)`` of (real, imag); the magnitudes come back in the same
    form.  Returns ``(IF, chirp rate, magnitudes)``, each per sample.
    Parameters should satisfy ``gamma_alpha << gamma_w << mu < 1``.
    """
    dt = ts[1] - ts[0]
    complex_in = ys.is_complex()
    y_pairs = torch.stack([ys.real, ys.imag], dim=-1) if complex_in else ys
    s0 = complex(s0)
    batch = y_pairs.shape[:-2]
    like = dict(dtype=y_pairs.dtype, device=y_pairs.device)
    w, alpha = (w0 * dt).expand(batch), (alpha0 * dt).expand(batch)
    sr = torch.full(batch, s0.real, **like)
    si = torch.full(batch, s0.imag, **like)
    freqs, alphas, srs, sis = [], [], [], []
    for t in range(y_pairs.shape[-2]):
        theta = 2.0 * math.pi * (w + alpha)
        c, sn = torch.cos(theta), torch.sin(theta)
        a = c * sr - sn * si                             # rot * s
        b = sn * sr + c * si
        er = y_pairs[..., t, 0] - a
        ei = y_pairs[..., t, 1] - b
        # Im(eps * conj(rot) * conj(s)) = Im((er + i ei)(a - i b))
        delta = (ei * a - er * b) / (sr ** 2 + si ** 2)
        sr, si = a + mu * er, b + mu * ei
        w = w + alpha + gamma_w * delta
        alpha = alpha + gamma_alpha * delta
        freqs.append(w)
        alphas.append(alpha)
        srs.append(sr)
        sis.append(si)
    freqs, alphas = torch.stack(freqs, -1), torch.stack(alphas, -1)
    srs, sis = torch.stack(srs, -1), torch.stack(sis, -1)
    mags = torch.complex(srs, sis) if complex_in \
        else torch.stack([srs, sis], dim=-1)
    return freqs / dt, alphas / dt, mags
