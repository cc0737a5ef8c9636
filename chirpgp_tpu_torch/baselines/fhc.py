"""Fast harmonic-chirp (FHC-class) NLS estimation (counterpart of
``chirpgp_tpu.baselines.fhc``).

Within each window the signal is modeled as a linear-chirp harmonic

    y(n) = sum_{l=1..L} a_l cos(l phi(n)) + b_l sin(l phi(n)),
    phi(n) = w n + 0.5 alpha n^2,

and (w, alpha) are estimated by NLS over a 2-D grid with exact
normal-equation objectives, followed by local grid zooms.  Windows are
solved in batches: the grid projections of a batch are batched matrix
products (``torch.einsum``), the normal equations one batched
``torch.linalg.solve``, on the windows' device.  The JAX package computes
the same projections with ``jnp.einsum`` outside any Pallas kernel.
"""

import math
from typing import Tuple

import numpy as np
import torch

__all__ = ["harmonic_chirp_nls", "fhc_pitch_track", "fhc_pitch_track_batch"]

# Windows per batch of fhc_pitch_track_batch on the card.  The live grid
# tensors of a batch are about 2.5 x window_chunk x n_w x n_alpha x 2L x
# window_length values: at the defaults (96 x 11 grid, L = 3, 300
# samples) 19 MB per window in float32, so 1024 windows take ~20 GB of
# the H100's 80 GB, and twice that in float64.
WINDOW_CHUNK = 1024


def _linspace(lo: torch.Tensor, hi: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace(lo, hi, num)`` per row of ``lo``/``hi`` (W,):
    ``lo + i (hi - lo) / (num - 1)`` with the last point ``hi``."""
    i = torch.arange(num - 1, dtype=lo.dtype, device=lo.device)
    inner = lo[:, None] + i * ((hi - lo) / (num - 1))[:, None]
    return torch.cat([inner, hi[:, None]], dim=1)


def _objective_grid(y: torch.Tensor, ws: torch.Tensor, alphas: torch.Tensor,
                    L: int, ridge: float = 1e-8) -> torch.Tensor:
    """NLS objective ``J(w, alpha) = v^T G^{-1} v`` on each window's grid.

    y: (W, N); ws: (W, Nw); alphas: (W, Na).  Returns (W, Nw, Na).
    """
    N = y.shape[-1]
    n = torch.arange(N, dtype=y.dtype, device=y.device)
    phase = ws[:, :, None, None] * n + 0.5 * alphas[:, None, :, None] * n ** 2
    ls = torch.arange(1, L + 1, dtype=y.dtype, device=y.device)
    ph = phase[..., None, :] * ls[:, None]             # (W, Nw, Na, L, N)
    Z = torch.cat([torch.cos(ph), torch.sin(ph)], dim=-2)   # (W, Nw, Na, 2L, N)
    del ph, phase
    v = torch.einsum("wabkn,wn->wabk", Z, y)           # Z^T y
    G = torch.einsum("wabkn,wabln->wabkl", Z, Z)       # Z^T Z (2L, 2L)
    del Z
    G = G + ridge * N * torch.eye(2 * L, dtype=y.dtype, device=y.device)
    sol = torch.linalg.solve(G, v[..., None])[..., 0]
    return (v * sol).sum(-1)


def _nls_windows(y: torch.Tensor, L: int, w_lo, w_hi, a_lo, a_hi,
                 n_w: int, n_alpha: int, n_refine: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`harmonic_chirp_nls` for the windows ``y`` (W, N) at once:
    (w, alpha) per window, each grid zoomed around its own optimum."""
    y = y - y.mean(-1, keepdim=True)
    W = y.shape[0]
    bound = lambda v: torch.full((W,), float(v), dtype=y.dtype,
                                 device=y.device)
    w_lo, w_hi, a_lo, a_hi = map(bound, (w_lo, w_hi, a_lo, a_hi))
    rows = torch.arange(W, device=y.device)

    def solve_grid(w_lo, w_hi, a_lo, a_hi):
        ws = _linspace(w_lo, w_hi, n_w)
        alphas = _linspace(a_lo, a_hi, n_alpha)
        J = _objective_grid(y, ws, alphas, L)
        idx = torch.argmax(J.reshape(W, -1), dim=-1)
        iw, ia = idx // n_alpha, idx % n_alpha
        return (ws[rows, iw], alphas[rows, ia], ws[:, 1] - ws[:, 0],
                alphas[:, 1] - alphas[:, 0])

    w, a, dw, da = solve_grid(w_lo, w_hi, a_lo, a_hi)
    for _ in range(n_refine):
        w, a, dw, da = solve_grid(w - dw, w + dw, a - da, a + da)
    return w, a


def harmonic_chirp_nls(y, num_harmonics: int, w_bounds: Tuple[float, float],
                       alpha_bounds: Tuple[float, float] = (-2e-5, 2e-5),
                       n_w: int = 64, n_alpha: int = 15,
                       n_refine: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Estimate (w, alpha) of one windowed harmonic linear chirp ``y``
    (N,) by grid NLS with ``n_refine`` rounds of local grid zoom.  Returns
    0-dim tensors, in rad/sample and rad/sample^2, on ``y``'s device."""
    y = torch.as_tensor(y)
    w, a = _nls_windows(y[None], num_harmonics, *w_bounds, *alpha_bounds,
                        n_w, n_alpha, n_refine)
    return w[0], a[0]


def _solve_windows(windows: torch.Tensor, num_harmonics: int, w_bounds,
                   a_max, window_length: int, n_w: int,
                   n_alpha: int) -> torch.Tensor:
    """Per-window centre-IF estimates ``w + alpha N/2``, clipped into the
    f0 search band: in sub-cycle windows the (w, alpha) pair is nearly
    unidentifiable and the linear extrapolation can leave the band."""
    w, a = _nls_windows(windows, num_harmonics, w_bounds[0], w_bounds[1],
                        -a_max, a_max, n_w, n_alpha, 2)
    return torch.clamp(w + a * window_length / 2.0, w_bounds[0], w_bounds[1])


def _window_setup(T: int, fs: float, window_length: int, window_overlap: int,
                  f0_bounds_hz, max_chirp_rate_hz_s):
    step = window_length - window_overlap
    num_windows = round((T - window_length) / step) + 1
    centres = window_length / 2 + np.arange(num_windows) * step
    w_bounds = (2 * math.pi * f0_bounds_hz[0] / fs,
                2 * math.pi * f0_bounds_hz[1] / fs)
    a_max = 2 * math.pi * max_chirp_rate_hz_s / fs ** 2
    idx = torch.arange(num_windows)[:, None] * step \
        + torch.arange(window_length)[None, :]
    return centres * (1.0 / fs), w_bounds, a_max, idx


def _records(ys, device) -> torch.Tensor:
    if isinstance(ys, torch.Tensor):
        return ys
    return torch.as_tensor(np.asarray(ys), device=device)


def fhc_pitch_track(ys, fs: float, num_harmonics: int,
                    window_length: int = 300, window_overlap: int = 295,
                    f0_bounds_hz: Tuple[float, float] = (2.0, 15.0),
                    max_chirp_rate_hz_s: float = 50.0,
                    n_w: int = 96, n_alpha: int = 11, device="cuda"):
    """Sliding-window harmonic-chirp pitch tracking: per-window estimates
    of the IF at the window centre, ``w + alpha N/2``.  ``ys`` as a tensor
    stays on its device; anything else goes to ``device``.  Returns host
    arrays (times, f0_hz)."""
    ys = _records(ys, device)
    times, w_bounds, a_max, idx = _window_setup(
        ys.shape[0], fs, window_length, window_overlap, f0_bounds_hz,
        max_chirp_rate_hz_s)
    windows = ys[idx.to(ys.device)]                          # (W, N)
    w_centre = _solve_windows(windows, num_harmonics, w_bounds, a_max,
                              window_length, n_w, n_alpha)
    return times, w_centre.cpu().numpy() * fs / (2.0 * math.pi)


def fhc_pitch_track_batch(yss, fs: float, num_harmonics: int,
                          window_length: int = 300,
                          window_overlap: int = 295,
                          f0_bounds_hz: Tuple[float, float] = (2.0, 15.0),
                          max_chirp_rate_hz_s: float = 50.0,
                          n_w: int = 96, n_alpha: int = 11,
                          window_chunk: int = WINDOW_CHUNK, device="cuda"):
    """Record-batched :func:`fhc_pitch_track`: ``yss`` (B, T) -> (times
    (W,), f0_hz (B, W)) host arrays.  The B * W windows are solved in
    batches of ``window_chunk``, which bounds the live grid tensors
    (see ``WINDOW_CHUNK``)."""
    yss = _records(yss, device)
    B, T = yss.shape
    times, w_bounds, a_max, idx = _window_setup(
        T, fs, window_length, window_overlap, f0_bounds_hz,
        max_chirp_rate_hz_s)
    windows = yss[:, idx.to(yss.device)].reshape(-1, window_length)
    out = [_solve_windows(windows[lo:lo + window_chunk], num_harmonics,
                          w_bounds, a_max, window_length, n_w, n_alpha)
           for lo in range(0, windows.shape[0], window_chunk)]
    f0 = torch.cat(out).reshape(B, -1).cpu().numpy() * fs / (2.0 * math.pi)
    return times, f0
