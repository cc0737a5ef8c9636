"""Fast harmonic-NLS pitch estimation baseline, fastF0NLS (counterpart of
``chirpgp_tpu.baselines.fastnls``).

The estimator is host C++ (``ops/native/fast_nls.cpp``, built by ``g++``
on first use; not a GPU kernel); this module is its ctypes wrapper:
``single_pitch`` (nData, maxModelOrder, pitchBounds, nFftGrid default
5*N*L; ``est`` returns rad/sample) and the sliding-window
``pitch_track`` with median smoothing.  It works on NumPy float64 host
arrays.
"""

import math
from typing import Optional, Tuple

import numpy as np

from chirpgp_tpu_torch.ops.native import load_fast_nls

__all__ = ["single_pitch", "pitch_track", "force_odd", "median_smooth"]


class single_pitch:
    """Windowed harmonic NLS pitch estimator.

    Parameters
    ----------
    nData : window length N.
    maxModelOrder : maximum number of harmonics L.
    pitchBounds : (2,) normalized frequency bounds (1.0 = Nyquist).
    nFftGrid : grid size; defaults to 5 * N * L.
    """

    def __init__(self, nData: int, maxModelOrder: int,
                 pitchBounds: np.ndarray, nFftGrid: Optional[int] = None):
        if nFftGrid is None:
            nFftGrid = 5 * nData * maxModelOrder
        self._lib = load_fast_nls()
        bounds = np.ascontiguousarray(pitchBounds, dtype=np.float64)
        self.obj = self._lib.single_pitch_new(
            maxModelOrder, nFftGrid, nData, bounds.ctypes.data)

    def est(self, data: np.ndarray, lnBFZeroOrder: float = 0.0,
            eps: float = 1e-3, method: int = 0) -> float:
        """Estimate the pitch in radians per sample.  ``method == 0`` is
        the fast path (order-select on the grid, refine the winner);
        ``method != 0`` refines every order before selecting."""
        buf = np.ascontiguousarray(data, dtype=np.float64)
        if method == 0:
            return self._lib.single_pitch_est_fast(
                self.obj, buf.ctypes.data, lnBFZeroOrder, eps)
        return self._lib.single_pitch_est(
            self.obj, buf.ctypes.data, lnBFZeroOrder, eps)

    def modelOrder(self) -> int:
        """Estimated model order of the latest solve."""
        return self._lib.single_pitch_model_order(self.obj)

    def __del__(self):
        try:
            self._lib.single_pitch_del(self.obj)
        except Exception:
            pass


def force_odd(number: int) -> int:
    return number + 1 if number % 2 == 0 else number


def median_smooth(x: np.ndarray, kernel: int) -> np.ndarray:
    """Median filter, ``scipy.signal.medfilt`` with an odd kernel."""
    import scipy.signal
    return scipy.signal.medfilt(x, force_odd(kernel))


def pitch_track(ys, fs: float, num_harmonics: int,
                window_length: int = 300, window_overlap: int = 295,
                f0_bounds_hz: Tuple[float, float] = (2.0, 15.0),
                eps: float = 1e-7,
                method: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding-window pitch tracking: window-centre times and per-window
    f0 estimates in Hz, host arrays.  A tensor ``ys`` is copied to the
    host."""
    ys = np.asarray(ys.cpu() if hasattr(ys, "cpu") else ys, dtype=np.float64)
    T = ys.shape[0]
    dt = 1.0 / fs
    f0Bounds = np.array(f0_bounds_hz) / fs
    estimator = single_pitch(window_length, num_harmonics, f0Bounds)

    step = window_length - window_overlap
    num_windows = round((T - window_length) / step) + 1
    centres = window_length / 2 + np.arange(num_windows) * step
    times = centres * dt

    f0 = np.zeros((num_windows,))
    for k in range(num_windows):
        idx = k * step
        chunk = ys[idx:idx + window_length]
        f0[k] = (fs / (2.0 * math.pi)) * estimator.est(chunk, eps=eps,
                                                       method=method)
    return times, f0
