"""Real-data IF-estimation pipelines: bat echolocation calls and the LIGO
GW150914 chirp (counterpart of ``chirpgp_tpu.apps.realdata``).

- Bats: read a wav, crop a window, standardize, run the harmonic chirp
  model with hand-set parameters (no MLE), cubature sigma points and
  ``freq_scale`` for numerical stability.  Eptesicus: 5 harmonics,
  freq_scale=1e4, Xi=1e-3, params [0.2, 1, 1, 0.5, 5, 1]; Myotis: 4
  harmonics, freq_scale=1e4, Xi=1e-4, params [0.1, 1, 1, 0.2, 10, 2].
  This is the unbatched ``estimate_if`` (d = 2K + 2, covariance form by
  default), not a batched kernel: the batched paths take a one-hot H only.
- LIGO: strain txt data, Xi=0.3, GH d=4 order 3, MLE from
  g^{-1}([0.1, 2, 0.5, 0.02, 40, 1]).

The wav and strain files are not vendored; the loaders take explicit
paths.  Loaded data go to ``device``, the card unless the caller passes
``device="cpu"``; tensors stay where they are.
"""

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from chirpgp_tpu_torch.apps.pipeline import (
    IFEstimationConfig, _measurements, estimate_if, fit_mle)
from chirpgp_tpu_torch.models.bijections import g, g_inv

__all__ = ["BatCallConfig", "EPTESICUS", "MYOTIS", "analyze_bat_call",
           "ligo_config", "analyze_ligo", "standardize", "load_wav",
           "load_ligo_strain"]


def standardize(ys: torch.Tensor) -> torch.Tensor:
    """Zero-mean unit-variance normalization (population std, as
    ``jnp.std``)."""
    return (ys - ys.mean()) / ys.std(correction=0)


def load_wav(path: str, crop: Optional[Tuple[int, int]] = None,
             device="cuda"):
    """Load a mono wav file (the first channel of a multi-channel one);
    returns ``(fs, ys)``, ``ys`` a float64 tensor on ``device``."""
    from scipy.io import wavfile
    fs, data = wavfile.read(path)
    ys = np.asarray(data, dtype=np.float64)
    if ys.ndim > 1:
        ys = ys[:, 0]
    if crop is not None:
        ys = ys[crop[0]:crop[1]]
    return fs, torch.as_tensor(ys, device=device)


def load_ligo_strain(paths: Sequence[str], device="cuda"):
    """Load LIGO strain txt files (time, strain columns); returns a list of
    ``(ts, ys)`` float64 tensors on ``device``."""
    out = []
    for p in paths:
        arr = np.loadtxt(p)
        out.append((torch.as_tensor(arr[:, 0], device=device),
                    torch.as_tensor(arr[:, 1], device=device)))
    return out


@dataclasses.dataclass(frozen=True)
class BatCallConfig:
    """Hand-set (no-MLE) harmonic analysis configuration for one species."""
    num_harmonics: int
    freq_scale: float
    Xi: float
    params: Tuple[float, ...]        # [lam, b, delta, ell, sigma, m0_v]


EPTESICUS = BatCallConfig(num_harmonics=5, freq_scale=1e4, Xi=1e-3,
                          params=(0.2, 1.0, 1.0, 0.5, 5.0, 1.0))
MYOTIS = BatCallConfig(num_harmonics=4, freq_scale=1e4, Xi=1e-4,
                       params=(0.1, 1.0, 1.0, 0.2, 10.0, 2.0))


def _sync(ys: torch.Tensor):
    if ys.device.type == "cuda":
        torch.cuda.synchronize(ys.device)


def analyze_bat_call(ys, fs: float, bat: BatCallConfig, form: str = "cov",
                     time_it: bool = False, device="cuda"):
    """Filter and smooth a standardized bat call with the fixed hand-set
    params of ``bat``.

    Returns the estimate dict (IF posterior in Hz) and, when ``time_it``,
    the filter+smoother wall time in seconds of a second call, after a
    warm-up call at the full shape, synchronized on the card; else
    ``None``.
    """
    ys = _measurements(ys, device)
    cfg = IFEstimationConfig(
        dt=1.0 / fs, Xi=bat.Xi, method="ghfs", model="harmonic",
        num_harmonics=bat.num_harmonics, freq_scale=bat.freq_scale,
        quadrature="cubature", form=form)
    params = torch.tensor(bat.params, dtype=ys.dtype, device=ys.device)
    if not time_it:
        return estimate_if(cfg, params, ys), None
    with torch.no_grad():
        estimate_if(cfg, params, ys)
        _sync(ys)
        t0 = time.perf_counter()
        est = estimate_if(cfg, params, ys)
        _sync(ys)
    return est, time.perf_counter() - t0


def ligo_config(dt: float, max_iters: Optional[int] = None
                ) -> Tuple[IFEstimationConfig, torch.Tensor]:
    """LIGO pipeline config and init theta (float64, host); ``max_iters``
    caps the MLE's iterations (default: the config's)."""
    cfg = IFEstimationConfig(dt=dt, Xi=0.3, method="ghfs", model="chirp",
                             gh_order=3)
    if max_iters is not None:
        cfg = dataclasses.replace(cfg, max_iters=max_iters)
    init_theta = g_inv(torch.tensor([0.1, 2.0, 0.5, 0.02, 40.0, 1.0],
                                    dtype=torch.float64))
    return cfg, init_theta


def analyze_ligo(ts, ys, max_iters: Optional[int] = None, device="cuda"):
    """MLE and IF posterior on one LIGO strain record (standardized
    first).  Returns ``(opt, params, est)``."""
    ts = _measurements(ts, device)
    ys = _measurements(ys, device)
    dt = float(ts[1] - ts[0])
    cfg, init_theta = ligo_config(dt, max_iters)
    ys = standardize(ys)
    opt = fit_mle(cfg, ys, init_theta)
    params = g(opt.params)
    est = estimate_if(cfg, params, ys)
    return opt, params, est
