"""Baseline IF estimators: the classical signal-processing methods
(Hilbert transform, spectrogram, polynomial-IF MLE, adaptive notch
filter), the harmonic-chirp grid NLS (FHC) and the fast harmonic-NLS
pitch tracker (fastF0NLS, host C++).  The KPT Kalman pitch tracker is
``chirpgp_tpu_torch.apps.kpt``."""

from chirpgp_tpu_torch.baselines.classical import (
    hilbert_transform, hilbert_method, mean_power_spectrum,
    mle_polynomial, mle_polynomial_batched, adaptive_notch_filter,
    tukey_window, butter_lowpass)
from chirpgp_tpu_torch.baselines.fhc import (
    harmonic_chirp_nls, fhc_pitch_track, fhc_pitch_track_batch)
from chirpgp_tpu_torch.baselines.fastnls import (
    single_pitch, pitch_track, force_odd, median_smooth)

__all__ = ["hilbert_transform", "hilbert_method", "mean_power_spectrum",
           "mle_polynomial", "mle_polynomial_batched",
           "adaptive_notch_filter", "tukey_window", "butter_lowpass",
           "harmonic_chirp_nls", "fhc_pitch_track", "fhc_pitch_track_batch",
           "single_pitch", "pitch_track", "force_odd", "median_smooth"]
