"""Baseline IF estimators: the classical signal-processing methods
(Hilbert transform, spectrogram, polynomial-IF MLE, adaptive notch
filter).  The KPT Kalman pitch tracker is ``chirpgp_tpu_torch.apps.kpt``."""

from chirpgp_tpu_torch.baselines.classical import (
    hilbert_transform, hilbert_method, mean_power_spectrum,
    mle_polynomial, mle_polynomial_batched, adaptive_notch_filter,
    tukey_window, butter_lowpass)

__all__ = ["hilbert_transform", "hilbert_method", "mean_power_spectrum",
           "mle_polynomial", "mle_polynomial_batched",
           "adaptive_notch_filter", "tukey_window", "butter_lowpass"]
