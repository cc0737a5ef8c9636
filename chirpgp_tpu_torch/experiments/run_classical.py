"""Classical-baseline Monte-Carlo sweep on the PyTorch port: Hilbert
transform, spectrogram, adaptive notch filter and polynomial-IF MLE, per
seed per magnitude, written as ``{method}_{mag}.npz`` (``rmse``; the
polynomial column also ``converged``) and printed as the RMSE table.

The records are the JAX package's (``experiments/run_classical.py``): its
pregenerated keys, float64 draws (the classical jobs run in float64),
remade without JAX (``utils/jax_keys.py``).  Each method runs all seeds of
a magnitude as one batch on the device.  The JAX script's ``--platform``
is ``--device`` here.

Usage:
    python -m chirpgp_tpu_torch.experiments.run_classical \\
        --methods hilbert anf --seeds 100
"""

import argparse
import math
import os

import numpy as np
import torch

from chirpgp_tpu_torch.experiments._common import add_device_args, setup
from chirpgp_tpu_torch.utils.jax_keys import (
    jax_linspace, jax_rnd_keys, jax_toymodel_draws)

# The reference jobs' protocol: an order-8 Butterworth lowpass at 18 Hz
# before the Hilbert transform and the spectrogram (cosine window,
# nperseg=450, noverlap=449); the ANF from alpha0=0, w0 = the true IF at
# t=dt, s0=1 with mu=0.015; the polynomial LM from numpy's degree-11 fit
# of the true IF.
LOWPASS_HZ, SPEC_NPERSEG, ANF_MU, POLY_DEGREE = 18.0, 450, 0.015, 11
DT, XI = 1e-3, 0.1


def _rmse_rows(est, truth):
    return torch.sqrt(((est - truth) ** 2).mean(-1))


def classical_column(method, ts, ys, env, device):
    """Per-record IF-RMSE of ``method`` on records ``ys`` (B, T) (the ANF
    on the complex envelopes ``env``): a dict of host arrays."""
    from chirpgp_tpu_torch.baselines import (
        adaptive_notch_filter, butter_lowpass, hilbert_method,
        mean_power_spectrum, mle_polynomial_batched)
    from chirpgp_tpu_torch.toymodels import meow_freq

    freq_func, _ = meow_freq(offset=8.0)
    fs = 1.0 / DT
    ts = ts.to(device)
    true_if = freq_func(ts)
    if method == "hilbert":
        est = hilbert_method(ts, butter_lowpass(ys.to(device), LOWPASS_HZ,
                                                fs))
        return dict(rmse=_rmse_rows(est, true_if[1:]).cpu().numpy())
    if method == "spectrogram":
        new_ts, est = mean_power_spectrum(
            ts, butter_lowpass(ys.to(device), LOWPASS_HZ, fs),
            nperseg=SPEC_NPERSEG, noverlap=SPEC_NPERSEG - 1,
            window="cosine")
        return dict(rmse=_rmse_rows(est, freq_func(new_ts)).cpu().numpy())
    if method == "anf":
        gamma_w = ANF_MU ** 2 / 2
        w0 = float(freq_func(ts[:1])[0])
        est, _, _ = adaptive_notch_filter(
            ts, env.to(device), 0.0, w0, 1.0 + 0.0j, ANF_MU,
            ANF_MU * gamma_w / 4, gamma_w)
        return dict(rmse=_rmse_rows(est, true_if).cpu().numpy())
    if method == "poly":
        # No perturbation of the init: the reference's fixed-key 2e-5
        # relative noise detunes this fit's phase by whole cycles.
        fit = np.polynomial.Polynomial.fit(ts.cpu().numpy(),
                                           true_if.cpu().numpy(), POLY_DEGREE)
        init = torch.as_tensor(np.concatenate([[1.0], fit.convert().coef]),
                               device=device)
        res = mle_polynomial_batched(ts, ys.to(device), XI,
                                     init.expand(ys.shape[0], -1))
        powers = ts[:, None] ** torch.arange(POLY_DEGREE + 1,
                                             dtype=ts.dtype, device=device)
        est = res.params[:, 1:] @ powers.T
        return dict(rmse=_rmse_rows(est, true_if).cpu().numpy(),
                    converged=res.converged.cpu().numpy())
    raise ValueError(method)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--methods", nargs="+",
                    default=["hilbert", "spectrogram", "anf", "poly"])
    ap.add_argument("--seeds", type=int, default=100)
    ap.add_argument("--T", type=int, default=3141)
    ap.add_argument("--mags", nargs="+",
                    default=["const", "damped", "random"])
    ap.add_argument("--out", default="./results")
    add_device_args(ap, x64=False)
    args = ap.parse_args(argv)
    device = setup(args)

    from chirpgp_tpu_torch.apps.sweeps import print_rmse_table
    from chirpgp_tpu_torch.toymodels import (
        gen_chirp, gen_chirp_envelope, meow_freq)

    # The reference runs every classical job in float64; the polynomial
    # MLE is ill-conditioned in float32.
    dtype = torch.float64
    T = args.T
    ts = jax_linspace(DT, DT * T, T, dtype)
    _, phase_func = meow_freq(offset=8.0)
    keys = jax_rnd_keys(max(args.seeds, 1))[:args.seeds]
    os.makedirs(args.out, exist_ok=True)
    records = {}
    for mag in args.mags:
        magnitude, noise = jax_toymodel_draws(keys, mag, T, dtype)
        records[mag] = (
            gen_chirp(ts, magnitude, phase_func) + math.sqrt(XI) * noise,
            gen_chirp_envelope(ts, magnitude, phase_func)
            + math.sqrt(XI) * noise)

    all_results = {}
    for method in args.methods:
        by_mag = {}
        for mag in args.mags:
            ys, env = records[mag]
            res = classical_column(method, ts, ys, env, device)
            np.savez(os.path.join(args.out, f"{method}_{mag}.npz"), **res)
            by_mag[mag] = res
        all_results[method] = by_mag

    print_rmse_table(all_results)


if __name__ == "__main__":
    main()
