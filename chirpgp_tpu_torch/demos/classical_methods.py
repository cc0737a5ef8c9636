"""Classical-baseline demos on the toy chirp on the PyTorch port
(counterpart of the JAX package's ``demos/classical_methods.py``): the
Hilbert transform, the mean spectrogram, the adaptive notch filter and the
polynomial-IF MLE, each with its IF RMSE.

The records are the JAX demo's: the meow chirp (T=3141) plus JAX's normal
draws of ``PRNGKey(555)`` (the ANF's envelope: ``PRNGKey(3)``), remade
without JAX (``utils/jax_keys.py``), float32 unless ``--x64``.  The JAX
demo's ``--tpu`` is ``--device`` here.

Usage:
    python -m chirpgp_tpu_torch.demos.classical_methods [--method all]
"""

import argparse
import math

import numpy as np
import torch

from chirpgp_tpu_torch.experiments._common import (
    add_device_args, numpy_dtype, setup)
from chirpgp_tpu_torch.experiments.print_time import toy_record
from chirpgp_tpu_torch.utils.jax_keys import jax_normal, prng_key


def _rmse(a, b) -> float:
    return float(torch.sqrt(((a - b) ** 2).mean()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", default="all",
                    choices=["all", "hilbert", "spectrogram", "anf", "poly"])
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = setup(args)

    from chirpgp_tpu_torch.baselines import (
        adaptive_notch_filter, hilbert_method, mean_power_spectrum,
        mle_polynomial)
    from chirpgp_tpu_torch.toymodels import (
        constant_mag, gen_chirp_envelope, meow_freq, polynomial_freq)

    dtype = torch.get_default_dtype()
    dt, T, Xi = 1e-3, 3141, 0.1
    ts, ys = (x.to(device) for x in toy_record(T, dt, Xi))
    freq_func, phase_func = meow_freq(offset=8.0)
    true_if = freq_func(ts)

    if args.method in ("all", "hilbert"):
        est = hilbert_method(ts, ys)
        print(f"[hilbert] IF RMSE: {_rmse(true_if[:-1], est):.4f}")

    if args.method in ("all", "spectrogram"):
        new_ts, est = mean_power_spectrum(ts, ys)
        print(f"[spectrogram] IF RMSE: {_rmse(freq_func(new_ts), est):.4f}")

    if args.method in ("all", "anf"):
        env = gen_chirp_envelope(ts, constant_mag(1.0), phase_func) \
            + math.sqrt(Xi) * torch.as_tensor(
                jax_normal(prng_key(3), (T,), numpy_dtype(dtype)),
                device=device)
        mu = 0.015
        gamma_w = mu ** 2 / 2
        gamma_alpha = mu * gamma_w / 4
        est, _, _ = adaptive_notch_filter(ts, env, 0.0, 8.0, 0.1 + 0.0j,
                                          mu, gamma_alpha, gamma_w)
        print(f"[anf] IF RMSE (post-lock-in): "
              f"{_rmse(true_if[1000:], est[1000:]):.4f}")

    if args.method in ("all", "poly"):
        # A 7th-order polynomial IF, from a least-squares fit of the
        # spectrogram's first moment.
        new_ts, rough = mean_power_spectrum(ts, ys)
        order = 7
        coeffs = np.polyfit(new_ts.cpu().numpy(), rough.cpu().numpy(), order)
        init = torch.as_tensor(np.concatenate([[1.0], coeffs[::-1]]),
                               dtype=dtype, device=device)
        params, _ = mle_polynomial(ts, ys, Xi, init)
        poly_if, _ = polynomial_freq(list(params[1:].cpu().numpy()))
        print(f"[poly-mle] IF RMSE: {_rmse(true_if, poly_if(ts)):.4f}")


if __name__ == "__main__":
    main()
