"""Multi-harmonic toy-chirp IF estimation on the PyTorch port
(counterpart of the JAX package's ``demos/ghfs_harmonics_mle.py``): 3
harmonics (d=8) of magnitudes 1, 1/2, 1/3, cubature sigma points, MLE.
The record is the JAX demo's: JAX's normal draws of ``PRNGKey(555)``,
remade without JAX (``utils/jax_keys.py``), float32 unless ``--x64``.

Usage:
    python -m chirpgp_tpu_torch.demos.ghfs_harmonics_mle [--harmonics 3] \\
        [--device cpu] [--plot]
"""

import argparse
import math

import numpy as np
import torch

from chirpgp_tpu_torch.experiments._common import (
    add_device_args, numpy_dtype, require_matplotlib, setup)
from chirpgp_tpu_torch.utils.jax_keys import jax_linspace, jax_normal, prng_key


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--harmonics", type=int, default=3)
    ap.add_argument("--form", default="cov", choices=["cov", "sqrt"])
    ap.add_argument("--T", type=int, default=3141)
    ap.add_argument("--plot", action="store_true")
    add_device_args(ap)
    args = ap.parse_args(argv)
    if args.plot:
        require_matplotlib(ap)
    device = setup(args)

    from chirpgp_tpu_torch.apps import IFEstimationConfig, run_pipeline
    from chirpgp_tpu_torch.toymodels import (
        constant_mag, gen_harmonic_chirp, meow_freq)

    dtype = torch.get_default_dtype()
    dt, T, Xi = 1e-3, args.T, 0.1
    ts = jax_linspace(dt, dt * T, T, dtype)
    true_freq_func, true_phase_func = meow_freq(offset=8.0)
    mags = [constant_mag(1.0 / k) for k in range(1, args.harmonics + 1)]
    noise = jax_normal(prng_key(555), (T,), numpy_dtype(dtype))
    ys = gen_harmonic_chirp(ts, mags, true_phase_func) \
        + math.sqrt(Xi) * torch.from_numpy(noise)

    cfg = IFEstimationConfig(dt=dt, Xi=Xi, method="ghfs", model="harmonic",
                             num_harmonics=args.harmonics,
                             quadrature="cubature", form=args.form)
    opt, params, est = run_pipeline(cfg, ys.to(device))
    if_mean = est["if_mean"].detach().cpu()
    err = float(torch.sqrt(((true_freq_func(ts) - if_mean) ** 2).mean()))
    print(f"learnt params: {np.asarray(params.detach().cpu())}  "
          f"converged={bool(opt.success)}")
    print(f"IF RMSE: {err:.4f}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.plot(ts, true_freq_func(ts), "--", label="True")
        plt.plot(ts, if_mean, "k", label="Estimated")
        plt.legend()
        plt.savefig("ghfs_harmonics_if.png", dpi=120)


if __name__ == "__main__":
    main()
