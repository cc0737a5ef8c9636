"""Toy-chirp IF estimation with a Gauss--Hermite sigma-point filter and
smoother, hyperparameters learnt by MLE, on the PyTorch port
(counterpart of the JAX package's ``demos/ghfs_mle.py``).

The experiment contract: dt=1e-3, T=3141, the meow IF with offset 8,
Xi=0.1, three magnitude scenarios (constant, damped, a random OU path),
GH order 3, init theta g^{-1}([.1, .1, .1, 1, 1, 7]).  The records are the
JAX demo's: JAX's normal draws of ``PRNGKey(555)``'s split, remade without
JAX (``utils/jax_keys.py``), float32 unless ``--x64``.

Usage:
    python -m chirpgp_tpu_torch.demos.ghfs_mle [--method ghfs] \\
        [--form cov|sqrt] [--device cpu] [--plot]
"""

import argparse
import math

import numpy as np
import torch

from chirpgp_tpu_torch.experiments._common import (
    add_device_args, numpy_dtype, require_matplotlib, setup)
from chirpgp_tpu_torch.utils.jax_keys import (
    jax_linspace, jax_normal, jax_ou_mag, prng_key, split)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", default="ghfs",
                    choices=["ghfs", "ekfs", "cd_ghfs", "cd_ekfs"])
    ap.add_argument("--form", default="cov", choices=["cov", "sqrt"])
    ap.add_argument("--T", type=int, default=3141)
    ap.add_argument("--max-iters", type=int, default=100)
    ap.add_argument("--optimizer", default="scipy",
                    choices=["scipy", "lbfgs"],
                    help="scipy: host L-BFGS-B, one value-and-grad on the "
                         "device per step; lbfgs: the port's batched "
                         "L-BFGS on the device")
    ap.add_argument("--plot", action="store_true")
    add_device_args(ap)
    args = ap.parse_args(argv)
    if args.plot:
        require_matplotlib(ap)
    device = setup(args)

    from chirpgp_tpu_torch.apps import IFEstimationConfig, run_pipeline
    from chirpgp_tpu_torch.toymodels import (
        constant_mag, damped_exp_mag, gen_chirp, meow_freq)

    dtype = torch.get_default_dtype()
    dt, T, Xi = 1e-3, args.T, 0.1
    ts = jax_linspace(dt, dt * T, T, dtype)
    true_freq_func, true_phase_func = meow_freq(offset=8.0)
    key, subkey = split(prng_key(555))
    noise = torch.from_numpy(jax_normal(key, (T,), numpy_dtype(dtype)))

    cfg = IFEstimationConfig(dt=dt, Xi=Xi, method=args.method,
                             form=args.form, max_iters=args.max_iters,
                             optimizer=args.optimizer)
    for name, mag in [("const", constant_mag(1.0)),
                      ("damped", damped_exp_mag(0.3)),
                      ("random_ou", jax_ou_mag(subkey, T,
                                               numpy_dtype(dtype)))]:
        ys = gen_chirp(ts, mag, true_phase_func) + math.sqrt(Xi) * noise
        opt, params, est = run_pipeline(cfg, ys.to(device))
        if_mean = est["if_mean"].detach().cpu()
        err = float(torch.sqrt(((true_freq_func(ts) - if_mean) ** 2).mean()))
        print(f"[{name}] learnt params: "
              f"{np.asarray(params.detach().cpu())}  "
              f"converged={bool(opt.success)} ({int(opt.num_iters)} iters)")
        print(f"[{name}] IF RMSE: {err:.4f}", flush=True)

        if args.plot:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            plt.figure()
            plt.plot(ts, true_freq_func(ts), "--", label="True frequency")
            plt.plot(ts, if_mean, "k", label="Estimated")
            plt.fill_between(ts, est["if_lower"].detach().cpu(),
                             est["if_upper"].detach().cpu(), alpha=0.15,
                             color="k", edgecolor="none")
            plt.legend()
            plt.savefig(f"{args.method}_{name}_if.png", dpi=120)
            plt.close()


if __name__ == "__main__":
    main()
