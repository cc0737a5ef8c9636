"""Kalman-pitch-tracker Monte-Carlo sweep on the PyTorch port: per seed,
learn the KPT parameters by EKF-marginal MLE, smooth, estimate the IF and
record its RMSE (NaN on divergence), on the JAX package's records of its
pregenerated keys (``utils/jax_keys.py``).

All seeds of a magnitude step in one batch through the port's stepped KPT
sweep (``apps.sweeps._kpt_sweep_on_measurements``, the stepped path of
``mc_kpt_sweep``): the stepped L-BFGS on the device, the rescue, the
float64 polish and the estimate.  Writes ``kpt_{mag}.npz``
(``harmonic_kpt_{mag}.npz`` for K > 1) and prints the RMSE table.  The
JAX script's ``--platform`` is ``--device`` here.

Usage:
    python -m chirpgp_tpu_torch.experiments.run_kpt --seeds 100
    python -m chirpgp_tpu_torch.experiments.run_kpt --num-harmonics 3
"""

import argparse
import os

import numpy as np

from chirpgp_tpu_torch.experiments._common import (
    add_device_args, jax_records, setup)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=100)
    ap.add_argument("--T", type=int, default=3141)
    ap.add_argument("--num-harmonics", type=int, default=1)
    ap.add_argument("--max-iters", type=int, default=100)
    ap.add_argument("--mags", nargs="+",
                    default=["const", "damped", "random"])
    ap.add_argument("--out", default="./results")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = setup(args)

    from chirpgp_tpu_torch.apps.sweeps import (
        _kpt_sweep_on_measurements, print_rmse_table)

    os.makedirs(args.out, exist_ok=True)
    prefix = "harmonic_kpt" if args.num_harmonics > 1 else "kpt"
    all_results = {}
    for mag in args.mags:
        tf, ys = jax_records(args.seeds, mag, args.T,
                             num_harmonics=args.num_harmonics)
        res = _kpt_sweep_on_measurements(
            tf.to(device), ys.to(device), num_harmonics=args.num_harmonics,
            max_iters=args.max_iters, device=device)
        # Keys in sorted order, as the JAX package writes them.
        res = dict(sorted(res.items()))
        np.savez(os.path.join(args.out, f"{prefix}_{mag}.npz"), **res)
        all_results.setdefault(prefix, {})[mag] = res
        print(f"{prefix} {mag}: median rmse "
              f"{np.nanmedian(res['rmse']):.4f} "
              f"nan={int(np.sum(~np.isfinite(res['rmse'])))}", flush=True)

    print_rmse_table(all_results)


if __name__ == "__main__":
    main()
