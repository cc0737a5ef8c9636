"""Fast-NLS pitch-tracking Monte-Carlo sweep on the PyTorch port:
sliding-window single or harmonic pitch tracking (window 300, overlap
299) with median smoothing, by the port's copy of the host C++ estimator
(``ops/native``), written as ``fastf0nls_{mag}.npz``
(``harmonic_fastf0nls_{mag}.npz`` with ``-harmonic 1``) and printed as
the RMSE table.

The records are the JAX package's (``experiments/run_fastnls.py``): its
pregenerated keys, float32 draws, remade without JAX
(``utils/jax_keys.py``).  The estimator and the records stay on the host
CPU, so ``--device`` defaults to ``cpu``, as the JAX script's
``--platform`` does; ``--device cuda`` only checks that a card is there.

Usage:
    python -m chirpgp_tpu_torch.experiments.run_fastnls -harmonic 0
"""

import argparse
import os

import numpy as np
import torch

from chirpgp_tpu_torch.experiments._common import (
    add_device_args, jax_records, setup)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-harmonic", type=float, default=0,
                    help="1 for 3-harmonic chirps, 0 for single")
    ap.add_argument("--seeds", type=int, default=100)
    ap.add_argument("--T", type=int, default=3141)
    ap.add_argument("--window-length", type=int, default=300)
    ap.add_argument("--out", default="./results")
    add_device_args(ap, default="cpu")
    args = ap.parse_args(argv)
    setup(args)

    from chirpgp_tpu_torch.apps.sweeps import print_rmse_table
    from chirpgp_tpu_torch.baselines import (
        force_odd, median_smooth, pitch_track)
    from chirpgp_tpu_torch.toymodels import meow_freq

    fs = 1e3
    num_harmonics = 3 if args.harmonic else 1
    freq_func, _ = meow_freq(offset=8.0)
    os.makedirs(args.out, exist_ok=True)
    prefix = "harmonic_fastf0nls" if args.harmonic else "fastf0nls"
    # The reference's window contract: overlap = length - 1, the median
    # kernel about half a window, forced odd.
    wl = args.window_length
    overlap = wl - 1

    all_results = {}
    for mag in ["const", "damped", "random"]:
        _, yss = jax_records(args.seeds, mag, args.T,
                             num_harmonics=num_harmonics)
        rmses = []
        for ys in yss:
            times, f0s = pitch_track(ys.numpy(), fs, num_harmonics,
                                     window_length=wl,
                                     window_overlap=overlap)
            tf = freq_func(torch.as_tensor(times, dtype=yss.dtype))
            smoothed = torch.as_tensor(
                median_smooth(f0s, force_odd(round(wl / 2))), dtype=tf.dtype)
            rmses.append(float(torch.sqrt(((smoothed - tf) ** 2).mean())))
        res = dict(rmse=np.asarray(rmses))
        np.savez(os.path.join(args.out, f"{prefix}_{mag}.npz"), **res)
        all_results.setdefault(prefix, {})[mag] = res

    print_rmse_table(all_results)


if __name__ == "__main__":
    main()
