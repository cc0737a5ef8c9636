"""FHC (harmonic-chirp NLS) Monte-Carlo sweep on the PyTorch port: the
grid NLS of ``baselines/fhc.py`` over the windows of every record (length
300, hop 5, median smoothing), RMSE against the true IF at the window
centres, written as ``fhc_{mag}.npz`` (``harmonic_fhc_{mag}.npz`` for K >
1) and printed as the RMSE table.

Records: ``--data-dir`` (default ``./results/data``, the committed
``toydata_*`` files, as in the JAX package's ``experiments/run_fhc.py``),
or with ``--data-dir ''`` the JAX package's records of its pregenerated
keys, remade without JAX (``utils/jax_keys.py``).  The JAX script's
``--platform`` is ``--device`` here.

Usage:
    python -m chirpgp_tpu_torch.experiments.run_fhc --num-harmonics 1
    python -m chirpgp_tpu_torch.experiments.run_fhc --num-harmonics 3
"""

import argparse
import os

import numpy as np
import torch

from chirpgp_tpu_torch.experiments._common import (
    add_device_args, jax_records, load_toydata, setup)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=100)
    ap.add_argument("--T", type=int, default=3141)
    ap.add_argument("--num-harmonics", type=int, default=3)
    ap.add_argument("--window-length", type=int, default=300)
    ap.add_argument("--hop", type=int, default=5)
    ap.add_argument("--mags", nargs="+",
                    default=["const", "damped", "random"])
    ap.add_argument("--out", default="./results")
    ap.add_argument("--data-dir", default="./results/data",
                    help="the toydata_*.npz records of this directory; '' "
                         "remakes them from JAX's keys")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = setup(args)

    from chirpgp_tpu_torch.apps.sweeps import print_rmse_table
    from chirpgp_tpu_torch.baselines import (
        fhc_pitch_track_batch, force_odd, median_smooth)
    from chirpgp_tpu_torch.toymodels import meow_freq

    fs = 1e3
    freq_func, _ = meow_freq(offset=8.0)
    os.makedirs(args.out, exist_ok=True)
    wl, overlap = args.window_length, args.window_length - args.hop
    prefix = "harmonic_fhc" if args.num_harmonics > 1 else "fhc"
    all_results = {}
    for mag in args.mags:
        if args.data_dir:
            _, yss = load_toydata(args.data_dir, mag, args.num_harmonics,
                                  args.seeds)
        else:
            _, yss = jax_records(args.seeds, mag, args.T,
                                 num_harmonics=args.num_harmonics)
        times, f0s = fhc_pitch_track_batch(
            yss.to(device=device, dtype=torch.get_default_dtype()), fs,
            args.num_harmonics, window_length=wl, window_overlap=overlap,
            device=device)
        tf = freq_func(torch.as_tensor(times, dtype=torch.get_default_dtype()))
        rmses = []
        for f0 in f0s:
            smoothed = torch.as_tensor(
                median_smooth(f0, force_odd(round(wl / 10))), dtype=tf.dtype)
            rmses.append(float(torch.sqrt(((smoothed - tf) ** 2).mean())))
        res = dict(rmse=np.asarray(rmses))
        np.savez(os.path.join(args.out, f"{prefix}_{mag}.npz"), **res)
        all_results.setdefault(prefix, {})[mag] = res
        print(f"{prefix} {mag}: median rmse {np.nanmedian(res['rmse']):.4f}",
              flush=True)

    print_rmse_table(all_results)


if __name__ == "__main__":
    main()
