"""Bat echolocation IF analysis on the PyTorch port (counterpart of the
JAX package's ``demos/bats_analysis.py``): the harmonic chirp model with
the species' hand-set parameters (no MLE), cubature sigma points,
freq_scale=1e4; prints the filter+smoother wall time after a warm-up
call, synchronized on the card, and the IF range.

The wav files (batcalls.com) are not vendored; pass the path.  The record
is standardized and run in float32 unless ``--x64``.

Usage:
    python -m chirpgp_tpu_torch.demos.bats_analysis --wav call.wav \\
        --species myotis [--crop-start 19000 --crop-end 44334] [--plot f.png]
"""

import argparse

import numpy as np
import torch

from chirpgp_tpu_torch.experiments._common import (
    add_device_args, require_matplotlib, setup)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wav", required=True)
    ap.add_argument("--species", default="myotis",
                    choices=["myotis", "eptesicus"])
    ap.add_argument("--crop-start", type=int, default=None)
    ap.add_argument("--crop-end", type=int, default=None)
    ap.add_argument("--form", default="cov", choices=["cov", "sqrt"])
    ap.add_argument("--plot", default=None)
    add_device_args(ap)
    args = ap.parse_args(argv)
    if args.plot:
        require_matplotlib(ap)
    device = setup(args)

    from chirpgp_tpu_torch.apps import (
        EPTESICUS, MYOTIS, analyze_bat_call, load_wav, standardize)

    crop = None
    if args.crop_start is not None or args.crop_end is not None:
        crop = (args.crop_start or 0, args.crop_end)
    fs, ys = load_wav(args.wav, crop=crop, device=device)
    ys = standardize(ys.to(torch.get_default_dtype()))
    bat = MYOTIS if args.species == "myotis" else EPTESICUS

    est, wall = analyze_bat_call(ys, float(fs), bat, form=args.form,
                                 time_it=True, device=device)
    if_mean = est["if_mean"].detach().cpu()
    print(f"T={ys.shape[0]} samples at fs={fs} Hz, "
          f"{bat.num_harmonics} harmonics")
    print(f"filter+smoother wall time (post warm-up): {wall:.4f} s")
    print(f"IF range: {float(if_mean.min()):.1f} .. "
          f"{float(if_mean.max()):.1f} Hz")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        ts = np.arange(ys.shape[0]) / float(fs)
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.specgram(ys.cpu().numpy(), NFFT=256, Fs=float(fs), noverlap=192,
                    cmap="magma")
        ax.plot(ts, if_mean.numpy(), "c", lw=1.5, label="IF posterior mean")
        ax.set_xlabel("time (s)")
        ax.set_ylabel("frequency (Hz)")
        ax.legend()
        fig.savefig(args.plot, dpi=130)
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()
