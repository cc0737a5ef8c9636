"""LIGO GW150914 chirp IF estimation on the PyTorch port (counterpart of
the JAX package's ``demos/ligo_analysis.py``).

Strain data: two-column text files (time, strain), e.g. the GW150914
releases of the Gravitational Wave Open Science Center.  Xi=0.3, GH order
3, MLE from g^{-1}([0.1, 2, 0.5, 0.02, 40, 1]), float32 unless ``--x64``.

Usage:
    python -m chirpgp_tpu_torch.demos.ligo_analysis --data H-H1.txt \\
        [L-L1.txt] [--plot out.png]
"""

import argparse

import numpy as np
import torch

from chirpgp_tpu_torch.experiments._common import (
    add_device_args, require_matplotlib, setup)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", nargs="+", required=True)
    ap.add_argument("--plot", default=None)
    add_device_args(ap)
    args = ap.parse_args(argv)
    if args.plot:
        require_matplotlib(ap)
    device = setup(args)

    from chirpgp_tpu_torch.apps import analyze_ligo, load_ligo_strain

    dtype = torch.get_default_dtype()
    results = []
    for path, (ts, ys) in zip(args.data,
                              load_ligo_strain(args.data, device=device)):
        ts, ys = ts.to(dtype), ys.to(dtype)
        opt, params, est = analyze_ligo(ts, ys, device=device)
        if_mean = est["if_mean"].detach().cpu()
        print(f"[{path}] converged={bool(opt.success)} "
              f"({int(opt.num_iters)} iters), "
              f"params={np.asarray(params.detach().cpu())}")
        print(f"[{path}] IF range: {float(if_mean.min()):.1f} .. "
              f"{float(if_mean.max()):.1f} Hz")
        results.append((ts.cpu(), est))

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(len(results), 1,
                                 figsize=(8, 3 * len(results)), squeeze=False)
        for ax_row, (ts, est) in zip(axes, results):
            ax = ax_row[0]
            ax.plot(ts, est["if_mean"].detach().cpu(), "k")
            ax.fill_between(ts, est["if_lower"].detach().cpu(),
                            est["if_upper"].detach().cpu(), alpha=0.2,
                            color="k")
            ax.set_xlabel("time (s)")
            ax.set_ylabel("IF (Hz)")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=130)
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()
