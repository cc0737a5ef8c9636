"""Write the paired toymodel measurement data, ``{out}/toydata_{mag}.npz``
(``toydata_h{K}_{mag}.npz`` for K harmonics), in the committed format: ys
(N, T) float32, true_freqs (T,), ts (T,) and the JAX keys used.

The records are the JAX package's (``experiments/gen_toymodel_data.py``):
its pregenerated keys and float32 draws, remade without JAX by
``chirpgp_tpu_torch.utils.jax_keys``.  The keys come out bit for bit; the
records agree with the committed files to float32 round-off of the chirp
(XLA's float32 ``sin``/``exp`` are not torch's).

Usage:
    python -m chirpgp_tpu_torch.experiments.gen_toymodel_data --seeds 100
"""

import argparse
import os

import numpy as np
import torch

from chirpgp_tpu_torch.experiments._common import toydata_prefix
from chirpgp_tpu_torch.utils.jax_keys import (
    jax_rnd_keys, jax_toymodel_measurements)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=100)
    ap.add_argument("--T", type=int, default=3141)
    ap.add_argument("--num-harmonics", type=int, default=1)
    ap.add_argument("--out", default="./results/data")
    args = ap.parse_args(argv)

    keys = jax_rnd_keys(max(args.seeds, 1))[:args.seeds]
    os.makedirs(args.out, exist_ok=True)
    prefix = toydata_prefix(args.num_harmonics)
    for mag in ("const", "damped", "random"):
        ts, tf, ys = jax_toymodel_measurements(
            keys, mag, dt=1e-3, T=args.T, Xi=0.1,
            num_harmonics=args.num_harmonics, dtype=torch.float32,
            device="cpu")
        path = os.path.join(args.out, f"{prefix}_{mag}.npz")
        np.savez(path, ys=ys.numpy(), true_freqs=tf[0].numpy(),
                 ts=ts[0].numpy(), keys=keys)
        print(f"saved {path} ys{tuple(ys.shape)}")


if __name__ == "__main__":
    main()
