"""Filter-error Monte-Carlo sweep against the CRLB (paper Fig. 5) on the
PyTorch port.

Each (lam, b) grid point simulates ``-num_mcs`` trajectories of the chirp
SDE and filters them in chunks of ``--chunk`` on the device
(``apps.crlb.filter_error_mc_chunked``): with the ``cf`` backend (the
default for the GHF) every chunk is one launch of the CUDA filter kernel
(``ops/csrc/ghfs_chirp_filter.cu``) on the card.  The per-step error sums
accumulate in float64 on the host.  ``--pcrlb`` adds the posterior
Cramer--Rao bound at the same parameters; ``--sharded`` runs the
in-memory ``filter_error_mc`` over the mesh (every rank under
``torchrun``).  Writes ``crlb_{method}_lam{lam}_b{b}.npz`` in the format
of the JAX package's ``experiments/run_crlb.py`` and prints, per grid
point, its line and the kernel launches it made.

The draws are the port's own (a ``torch.Generator`` seeded as
``filter_error_mc_chunked`` seeds it), float32 unless ``--x64``.

Usage:
    python -m chirpgp_tpu_torch.experiments.run_crlb -method ghf \\
        -num_mcs 1000000 -lam 0.1 0.4 -b 0.1 0.4 --pcrlb
"""

import argparse
import os
import time

import numpy as np
import torch

from chirpgp_tpu_torch.experiments._common import (
    add_device_args, setup, torchrun_mesh)


def _mesh(device):
    """The ranks of ``torchrun``, or this process alone."""
    from chirpgp_tpu_torch.parallel import make_mesh
    mesh = torchrun_mesh(device)
    return mesh if mesh is not None else make_mesh(device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # Flag names mirror the reference job's.
    ap.add_argument("-method", default="ghf", choices=["ghf", "ekf"])
    ap.add_argument("-lam", type=float, nargs="+", default=[0.1])
    ap.add_argument("-b", type=float, nargs="+", default=[0.1])
    ap.add_argument("-delta", type=float, default=0.1)
    ap.add_argument("-ell", type=float, default=1.0)
    ap.add_argument("-sigma", type=float, default=1.0)
    ap.add_argument("-Xi", type=float, default=0.1)
    ap.add_argument("-num_mcs", type=int, default=1_000_000)
    ap.add_argument("-dt", type=float, default=0.01)
    ap.add_argument("-T", type=int, default=500)
    ap.add_argument("-out", default="./results")
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cf", "vmap"],
                    help="chunk filter backend: the batched sigma-point "
                         "filter (cf: the CUDA kernel on the card) or the "
                         "per-seed filter under vmap")
    ap.add_argument("--pcrlb", action="store_true",
                    help="also compute the PCRLB overlay per grid point")
    ap.add_argument("--pcrlb-mcs", type=int, default=100_000)
    ap.add_argument("--sharded", action="store_true",
                    help="the mesh-sharded in-memory path instead of the "
                         "chunked accumulator (small num_mcs only)")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = setup(args)
    dtype = torch.get_default_dtype()

    from chirpgp_tpu_torch.apps.crlb import (
        filter_error_mc, filter_error_mc_chunked, pcrlb_chirp_mc)
    from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter

    mesh = _mesh(device) if args.sharded else None
    rank = mesh.rank if mesh is not None else 0
    os.makedirs(args.out, exist_ok=True)
    for lam in args.lam:
        for b in args.b:
            launches0 = ghfs_chirp_filter.launches
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.time()
            if args.sharded:
                res = filter_error_mc(
                    lam, b, args.delta, args.ell, args.sigma, args.Xi,
                    args.num_mcs, method=args.method, dt=args.dt,
                    T=args.T, mesh=mesh, dtype=dtype, device=device)
            else:
                res = filter_error_mc_chunked(
                    lam, b, args.delta, args.ell, args.sigma, args.Xi,
                    args.num_mcs, method=args.method, dt=args.dt,
                    T=args.T, chunk=args.chunk, backend=args.backend,
                    dtype=dtype, device=device)
            wall = time.time() - t0
            launches = ghfs_chirp_filter.launches - launches0
            res["wall_s"] = np.float64(wall)
            res["num_mcs"] = np.int64(args.num_mcs)
            res["dt"] = np.float64(args.dt)
            if args.pcrlb:
                res.update(pcrlb_chirp_mc(
                    lam, b, args.delta, args.ell, args.sigma, args.Xi,
                    num_mcs=args.pcrlb_mcs, dt=args.dt, T=args.T,
                    dtype=dtype, device=device))
            if rank:
                continue
            path = os.path.join(
                args.out, f"crlb_{args.method}_lam{lam}_b{b}.npz")
            np.savez(path, **res)
            print(f"lam={lam} b={b}: {args.num_mcs} trajs in {wall:.1f}s "
                  f"({args.num_mcs * args.T / wall / 1e6:.2f}M "
                  f"filter-steps/s) final mean err_x2="
                  f"{res['mean_err_x2'][-1]:.5f} err_v="
                  f"{res['mean_err_v'][-1]:.5f} -> {path}", flush=True)
            print(f"lam={lam} b={b}: filter kernel launches {launches}",
                  flush=True)


if __name__ == "__main__":
    main()
