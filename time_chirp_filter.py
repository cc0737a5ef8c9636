#!/usr/bin/env python3
"""CUDA-event times of the fused chirp filter through its public wrapper,
``chirpgp_tpu_torch.ops.chirp_filter.ghfs_chirp_filter``, on one NVIDIA GPU.

    python3 time_chirp_filter.py [--root DIR]

``--root`` names the checkout whose ``chirpgp_tpu_torch`` is timed
(default: the directory of this script), so that two versions of the
kernel run in one process each on the same card, for example an unpacked
``git archive`` of the parent commit and the working tree, in the order
parent, change, change, parent.  The wrapper's signature is the same in
every version of the port, and its host work (model constants, the
sigma-point table, the output allocation) is timed with the kernel.

Cases, float32: GH-3 and cubature at the benchmark's B=4096 x T=3141
(``chip_smoke.py``'s data and parameters) and at the Table-I width, the
100 records of ``results/data/toydata_const.npz`` at the reference's GHFS
and CKFS optima.  Prints the ``nvidia-smi`` name and power limit, then one
JSON object per case: mean ms over 6 calls after one warm-up, and nll[-1]
summed over the lanes.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose chirpgp_tpu_torch is timed")
    root = ap.parse_args().root.resolve()
    if not torch.cuda.is_available():
        print("time_chirp_filter: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # This script's chip_smoke (it imports the package only when called),
    # then the package of --root.
    sys.path.insert(0, str(HERE))
    from chip_smoke import (B_FULL, DT, T_FULL, XI, event_ms, measurements,
                            nvidia_smi)
    sys.path.insert(0, str(root))
    import chirpgp_tpu_torch
    if root not in Path(chirpgp_tpu_torch.__file__).resolve().parents:
        print(f"time_chirp_filter: imported {chirpgp_tpu_torch.__file__}, "
              f"not the package of {root}", file=sys.stderr)
        return 2
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.convert import params_from_jax
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
    from chirpgp_tpu_torch.quad import cubature, gauss_hermite

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(nvidia_smi())
    bench = measurements(B_FULL, T_FULL, 999, torch.float32, device)
    p_bench = g(IFEstimationConfig().default_init_theta()).to(torch.float64)
    y100 = torch.as_tensor(
        np.load(HERE / "results/data/toydata_const.npz")["ys"],
        dtype=torch.float32, device=device)
    opt = {name: params_from_jax(np.load(
        HERE / f"results/reference/{name}_const.npz")["params"][0])
        for name in ("ghfs", "ckfs")}
    rules = {"gh3": gauss_hermite(4, 3), "cubature": cubature(4)}
    cases = {
        "gh3/B=4096": (p_bench, "gh3", bench),
        "cubature/B=4096": (p_bench, "cubature", bench),
        "gh3/B=100": (opt["ghfs"], "gh3", y100),
        "cubature/B=100": (opt["ckfs"], "cubature", y100),
    }
    for tag, (params, rule, yss) in cases.items():
        args = (params.cpu(), XI, DT, rules[rule], yss)
        ms = event_ms(lambda: ghfs_chirp_filter(*args))
        nll = float(ghfs_chirp_filter(*args)[2][-1].double().sum())
        print(json.dumps({"root": str(root), "case": tag, "ms": ms,
                          "nll_last_sum": nll}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
