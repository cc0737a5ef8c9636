#!/usr/bin/env python3
"""Time one batched value-and-grad of the Table-I sweep objective on the
card in its two forms, on the same inputs, in one process:

- ``vmap(grad)``: ``torch.func.vmap(torch.func.grad_and_value(nll))``;
- ``vmap + autograd``: the port's ``fit/lbfgs.py::batched_value_and_grad``,
  a vmapped forward and one ``torch.autograd.grad`` of the summed values.

    python3 time_sweep_objective.py [--B 6 300] [--T 300 3141]

Seeds 0..B/3-1 of each magnitude of ``results/data``, sqrt GHFS, GH-3,
float32, at the default init.  For each B and T the forms run in turns
(vmap + autograd, vmap(grad), vmap + autograd); each line gives the
host-clock seconds around synchronized work, ms per step, the peak
memory, and the largest deviation from the first turn's values
(relative) and gradients (over max |grad|).  The first line is the
card's ``nvidia-smi`` name and power limit.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, nargs="+", default=[6, 300])
    ap.add_argument("--T", type=int, nargs="+", default=[300, 3141])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_sweep_objective: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chirpgp_tpu_torch.apps import IFEstimationConfig, make_nll_fn
    from chirpgp_tpu_torch.fit import batched_value_and_grad

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    device = torch.device("cuda", 0)
    cfg = IFEstimationConfig(method="ghfs", form="sqrt")
    data = [np.load(ROOT / f"results/data/toydata_{m}.npz")["ys"]
            for m in ("const", "damped", "random")]

    def nll(th, y):
        return make_nll_fn(cfg, y)(th)

    for B, T in [(B, T) for B in args.B for T in args.T]:
        ys = torch.as_tensor(np.concatenate([d[:B // 3, :T] for d in data]),
                             dtype=torch.float32, device=device)
        theta = cfg.default_init_theta(torch.float32).to(device).expand(
            ys.shape[0], -1).clone()
        vmap_grad = torch.func.vmap(torch.func.grad_and_value(nll))
        forms = {"vmap + autograd": batched_value_and_grad(nll, (ys,)),
                 "vmap(grad)": lambda th: vmap_grad(th, ys)[::-1]}
        first = None
        for name in ("vmap + autograd", "vmap(grad)", "vmap + autograd"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            values, grads = forms[name](theta)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
            first = first or (values.detach(), grads.detach())
            dv = float(((values - first[0]).abs() / first[0].abs()).max())
            dg = float((grads - first[1]).abs().max() / first[1].abs().max())
            print(f"B={ys.shape[0]} T={T} {name}: {seconds:.3f} s = "
                  f"{1e3 * seconds / T:.3f} ms per step, peak "
                  f"{peak:.3f} GiB; against the first turn: value rel "
                  f"{dv:.3g}, grad {dg:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
