#!/usr/bin/env python3
"""Time one batched value-and-grad of the Table-I sweep objective on the
card in three forms, on the same inputs, in one process:

- ``kernels``: ``make_nll_fn``'s route, the per-lane filter kernel and
  its adjoint (``ops/chirp_filter_grad.py``) under the port's
  ``fit/lbfgs.py::batched_value_and_grad``, one launch of each;
- ``eager vmap + autograd``: the eager square-root filter (the Python loop
  of ``infer/sqrt.py``) under the same ``batched_value_and_grad``, a
  vmapped forward and one ``torch.autograd.grad`` of the summed values;
- ``eager vmap(grad)``: ``torch.func.vmap(torch.func.grad_and_value(nll))``
  of the eager filter.

    python3 time_sweep_objective.py [--B 6 300] [--T 300 3141]

Seeds 0..B/3-1 of each magnitude of ``results/data``, sqrt GHFS, GH-3,
float32, at the default init.  For each B and T the forms run in turns
(kernels, eager vmap + autograd, eager vmap(grad), kernels); each line
gives the host-clock seconds around synchronized work, ms per step, the
peak memory, and the largest deviation from the first turn's values
(relative) and gradients (over max |grad|).  The first line is the
card's ``nvidia-smi`` name and power limit.  The kernels are built
before the first turn.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FORMS = {"kernels": "kernels", "eager": "eager vmap + autograd",
         "eager_grad": "eager vmap(grad)"}


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
    from chirpgp_tpu_torch.apps.pipeline import _filter_fns, _on_data
    from chirpgp_tpu_torch.fit import batched_value_and_grad
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter import load_kernel
    from chirpgp_tpu_torch.ops.chirp_filter_grad import (
        ChirpFilterNLL, load_adjoint_kernel)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    device = torch.device("cuda", 0)
    load_kernel(), load_adjoint_kernel()   # built before any turn is timed
    cfg = IFEstimationConfig(method="ghfs", form="sqrt")
    flt, _ = _filter_fns(cfg)
    data = [np.load(ROOT / f"results/data/toydata_{m}.npz")["ys"]
            for m in ("const", "damped", "random")]

    def nll(th, y):
        return make_nll_fn(cfg, y)(th)

    def eager_nll(th, y):
        return flt(cfg.build(g(_on_data(th, y))), y)[2][-1]

    for B, T in [(B, T) for B in args.B for T in args.T]:
        ys = torch.as_tensor(np.concatenate([d[:B // 3, :T] for d in data]),
                             dtype=torch.float32, device=device)
        theta = cfg.default_init_theta(torch.float32).to(device).expand(
            ys.shape[0], -1).clone()
        vmap_grad = torch.func.vmap(torch.func.grad_and_value(eager_nll))
        forms = {"kernels": batched_value_and_grad(nll, (ys,)),
                 "eager": batched_value_and_grad(eager_nll, (ys,)),
                 "eager_grad": lambda th: vmap_grad(th, ys)[::-1]}
        first = None
        for name in ("kernels", "eager", "eager_grad", "kernels"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            ChirpFilterNLL.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            values, grads = forms[name](theta)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
            first = first or (values.detach(), grads.detach())
            dv = float(((values - first[0]).abs() / first[0].abs()).max())
            dg = float((grads - first[1]).abs().max() / first[1].abs().max())
            launches = (f", kernel launches {dict(ChirpFilterNLL.launches)}"
                        if name == "kernels" else "")
            print(f"B={ys.shape[0]} T={T} {FORMS[name]}: {seconds:.4f} s = "
                  f"{1e3 * seconds / T:.4f} ms per step, peak "
                  f"{peak:.3f} GiB{launches}; against the first turn: value "
                  f"rel {dv:.3g}, grad {dg:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
