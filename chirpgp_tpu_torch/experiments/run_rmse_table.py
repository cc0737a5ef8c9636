"""Monte-Carlo RMSE-table experiment (paper Table I) on the PyTorch port.

For each method, every seed of the three magnitude cases steps in one
batch through the stepped L-BFGS (``mle_sweep_on_measurements``: the
batched float32 stage on the device, the rescue of stuck lanes, the
float64 polish and the estimate), writes ``{method}_{mag}.npz``
(``rmse``, ``params``, ``success``) and prints the reference's table
(RMSE x10 mean+-std / median / min / #NaN).

Records, as the JAX package's ``experiments/run_rmse_table.py`` draws them:

- default: the JAX package's records of its pregenerated keys
  (``PRNGKey(999)``), remade without JAX (``utils/jax_keys.py``), so the
  columns pair seed by seed with the JAX package's;
- ``--data-dir``: the committed ``toydata_*.npz`` files.  The records'
  own length is used and ``--T`` is ignored, as in the JAX driver;
- ``--monolithic``: the same JAX records, from the JAX package's keys
  (``generate_rnd_keys``), one ``mc_mle_sweep`` per magnitude; under
  ``torchrun`` its seeds are split over every rank (``global_mesh``), each
  rank remaking its own keys' records.

A stepped run keeps a checkpoint ``{out}/.ckpt_{method}.npz``; run again,
the same command resumes from it, and it is removed once the column is
saved.

Usage:
    python -m chirpgp_tpu_torch.experiments.run_rmse_table --methods ghfs
    python -m chirpgp_tpu_torch.experiments.run_rmse_table --methods all \\
        --data-dir results/data --device cpu --x64
    torchrun --nproc_per_node=4 -m \\
        chirpgp_tpu_torch.experiments.run_rmse_table --monolithic
"""

import argparse
import os

import torch

from chirpgp_tpu_torch.experiments._common import (
    METHOD_CONFIGS, add_device_args, jax_records, load_toydata, setup,
    torchrun_mesh)


def _stepped(args, methods, device):
    from chirpgp_tpu_torch.apps import (
        IFEstimationConfig, mle_sweep_on_measurements, print_rmse_table,
        save_results)

    if args.data_dir:
        print(f"--data-dir {args.data_dir}: the records' own T is used, "
              f"--T {args.T} is ignored (as the JAX package's driver does)",
              flush=True)
    all_results = {}
    for method in methods:
        kwargs = dict(METHOD_CONFIGS[method])
        if args.form:
            kwargs["form"] = args.form
        cfg = IFEstimationConfig(max_iters=args.max_iters, **kwargs)
        nh = cfg.num_harmonics if cfg.model == "harmonic" else 1
        tf_parts, ys_parts = [], []
        for mag in args.mags:
            if args.data_dir:
                tf, ys = load_toydata(args.data_dir, mag, nh, args.seeds)
            else:
                tf, ys = jax_records(args.seeds, mag, args.T, cfg.dt,
                                     cfg.Xi, nh)
            tf_parts.append(tf)
            ys_parts.append(ys)
        # A killed run resumes from the last checkpoint of the stepped
        # L-BFGS when the same command runs again.
        ckpt = os.path.join(args.out, f".ckpt_{method}.npz")
        tag = (f"{method}|T={args.T}|form={cfg.form}"
               f"|mags={','.join(args.mags)}|seeds={args.seeds}"
               f"|data={args.data_dir or 'gen'}")
        os.makedirs(args.out, exist_ok=True)
        res = mle_sweep_on_measurements(
            cfg, torch.cat(tf_parts).to(device), torch.cat(ys_parts).to(device),
            checkpoint_path=ckpt, checkpoint_tag=tag, verbose=True,
            device=device)
        n = ys_parts[0].shape[0]
        by_mag = {}
        for i, mag in enumerate(args.mags):
            # Keys in sorted order, as the JAX package writes them.
            r = {k: v[i * n:(i + 1) * n] for k, v in sorted(res.items())}
            path = save_results(r, method, mag, args.out)
            print(f"saved {path}", flush=True)
            by_mag[mag] = r
        all_results[method] = by_mag
        if os.path.exists(ckpt):
            os.remove(ckpt)
    print_rmse_table(all_results)


def _monolithic(args, methods, device):
    from chirpgp_tpu_torch.apps import (
        IFEstimationConfig, generate_rnd_keys, mc_mle_sweep,
        print_rmse_table, save_results)
    from chirpgp_tpu_torch.parallel import pad_to_multiple

    mesh = torchrun_mesh(device)
    rank = mesh.rank if mesh is not None else 0
    size = mesh.size if mesh is not None else 1
    if rank == 0:
        print(f"--monolithic: the JAX package's records of its keys "
              f"(generate_rnd_keys); {size} rank(s)", flush=True)
    keys, n_real = pad_to_multiple(generate_rnd_keys(max(args.seeds, 1))
                                   [:args.seeds], size)
    all_results = {}
    for method in methods:
        kwargs = dict(METHOD_CONFIGS[method])
        if args.form:
            kwargs["form"] = args.form
        cfg = IFEstimationConfig(max_iters=args.max_iters, **kwargs)
        by_mag = {}
        for mag in args.mags:
            res = mc_mle_sweep(cfg, keys, mag, T=args.T, mesh=mesh,
                               device=device)
            res = {k: v[:n_real] for k, v in sorted(res.items())}
            if rank == 0:
                print(f"saved {save_results(res, method, mag, args.out)}",
                      flush=True)
            by_mag[mag] = res
        all_results[method] = by_mag
    if rank == 0:
        print_rmse_table(all_results)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--methods", nargs="+", default=["ghfs"],
                    help=f"any of {sorted(METHOD_CONFIGS)} or 'all'")
    ap.add_argument("--seeds", type=int, default=100)
    ap.add_argument("--T", type=int, default=3141)
    ap.add_argument("--mags", nargs="+",
                    default=["const", "damped", "random"])
    ap.add_argument("--out", default="./results")
    ap.add_argument("--form", default=None, choices=["cov", "sqrt"],
                    help="override the per-method default form")
    ap.add_argument("--max-iters", type=int, default=300)
    ap.add_argument("--stepped", action="store_true",
                    help="the stepped batched L-BFGS with rescue and "
                         "float64 polish (the default)")
    ap.add_argument("--monolithic", action="store_true",
                    help="one mc_mle_sweep per magnitude on JAX's records "
                         "of its keys; split over the ranks under torchrun")
    ap.add_argument("--data-dir", default=None,
                    help="load the toydata_*.npz records of this directory "
                         "instead of remaking them from JAX's keys")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = setup(args)
    methods = sorted(METHOD_CONFIGS) if args.methods == ["all"] \
        else args.methods
    unknown = sorted(set(methods) - set(METHOD_CONFIGS))
    if unknown:
        ap.error(f"unknown methods {unknown}")
    if args.monolithic:
        _monolithic(args, methods, device)
    else:
        _stepped(args, methods, device)


if __name__ == "__main__":
    main()
