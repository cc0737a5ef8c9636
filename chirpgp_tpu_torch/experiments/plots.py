"""Paper-figure reproductions on the PyTorch port (the JAX package's
``experiments/plots.py``): chirp-SDE sample paths, the harmonic-SDE
covariance surface, the conditional chirp covariance, the IF-estimation
overlays and the filter MSE against the PCRLB.

Each figure is two functions: ``<figure>_arrays(..., device)`` computes
its data on ``device`` and returns a dict of host NumPy arrays (sizes are
arguments whose defaults are the JAX script's), and ``draw_<figure>(arrays,
outdir)`` draws them to the JAX script's PNG, importing matplotlib only
then.  ``--save-arrays DIR`` writes ``DIR/<figure>.npz`` for each figure
and never imports matplotlib (a machine with a card may have none);
``--from-arrays DIR`` draws those files on a host that has it.  Without
either, the figures are computed and drawn to ``--out``.

The draws are JAX's, of the JAX script's keys (``PRNGKey(0)`` for the
samples, ``PRNGKey(1)`` for the conditional covariance, ``PRNGKey(555)``
for the estimation records), remade without JAX (``utils/jax_keys.py``),
float32 unless ``--x64``, as the JAX script runs without x64.  The
``crlb*`` figures read the ``crlb_{ekf,ghf}_lam*_b*.npz`` files of
``--results-dir`` (the JAX package's or the port's ``run_crlb``).

Usage:
    python -m chirpgp_tpu_torch.experiments.plots --which samples cov \\
        --out figures
    python -m chirpgp_tpu_torch.experiments.plots --save-arrays arrays
    python -m chirpgp_tpu_torch.experiments.plots --from-arrays arrays \\
        --out figures
"""

import argparse
import glob
import math
import os
import re

import numpy as np
import torch

from chirpgp_tpu_torch.experiments._common import (
    add_device_args, numpy_dtype, require_matplotlib, setup)
from chirpgp_tpu_torch.utils.jax_keys import (
    jax_linspace, jax_normal, prng_key, split)

# The chirp prior of the sample paths: lam, b, ell, sigma, delta.
SAMPLES_PRIOR = (0.1, 0.3, 1.0, 1.0, 0.1)
# The harmonic SDE's covariance surface: cov0 = 0.1 I, f, lam, b.
COV_ARGS = (2.0, 0.3, 0.5)
# The conditional covariance's chirp prior: lam, b, ell, sigma, delta.
COND_COV_PRIOR = (0.2, 0.3, 1.0, 1.0, 0.1)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _params(values, device):
    """Model constants as 0-dim tensors of torch's default dtype on
    ``device``: the transitions then compute on the data's device in its
    dtype, as the JAX script's weakly typed floats do."""
    return [torch.tensor(v, dtype=torch.get_default_dtype(), device=device)
            for v in values]


def _sde_draws(key, T: int, d: int, dtype):
    """``simulate_sde``'s draws of ``key``: ``normal(key, (d,))`` for the
    initial state, then ``normal(split(key)[0], (T, d))`` for the
    increments (``chirpgp_tpu/utils/sim.py:51-55``), as float tensors."""
    z0 = jax_normal(key, (d,), dtype)
    dws = jax_normal(split(key)[0], (T, d), dtype)
    return torch.from_numpy(z0), torch.from_numpy(dws)


def _stacked_sde_draws(keys, T: int, d: int, dtype):
    draws = [_sde_draws(k, T, d, dtype) for k in keys]
    return torch.stack([z for z, _ in draws]), torch.stack([w for _, w in draws])


def samples_arrays(T: int = 3000, dt: float = 1e-3, n_paths: int = 4,
                   device="cuda") -> dict:
    """Sample paths of the chirp SDE prior from ``split(PRNGKey(0),
    n_paths)``: ``ts`` (T,), ``x2`` and the IF ``g(V)`` (n_paths, T)."""
    from chirpgp_tpu_torch.models import disc_chirp_lcd, g, model_chirp
    from chirpgp_tpu_torch.utils.sim import _simulate_batch_from_noise
    lam, b, ell, sigma, delta = _params(SAMPLES_PRIOR, device)
    _, _, m0, P0, _ = model_chirp(lam, b, ell, sigma, delta)
    z0, dws = _stacked_sde_draws(split(prng_key(0), n_paths), T, 4,
                                 numpy_dtype(torch.get_default_dtype()))
    x0 = m0 + z0.to(m0) @ torch.linalg.cholesky(P0).T
    traj = _simulate_batch_from_noise(disc_chirp_lcd(lam, b, ell, sigma), x0,
                                      dws.to(m0), dt)
    return {"ts": np.arange(1, T + 1) * dt, "x2": _host(traj[..., 1]),
            "if": _host(g(traj[..., 2]))}


def cov_arrays(n: int = 80, device="cuda") -> dict:
    """The closed-form harmonic-SDE covariance surface on
    ``linspace(0.01, 2, n)``: ``ts`` (n,), ``surf`` (n, n, 2, 2)."""
    from chirpgp_tpu_torch.models.cov_funcs import vmap_cov_harmonic_sde
    ts = jax_linspace(0.01, 2.0, n, torch.get_default_dtype()).to(device)
    f, lam, b = COV_ARGS
    lam, b = _params((lam, b), device)
    cov0 = 0.1 * torch.eye(2, dtype=ts.dtype, device=device)
    surf = vmap_cov_harmonic_sde(ts, ts, cov0, f, lam, b)
    return {"ts": _host(ts), "surf": _host(surf)}


def cond_cov_arrays(n: int = 100, num_mcs: int = 2000,
                    device="cuda") -> dict:
    """The Monte-Carlo covariance of the chirp pair given one V path, on
    ``linspace(0.01, 1, n)`` with ``num_mcs`` paths of ``PRNGKey(1)``: the
    V path from the key, the X paths from ``split(split(key)[0],
    num_mcs)`` (``chirpgp_tpu/models/cov_funcs.py:74, :105-116``).
    ``ts`` (n,), ``vs`` (n, 2), ``surf`` (n, n, 2, 2)."""
    from chirpgp_tpu_torch.models.cov_funcs import (
        _approx_cond_cov_chirp_sde_from_noise)
    dtype = torch.get_default_dtype()
    ts = jax_linspace(0.01, 1.0, n, dtype).to(device)
    key = prng_key(1)
    z0_v, dws_v = _sde_draws(key, n, 2, numpy_dtype(dtype))
    z0, dws = _stacked_sde_draws(split(split(key)[0], num_mcs), n, 2,
                                 numpy_dtype(dtype))
    vs, surf = _approx_cond_cov_chirp_sde_from_noise(
        ts, *_params(COND_COV_PRIOR, device), z0_v, dws_v, z0, dws)
    return {"ts": _host(ts), "vs": _host(vs), "surf": _host(surf)}


def _estimation(cfg, T: int, mags, device) -> dict:
    from chirpgp_tpu_torch.apps import estimate_if
    from chirpgp_tpu_torch.experiments.print_time import toy_record
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.toymodels import meow_freq
    ts, ys = toy_record(T, cfg.dt, cfg.Xi, mags=mags)
    with torch.no_grad():
        est = estimate_if(cfg, g(cfg.default_init_theta()), ys.to(device),
                          device=device)
    out = {"ts": _host(ts), "true_if": _host(meow_freq(offset=8.0)[0](ts))}
    out.update({k: _host(est[k]) for k in ("if_mean", "if_lower",
                                           "if_upper")})
    return out


def estimation_arrays(T: int = 3141, device="cuda") -> dict:
    """GHFS IF estimate at ``g(default_init_theta())`` on the
    ``PRNGKey(555)`` toy record: ``ts``, ``true_if``, ``if_mean``,
    ``if_lower``, ``if_upper``, each (T,)."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    cfg = IFEstimationConfig(dt=1e-3, Xi=0.1, method="ghfs")
    return _estimation(cfg, T, None, device)


def estimation_harmonic_arrays(T: int = 3141, K: int = 3,
                               device="cuda") -> dict:
    """As :func:`estimation_arrays` on the K-harmonic record (magnitudes
    ``1/(k+1)``), the cubature GHFS of the harmonic model."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.toymodels import constant_mag
    cfg = IFEstimationConfig(dt=1e-3, Xi=0.1, method="ghfs",
                             model="harmonic", num_harmonics=K,
                             quadrature="cubature")
    return _estimation(cfg, T, [constant_mag(1.0 / (k + 1))
                                for k in range(K)], device)


def _crlb_grid(files):
    lams = sorted({float(re.search(r"lam([\d.]+)_", f).group(1))
                   for f in files})
    bs = sorted({float(re.search(r"_b([\d.]+)\.npz", f).group(1))
                 for f in files})
    return lams, bs


def crlb_arrays(methods=("ekf",), results_dir: str = "./results"):
    """The filter MSE and PCRLB files ``crlb_{method}_lam*_b*.npz`` of
    ``results_dir`` on the (lam, b) grid of the first method's files, as
    the JAX script reads them: ``lams``, ``bs``, and per method and grid
    point with a file ``{method}_lam{lam}_b{b}_{ts,mean_err_v}`` and, where
    the file has it, ``..._pcrlb_v``.  None when the first method has no
    files."""
    files = sorted(glob.glob(os.path.join(
        results_dir, f"crlb_{methods[0]}_lam*_b*.npz")))
    if not files:
        return None
    lams, bs = _crlb_grid(files)
    out = {"lams": np.array(lams), "bs": np.array(bs)}
    for method in methods:
        for lam in lams:
            for b in bs:
                path = os.path.join(results_dir,
                                    f"crlb_{method}_lam{lam}_b{b}.npz")
                if not os.path.exists(path):
                    continue
                d = np.load(path)
                T = len(d["mean_err_v"])
                dt = float(d["dt"]) if "dt" in d else 0.01
                cell = f"{method}_lam{lam}_b{b}"
                out[f"{cell}_ts"] = np.arange(1, T + 1) * dt
                out[f"{cell}_mean_err_v"] = d["mean_err_v"]
                if "pcrlb_v" in d:
                    out[f"{cell}_pcrlb_v"] = d["pcrlb_v"]
    return out


# -- drawing (matplotlib is imported only here) ------------------------------

def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(fig, outdir, name):
    path = os.path.join(outdir, name)
    fig.savefig(path, dpi=130)
    _pyplot().close(fig)
    print("wrote", path)


def draw_samples(a, outdir):
    plt = _pyplot()
    fig, axes = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    for x2, f in zip(a["x2"], a["if"]):
        axes[0].plot(a["ts"], x2, lw=0.8)
        axes[1].plot(a["ts"], f, lw=0.8)
    axes[0].set_ylabel("chirp X2(t)")
    axes[1].set_ylabel("IF g(V(t)) [Hz]")
    axes[1].set_xlabel("t [s]")
    _save(fig, outdir, "chirp_samples.png")


def draw_cov(a, outdir):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    lo, hi = float(a["ts"][0]), float(a["ts"][-1])
    im = ax.imshow(a["surf"][:, :, 1, 1], origin="lower",
                   extent=[lo, hi, lo, hi], cmap="RdBu_r")
    fig.colorbar(im, ax=ax, label="Cov[X2(t1), X2(t2)]")
    ax.set_xlabel("t1 [s]")
    ax.set_ylabel("t2 [s]")
    _save(fig, outdir, "cov_harmonic_sde.png")


def draw_cond_cov(a, outdir):
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    axes[0].plot(a["ts"], a["vs"][:, 0])
    axes[0].set_title("conditioning V path")
    im = axes[1].imshow(a["surf"][:, :, 1, 1], origin="lower",
                        cmap="RdBu_r")
    fig.colorbar(im, ax=axes[1])
    axes[1].set_title("MC Cov[X2(t1), X2(t2) | V]")
    _save(fig, outdir, "cond_cov_chirp_sde.png")


def _draw_estimation(a, outdir, name, true_label):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(a["ts"], a["true_if"], "--", label=true_label)
    ax.plot(a["ts"], a["if_mean"], "k", label="posterior mean")
    ax.fill_between(a["ts"], a["if_lower"], a["if_upper"], color="k",
                    alpha=0.15, edgecolor="none")
    ax.legend()
    ax.set_xlabel("t [s]")
    ax.set_ylabel("IF [Hz]")
    _save(fig, outdir, name)


def draw_estimation(a, outdir):
    _draw_estimation(a, outdir, "estimation.png", "true IF")


def draw_estimation_harmonic(a, outdir):
    _draw_estimation(a, outdir, "estimation_harmonic.png",
                     "true fundamental IF")


def draw_crlb(a, outdir, methods=("ekf",), name="crlb_ekf.png"):
    """One panel per (lam, b): each method's filter MSE of V and the first
    file's PCRLB, as the JAX script's ``plot_crlb`` (one method) and
    ``plot_crlb_both`` (GHF and EKF) draw them."""
    plt = _pyplot()
    lams, bs = list(a["lams"]), list(a["bs"])
    fig, axes = plt.subplots(len(lams), len(bs),
                             figsize=(3.2 * len(bs), 2.6 * len(lams)),
                             sharex=True, squeeze=False)
    colors = ("k", "C0")
    for i, lam in enumerate(lams):
        for j, b in enumerate(bs):
            ax = axes[i][j]
            drawn = False
            for method, color in zip(methods, colors):
                cell = f"{method}_lam{lam}_b{b}"
                if f"{cell}_mean_err_v" not in a:
                    continue
                label = "filter MSE (V)" if len(methods) == 1 \
                    else f"{method.upper()} MSE (V)"
                ax.semilogy(a[f"{cell}_ts"], a[f"{cell}_mean_err_v"], color,
                            label=label)
                if not drawn and f"{cell}_pcrlb_v" in a:
                    ax.semilogy(a[f"{cell}_ts"], a[f"{cell}_pcrlb_v"], "r--",
                                label="PCRLB (V)")
                drawn = True
            if not drawn:
                ax.axis("off")
                continue
            ax.set_title(f"$\\lambda$={lam}, b={b}", fontsize=9)
            if i == len(lams) - 1:
                ax.set_xlabel("t (s)")
            if j == 0:
                ax.set_ylabel("MSE")
    axes[0][0].legend(fontsize=7)
    fig.tight_layout()
    _save(fig, outdir, name)


def _crlb_plot(methods, name):
    return (lambda device, T, results_dir: crlb_arrays(methods, results_dir),
            lambda a, outdir: draw_crlb(a, outdir, methods, name))


# name -> (arrays(device, T, results_dir), draw(arrays, outdir)); the names
# and PNG files of the JAX script's PLOTS.  T is the estimation records'
# length.
PLOTS = {
    "samples": (lambda device, T, results_dir: samples_arrays(device=device),
                draw_samples),
    "cov": (lambda device, T, results_dir: cov_arrays(device=device),
            draw_cov),
    "cond_cov": (lambda device, T, results_dir: cond_cov_arrays(
        device=device), draw_cond_cov),
    "estimation": (lambda device, T, results_dir: estimation_arrays(
        T, device=device), draw_estimation),
    "estimation_harmonic": (lambda device, T, results_dir:
                            estimation_harmonic_arrays(T, device=device),
                            draw_estimation_harmonic),
    "crlb": _crlb_plot(("ekf",), "crlb_ekf.png"),
    "crlb_ghf": _crlb_plot(("ghf",), "crlb_ghf.png"),
    "crlb_ekf": _crlb_plot(("ekf",), "crlb_ekf.png"),
    "crlb_both": _crlb_plot(("ghf", "ekf"), "crlb_ghf_ekf.png"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--which", nargs="+", default=list(PLOTS),
                    choices=list(PLOTS))
    ap.add_argument("--out", default="./figures")
    ap.add_argument("--save-arrays", default=None, metavar="DIR",
                    help="write DIR/<figure>.npz instead of drawing "
                         "(no matplotlib needed)")
    ap.add_argument("--from-arrays", default=None, metavar="DIR",
                    help="draw the DIR/<figure>.npz files of --save-arrays")
    ap.add_argument("--results-dir", default="./results",
                    help="where the crlb_*.npz files are")
    ap.add_argument("--T", type=int, default=3141,
                    help="length of the estimation figures' records")
    add_device_args(ap)
    args = ap.parse_args(argv)
    if args.save_arrays and args.from_arrays:
        ap.error("--save-arrays and --from-arrays exclude each other")
    if not args.save_arrays:
        require_matplotlib(ap, "drawing the figures (without --save-arrays)")
    device = None if args.from_arrays else setup(args)
    out = args.save_arrays or args.out
    os.makedirs(out, exist_ok=True)
    for name in args.which:
        compute, draw = PLOTS[name]
        if args.from_arrays:
            arrays = dict(np.load(os.path.join(args.from_arrays,
                                               f"{name}.npz")))
        else:
            arrays = compute(device, args.T, args.results_dir)
        if arrays is None:
            print(f"{name}: no crlb_*.npz in {args.results_dir}; run "
                  f"chirpgp_tpu_torch.experiments.run_crlb first",
                  flush=True)
            continue
        if args.save_arrays:
            path = os.path.join(out, f"{name}.npz")
            np.savez(path, **arrays)
            print("wrote", path, flush=True)
        else:
            draw(arrays, out)


if __name__ == "__main__":
    main()
