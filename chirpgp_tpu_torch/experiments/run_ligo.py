"""GW150914-configuration LIGO pipeline run on the PyTorch port.

The reference's LIGO job reads the GW150914 strain files, which neither
the reference nor this repository vendors.  As the JAX package's
``experiments/run_ligo.py`` does, this runner synthesizes a GW150914-like
inspiral at the reference configuration (fs=4096 Hz, Xi=0.3, GH order 3,
init g^{-1}([0.1, 2, 0.5, 0.02, 40, 1])): a Newtonian chirp of chirp mass
30 Msun from 35 Hz to the ~300 Hz merger regime, amplitude growing as
f^{2/3}, and two detector records (H, and L inverted and shifted 7 ms)
with independent noise -- JAX's normal draws of ``PRNGKey(0)``'s two
splits, remade without JAX (``utils/jax_keys.py``), float64.  With real
strain files (``--data``), the synthetic branch is skipped.

The JAX script's ``--reference`` (the reference package's own pipeline,
which imports JAX) is not ported.  ``--plot`` needs matplotlib, imported
only then.

Outputs ``{out}/ligo_synthetic.npz`` (``ligo_real.npz`` with ``--data``):
the true IF, posterior IF and band, learnt params and the in-band RMSE.

Usage:
    python -m chirpgp_tpu_torch.experiments.run_ligo [--plot out.png]
    python -m chirpgp_tpu_torch.experiments.run_ligo --data H.txt L.txt
"""

import argparse
import math
import os

import numpy as np
import torch

from chirpgp_tpu_torch.experiments._common import (
    add_device_args, require_matplotlib, setup)
from chirpgp_tpu_torch.utils.jax_keys import jax_normal, prng_key, split

MSUN_SEC = 4.925491e-6          # G Msun / c^3 in seconds
FS = 4096.0


def synth_gw150914(seed: int = 0, mc_msun: float = 30.0, f0: float = 35.0,
                   f_cut: float = 300.0, noise_std: float = 0.55,
                   shift_ms: float = 7.0):
    """Two ``(ts, ys, true_f, shift)`` float64 host records mimicking the
    fig1 observed strain, the noise drawn from ``PRNGKey(seed)``'s split
    as the JAX package draws it."""
    gm = mc_msun * MSUN_SEC
    # Newtonian chirp: f(t) = k (tc - t)^{-3/8}, k = (5/256)^{3/8} / pi
    # gm^{-5/8}; tc puts f(0) = f0, and the record ends at f_cut.
    k = (5.0 / 256.0) ** 0.375 / math.pi * gm ** (-0.625)
    tc = (k / f0) ** (8.0 / 3.0)
    t_end = tc - (k / f_cut) ** (8.0 / 3.0)
    T = int(t_end * FS)
    ts = torch.arange(1, T + 1, dtype=torch.float64) / FS
    tau = tc - ts
    true_f = k * tau ** (-0.375)
    # phase = 2 pi \int f dt = -2 pi k (8/5) tau^{5/8} + const
    phase = -2.0 * math.pi * k * 1.6 * tau ** 0.625
    amp = (true_f / f0) ** (2.0 / 3.0)
    clean = amp * torch.sin(phase - phase[0])
    k1, k2 = split(prng_key(seed))
    shift = int(round(shift_ms * 1e-3 * FS))
    ys_h = clean + noise_std * torch.from_numpy(jax_normal(k1, (T,)))
    # L: the inverted, delayed waveform with its own noise.
    clean_l = -torch.roll(clean, shift)
    clean_l[:shift] = 0.0
    ys_l = clean_l + noise_std * torch.from_numpy(jax_normal(k2, (T,)))
    return [(ts, ys_h, true_f, 0), (ts, ys_l, true_f, shift)]


def _plot(path, names, results):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(len(names), 1, figsize=(8, 3 * len(names)),
                             squeeze=False)
    for ax_row, name in zip(axes, names):
        ax = ax_row[0]
        ts = results[f"{name}_ts"]
        ax.plot(ts, results[f"{name}_if_mean"], "k", label="posterior IF")
        ax.fill_between(ts, results[f"{name}_if_lower"],
                        results[f"{name}_if_upper"], alpha=0.2, color="k",
                        label="95% band")
        if f"{name}_true_f" in results:
            ax.plot(ts, results[f"{name}_true_f"], "r--", label="true IF")
        ax.set_ylabel("IF (Hz)")
        ax.set_title(name)
        ax.legend(fontsize=8)
    axes[-1][0].set_xlabel("time (s)")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    print(f"wrote {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", nargs="+", default=None,
                    help="real strain txt files (time, strain); if "
                         "omitted, the synthetic GW150914-like event is "
                         "used")
    ap.add_argument("--out", default="./results")
    ap.add_argument("--plot", default=None)
    add_device_args(ap, x64=False)
    args = ap.parse_args(argv)
    if args.plot:
        require_matplotlib(ap)
    device = setup(args)

    from chirpgp_tpu_torch.apps import analyze_ligo, load_ligo_strain

    os.makedirs(args.out, exist_ok=True)
    records = []
    if args.data:
        for path, (ts, ys) in zip(args.data,
                                  load_ligo_strain(args.data, device=device)):
            records.append((path, ts, ys, None, 0))
    else:
        for name, (ts, ys, tf, shift) in zip(("H_synth", "L_synth"),
                                             synth_gw150914()):
            records.append((name, ts, ys, tf, shift))

    results = {}
    for name, ts, ys, true_f, shift in records:
        opt, params, est = analyze_ligo(ts, ys, device=device)
        if_mean = est["if_mean"].cpu().numpy()
        print(f"[{name}] converged={bool(opt.success)} "
              f"iters={int(opt.num_iters)} "
              f"params={np.round(params.detach().cpu().numpy(), 4)}")
        print(f"[{name}] IF range {if_mean.min():.1f}..{if_mean.max():.1f} Hz")
        results[f"{name}_if_mean"] = if_mean
        results[f"{name}_if_lower"] = est["if_lower"].cpu().numpy()
        results[f"{name}_if_upper"] = est["if_upper"].cpu().numpy()
        results[f"{name}_params"] = params.detach().cpu().numpy()
        results[f"{name}_ts"] = ts.cpu().numpy()
        if true_f is not None:
            # Score the settled, aligned segment: skip the filter burn-in
            # quarter and (for L) the shifted head.
            lo = max(len(ts) // 4, shift + 50)
            tf_aligned = np.roll(true_f.numpy(), shift)
            err = float(np.sqrt(np.mean((tf_aligned[lo:] - if_mean[lo:]) ** 2)))
            rel = err / float(np.mean(tf_aligned[lo:]))
            print(f"[{name}] in-band IF RMSE {err:.2f} Hz "
                  f"({100 * rel:.1f}% of mean IF)")
            results[f"{name}_true_f"] = tf_aligned
            results[f"{name}_rmse_hz"] = err

    path = os.path.join(args.out, "ligo_real.npz" if args.data
                        else "ligo_synthetic.npz")
    np.savez(path, **results)
    print(f"saved {path}")
    if args.plot:
        _plot(args.plot, [r[0] for r in records], results)


if __name__ == "__main__":
    main()
