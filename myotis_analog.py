#!/usr/bin/env python3
"""IF accuracy of the Myotis bat configuration on its synthetic analog, for
any crop, form and dtype.

    python3 myotis_analog.py                          # the port, on the card
    python3 myotis_analog.py --device cpu --crop 0 12000 --crop 4000 8000
    python3 myotis_analog.py --device cpu --package jax   # the JAX package

The analog is ``tests/test_bats_longrecord.py``'s: 4 harmonics sweeping
60 -> 25 kHz over 25334 samples at 250 kHz under a Gaussian envelope, plus
0.01 N(0, 1) from ``default_rng(0)``.  Each crop is standardized and run
through the harmonic model at ``MYOTIS``'s hand-set parameters (cubature,
d=10, freq_scale=1e4); the line printed per configuration gives the IF
RMS against the true IF in the envelope core (envelope > 0.5) and the
seconds.  Whether the filter locks on the fundamental depends on
round-off before the envelope rises, so it changes with the crop, the
dtype, the package and the device.  ``--package jax`` runs the JAX
package's ``estimate_if`` on the host CPU instead of the port (float32
needs JAX's x64 off, so each dtype runs in its own process).
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T_FULL, FS = 25334, 250000.0


def analog():
    """(ys, true IF, envelope) of the full synthetic call."""
    ts = np.arange(T_FULL) / FS
    dur = T_FULL / FS
    freq = 60e3 + (25e3 - 60e3) * ts / dur
    phase = np.cumsum(freq) / FS
    env = np.exp(-0.5 * ((ts - dur / 2) / (dur / 5)) ** 2)
    sig = sum((0.6 ** (k - 1)) * np.sin(2 * np.pi * k * phase)
              for k in range(1, 5))
    ys = env * sig + 0.01 * np.random.default_rng(0).standard_normal(T_FULL)
    return ys, freq, env


def run_port(lo, hi, form, dtype, device):
    import torch
    from chirpgp_tpu_torch.apps import MYOTIS, analyze_bat_call
    ys, freq, env = analog()
    y = ys[lo:hi]
    y = (y - y.mean()) / y.std()
    t0 = time.perf_counter()
    est, _ = analyze_bat_call(torch.as_tensor(y, dtype=getattr(torch, dtype),
                                              device=device),
                              FS, MYOTIS, form=form)
    if_mean = est["if_mean"].double().cpu().numpy()
    return if_mean, time.perf_counter() - t0


def run_jax(lo, hi, form, dtype):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "float64")
    import jax.numpy as jnp
    from chirpgp_tpu.apps import MYOTIS
    from chirpgp_tpu.apps.pipeline import IFEstimationConfig, estimate_if
    ys, freq, env = analog()
    y = ys[lo:hi]
    y = (y - y.mean()) / y.std()
    cfg = IFEstimationConfig(
        dt=1.0 / FS, Xi=MYOTIS.Xi, method="ghfs", model="harmonic",
        num_harmonics=MYOTIS.num_harmonics, freq_scale=MYOTIS.freq_scale,
        quadrature="cubature", form=form)
    dt = getattr(jnp, dtype)
    t0 = time.perf_counter()
    est = jax.jit(lambda v: estimate_if(cfg, jnp.asarray(MYOTIS.params, dt),
                                        v))(jnp.asarray(y, dt))
    if_mean = np.asarray(est["if_mean"], np.float64)
    return if_mean, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--crop", nargs=2, type=int, action="append",
                    help="first and last+1 sample (repeatable); default "
                         "4000 8000 and 0 12000")
    ap.add_argument("--form", nargs="+", default=["cov"],
                    choices=["cov", "sqrt"])
    ap.add_argument("--dtype", nargs="+", default=["float32", "float64"],
                    choices=["float32", "float64"])
    ap.add_argument("--package", default="port", choices=["port", "jax"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--one", nargs=4, help=argparse.SUPPRESS)
    args = ap.parse_args()
    _, freq, env = analog()
    if args.one:      # one JAX configuration, in its own process
        lo, hi, form, dtype = int(args.one[0]), int(args.one[1]), *args.one[2:]
        if_mean, secs = run_jax(lo, hi, form, dtype)
        print(json.dumps(dict(if_mean=if_mean.tolist(), secs=secs)))
        return 0
    sys.path.insert(0, str(ROOT))
    for lo, hi in args.crop or [(4000, 8000), (0, 12000)]:
        core = env[lo:hi] > 0.5
        for form in args.form:
            for dtype in args.dtype:
                if args.package == "jax":
                    proc = subprocess.run(
                        [sys.executable, __file__, "--one", str(lo), str(hi),
                         form, dtype], capture_output=True, text=True,
                        check=True, cwd=ROOT)
                    res = json.loads(proc.stdout.strip().splitlines()[-1])
                    if_mean, secs = np.array(res["if_mean"]), res["secs"]
                    where = "JAX package, host CPU"
                else:
                    if_mean, secs = run_port(lo, hi, form, dtype, args.device)
                    where = f"port, {args.device}"
                rms = float(np.sqrt(np.mean(
                    (if_mean[core] - freq[lo:hi][core]) ** 2)))
                print(f"{where}: samples {lo}:{hi} {form} {dtype}: IF RMS in "
                      f"the core ({int(core.sum())} samples) {rms!r} Hz, "
                      f"finite {bool(np.all(np.isfinite(if_mean)))}, "
                      f"{secs:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
