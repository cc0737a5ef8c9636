"""Wall-clock timing of the filter + smoother + IF expectation on one
toy chirp record (the reference's ``paper_plots_tables/print_time.py``) on
the PyTorch port, through ``utils/timing.py``: one warm-up call, then
five timed calls, each between two device synchronizations.

The record is the JAX package's (``experiments/print_time.py``): the meow
chirp plus ``sqrt(Xi)`` times JAX's normal draws of ``PRNGKey(555)``,
float32 unless ``--x64``, remade without JAX (``utils/jax_keys.py``).

Usage:
    python -m chirpgp_tpu_torch.experiments.print_time [--T 3141] \\
        [--form sqrt]
"""

import argparse
import math

import torch

from chirpgp_tpu_torch.experiments._common import (
    add_device_args, numpy_dtype, setup)
from chirpgp_tpu_torch.utils.jax_keys import (
    jax_linspace, jax_normal, prng_key)


def toy_record(T: int, dt: float = 1e-3, Xi: float = 0.1, seed: int = 555,
               dtype=None, mags=None):
    """``gen_chirp(meow) + sqrt(Xi) * normal(PRNGKey(seed), (T,))`` as the
    JAX package's timing script and demos make it, on the host in
    ``dtype`` (torch's default): ``(ts, ys)``.  With ``mags``, a list of
    magnitude functions, the chirp is ``gen_harmonic_chirp(ts, mags,
    meow)`` instead, as the JAX package's harmonic figure makes it."""
    from chirpgp_tpu_torch.toymodels import (
        constant_mag, gen_chirp, gen_harmonic_chirp, meow_freq)
    dtype = dtype or torch.get_default_dtype()
    ts = jax_linspace(dt, dt * T, T, dtype)
    _, phase = meow_freq(offset=8.0)
    noise = jax_normal(prng_key(seed), (T,), numpy_dtype(dtype))
    chirp = gen_chirp(ts, constant_mag(1.0), phase) if mags is None \
        else gen_harmonic_chirp(ts, mags, phase)
    return ts, chirp + math.sqrt(Xi) * torch.from_numpy(noise)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T", type=int, default=3141)
    ap.add_argument("--form", default="cov", choices=["cov", "sqrt"])
    ap.add_argument("--methods", nargs="+", default=["ekfs", "ghfs"])
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = setup(args)

    from chirpgp_tpu_torch.apps import IFEstimationConfig, estimate_if
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.utils import time_jitted

    dt, T, Xi = 1e-3, args.T, 0.1
    _, ys = toy_record(T, dt, Xi)
    ys = ys.to(device)
    for method in args.methods:
        cfg = IFEstimationConfig(dt=dt, Xi=Xi, method=method,
                                 form=args.form)
        params = g(cfg.default_init_theta())

        def fn(y, cfg=cfg, params=params):
            with torch.no_grad():
                return estimate_if(cfg, params, y)["if_mean"]

        res = time_jitted(fn, ys)
        print(f"[{method}/{args.form}] filter+smoother+expectation, "
              f"T={T}: {res}", flush=True)


if __name__ == "__main__":
    main()
