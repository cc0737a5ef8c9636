#!/usr/bin/env python3
"""Side measurements of the parallel-in-time and posterior-inference paths
(``chip_smoke.py`` phase 11 runs and gates the paths themselves).

    python3 parallel_posterior_probes.py ops        # host CPU: operations per call
    python3 parallel_posterior_probes.py smc --device cpu --particles 4096 32768
    python3 parallel_posterior_probes.py smc --package jax --particles 4096
    python3 parallel_posterior_probes.py nan        # the card: NaN log densities
    python3 parallel_posterior_probes.py nan --thetas F.npy --package jax
    python3 parallel_posterior_probes.py nan --thetas F.npy --device cpu

``ops`` counts the ATen operations (views excluded) that each path of
phase 11 dispatches, float32, an estimate of its kernel launches on the
card made without one.  ``smc`` prints ``smc_nll`` of phase 11b's record
(seed 0 of ``toydata_const``, T=3141, params (0.1, 0.1, 0.1, 1, 1, 7),
float64) at each particle count beside the covariance GHFS NLL at the
same params; ``--package jax`` runs the JAX package on the host CPU
instead of the port.  ``nan`` runs phase 11d's float32 sqrt GHFS
hyperposterior (T=``--T``, 8 chains, depth 3, ``--transitions`` warmup
and ``--samples`` sampling transitions) on the card from
``nuts_sample``'s first step size 0.1 for each of ``--seeds`` and saves
every evaluated theta whose log density or gradient is not finite to
``--out``; with ``--thetas`` it evaluates the log posterior and its
gradient at those thetas on the host CPU instead (``--package jax``: the
JAX package in float32; else the port, float32 and float64).
"""

import argparse
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PARAMS = (0.1, 0.1, 0.1, 1.0, 1.0, 7.0)
DT, XI = 1e-3, 0.1
VIEWS = {"view", "_unsafe_view", "expand", "slice", "select", "t",
         "transpose", "unsqueeze", "squeeze", "as_strided", "alias",
         "permute", "detach", "_reshape_alias", "reshape"}


def count_ops():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from chirpgp_tpu_torch.infer import (
        kf, kf_rts_parallel, psgp_filter_smoother, rts, sgp_filter,
        sgp_smoother)
    from chirpgp_tpu_torch.models import (
        build_chirp_model, m32_solution, stationary_cov_m32)
    from chirpgp_tpu_torch.quad import gauss_hermite

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func.__name__.split(".")[0] not in VIEWS
            return func(*args, **(kwargs or {}))

    def ops(fn):
        with Count() as c:
            fn()
        return c.n

    f32 = torch.float32
    F, Sigma = m32_solution(1.0, 1.0, DT)
    m32 = [torch.as_tensor(x, dtype=f32) for x in (
        F, Sigma, [1.0, 0.0], XI, [0.0, 0.0], stationary_cov_m32(1.0, 1.0))]
    ref = np.load(ROOT / "results/data/parallel_kf_ref.npz")
    for T in (3141, 25000):
        ys = torch.as_tensor(ref[f"ys_T{T}"])
        for bs in (None, 128, 512):
            n = ops(lambda: kf_rts_parallel(*m32, ys, block_size=bs))
            print(f"M32 kf_rts_parallel T={T} block_size={bs}: {n} ops")
    ys = torch.as_tensor(ref["ys_T3141"][:300])

    def seq():
        mfs, Pfs, _ = kf(*m32[:4], *m32[4:], ys)
        rts(m32[0], m32[1], mfs, Pfs)
    print(f"M32 sequential kf + rts: {ops(seq) / 300:.2f} ops per step")
    pack = build_chirp_model(torch.tensor(PARAMS, dtype=f32))
    rule = gauss_hermite(4, 3)
    ys = torch.as_tensor(np.load(ROOT / "results/data/toydata_const.npz")
                         ["ys"][0], dtype=f32)
    for bs in (None, 128):
        n = ops(lambda: psgp_filter_smoother(
            pack.m_and_cov, rule, pack.H, XI, pack.m0, pack.P0, DT, ys,
            num_iters=1, block_size=bs))
        print(f"chirp psgp, one iteration, block_size={bs}: {n} ops")

    def seq_sgp():
        mfs, Pfs, _ = sgp_filter(pack.m_and_cov, rule, pack.H, XI, pack.m0,
                                 pack.P0, DT, ys[:100])
        sgp_smoother(pack.m_and_cov, rule, mfs, Pfs, DT)
    print(f"chirp sequential sgp filter + smoother: {ops(seq_sgp) / 100:.2f} "
          f"ops per step")


def smc(package, particles, device):
    ys = np.load(ROOT / "results/data/toydata_const.npz")["ys"][0] \
        .astype(np.float64)
    if package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        from chirpgp_tpu.apps.pipeline import IFEstimationConfig, make_nll_fn
        from chirpgp_tpu.apps.posterior import smc_nll
        from chirpgp_tpu.models import g_inv
        p = jnp.asarray(PARAMS)
        ghfs = float(make_nll_fn(IFEstimationConfig(), jnp.asarray(ys))(
            g_inv(p)))
        for N in particles:
            t0 = time.perf_counter()
            nll, res = jax.jit(lambda y, k, N=N: smc_nll(
                IFEstimationConfig(), p, y, k, num_particles=N))(
                jnp.asarray(ys), jax.random.PRNGKey(0))
            print(f"JAX package, N={N}: SMC NLL {float(nll):.4f}, min ESS "
                  f"{float(res.ess.min()):.1f}, {time.perf_counter() - t0:.1f}"
                  f" s; GHFS NLL {ghfs:.4f}")
        return
    import torch
    from chirpgp_tpu_torch.apps import IFEstimationConfig, make_nll_fn, smc_nll
    from chirpgp_tpu_torch.models import g_inv
    y = torch.as_tensor(ys, device=device)
    p = torch.tensor(PARAMS, dtype=torch.float64, device=device)
    with torch.no_grad():
        ghfs = float(make_nll_fn(IFEstimationConfig(), y)(g_inv(p)))
    for N in particles:
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(0)
        nll, res = smc_nll(IFEstimationConfig(), p, y, gen, num_particles=N)
        print(f"port on {device}, N={N}: SMC NLL {float(nll):.4f}, min ESS "
              f"{float(res.ess.min()):.1f}, {time.perf_counter() - t0:.1f} s;"
              f" GHFS NLL {ghfs:.4f}")


def hyper_nan(seeds, T, transitions, samples, out):
    """The card: phase 11d's hyperposterior from nuts_sample's first step
    size 0.1, keeping every evaluated point with a non-finite log density
    or gradient."""
    from unittest import mock
    import torch
    import chirpgp_tpu_torch.infer.nuts as nuts_module
    from chirpgp_tpu_torch.apps import IFEstimationConfig, sample_hyperposterior
    from chirpgp_tpu_torch.fit import batched_value_and_grad
    cfg = IFEstimationConfig(method="ghfs", form="sqrt")
    ys = torch.as_tensor(np.load(ROOT / "results/data/toydata_const.npz")
                         ["ys"][0, :T], dtype=torch.float32, device="cuda")
    bad = []
    for seed in seeds:
        seen = []

        def watched(logdensity):
            vg = batched_value_and_grad(logdensity)

            def run(q):
                seen.append((q,) + tuple(vg(q)))
                return seen[-1][1:]
            return run

        gen = torch.Generator(device="cuda").manual_seed(seed)
        init = cfg.default_init_theta(torch.float32).cuda() \
            + 0.1 * torch.randn(8, 6, generator=gen, device="cuda")
        with mock.patch.object(nuts_module, "batched_value_and_grad", watched):
            res = sample_hyperposterior(cfg, ys, gen, init_theta=init,
                                        num_samples=samples,
                                        num_warmup=transitions,
                                        step_size=0.1, max_tree_depth=3)
        qs, logps, grads = (torch.cat(x) for x in zip(*seen))
        nf = ~(torch.isfinite(logps) & torch.isfinite(grads).all(-1))
        bad.append(qs[nf].cpu().numpy())
        print(f"seed {seed}, T={T}, 8 chains, {transitions} + {samples} "
              f"transitions from step 0.1: {len(logps)} points, "
              f"{int(nf.sum())} non-finite (log density "
              f"{logps[nf].tolist()}); step sizes {res.step_size.tolist()}; "
              f"mean accept {res.accept_prob.mean(1).tolist()}")
        for q in qs[nf].tolist():
            print(f"  theta {q}")
    np.save(out, np.concatenate(bad))
    print(f"{sum(len(b) for b in bad)} thetas saved to {out}")


def objective_at(thetas, T, package, device):
    """The float32 (and the port's float64) sqrt GHFS log posterior of
    phase 11d's record, value and gradient, at ``thetas``."""
    ys = np.load(ROOT / "results/data/toydata_const.npz")["ys"][0, :T]
    thetas = np.load(thetas)
    if package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        from chirpgp_tpu.apps.pipeline import IFEstimationConfig
        from chirpgp_tpu.apps.posterior import make_logposterior
        vg = jax.jit(jax.value_and_grad(make_logposterior(
            IFEstimationConfig(method="ghfs", form="sqrt"),
            jnp.asarray(ys, jnp.float32))))
        runs = {"float32": lambda th: vg(jnp.asarray(th, jnp.float32))}
    else:
        import torch
        from chirpgp_tpu_torch.apps import IFEstimationConfig, make_logposterior
        cfg = IFEstimationConfig(method="ghfs", form="sqrt")

        def run(dtype):
            lp = make_logposterior(cfg, torch.as_tensor(ys, dtype=dtype,
                                                        device=device))

            def at(th):
                th = torch.tensor(th, dtype=dtype, device=device,
                                  requires_grad=True)
                v = lp(th)
                return v.detach(), torch.autograd.grad(v, th)[0]
            return at
        runs = {"float32": run(torch.float32), "float64": run(torch.float64)}
    for th in thetas:
        vals = []
        for name, at in runs.items():
            v, g = at(th)
            vals.append(f"{name} {float(v):.6g}, gradient finite "
                        f"{bool(np.isfinite(np.asarray(g.tolist())).all())}")
        print(f"{package} on {'cpu' if package == 'jax' else device} at "
              f"theta {th.tolist()}: "
              + "; ".join(vals))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("probe", choices=("ops", "smc", "nan"))
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--particles", type=int, nargs="+", default=[4096])
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 4, 5])
    ap.add_argument("--T", type=int, default=64)
    ap.add_argument("--transitions", type=int, default=2, help="warmup")
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--thetas", help="evaluate the objective at these")
    ap.add_argument("--out", default="chiprun_out/nan_thetas.npy")
    args = ap.parse_args()
    if args.probe == "ops":
        count_ops()
    elif args.probe == "smc":
        smc(args.package, args.particles, args.device)
    elif args.thetas:
        objective_at(args.thetas, args.T, args.package, args.device)
    else:
        hyper_nan(args.seeds, args.T, args.transitions, args.samples,
                  args.out)


if __name__ == "__main__":
    main()
