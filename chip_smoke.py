#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Builds the hand-written CUDA kernel from ``chirpgp_tpu_torch/ops/csrc`` on
first use and drives the batched IF-estimation path, the single-record
MLE path and the fused batched filter+smoother once at full width.
Phases, one line each:

1. environment: card, ``nvidia-smi`` name and power limit, torch/CUDA
   versions, the kernel's nvcc build time and ptxas report (no register
   spills allowed);
2. kernel vs plain PyTorch version on the card: GH-3 and cubature at
   B=512, T=32 on 0.1 N(0, 1) measurements in float32 (atol 5e-5 on
   mfs/nll, 1e-4 on L L^T and on Lfs) and float64 (atol 1e-9), at every
   team size the kernel is built for, then GH-3 at B=4096, T=3141 on the
   benchmark's data in float64 and float32 (scaled bounds below), and
   each float32 version against the float64 kernel, the on-card oracle;
3. ``estimate_if_batched`` at B=4096, T=3141, dt=1e-3, Xi=0.1, GH-3,
   float32: finite outputs, the kernel launched by the main path, wall
   times of the kernel, of the plain filter (in turns: plain, kernel,
   kernel, plain) and of the whole estimate;
   3b. the kernel's CUDA-event time (the bare launch) at every team size:
   GH-3 at B=4096, T=3141 (float32 and float64), GH-3 and cubature at the
   Table-I width (the 100 records of ``toydata_const`` at the GHFS and
   CKFS reference optima, float32), cubature at B=4096 (float32), beside
   its flop and byte counts, its bound and its share of the bound;
4. accuracy gate: seed 0 of ``results/data/toydata_const.npz`` at the
   reference's learnt optimum, CKFS (cubature) and GHFS (GH-3), float32;
5. the MLE path on seed 0 at full T=3141: ``make_nll_fn`` (cov GHFS,
   float64) value and gradient on the card against the host CPU; the
   float32 sqrt objective against the CUDA kernel's nll; ``fit_mle``
   (SciPy L-BFGS-B, 5 iterations); ``estimate_if`` GHFS and EKFS gates;
6. the fused batched filter+smoother: at B=512, T=256, float64, against
   the separate filter and smoother, slim output bit-equal to the full
   one, covariance form against square-root form; then the slim output at
   the benchmark's B=4096, T=3141, float32, its GH-10 IF mean against
   phase 3's.

Every phase must pass; a failure ends the run with a nonzero exit code.
The line before the last is a JSON record of the kernels (``ms`` and
``bound_ms`` at B=4096 float32, ``ms_b100`` at the Table-I width,
``ms_f64`` and ``bound_ms_f64`` at B=4096 float64); the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the ``chirpgp_tpu_torch`` package beside this script, it exits nonzero.
"""

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DT, XI = 1e-3, 0.1
B_FULL, T_FULL = 4096, 3141
SMALL_B, SMALL_T = 512, 32
SMALL_PARAMS = (0.1, 0.1, 0.1, 1.0, 1.0, 7.0)
# Kernel-vs-plain bounds at the full shape, B=4096 x T=3141: max deviation
# over (1 + max |plain|) for mfs and L L^T, and the relative deviation of
# nll[-1].  In float64 the two must agree to round-off.  In float32 each
# version alone deviates from the float64 kernel by up to ~8e-6 in
# nll[-1] (measured on an H100), so their difference is held to 2e-5.
FULL_BOUNDS = {"float64": (1e-9, 1e-9, 1e-12), "float32": (1e-4, 1e-4, 2e-5)}
# Seed-0 gates: (IF-RMSE x10, nell) of the float64 reference.
GATES = {"ckfs": ("cubature", 0.77619, 906.6107),
         "ghfs": ("gauss_hermite", 0.78564, 906.7245)}
GATE_RMSE_ATOL, GATE_NELL_RTOL = 0.005, 1e-4
# Phase 5: the float64 nll at the GHFS optimum through the float64 batched
# path (906.72448), and the reference's seed-0 IF-RMSE x10 of GHFS and EKFS.
MLE_NLL, MLE_NLL_RTOL = 906.72448, 1e-6
MLE_GATES = {"ghfs": 0.7856412, "ekfs": 0.7327871}
MLE_ITERS = 5
# Phase 6d: the slim fused IF mean against estimate_if_batched's, both in
# float32, as max deviation over (1 + max |IF|).  On the host CPU the two
# plain versions differ by 9.3e-6 at B=32; the bound leaves room for the
# lane maximum at B=4096 and the filter kernel's own float32 rounding.
FUSED_IF_BOUND = 1e-4
FUSED_SMALL_B, FUSED_SMALL_T, FUSED_F64_BOUND = 512, 256, 1e-9
KERNEL_SOURCE = "chirpgp_tpu_torch/ops/csrc/ghfs_chirp_filter.cu"
KERNEL_REPLACES = "chirpgp_tpu/experimental/pallas_filter.py:248"
# Phase 3b: CUDA-event launches after one warm-up, and the H100 SXM's
# published peaks (NVIDIA data sheet, dense, at 700 W): float32 and float64
# outside the tensor cores, and HBM3.
TIMING_REPS = 6
SWEEP_B = (528, 1056, 2112)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def measurements(B, T, seed, dtype, device):
    """gen_chirp(meow_freq(offset=8)) + sqrt(Xi) N(0, 1), noise from a
    seeded NumPy generator -- the benchmark's data."""
    from chirpgp_tpu_torch.toymodels import gen_chirp, constant_mag, meow_freq
    ts = torch.linspace(DT, DT * T, T, dtype=dtype, device=device)
    _, phase = meow_freq(offset=8.0)
    base = gen_chirp(ts, constant_mag(1.0), phase)
    noise = np.random.default_rng(seed).standard_normal((B, T))
    return base[None] + math.sqrt(XI) * torch.as_tensor(
        noise, dtype=dtype, device=device)


def deviations(kern, plain):
    """max |d mfs|, max |d L L^T|, max |d Lfs|, max |d nll|, the largest
    relative deviation of nll[-1], and the scales max |mfs|, max |L L^T|
    of the plain version."""
    (mk, lk, nk), (mp, lp, np_) = [[x.double() for x in out]
                                   for out in (kern, plain)]
    Pk = torch.einsum("tikb,tjkb->tijb", lk, lk)
    Pp = torch.einsum("tikb,tjkb->tijb", lp, lp)
    return dict(
        mfs=float((mk - mp).abs().max()), LLT=float((Pk - Pp).abs().max()),
        Lfs=float((lk - lp).abs().max()), nll=float((nk - np_).abs().max()),
        nll_last_rel=float(((nk[-1] - np_[-1]).abs() / np_[-1].abs()).max()),
        scale_mfs=float(mp.abs().max()), scale_LLT=float(Pp.abs().max()))


def timed(fn, *args, **kwargs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_environment(device):
    from chirpgp_tpu_torch.ops.chirp_filter import load_kernel
    from chirpgp_tpu_torch.ops._build import find_nvcc
    smi = nvidia_smi()
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    built = load_kernel()
    # ptxas -v: each kernel instance (dtype, team size, rows per member)
    # with its registers, stack frame and spills.
    ptxas = []
    for ln in built.log.splitlines():
        inst = re.search(r"entry function '\S*?kernelI([fd])Li(\d+)ELi(\d+)E",
                         ln)
        if inst:
            ptxas.append(f"{dict(f='f32', d='f64')[inst[1]]} P={inst[2]} "
                         f"rows={inst[3]}:")
        elif "registers" in ln or "spill" in ln:
            ptxas.append(ln.split("ptxas info    :")[-1].strip())
    print(f"phase 1 environment: device={torch.cuda.get_device_name(device)}"
          f" | nvidia-smi: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {nvcc[-1] if nvcc else 'nvcc ?'} | "
          f"kernel build {built.build_seconds:.2f} s | ptxas: "
          f"{' '.join(ptxas)}")
    print(smi)
    spills = [ln for ln in ptxas if "spill" in ln
              and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    check(not spills, f"ptxas reports register spills: {spills}")
    return smi


def phase_kernel_vs_plain(device):
    from chirpgp_tpu_torch.ops.chirp_filter import (
        TEAMS, ghfs_chirp_filter, ghfs_chirp_filter_kernel,
        ghfs_chirp_filter_reference)
    from chirpgp_tpu_torch.quad import cubature, gauss_hermite
    rules = {"gh3": gauss_hermite(4, 3), "cubature": cubature(4)}
    parts = []
    # The small cases take tests/test_pallas_filter.py's inputs,
    # 0.1 N(0, 1), at which its absolute tolerances were set; every team
    # size the kernel is built for is held to them.
    small = 0.1 * np.random.default_rng(0).standard_normal((SMALL_B, SMALL_T))
    for dtype, tols in ((torch.float32, (5e-5, 1e-4, 1e-4, 5e-5)),
                        (torch.float64, (1e-9,) * 4)):
        yss = torch.as_tensor(small, dtype=dtype, device=device)
        for name, rule in rules.items():
            args = (SMALL_PARAMS, XI, DT, rule, yss)
            plain = ghfs_chirp_filter_reference(*args)
            for team in TEAMS:
                dev = deviations(ghfs_chirp_filter_kernel(*args, team=team),
                                 plain)
                tag = f"{name}/{str(dtype)[6:]}/P={team}"
                for key, tol in zip(("mfs", "LLT", "Lfs", "nll"), tols):
                    check(dev[key] <= tol,
                          f"{tag}: max |d {key}| = {dev[key]} > {tol}")
                parts.append(f"{tag} mfs {dev['mfs']:.3g} LLT "
                             f"{dev['LLT']:.3g} Lfs {dev['Lfs']:.3g} nll "
                             f"{dev['nll']:.3g}")

    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.models import g
    cfg = IFEstimationConfig()
    params = g(cfg.default_init_theta()).to(torch.float32)
    y64 = measurements(B_FULL, T_FULL, 999, torch.float64, device)
    kern, plain = {}, {}
    for yss in (y64, y64.float()):
        args = (params, XI, DT, cfg.sigma_points(), yss)
        tag = str(yss.dtype)[6:]
        kern[tag] = ghfs_chirp_filter(*args)
        plain[tag] = ghfs_chirp_filter_reference(*args)
        dev = deviations(kern[tag], plain[tag])
        scaled = (dev["mfs"] / (1.0 + dev["scale_mfs"]),
                  dev["LLT"] / (1.0 + dev["scale_LLT"]), dev["nll_last_rel"])
        for key, val, bound in zip(("mfs", "LLT", "nll[-1]"), scaled,
                                   FULL_BOUNDS[tag]):
            check(val <= bound, f"full {tag}: scaled |d {key}| {val} > {bound}")
        parts.append(
            f"full gh3/{tag} B={B_FULL} T={T_FULL}: max|d mfs| {dev['mfs']!r}"
            f" (max|mfs| {dev['scale_mfs']!r}), max|d LLT| {dev['LLT']!r} "
            f"(max|LLT| {dev['scale_LLT']!r}), max|d Lfs| {dev['Lfs']!r}, "
            f"max rel|d nll[-1]| {dev['nll_last_rel']!r}")
    del plain["float64"]
    # Each float32 version against the float64 kernel, the on-card oracle.
    for name, out in (("kernel", kern["float32"]), ("plain", plain["float32"])):
        dev = deviations(out, kern["float64"])
        parts.append(f"float32 {name} vs float64 kernel: max|d mfs| "
                     f"{dev['mfs']!r}, max|d LLT| {dev['LLT']!r}, max rel|d "
                     f"nll[-1]| {dev['nll_last_rel']!r}")
    dev = deviations(kern["float32"], plain["float32"])
    print("phase 2 kernel vs plain: " + "; ".join(parts))
    return max(dev["mfs"], dev["Lfs"], dev["nll"])


def phase_slice(device):
    from chirpgp_tpu_torch.apps import IFEstimationConfig, estimate_if_batched
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter import (
        ghfs_chirp_filter, ghfs_chirp_filter_reference)
    cfg = IFEstimationConfig()
    params = g(cfg.default_init_theta()).to(torch.float32).to(device)
    yss = measurements(B_FULL, T_FULL, 999, torch.float32, device)
    rule = cfg.sigma_points()
    args = (params, cfg.Xi, cfg.dt, rule, yss)
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = ghfs_chirp_filter if which == "kernel" else ghfs_chirp_filter_reference
        times[which].append(timed(fn, *args)[1])

    ghfs_chirp_filter.launches = 0
    est, t_est = timed(estimate_if_batched, cfg, params, yss)
    launches = ghfs_chirp_filter.launches
    check(launches >= 1, "estimate_if_batched did not launch the kernel")
    for key in ("if_mean", "nell", "mss", "Lss"):
        check(bool(torch.isfinite(est[key]).all()), f"non-finite {key}")
    check(tuple(est["if_mean"].shape) == (B_FULL, T_FULL), "if_mean shape")
    check(tuple(est["nell"].shape) == (B_FULL,), "nell shape")
    ms_p = 1e3 * sum(times["plain"]) / 2
    print(f"phase 3 slice: estimate_if_batched B={B_FULL} T={T_FULL} GH-3 "
          f"float32: finite, kernel launches {launches}; filter kernel "
          f"{[round(1e3 * t, 3) for t in times['kernel']]} ms, plain filter "
          f"{[round(1e3 * t, 3) for t in times['plain']]} ms (order plain, "
          f"kernel, kernel, plain); whole estimate {1e3 * t_est:.3f} ms = "
          f"{B_FULL * T_FULL / t_est:.1f} steps/s")
    return launches, ms_p, est["if_mean"], t_est


def event_ms(fn, reps=TIMING_REPS):
    """Mean CUDA-event time of ``fn()`` over ``reps`` calls after one
    warm-up call, in ms."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(S, T, B, dtype):
    """The least time the card could take for one filter call: the larger
    of flop over the peak rate of ``dtype`` and bytes over the memory
    rate.  Returns (flop, bytes, ms, what bounds it)."""
    from chirpgp_tpu_torch.ops.chirp_filter import filter_cost
    cost = filter_cost(S, T, B, dtype)
    t_ops = cost.flop / PEAK_FLOPS[dtype]
    t_bytes = cost.bytes / PEAK_BYTES
    return (cost.flop, cost.bytes, 1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernel_timing(device, smi):
    """CUDA-event times of the bare kernel launch at every team size: GH-3
    at the benchmark's B=4096 x T=3141 (float32 and float64), GH-3 and
    cubature at the Table-I width (the 100 records of toydata_const at the
    reference's GHFS and CKFS optima, float32), and cubature at B=4096
    float32, beside the bound.  Each team's nll[-1] is held to the default
    geometry's."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.convert import params_from_jax
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter import (
        TEAMS, kernel_launcher, launch_geometry)
    from chirpgp_tpu_torch.quad import cubature
    cfg = IFEstimationConfig()
    gh3, cub = cfg.sigma_points(), cubature(4)
    num_sms = torch.cuda.get_device_properties(device).multi_processor_count
    bench = measurements(B_FULL, T_FULL, 999, torch.float64, device)
    p_bench = g(cfg.default_init_theta())
    y100 = torch.as_tensor(
        np.load(ROOT / "results/data/toydata_const.npz")["ys"],
        dtype=torch.float32, device=device)
    opt = {name: params_from_jax(np.load(
        ROOT / f"results/reference/{name}_const.npz")["params"][0])
        for name in ("ghfs", "ckfs")}
    cases = {
        "gh3/B=4096/f32": (p_bench, gh3, bench.float()),
        "gh3/B=4096/f64": (p_bench, gh3, bench),
        "gh3/B=100/f32": (opt["ghfs"], gh3, y100),
        "cubature/B=4096/f32": (p_bench, cub, bench.float()),
        "cubature/B=100/f32": (opt["ckfs"], cub, y100),
    }

    def team_times(args):
        """{team: (ms, nll[-1])} of the bare launch at each team size."""
        out = {}
        for team in TEAMS:
            launch, (_, _, nll) = kernel_launcher(*args, team=team)
            out[team] = (event_ms(launch), nll[-1].double())
        return out

    out, parts = {}, []
    for tag, (params, rule, yss) in cases.items():
        B, T = yss.shape
        default = launch_geometry(B, rule.n_points, num_sms)
        times = team_times((params.to(torch.float64).cpu(), XI, DT, rule,
                            yss))
        nll_ref = times[default.team][1]
        rtol = FULL_BOUNDS[str(yss.dtype)[6:]][2]
        for team, (_, nll) in times.items():
            rel = float(((nll - nll_ref).abs() / nll_ref.abs()).max())
            check(bool(torch.isfinite(nll).all()) and rel <= rtol,
                  f"timing {tag} P={team}: rel d nll[-1] vs default {rel}")
        flop, nbytes, bound, bound_by = bound_ms(rule.n_points, T, B,
                                                 yss.dtype)
        ms = times[default.team][0]
        out[tag] = dict(ms=ms, bound_ms=bound, bound_by=bound_by,
                        team=default.team)
        parts.append(
            f"{tag} T={T}: " + ", ".join(f"P={p} {t!r} ms" for p, (t, _) in
                                         times.items())
            + f"; default P={default.team} rows={default.rows} "
            f"({default.lanes_per_block} lanes x {default.blocks} blocks) "
            f"{ms!r} ms; {flop} flop, {nbytes} B, bound {bound!r} ms "
            f"({bound_by}), share {bound / ms:.4f}")
    # The widths between, on the benchmark's first B records: where the
    # fastest team changes (launch_geometry's threshold).
    for B in SWEEP_B:
        times = team_times((p_bench, XI, DT, gh3, bench[:B].float()))
        parts.append(f"gh3/B={B}/f32: " + ", ".join(
            f"P={p} {t!r} ms" for p, (t, _) in times.items()) + f"; default "
            f"P={launch_geometry(B, gh3.n_points, num_sms).team}")
    print(f"phase 3b kernel timing (CUDA events around the bare launch, 1 "
          f"warm-up + {TIMING_REPS} launches; {smi}; peaks 67/34 TFLOP/s "
          f"f32/f64, 3.35 TB/s): " + "; ".join(parts))
    return out


def phase_accuracy(device):
    from chirpgp_tpu_torch.apps import IFEstimationConfig, estimate_if_batched
    from chirpgp_tpu_torch.convert import params_from_jax
    from chirpgp_tpu_torch.utils import rmse
    data = np.load(ROOT / "results/data/toydata_const.npz")
    ys = torch.as_tensor(data["ys"][:1], dtype=torch.float32, device=device)
    tf = torch.as_tensor(data["true_freqs"], dtype=torch.float32, device=device)
    parts = []
    for name, (quad, ref_rmse, ref_nell) in GATES.items():
        params = params_from_jax(
            np.load(ROOT / f"results/reference/{name}_const.npz")["params"][0],
            torch.float32, device)
        est = estimate_if_batched(IFEstimationConfig(quadrature=quad), params, ys)
        r10 = 10.0 * float(rmse(tf, est["if_mean"][0]))
        nell = float(est["nell"][0])
        check(abs(r10 - ref_rmse) <= GATE_RMSE_ATOL,
              f"{name}: IF-RMSE x10 {r10} not within {GATE_RMSE_ATOL} of {ref_rmse}")
        check(abs(nell - ref_nell) <= GATE_NELL_RTOL * ref_nell,
              f"{name}: nell {nell} not within {GATE_NELL_RTOL} rel of {ref_nell}")
        parts.append(f"{name} IF-RMSE x10 {r10!r} (ref {ref_rmse}), "
                     f"nell {nell!r} (ref {ref_nell})")
    print("phase 4 accuracy: " + "; ".join(parts))


def scaled_dev(a, b):
    """max |a - b| over (1 + max |b|)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (1.0 + b.abs().max()))


def value_and_grad(fn, theta, device):
    """The objective's value and gradient at ``theta`` on ``device``, as
    float64 host tensors, and the wall time of the call."""
    th = theta.to(device).requires_grad_(True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = fn(th)
    grad, = torch.autograd.grad(value, th)
    value, grad = value.detach().cpu(), grad.cpu()
    return float(value), grad, time.perf_counter() - t0


def phase_mle(device):
    from unittest import mock
    import chirpgp_tpu_torch.apps.pipeline as pipeline
    from chirpgp_tpu_torch.apps import IFEstimationConfig, estimate_if
    from chirpgp_tpu_torch.convert import params_from_jax
    from chirpgp_tpu_torch.models import g, g_inv
    from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
    from chirpgp_tpu_torch.utils import rmse
    data = np.load(ROOT / "results/data/toydata_const.npz")
    y_host = torch.as_tensor(data["ys"][0], dtype=torch.float64)
    ys = y_host.to(device)
    tf = torch.as_tensor(data["true_freqs"], dtype=torch.float64, device=device)
    ref = {name: np.load(ROOT / f"results/reference/{name}_const.npz")
           for name in MLE_GATES}
    theta_star = g_inv(params_from_jax(ref["ghfs"]["params"][0]))
    theta0 = g_inv(torch.tensor(SMALL_PARAMS, dtype=torch.float64))
    cfg = IFEstimationConfig()
    cpu = torch.device("cpu")
    parts = []
    t_phase = time.perf_counter()

    ghfs_chirp_filter.launches = 0
    # a. float64 cov GHFS objective: card against host CPU, at theta* and
    # theta0.  The gradient nearly vanishes at the optimum, so there its
    # deviation is held to the gradient's scale at theta0.
    card_nll = pipeline.make_nll_fn(cfg, ys)
    host_nll = pipeline.make_nll_fn(cfg, y_host)
    v_star, g_star, t_star = value_and_grad(card_nll, theta_star, device)
    v0, g0, t0 = value_and_grad(card_nll, theta0, device)
    v_host, g_host, t_host = value_and_grad(host_nll, theta_star, cpu)
    v0_host, g0_host, _ = value_and_grad(host_nll, theta0, cpu)
    check(abs(v_star - MLE_NLL) <= MLE_NLL_RTOL * MLE_NLL,
          f"nll at theta* {v_star!r} not within {MLE_NLL_RTOL} of {MLE_NLL}")
    scale = float(g0_host.abs().max())
    devs = {}
    for at, (vc, gc, vh, gh) in (("theta*", (v_star, g_star, v_host, g_host)),
                                 ("theta0", (v0, g0, v0_host, g0_host))):
        check(np.isfinite(vc) and abs(vc - vh) <= 1e-9 * abs(vh),
              f"nll at {at}: card {vc!r} vs host {vh!r}")
        devs[at] = float((gc - gh).abs().max()) / scale
        check(devs[at] <= 1e-7, f"grad at {at}: card vs host {devs[at]} of "
                                f"max|grad(theta0)|")
    parts.append(
        f"5a cov GHFS f64 T={ys.shape[0]}: nll(theta*) card {v_star!r}, "
        f"host {v_host!r}; nll(theta0) card {v0!r}, host {v0_host!r}; max|d "
        f"grad| card vs host over max|grad(theta0)| {devs['theta*']:.3g} at "
        f"theta*, {devs['theta0']:.3g} at theta0; |grad(theta*)| "
        f"{float(g_star.norm())!r}, |grad(theta0)| {float(g0.norm())!r}; "
        f"value-and-grad card {t_star:.3f} s, {t0:.3f} s, host CPU "
        f"{t_host:.3f} s")

    # c. fit_mle from theta0, counting the objective's calls.
    calls = []

    def counted_make_nll_fn(_cfg, _ys):
        def nll(theta):
            calls.append(1)
            return card_nll(theta)
        return nll

    with mock.patch.object(pipeline, "make_nll_fn", counted_make_nll_fn):
        opt, t_fit = timed(pipeline.fit_mle,
                           dataclasses.replace(cfg, max_iters=MLE_ITERS),
                           ys, theta0)
    f_fit = float(opt.fun_val)
    check(np.isfinite(f_fit) and f_fit < v0,
          f"fit_mle: final nll {f_fit!r} not finite and below {v0!r}")
    parts.append(
        f"5c fit_mle scipy {int(opt.num_iters)} iters, {len(calls)} "
        f"objective calls, nll {v0!r} -> {f_fit!r}, success "
        f"{bool(opt.success)}; {t_fit:.3f} s = {t_fit / len(calls):.3f} s "
        f"per value-and-grad on the card (host CPU {t_host:.3f} s, once)")

    # d. estimate_if gates, float64.
    for name, want in MLE_GATES.items():
        params = params_from_jax(ref[name]["params"][0], device=device)
        est, t_est = timed(estimate_if, IFEstimationConfig(method=name),
                           params, ys)
        check(bool(torch.isfinite(est["if_mean"]).all()),
              f"{name}: non-finite if_mean")
        r10 = 10.0 * float(rmse(tf, est["if_mean"]))
        check(abs(r10 - want) <= GATE_RMSE_ATOL,
              f"{name}: IF-RMSE x10 {r10!r} not within {GATE_RMSE_ATOL} of {want}")
        parts.append(f"5d estimate_if {name} f64 IF-RMSE x10 {r10!r} (ref "
                     f"{want}), nell {float(est['nell'][-1])!r}, "
                     f"{t_est:.3f} s")
    path_launches = ghfs_chirp_filter.launches

    # b. float32 sqrt objective at theta* against the kernel's nll[-1].
    th32 = theta_star.to(device, torch.float32)
    with torch.no_grad():
        v32, t32 = timed(pipeline.make_nll_fn(IFEstimationConfig(form="sqrt"),
                                              ys.float()), th32)
        _, _, nll_k = ghfs_chirp_filter(g(th32), XI, DT, cfg.sigma_points(),
                                        ys.float()[None])
    check(v32.dtype == torch.float32, f"sqrt objective dtype {v32.dtype}")
    rel = abs(float(v32) - float(nll_k[-1, 0])) / abs(float(nll_k[-1, 0]))
    check(rel <= FULL_BOUNDS["float32"][2],
          f"sqrt f32 objective {float(v32)!r} vs kernel nll "
          f"{float(nll_k[-1, 0])!r}: rel {rel}")
    parts.insert(1, f"5b sqrt GHFS f32 nll(theta*) {float(v32)!r} ({t32:.3f} "
                    f"s) vs CUDA kernel {float(nll_k[-1, 0])!r}: rel {rel:.3g}")
    print(f"phase 5 MLE path ({time.perf_counter() - t_phase:.3f} s; kernel "
          f"launches in 5a/5c/5d: {path_launches}): " + "; ".join(parts))


def phase_fused(device, if_ref, t_ref):
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.infer.batched import (
        cov_sgp_filter_smoother_batched, gaussian_expectation_batched,
        sqrt_sgp_filter_batched, sqrt_sgp_filter_smoother_batched,
        sqrt_sgp_smoother_batched)
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
    cfg = IFEstimationConfig()
    rule = cfg.sigma_points()
    parts = []
    t_phase = time.perf_counter()

    def args(dtype, yss):
        pack = cfg.build(g(cfg.default_init_theta()).to(device, dtype))
        return (pack.m_and_cov, rule, pack.H, XI, pack.m0, pack.P0, DT, yss)

    ghfs_chirp_filter.launches = 0
    yss = measurements(FUSED_SMALL_B, FUSED_SMALL_T, 7, torch.float64, device)
    a = args(torch.float64, yss)
    mfs, Lfs, nll = sqrt_sgp_filter_batched(*a)
    mss, Lss = sqrt_sgp_smoother_batched(a[0], rule, mfs, Lfs, DT)
    Pss = torch.einsum("tikb,tjkb->tijb", Lss, Lss)
    ms_f, Ls_f, nll_f = sqrt_sgp_filter_smoother_batched(*a)
    Ps_f = torch.einsum("tikb,tjkb->tijb", Ls_f, Ls_f)
    ms_c, Ps_c, nll_c = sqrt_sgp_filter_smoother_batched(
        *a, return_factors=False)
    vm, vv, nll_s = sqrt_sgp_filter_smoother_batched(
        *a, return_factors=False, out_index=2)
    ms_k, Ps_k, nll_k = cov_sgp_filter_smoother_batched(*a)
    devs = {"fused vs separate": (scaled_dev(ms_f, mss), scaled_dev(Ps_f, Pss),
                                  scaled_dev(nll_f, nll)),
            "cov form vs sqrt fused": (scaled_dev(ms_k, ms_c),
                                       scaled_dev(Ps_k, Ps_c),
                                       scaled_dev(nll_k, nll_c))}
    for what, vals in devs.items():
        for key, val in zip(("mss", "Pss", "nll"), vals):
            check(val <= FUSED_F64_BOUND, f"6: {what} {key} {val} > "
                                          f"{FUSED_F64_BOUND}")
        parts.append(f"{what} (scaled mss, Pss, nll) "
                     f"{', '.join(f'{v:.3g}' for v in vals)}")
    slim_equal = (torch.equal(vm, ms_c[:, 2]) and torch.equal(vv, Ps_c[:, 2, 2])
                  and torch.equal(nll_s, nll_c))
    check(slim_equal, "6b: slim output is not bit-equal to the full slices")
    parts.insert(0, f"6a-c B={FUSED_SMALL_B} T={FUSED_SMALL_T} f64; slim == "
                    f"full slices: {slim_equal}")

    yss = measurements(B_FULL, T_FULL, 999, torch.float32, device)
    (vm, vv, nll), t_fused = timed(sqrt_sgp_filter_smoother_batched,
                                   *args(torch.float32, yss),
                                   return_factors=False, out_index=2)
    for name, x in (("v_mean", vm), ("v_var", vv), ("nll", nll)):
        check(bool(torch.isfinite(x).all()), f"6d: non-finite {name}")
    if_mean = gaussian_expectation_batched(vm, vv.clamp_min(0.0).sqrt(),
                                           order=cfg.expectation_order).T
    dev = scaled_dev(if_mean, if_ref)
    check(dev <= FUSED_IF_BOUND,
          f"6d: fused IF mean vs estimate_if_batched {dev} > {FUSED_IF_BOUND}")
    parts.append(
        f"6d slim fused B={B_FULL} T={T_FULL} f32: {1e3 * t_fused:.3f} ms = "
        f"{B_FULL * T_FULL / t_fused:.1f} steps/s (estimate_if_batched, "
        f"phase 3: {1e3 * t_ref:.3f} ms = {B_FULL * T_FULL / t_ref:.1f} "
        f"steps/s); GH-10 IF mean vs phase 3's: scaled {dev:.3g} (bound "
        f"{FUSED_IF_BOUND})")
    print(f"phase 6 fused filter+smoother ({time.perf_counter() - t_phase:.3f}"
          f" s; kernel launches: {ghfs_chirp_filter.launches}): "
          + "; ".join(parts))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import chirpgp_tpu_torch
    except ImportError as exc:
        print(f"chip_smoke: cannot import chirpgp_tpu_torch beside this "
              f"script ({exc})", file=sys.stderr)
        return 2
    if ROOT not in Path(chirpgp_tpu_torch.__file__).resolve().parents:
        print(f"chip_smoke: chirpgp_tpu_torch was imported from "
              f"{chirpgp_tpu_torch.__file__}, not from beside this script",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = phase_environment(device)
    max_err = phase_kernel_vs_plain(device)
    launches, ms_p, if_ref, t_ref = phase_slice(device)
    timing = phase_kernel_timing(device, smi)
    phase_accuracy(device)
    phase_mle(device)
    phase_fused(device, if_ref, t_ref)
    full = timing["gh3/B=4096/f32"]
    print(json.dumps({"kernels": [{
        "name": "ghfs_chirp_filter", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": full["ms"], "plain_ms": ms_p,
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": None, "ms_b100": timing["gh3/B=100/f32"]["ms"],
        "ms_f64": timing["gh3/B=4096/f64"]["ms"],
        "bound_ms_f64": timing["gh3/B=4096/f64"]["bound_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
