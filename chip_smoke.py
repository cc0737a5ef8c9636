#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Builds the hand-written CUDA kernel from ``chirpgp_tpu_torch/ops/csrc`` on
first use and drives the batched IF-estimation path once at full width.
Phases, one line each:

1. environment: card, ``nvidia-smi`` name and power limit, torch/CUDA
   versions, the kernel's nvcc build time and ptxas report;
2. kernel vs plain PyTorch version on the card: GH-3 and cubature at
   B=512, T=32 on 0.1 N(0, 1) measurements in float32 (atol 5e-5 on
   mfs/nll, 1e-4 on L L^T and on Lfs) and float64 (atol 1e-9), then GH-3
   at B=4096, T=3141 on the benchmark's data in float64 and float32
   (scaled bounds below), and each float32 version against the float64
   kernel, the on-card oracle;
3. ``estimate_if_batched`` at B=4096, T=3141, dt=1e-3, Xi=0.1, GH-3,
   float32: finite outputs, the kernel launched by the main path, wall
   times of the kernel, of the plain filter (in turns: plain, kernel,
   kernel, plain) and of the whole estimate;
4. accuracy gate: seed 0 of ``results/data/toydata_const.npz`` at the
   reference's learnt optimum, CKFS (cubature) and GHFS (GH-3), float32.

Every phase must pass; a failure ends the run with a nonzero exit code.
The line before the last is a JSON record of the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the ``chirpgp_tpu_torch`` package beside this script, it exits nonzero.
"""

import json
import math
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
KERNEL_SOURCE = "chirpgp_tpu_torch/ops/csrc/ghfs_chirp_filter.cu"
KERNEL_REPLACES = "chirpgp_tpu/experimental/pallas_filter.py:248"


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


def timed(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_environment(device):
    from chirpgp_tpu_torch.ops.chirp_filter import load_kernel
    from chirpgp_tpu_torch.ops._build import find_nvcc
    smi = nvidia_smi()
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    built = load_kernel()
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 1 environment: device={torch.cuda.get_device_name(device)}"
          f" | nvidia-smi: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {nvcc[-1] if nvcc else 'nvcc ?'} | "
          f"kernel build {built.build_seconds:.2f} s | ptxas: "
          f"{' / '.join(ptxas)}")
    print(smi)


def phase_kernel_vs_plain(device):
    from chirpgp_tpu_torch.ops.chirp_filter import (
        ghfs_chirp_filter, ghfs_chirp_filter_reference)
    from chirpgp_tpu_torch.quad import cubature, gauss_hermite
    rules = {"gh3": gauss_hermite(4, 3), "cubature": cubature(4)}
    parts = []
    # The small cases take tests/test_pallas_filter.py's inputs,
    # 0.1 N(0, 1), at which its absolute tolerances were set.
    small = 0.1 * np.random.default_rng(0).standard_normal((SMALL_B, SMALL_T))
    for dtype, tols in ((torch.float32, (5e-5, 1e-4, 1e-4, 5e-5)),
                        (torch.float64, (1e-9,) * 4)):
        yss = torch.as_tensor(small, dtype=dtype, device=device)
        for name, rule in rules.items():
            args = (SMALL_PARAMS, XI, DT, rule, yss)
            dev = deviations(ghfs_chirp_filter(*args),
                             ghfs_chirp_filter_reference(*args))
            tag = f"{name}/{str(dtype)[6:]}"
            for key, tol in zip(("mfs", "LLT", "Lfs", "nll"), tols):
                check(dev[key] <= tol, f"{tag}: max |d {key}| = {dev[key]} > {tol}")
            parts.append(f"{tag} mfs {dev['mfs']:.3g} LLT {dev['LLT']:.3g} "
                         f"Lfs {dev['Lfs']:.3g} nll {dev['nll']:.3g}")

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
    ms_k = 1e3 * sum(times["kernel"]) / 2
    ms_p = 1e3 * sum(times["plain"]) / 2
    print(f"phase 3 slice: estimate_if_batched B={B_FULL} T={T_FULL} GH-3 "
          f"float32: finite, kernel launches {launches}; filter kernel "
          f"{[round(1e3 * t, 3) for t in times['kernel']]} ms, plain filter "
          f"{[round(1e3 * t, 3) for t in times['plain']]} ms (order plain, "
          f"kernel, kernel, plain); whole estimate {1e3 * t_est:.3f} ms = "
          f"{B_FULL * T_FULL / t_est:.1f} steps/s")
    return launches, ms_k, ms_p


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
    phase_environment(device)
    max_err = phase_kernel_vs_plain(device)
    launches, ms_k, ms_p = phase_slice(device)
    phase_accuracy(device)
    print(json.dumps({"kernels": [{
        "name": "ghfs_chirp_filter", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": ms_k, "plain_ms": ms_p}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
