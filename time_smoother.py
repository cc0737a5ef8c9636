#!/usr/bin/env python3
"""CUDA-event times of the chirp smoother's phases A and B on one NVIDIA
GPU, for the shipped kernel source and for timing-only variants of it, and
the SASS instruction counts of every kernel instance of the shipped build.

    python3 time_smoother.py [--out DIR]

A variant is ``chirpgp_tpu_torch/ops/csrc/ghfs_chirp_smoother.cu`` (with
``csrc/chirp_lcd.cuh``) under one text substitution, built by ``nvcc``
with the port's flags into ``DIR/<variant>/`` (default
``chirpgp_tpu_torch/ops/_build/variants``, beside the port's own builds);
a substitution that finds nothing to replace stops the script.  No
variant is used by the port; each asks what bounds a phase:

- ``launch_bounds_7``, ``launch_bounds_8``: phase A held to 7 or 8 blocks
  of 64 threads per SM (more warps, fewer registers a thread);
- ``threads_32``, ``threads_256``: phase A's blocks of 32 or 256 threads;
- ``no_transcendentals``: the LCD mean's softplus and sincospi replaced by
  two arithmetic operations (wrong values, the same data flow);
- ``no_shuffles``: the Householder's butterfly shuffles replaced by an
  addition each (wrong values, the same data flow);
- ``stages_2``: phase B's ring two steps deep instead of four.

Phase A with GH-3's 11 rows per member and phase B run alone, float32,
on the filter kernel's outputs at ``chip_smoke.py``'s benchmark shape
(B=4096, T=3141, its measurements and parameters): the mean over 6
launches after one warm-up (``chip_smoke.event_ms``).  Prints the
``nvidia-smi`` name and power limit, one line per variant (its times, and
whether phase A's rows and phase B's means keep the shipped source's
bits), and one line per kernel instance: its SASS instructions in all and
by opcode (``cuobjdump -sass``).
"""

import argparse
import collections
import concurrent.futures
import ctypes
import math
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from chip_smoke import B_FULL as B, DT, T_FULL as T, XI, event_ms, nvidia_smi
from chirpgp_tpu_torch.ops import _build
from chirpgp_tpu_torch.ops.chirp_filter import (
    _chirp_constants, ghfs_chirp_filter)
from chirpgp_tpu_torch.ops.chirp_smoother import (
    ROW_WORDS, load_smoother_kernel)

_ROWS_KERNEL = ("__global__ void __launch_bounds__(kRowsThreads)\n"
                "smoother_rows_kernel(")
# name -> (file, text, replacement)
VARIANTS = {
    "launch_bounds_7": ("ghfs_chirp_smoother.cu", _ROWS_KERNEL,
                        _ROWS_KERNEL.replace("(kRowsThreads)",
                                             "(kRowsThreads, 7)")),
    "launch_bounds_8": ("ghfs_chirp_smoother.cu", _ROWS_KERNEL,
                        _ROWS_KERNEL.replace("(kRowsThreads)",
                                             "(kRowsThreads, 8)")),
    "threads_32": ("ghfs_chirp_smoother.cu",
                   "constexpr int kRowsThreads = 64;",
                   "constexpr int kRowsThreads = 32;"),
    "threads_256": ("ghfs_chirp_smoother.cu",
                    "constexpr int kRowsThreads = 64;",
                    "constexpr int kRowsThreads = 256;"),
    "no_transcendentals": (
        "chirp_lcd.cuh",
        "dsincospi(Real(2) * c.dt * softplus(chi[kV]), &sn, &cs);",
        "sn = chi[kV] * c.dt; cs = Real(1) - sn;"),
    "no_shuffles": (
        "ghfs_chirp_smoother.cu",
        "for (int k = j; k < kD2; ++k) g2[k] += __shfl_xor_sync(mask, g2[k], "
        "o, P);",
        "for (int k = j; k < kD2; ++k) g2[k] += g2[k] * Real(o);"),
    "stages_2": ("ghfs_chirp_smoother.cu", "constexpr int kStages = 4;",
                 "constexpr int kStages = 2;"),
}


def variant_sources(name: str) -> dict:
    """{file name: text} of the sources of variant ``name`` (``"shipped"``
    for the sources as they are).  Raises if a substitution finds nothing
    to replace."""
    sources = {f: (_build.CSRC / f).read_text()
               for f in ("ghfs_chirp_smoother.cu", "chirp_lcd.cuh")}
    if name != "shipped":
        file, text, replacement = VARIANTS[name]
        if text not in sources[file]:
            raise ValueError(f"variant {name}: {text!r} is not in {file}")
        sources[file] = sources[file].replace(text, replacement)
    return sources


def _build_variant(name: str, out: Path) -> Path:
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    for file, text in variant_sources(name).items():
        (d / file).write_text(text)
    lib = d / "lib.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(d / "ghfs_chirp_smoother.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-2000:]}")
    return lib


def _bench_inputs(device):
    """The filter kernel's float32 outputs on ``chip_smoke.py``'s benchmark
    measurements (``gen_chirp(meow_freq(offset=8))`` + sqrt(Xi) N(0, 1),
    noise from ``default_rng(999)``) at the default parameters."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.toymodels import constant_mag, gen_chirp, meow_freq
    cfg = IFEstimationConfig()
    params = g(cfg.default_init_theta()).to(torch.float32)
    ts = torch.linspace(DT, DT * T, T, dtype=torch.float64, device=device)
    base = gen_chirp(ts, constant_mag(1.0), meow_freq(offset=8.0)[1])
    noise = np.random.default_rng(999).standard_normal((B, T))
    ys = (base[None] + math.sqrt(XI) * torch.as_tensor(
        noise, device=device)).float()
    rule = cfg.sigma_points()
    mfs, Lfs, _ = ghfs_chirp_filter(params, XI, DT, rule, ys)
    return params, rule, mfs, Lfs


def sass_counts(path: Path) -> dict:
    """{kernel instance: Counter of SASS opcodes} of a built library."""
    sass = subprocess.run([str(Path(_build.find_nvcc()).parent / "cuobjdump"),
                           "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts, func = collections.defaultdict(collections.Counter), None
    for ln in sass.splitlines():
        found = re.search(r"Function : (\S+)", ln)
        if found:
            found = re.search(r"([a-z_]+)_kernelI([fd])((?:Li\d+E)*)",
                              found[1])
            func = " ".join([found[1], found[2], *re.findall(
                r"\d+", found[3])]) if found else None
            continue
        op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                      ln)
        if op and func:
            counts[func][op[1]] += 1
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path,
                        default=_build.BUILD_DIR / "variants")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_smoother.py needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    print(nvidia_smi(), flush=True)
    names = ["shipped", *VARIANTS]
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(
            lambda n: _build_variant(n, args.out), names)))

    params, rule, mfs, Lfs = _bench_inputs(device)
    S = rule.n_points
    like = dict(dtype=mfs.dtype, device=device)
    xi = torch.as_tensor(np.ascontiguousarray(rule.xi), **like)
    w = torch.as_tensor(np.asarray(rule.w), **like)
    sw = torch.sqrt(w)
    consts = _chirp_constants(params, 1.0, DT)
    c_consts = (ctypes.c_double * consts.size)(*consts.tolist())
    rows = torch.empty((T - 1, ROW_WORDS, B), **like)
    mss = torch.empty((T, 4, B), **like)
    lss = torch.empty((T, 16, B), **like)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    shipped = None
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        fa, fb = lib.smoother_rows_f32, lib.smoother_backward_f32
        fa.argtypes = ([ptr] * 5 + [ctypes.POINTER(ctypes.c_double)]
                       + [i32] * 5 + [ptr] * 2)
        fb.argtypes = [ptr] * 3 + [i32] * 3 + [ptr] * 3
        fa.restype = fb.restype = i32

        def phase_a():
            if fa(mfs.data_ptr(), Lfs.data_ptr(), xi.data_ptr(), w.data_ptr(),
                  sw.data_ptr(), c_consts, S, T, B, B, 11, rows.data_ptr(),
                  None):
                raise RuntimeError(f"{name}: phase A launch failed")

        def phase_b():
            if fb(mfs.data_ptr(), Lfs.data_ptr(), rows.data_ptr(), T, B, B,
                  mss.data_ptr(), lss.data_ptr(), None):
                raise RuntimeError(f"{name}: phase B launch failed")

        phase_a()
        phase_b()
        torch.cuda.synchronize()
        if shipped is None:
            shipped = (rows.clone(), mss.clone())
        same = (torch.equal(rows, shipped[0]), torch.equal(mss, shipped[1]))
        print(f"{name}: phase A {event_ms(phase_a)!r} ms, phase B "
              f"{event_ms(phase_b)!r} ms; bits of the shipped source: rows "
              f"{same[0]}, mss {same[1]}", flush=True)
    for func, count in sass_counts(load_smoother_kernel().path).items():
        print(f"SASS {func}: {sum(count.values())} instructions; " + ", ".join(
            f"{op} {n}" for op, n in count.most_common(14)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
