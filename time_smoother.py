#!/usr/bin/env python3
"""CUDA-event times of the chirp smoother's phases A, B and E on one
NVIDIA GPU, for the shipped kernel source and for timing-only variants of
it, a sweep of phase B's chunk count, and the SASS instruction counts of
every kernel instance of the shipped build.

    python3 time_smoother.py [--root DIR] [--variants all|none|NAME,...]
                             [--chunks C,...] [--out DIR]

``--root`` times the package of another checkout of this repository (for
example the parent commit unpacked with ``git archive`` under the
git-ignored ``_checkout/``): its ``chirpgp_tpu_torch`` is imported and its
``csrc`` built, and phase B runs through its own
``SmootherKernels.backward``, and phase E through its own
``SmootherKernels.expect`` and ``expectation_launcher``, so two designs
are timed by one script in one process each.

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
- ``stages_2``, ``stages_4``: phase B's rings two or four steps deep
  instead of three (at backward_chunks' C);
- ``e_accurate``: phase E's float32 ex2 and lg2 by the accurate exp2f and
  log2f instead of the special-function unit's approximations;
- ``e_no_pairs``: phase E's nodes one by one (two logarithms a pair);
- ``e_loop``: phase E's order 10 through the instance for any order;
- ``e_one_lane``: phase E's threads one lane each, 4- or 8-byte accesses;
- ``e_threads_64``, ``e_threads_256``: phase E's blocks of at most 64 or
  256 threads instead of 128.

Variants named ``e_*`` time phase E alone, in both its input modes, in
every case; the others time phases A and B at B=4096 float32.

Phase A with GH-3's 11 rows per member and phase B run alone on the
filter kernel's outputs at ``chip_smoke.py``'s benchmark shape (B=4096,
T=3141, its measurements and parameters) in float32 and float64, and on
its first 100 lanes (float32): the mean over 6 launches after one
warm-up (``chip_smoke.event_ms``).  Phase B at ``backward_chunks``' C and
at each C of ``--chunks`` (C = 1 is the one-thread-per-lane recursion of
the design before the chunks, Apply alone), each of Compose, Carry and
Apply alone and the three together, and its largest deviation from C = 1
over (1 + max |mss|).  Prints the ``nvidia-smi`` name and power limit, one
line per case and C, one line per variant (its times, and whether phase
A's rows and phase B's means keep the shipped source's bits), and one
line per kernel instance: its SASS instructions in all and by opcode
(``cuobjdump -sass``).
"""

import argparse
import collections
import concurrent.futures
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

_ROWS_KERNEL = ("__global__ void __launch_bounds__(kRowsThreads)\n"
                "smoother_rows_kernel(")
_SOFTPLUS_ASM = 'asm("{0}.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
# name -> (file, text, replacement): each replacement of ``text`` in
# ``file``, and (``e_accurate``) a second pair.
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
    "stages_2": ("ghfs_chirp_smoother.cu", "constexpr int kStages = 3;",
                 "constexpr int kStages = 2;"),
    "stages_4": ("ghfs_chirp_smoother.cu", "constexpr int kStages = 3;",
                 "constexpr int kStages = 4;"),
    "e_accurate": ("ghfs_chirp_smoother.cu", _SOFTPLUS_ASM.format("ex2"),
                   "y = exp2f(x);", _SOFTPLUS_ASM.format("lg2"),
                   "y = log2f(x);"),
    "e_no_pairs": ("ghfs_chirp_smoother.cu",
                   "SP::pair(ms, ss * rule.x[q])",
                   "(SP::one(ms + ss * rule.x[q]) + SP::one(ms - ss * "
                   "rule.x[q]))"),
    "e_loop": ("ghfs_chirp_smoother.cu",
               "K == kMainOrder ? main_order : any_order", "any_order"),
    "e_one_lane": ("ghfs_chirp_smoother.cu",
                   "constexpr int kLanes = 16 / static_cast<int>(sizeof(Real));",
                   "constexpr int kLanes = 1;"),
    "e_threads_64": ("ghfs_chirp_smoother.cu",
                     "constexpr int kExpectThreads = 128;",
                     "constexpr int kExpectThreads = 64;"),
    "e_threads_256": ("ghfs_chirp_smoother.cu",
                      "constexpr int kExpectThreads = 128;",
                      "constexpr int kExpectThreads = 256;"),
}
_PHASE_B = ("smoother_compose", "smoother_carry", "smoother_backward")


def variant_sources(build, name: str) -> dict:
    """{file name: text} of the sources of variant ``name`` (``"shipped"``
    for the sources as they are).  Raises if a substitution finds nothing
    to replace."""
    sources = {f: (build.CSRC / f).read_text()
               for f in ("ghfs_chirp_smoother.cu", "chirp_lcd.cuh")}
    if name != "shipped":
        file, *subs = VARIANTS[name]
        for text, replacement in zip(subs[::2], subs[1::2]):
            if text not in sources[file]:
                raise ValueError(f"variant {name}: {text!r} is not in {file}")
            sources[file] = sources[file].replace(text, replacement)
    return sources


def _build_variant(build, name: str, out: Path) -> Path:
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    for file, text in variant_sources(build, name).items():
        (d / file).write_text(text)
    lib = d / "lib.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib), str(d / "ghfs_chirp_smoother.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-2000:]}")
    return lib


def _bench_inputs(device, dtype, B_):
    """The filter kernel's outputs on ``chip_smoke.py``'s benchmark
    measurements (``gen_chirp(meow_freq(offset=8))`` + sqrt(Xi) N(0, 1),
    noise from ``default_rng(999)``) at the default parameters, lanes
    ``:B_``, and phase A's rows of them."""
    from chip_smoke import DT, T_FULL, XI, measurements
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
    from chirpgp_tpu_torch.ops.chirp_smoother import ROW_WORDS, SmootherKernels
    cfg = IFEstimationConfig()
    params = g(cfg.default_init_theta()).to(torch.float32)
    ys = measurements(4096, T_FULL, 999, torch.float64, device)[:B_]
    rule = cfg.sigma_points()
    mfs, Lfs, _ = ghfs_chirp_filter(params, XI, DT, rule, ys.to(dtype))
    kernels = SmootherKernels(params, DT, rule, 10, mfs.dtype, device)
    rows = mfs.new_empty((T_FULL - 1, ROW_WORDS, B_))
    kernels.rows(mfs, Lfs, rows)
    return params, rule, kernels, mfs, Lfs, rows


def sass_counts(build, path: Path) -> dict:
    """{kernel instance: Counter of SASS opcodes} of a built library."""
    sass = subprocess.run([str(Path(build.find_nvcc()).parent / "cuobjdump"),
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


def time_phase_b(event_ms, kernels, mfs, Lfs, rows, sweep):
    """Phase B's times: {C: {kernel: ms, "all": ms, "dev": scaled |d mss|
    from C = 1}} for ``backward_chunks``' C (key "default") and each C of
    ``sweep``; a package without chunks times its ``backward`` alone."""
    T, _, B_ = mfs.shape
    mss, lss = torch.empty_like(mfs), mfs.new_empty((T, 16, B_))
    back = getattr(kernels, "back", None)
    if back is None:
        return {"old design": {"all": event_ms(
            lambda: kernels.backward(mfs, Lfs, rows, mss, lss))}}
    out, ref = {}, None
    for C in [1, back.chunks(T, B_)] + [c for c in sweep if c < T]:
        key = "default" if C == back.chunks(T, B_) and "default" not in out \
            else C
        agg, bounds = back.scratch(B_, C)
        ms = {}
        if C > 1:
            ms["smoother_compose"] = event_ms(
                lambda: back.compose(mfs, rows, agg, C))
            ms["smoother_carry"] = event_ms(
                lambda: back.carry(mfs, Lfs, agg, bounds, C))
        ms["smoother_backward"] = event_ms(
            lambda: back.apply(mfs, Lfs, rows, bounds, mss, lss, C))
        ms["all"] = event_ms(lambda: back.run(mfs, Lfs, rows, mss, lss,
                                              chunks=C,
                                              scratch=(agg, bounds)))
        if ref is None:
            ref = mss.clone()
        ms["dev"] = float((mss.double() - ref.double()).abs().max()
                          / (1.0 + ref.double().abs().max()))
        ms["C"] = C
        out[key] = ms
        del agg, bounds
    return out


def phase_e_inputs(kernels, mfs, Lfs, rows):
    """Phase E's inputs in both modes from phase B's run on ``rows``: mss
    (T, 4, B), lss (T, 16, B), and V's mean and variance (T, B)."""
    T, _, B_ = mfs.shape
    mss, lss = torch.empty_like(mfs), mfs.new_empty((T, 16, B_))
    kernels.backward(mfs, Lfs, rows, mss, lss)
    return (mss, lss, mss[:, 2].contiguous(),
            (lss[:, 8:11] * lss[:, 8:11]).sum(1))


def time_phase_e(event_ms, kernels, inputs, order):
    """Phase E's times through the timed package: ``smoother_expect``
    (``SmootherKernels.expect``) and ``smoother_expect_var``
    (``expectation_launcher``), ms, and each one's largest deviation from
    the plain ``smoothed_expectation_batched`` over (1 + its max)."""
    from chirpgp_tpu_torch.infer.batched import (
        gaussian_expectation_batched, smoothed_expectation_batched)
    from chirpgp_tpu_torch.ops.chirp_smoother import expectation_launcher
    mss, lss, vm, vv = inputs
    T, _, B_ = mss.shape
    if_e = torch.empty_like(vm)
    out = {"smoother_expect": event_ms(lambda: kernels.expect(mss, lss, if_e))}
    launch, if_v = expectation_launcher(vm, vv, order)
    out["smoother_expect_var"] = event_ms(launch)
    plain = smoothed_expectation_batched(mss, lss.view(T, 4, 4, B_), 2, order)
    plain_v = gaussian_expectation_batched(vm, vv.clamp_min(0.0).sqrt(),
                                           order=order)
    for key, got, want in (("dev_expect", if_e, plain),
                           ("dev_expect_var", if_v, plain_v)):
        out[key] = float((got.double() - want.double()).abs().max()
                         / (1.0 + want.double().abs().max()))
    return out


def time_expect_variants(event_ms, libs, shipped, inputs, order):
    """Phase E's variants in both modes on ``inputs``, through ctypes with
    the shipped library's signatures: {name: (ms, ms_var, same bits as
    the shipped source in both modes)}."""
    from chirpgp_tpu_torch.ops.chirp_smoother import _gh_rule
    mss, lss, vm, vv = inputs
    T, _, B_ = mss.shape
    dt = "f32" if mss.dtype == torch.float32 else "f64"
    ghx, ghw = _gh_rule(order)
    out, base = {}, None
    for name, lib in libs:
        fns = []
        for k in ("smoother_expect", "smoother_expect_var"):
            fn, ref = getattr(lib, f"{k}_{dt}"), getattr(shipped, f"{k}_{dt}")
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
            fns.append(fn)
        if_e, if_v = torch.empty_like(vm), torch.empty_like(vm)

        def run(fn, a, b, o):
            if fn(a.data_ptr(), b.data_ptr(), ghx, ghw, order, T, B_,
                  o.data_ptr(), None):
                raise RuntimeError(f"{name}: phase E launch failed")

        times = (event_ms(lambda: run(fns[0], mss, lss, if_e)),
                 event_ms(lambda: run(fns[1], vm, vv, if_v)))
        if base is None:
            base = (if_e.clone(), if_v.clone())
        out[name] = times + (torch.equal(if_e, base[0])
                             and torch.equal(if_v, base[1]),)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parent)
    parser.add_argument("--variants", default="all")
    parser.add_argument("--chunks", default="2,4,16,32,64,128")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    from chip_smoke import T_FULL as T, event_ms, nvidia_smi
    from chirpgp_tpu_torch.ops import _build
    from chirpgp_tpu_torch.ops.chirp_filter import _chirp_constants
    from chirpgp_tpu_torch.ops.chirp_smoother import load_smoother_kernel
    if not torch.cuda.is_available():
        raise SystemExit("time_smoother.py needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    print(f"{nvidia_smi()} | timing the package of {_build.CSRC.parents[2]}",
          flush=True)
    names = {"all": list(VARIANTS), "none": []}.get(
        args.variants, [n for n in args.variants.split(",") if n])
    e_names = [n for n in names if n.startswith("e_")]
    out = args.out or _build.BUILD_DIR / "variants"
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool:
        shipped = pool.submit(load_smoother_kernel)
        libs = dict(zip(names, pool.map(
            lambda n: _build_variant(_build, n, out), names)))
        shipped = shipped.result()

    sweep = [int(c) for c in args.chunks.split(",") if c]
    for tag, dtype, B_ in (("B=4096/f32", torch.float32, 4096),
                           ("B=4096/f64", torch.float64, 4096),
                           ("B=100/f32", torch.float32, 100)):
        params, rule, kernels, mfs, Lfs, rows = _bench_inputs(device, dtype,
                                                              B_)
        for key, ms in time_phase_b(event_ms, kernels, mfs, Lfs, rows,
                                    sweep).items():
            print(f"{tag} T={T} phase B C={ms.get('C', 1)}"
                  f"{' (backward_chunks)' if key == 'default' else ''}: "
                  + ", ".join(f"{k} {v!r}" + ("" if k in ("dev", "C")
                                              else " ms")
                              for k, v in ms.items() if k != "C"),
                  flush=True)
        e_inputs = phase_e_inputs(kernels, mfs, Lfs, rows)
        e_ms = time_phase_e(event_ms, kernels, e_inputs, 10)
        print(f"{tag} T={T} phase E GH-10: " + ", ".join(
            f"{k} {v!r}" + ("" if k.startswith("dev") else " ms")
            for k, v in e_ms.items()), flush=True)
        if e_names:
            for name, (ms_e, ms_v, same) in time_expect_variants(
                    event_ms, [("shipped", shipped.lib)]
                    + [(n, ctypes.CDLL(str(libs[n]))) for n in e_names],
                    shipped.lib, e_inputs, 10).items():
                print(f"{tag} phase E {name}: smoother_expect {ms_e!r} ms, "
                      f"smoother_expect_var {ms_v!r} ms; bits of the shipped "
                      f"source: {same}", flush=True)
        del e_inputs
        libs_ab = {n: path for n, path in libs.items() if n not in e_names}
        if (dtype != torch.float32 or B_ != 4096 or not libs_ab
                or not hasattr(kernels, "back")):
            del kernels, mfs, Lfs, rows
            torch.cuda.empty_cache()
            continue
        # The variants, float32 at B=4096, through ctypes with the shipped
        # library's signatures.
        S = rule.n_points
        like = dict(dtype=mfs.dtype, device=device)
        xi = torch.as_tensor(np.ascontiguousarray(rule.xi), **like)
        w = torch.as_tensor(np.asarray(rule.w), **like)
        sw = torch.sqrt(w)
        consts = _chirp_constants(params, 1.0, 1e-3)
        c_consts = (ctypes.c_double * consts.size)(*consts.tolist())
        mss, lss = torch.empty_like(mfs), mfs.new_empty((T, 16, B_))
        back = kernels.back
        C = back.chunks(T, B_)
        agg, bounds = back.scratch(B_, C)
        base = None
        for name, path in [("shipped", shipped.path), *libs_ab.items()]:
            lib = ctypes.CDLL(str(path))
            for k in ("smoother_rows_f32",) + tuple(f"{k}_f32"
                                                    for k in _PHASE_B):
                fn, ref = getattr(lib, k), getattr(shipped.lib, k)
                fn.argtypes, fn.restype = ref.argtypes, ref.restype
            stream = None

            def phase_a():
                if lib.smoother_rows_f32(
                        mfs.data_ptr(), Lfs.data_ptr(), xi.data_ptr(),
                        w.data_ptr(), sw.data_ptr(), c_consts, S, T, B_, B_,
                        11, rows.data_ptr(), stream):
                    raise RuntimeError(f"{name}: phase A launch failed")

            def phase_b():
                for rc in (lib.smoother_compose_f32(
                               mfs.data_ptr(), rows.data_ptr(), T, B_, B_, C,
                               agg.data_ptr(), stream),
                           lib.smoother_carry_f32(
                               mfs.data_ptr(), Lfs.data_ptr(), agg.data_ptr(),
                               T, B_, B_, C, bounds.data_ptr(), stream),
                           lib.smoother_backward_f32(
                               mfs.data_ptr(), Lfs.data_ptr(),
                               rows.data_ptr(), bounds.data_ptr(), T, B_, B_,
                               C, mss.data_ptr(), lss.data_ptr(), stream)):
                    if rc:
                        raise RuntimeError(f"{name}: phase B launch failed")

            phase_a()
            phase_b()
            torch.cuda.synchronize()
            if base is None:
                base = (rows.clone(), mss.clone())
            same = (torch.equal(rows, base[0]), torch.equal(mss, base[1]))
            print(f"{name}: phase A {event_ms(phase_a)!r} ms, phase B (C={C}) "
                  f"{event_ms(phase_b)!r} ms; bits of the shipped source: "
                  f"rows {same[0]}, mss {same[1]}", flush=True)
        del kernels, mfs, Lfs, rows, mss, lss, agg, bounds
        torch.cuda.empty_cache()
    for func, count in sass_counts(_build, shipped.path).items():
        print(f"SASS {func}: {sum(count.values())} instructions; " + ", ".join(
            f"{op} {n}" for op, n in count.most_common(14))
            + f"; MUFU {count['MUFU']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
