#!/usr/bin/env python3
"""Time the Table-I sweep objective on the card.

    python3 time_sweep_objective.py [--B 6 300] [--T 300 3141]
    python3 time_sweep_objective.py --adjoint [--designs] [--variants NAME ..]
                                    [--widths B ..] [--root DIR]
    python3 time_sweep_objective.py --breakdown

By default, one batched value-and-grad in three forms, on the same
inputs, in one process:

- ``kernels``: ``make_nll_fn``'s route, the per-lane filter kernel and
  its adjoint (``ops/chirp_filter_grad.py``) under the port's
  ``fit/lbfgs.py::batched_value_and_grad``, one launch of each;
- ``eager vmap + autograd``: the eager square-root filter (the Python loop
  of ``infer/sqrt.py``) under the same ``batched_value_and_grad``, a
  vmapped forward and one ``torch.autograd.grad`` of the summed values;
- ``eager vmap(grad)``: ``torch.func.vmap(torch.func.grad_and_value(nll))``
  of the eager filter.

Seeds 0..B/3-1 of each magnitude of ``results/data``, sqrt GHFS, GH-3,
float32, at the default init.  For each B and T the forms run in turns
(kernels, eager vmap + autograd, eager vmap(grad), kernels); each line
gives the host-clock seconds around synchronized work, ms per step, the
peak memory, and the largest deviation from the first turn's values
(relative) and gradients (over max |grad|).  The kernels are built
before the first turn.

``--adjoint`` times the adjoint kernel alone (``adjoint_launcher``, CUDA
events, ``chip_smoke.event_ms``) at ``chip_smoke.py``'s bare-launch cases:
the Table-I column (seeds 0-99 of each magnitude, B=300, T=3141) in
float32 and float64 and bench.py's B=4096, T=3141 in float32, GH-3, the
default init, beside its bound (``adjoint_cost``), with the geometry its
wrapper picks.  ``--designs`` adds the other geometries of this tree's
wrapper: the chain design with one lane a block and with the other
producer count, and the designs and teams the wrapper does not pick at
that width (the team design at B=300, the chain design at B=4096).
``--variants NAME ..`` times copies of the source under ``VARIANTS``'
substitutions against the shipped build, in turns, in the wrapper's
geometry.  ``--widths B ..`` adds float32 cases at other widths
(bench.py's measurements).  ``--root DIR`` times the package of another
checkout of this repository (for example the parent commit unpacked
with ``git archive`` under the git-ignored ``_checkout/``): its
``chirpgp_tpu_torch`` and ``chip_smoke.py`` are imported and its
kernels built, so two designs are timed by this script in one process
each, in turns within one call.

``--breakdown`` builds a copy of this tree's adjoint source with
``clock64()`` stamps between the parts of one step of its team design
(a team of 32 at B=300: the design at that width before the producer
and chain warps): the recomputed forward (sigma points, LCD
means, the deviations and the Gram's parts), the m_p and Gram
reductions, ``update_adjoint``, the points' adjoints, the 14-word
reduction, L^-1 and the factor's adjoint.  The copy is built by
``nvcc`` with the port's flags into
``chirpgp_tpu_torch/ops/_build/variants/adjoint_stamps/`` and run at
B=300, T=3141, GH-3 and cubature, float32 and float64 (and GH-3 at
B=4096 with the team of 8): cycles per step of each part on member 0 of
each lane, averaged over the lanes, and the share of the carried chain
(``update_adjoint``, the points' adjoints, the 14-word reduction and the
factor's adjoint without L^-1), with the chain floor: its cycles per
step times T at the card's SM clock.  The stamps cost time themselves
(they keep the compiler from moving code across them); the line gives
the stamped launch's CUDA-event time and the shipped launch's in the
same geometry.

Every mode prints the card's ``nvidia-smi`` name and power limit first.
"""

import argparse
import ctypes
import inspect
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FORMS = {"kernels": "kernels", "eager": "eager vmap + autograd",
         "eager_grad": "eager vmap(grad)"}
# The adjoint cases: (tag, B, dtype).
ADJOINT_CASES = (("B=300/f32", 300, torch.float32),
                 ("B=300/f64", 300, torch.float64),
                 ("B=4096/f32", 4096, torch.float32))
# The parts of a step of the team design, in the order of the stamps'
# indices, and which of them carry the chain.
PARTS = ("recompute", "m_p reduction", "Gram reduction", "update_adjoint",
         "point adjoints", "14-word reduction", "factor adjoint",
         "L^-1")
CHAIN_PARTS = ("update_adjoint", "point adjoints", "14-word reduction",
               "factor adjoint")
# Timing-only variants of the adjoint's source (--variants): name ->
# [(text, replacement)].  butterfly: the chain design's reductions by
# team_sum's butterfly instead of team_allreduce (the same bits).
VARIANTS = {"butterfly": [
    (f"    team_allreduce<P>(mask, member, {w});\n",
     f"    team_sum<P>(mask, {w});\n") for w in ("mp", "gram", "red")]}
STAMP_LANES = 8192
_STAMP_HEADER = f"""
#define STAMP(k) {{ const long long now_ = clock64(); \\
  stamps_[k] += now_ - stamp_prev_; stamp_prev_ = now_; }}
__device__ long long g_adjoint_stamps[{STAMP_LANES} * {len(PARTS)}];
extern "C" int ghfs_chirp_filter_adjoint_stamps(long long* out, int n) {{
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_adjoint_stamps, sizeof(long long) * n));
}}
"""
# (text, replacement) in the team kernel's body; each must occur once.
_STAMPS = (
    ("  for (int t = T - 1; t >= 0; --t) {\n",
     f"  long long stamps_[{len(PARTS)}] = {{}};\n"
     "  long long stamp_prev_ = clock64();\n"
     "  for (int t = T - 1; t >= 0; --t) {\n"),
    ("    team_sum<P>(mask, mp);\n",
     "    STAMP(0) team_sum<P>(mask, mp); STAMP(1)\n"),
    ("    team_sum<P>(mask, gram);\n",
     "    STAMP(0) team_sum<P>(mask, gram); STAMP(2)\n"),
    ("    sums.add_step(G, S_bar);\n",
     "    sums.add_step(G, S_bar); STAMP(3)\n"),
    ("    team_sum<P>(mask, red);\n",
     "    STAMP(4) team_sum<P>(mask, red); STAMP(5)\n"),
    ("      lower_inverse(L, inv);\n",
     "      STAMP(6) lower_inverse(L, inv); STAMP(7)\n"),
    ("      write_initial<Real, P>(member, red, out);\n    }\n  }\n",
     "      write_initial<Real, P>(member, red, out);\n    }\n    STAMP(6)\n"
     "  }\n"
     f"  if (member == 0 && b < {STAMP_LANES})\n"
     f"    for (int q = 0; q < {len(PARTS)}; ++q)\n"
     f"      g_adjoint_stamps[b * {len(PARTS)} + q] = stamps_[q];\n"),
)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def stamped_sources(csrc: Path) -> dict:
    """{file name: text}: the adjoint source with the stamps in its team
    kernel, and the header it includes.  Raises if a stamp's text is not
    in the team kernel exactly once."""
    src = (csrc / "ghfs_chirp_filter_adjoint.cu").read_text()
    head = src.index("adjoint_team_kernel(const Real*")
    tail = src.index("int launch_team(", head)
    body = src[head:tail]
    for text, replacement in _STAMPS:
        if body.count(text) != 1:
            raise ValueError(f"stamp: {text!r} is not in the team kernel "
                             f"once")
        body = body.replace(text, replacement)
    include = '#include "chirp_lcd.cuh"\n'
    src = src[:head] + body + src[tail:]
    src = src.replace(include, include + _STAMP_HEADER, 1)
    return {"ghfs_chirp_filter_adjoint.cu": src,
            "chirp_lcd.cuh": (csrc / "chirp_lcd.cuh").read_text()}


def _build_copy(build, out: Path):
    """nvcc ``out/ghfs_chirp_filter_adjoint.cu`` with the port's flags into
    ``out/lib.so``; ``BuiltLibrary`` with the C signatures of
    ``load_adjoint_kernel``'s (and the stamps', where the copy has them)."""
    lib_path = out / "lib.so"
    t0 = time.perf_counter()
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib_path),
                           str(out / "ghfs_chirp_filter_adjoint.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {out.name}:\n"
                           f"{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ghfs_chirp_filter_adjoint_f32,
               lib.ghfs_chirp_filter_adjoint_f64):
        fn.argtypes = [ptr] * 7 + [i32] * 8 + [ptr, ptr]
        fn.restype = i32
    if hasattr(lib, "ghfs_chirp_filter_adjoint_stamps"):
        lib.ghfs_chirp_filter_adjoint_stamps.argtypes = [ptr, i32]
        lib.ghfs_chirp_filter_adjoint_stamps.restype = i32
    return build.BuiltLibrary(lib, lib_path, time.perf_counter() - t0,
                              proc.stdout + proc.stderr)


def build_stamped(build):
    """nvcc the stamped copy (:func:`stamped_sources`) into
    ``ops/_build/variants/adjoint_stamps/``."""
    out = build.BUILD_DIR / "variants" / "adjoint_stamps"
    out.mkdir(parents=True, exist_ok=True)
    for name, text in stamped_sources(build.CSRC).items():
        (out / name).write_text(text)
    return _build_copy(build, out)


def objective_inputs(cs, B, dtype, device, quadrature="gauss_hermite"):
    """``(rule, consts, ys, mfs, lfs, gbar)`` of a bare adjoint launch at
    ``chip_smoke.py``'s cases (``cs`` the imported script): the Table-I
    records at B=300, bench.py's measurements at B=4096, the default init
    theta, the per-lane forward's outputs, gbar = 1."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.ops.chirp_filter_grad import forward_launcher
    cfg = IFEstimationConfig(method="ghfs", form="sqrt",
                             quadrature=quadrature)
    rule = cfg.sigma_points()
    if B == 300:
        ys = cs.sweep_data(device, slice(0, cs.SWEEP_SEEDS),
                           cs.SWEEP_T)[0].to(dtype)
    else:
        ys = cs.measurements(B, cs.T_FULL, 999, dtype, device)
    consts = cs.sweep_lane_constants(
        cfg.default_init_theta(dtype).to(device).expand(B, -1))
    launch, (mfs, lfs, _) = forward_launcher(consts, rule, ys)
    launch()
    gbar = torch.ones(B, dtype=dtype, device=device)
    return rule, consts, ys, mfs, lfs, gbar


def lane_deviation(got, want) -> float:
    """The largest over lanes (rows) of max |got - want| over the lane's
    max |want|."""
    g, w = got.double(), want.double()
    return float(((g - w).abs().amax(1) / w.abs().amax(1)).max())


def other_geometries(cg, B, S, sms, dtype) -> list:
    """The geometries ``--designs`` times beside the wrapper's: the chain
    design with one lane a block and with the other producer count, and
    the design and teams the wrapper does not pick at this width."""
    default = cg.adjoint_geometry(B, S, sms, dtype)
    chain = cg.adjoint_geometry(B, S, sms, dtype, design="chain")
    other_k = {2: 3, 3: 2}[chain.producers]
    geos = [chain._replace(lanes_per_block=1, blocks=B,
                           ring=min(cg.CHAIN_MAX_RING,
                                    chain.ring * chain.lanes_per_block))]
    if (chain.rows, other_k) in cg.CHAIN_PRODUCERS:
        geos.append(cg.adjoint_geometry(B, S, sms, dtype, design="chain",
                                        producers=other_k))
    geos += [chain] + [cg.adjoint_geometry(B, S, sms, dtype, design="team",
                                           team=team)
                       for team in sorted(cg.TEAM_ROWS)]
    return [g for i, g in enumerate(geos) if g != default
            and g not in geos[:i]]


def build_variant(build, name: str):
    """nvcc the adjoint source under VARIANTS[name] (each text must occur)
    into ``ops/_build/variants/adjoint_<name>/``; ``BuiltLibrary`` with
    ``load_adjoint_kernel``'s C signatures."""
    out = build.BUILD_DIR / "variants" / f"adjoint_{name}"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "ghfs_chirp_filter_adjoint.cu").read_text()
    for text, replacement in VARIANTS[name]:
        if text not in src:
            raise ValueError(f"variant {name}: {text!r} is not in the "
                             f"adjoint's source")
        src = src.replace(text, replacement)
    (out / "ghfs_chirp_filter_adjoint.cu").write_text(src)
    (out / "chirp_lcd.cuh").write_text((build.CSRC / "chirp_lcd.cuh")
                                       .read_text())
    return _build_copy(build, out)


def time_adjoint(args, device) -> int:
    import chip_smoke as cs
    import chirpgp_tpu_torch.ops.chirp_filter_grad as cg
    from chirpgp_tpu_torch.ops import _build
    print(f"{smi()} | the adjoint of the package of "
          f"{_build.CSRC.parents[2]}", flush=True)
    shipped = cg.load_adjoint_kernel()
    variants = {n: build_variant(_build, n) for n in args.variants}
    takes_geometry = "geometry" in inspect.signature(
        cg.adjoint_launcher).parameters
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cases = list(ADJOINT_CASES) + [(f"B={B}/f32", B, torch.float32)
                                   for B in args.widths]
    for tag, B, dtype in cases:
        rule, consts, ys, mfs, lfs, gbar = objective_inputs(cs, B, dtype,
                                                            device)
        S, T = rule.n_points, ys.shape[1]
        _, _, b_ms, by = cs.bound_ms(S, T, B, dtype, cg.adjoint_cost)
        geometries = [None]
        if takes_geometry and args.designs:
            geometries += other_geometries(cg, B, S, sms, dtype)
        first = None
        for geo in geometries:
            kw = {"geometry": geo} if takes_geometry else {}
            launch, dconsts = cg.adjoint_launcher(consts, rule, ys, mfs,
                                                  lfs, gbar, **kw)
            ms = cs.event_ms(launch)
            shown = geo or (cg.adjoint_geometry(B, S, sms, dtype)
                            if takes_geometry else "a team of 32")
            first = dconsts.clone() if first is None else first
            print(f"adjoint {tag} T={T} GH-3: {ms!r} ms, bound {b_ms:.4f} "
                  f"ms ({by}), {100 * b_ms / ms:.2f}% of it; finite "
                  f"{bool(torch.isfinite(dconsts).all())}, from the first "
                  f"geometry's {lane_deviation(dconsts, first):.3g} of each "
                  f"lane's max; geometry {shown}", flush=True)
        for name, built in variants.items():
            times = {"shipped": [], name: []}
            outs = {}
            for turn in ("shipped", name, "shipped", name):
                lib = shipped if turn == "shipped" else built
                with mock.patch.object(cg, "load_adjoint_kernel",
                                       lambda lib=lib: lib):
                    launch, outs[turn] = cg.adjoint_launcher(
                        consts, rule, ys, mfs, lfs, gbar)
                times[turn].append(cs.event_ms(launch))
            print(f"adjoint {tag} T={T} GH-3, variant {name} in turns with "
                  f"the shipped source: {times[name]!r} ms against "
                  f"{times['shipped']!r} ms; the same bits "
                  f"{bool(torch.equal(outs[name], outs['shipped']))}",
                  flush=True)
        del mfs, lfs
        torch.cuda.empty_cache()
    return 0


def stamp_breakdown(built, consts, rule, ys, mfs, lfs, gbar, sms, team,
                    clock_mhz) -> dict:
    """One step of the team design (a team of ``team``) broken into
    ``PARTS`` by the stamped copy ``built`` (:func:`build_stamped`) on the
    inputs of a bare adjoint launch: cycles per step of each part on
    member 0 of each lane, averaged over the lanes; their total and the
    chain's (``CHAIN_PARTS``); the chain floor, the chain's cycles a step
    times T at ``clock_mhz``; the CUDA-event ms of the stamped launch and
    of the shipped one in the same geometry, and whether their outputs
    have the same bits."""
    import chip_smoke as cs
    import chirpgp_tpu_torch.ops.chirp_filter_grad as cg
    B, T = ys.shape
    S = rule.n_points
    geo = cg.adjoint_geometry(B, S, sms, ys.dtype, design="team", team=team)
    launch, d_ship = cg.adjoint_launcher(consts, rule, ys, mfs, lfs, gbar,
                                         geometry=geo)
    shipped_ms = cs.event_ms(launch)
    with mock.patch.object(cg, "load_adjoint_kernel", lambda: built):
        launch, d_stamp = cg.adjoint_launcher(consts, rule, ys, mfs, lfs,
                                              gbar, geometry=geo)
    stamped_ms = cs.event_ms(launch)
    torch.cuda.synchronize()
    raw = (ctypes.c_longlong * (STAMP_LANES * len(PARTS)))()
    rc = built.lib.ghfs_chirp_filter_adjoint_stamps(raw,
                                                   STAMP_LANES * len(PARTS))
    if rc:
        raise RuntimeError(f"reading the stamps: CUDA error {rc}")
    cycles = np.frombuffer(raw, dtype=np.int64).reshape(
        STAMP_LANES, len(PARTS))[:B].astype(np.float64) / T
    per = dict(zip(PARTS, cycles.mean(0).tolist()))
    chain = sum(per[p] for p in CHAIN_PARTS)
    return dict(parts=per, total=sum(per.values()), chain=chain,
                chain_floor_ms=1e3 * chain * T / (clock_mhz * 1e6),
                stamped_ms=stamped_ms, shipped_ms=shipped_ms,
                same_bits=bool(torch.equal(d_ship, d_stamp)), geometry=geo)


def breakdown(device) -> int:
    import chip_smoke as cs
    from chirpgp_tpu_torch.ops import _build
    built = build_stamped(_build)
    clock = cs.sm_clock_mhz()
    print(f"{smi()} | stamped copy built in {built.build_seconds:.1f} s; "
          f"SM clock {clock} MHz (clocks.max.sm)", flush=True)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cases = [(f"B=300/{d}/{q}", 300, dt, q, 32)
             for q in ("gauss_hermite", "cubature")
             for d, dt in (("f32", torch.float32), ("f64", torch.float64))]
    cases.append(("B=4096/f32/gauss_hermite", 4096, torch.float32,
                  "gauss_hermite", 8))
    for tag, B, dtype, quad, team in cases:
        rule, consts, ys, mfs, lfs, gbar = objective_inputs(cs, B, dtype,
                                                            device, quad)
        T = ys.shape[1]
        r = stamp_breakdown(built, consts, rule, ys, mfs, lfs, gbar, sms,
                            team, clock)
        shipped = (f"shipped {r['shipped_ms']!r} ms (the same bits: "
                   f"{r['same_bits']})")
        print(f"breakdown {tag} T={T} team {team} ({r['geometry']}): stamped"
              f" {r['stamped_ms']!r} ms, {shipped}; cycles per step on "
              f"member 0, mean over lanes: " + ", ".join(
                  f"{p} {v:.1f}" for p, v in r["parts"].items())
              + f"; total {r['total']:.1f} = "
              f"{1e3 * r['total'] * T / (clock * 1e6):.4f} ms at {clock} "
              f"MHz; chain ({', '.join(CHAIN_PARTS)}) {r['chain']:.1f} "
              f"cycles, {100 * r['chain'] / r['total']:.1f}% of the step; "
              f"chain floor {r['chain_floor_ms']:.4f} ms", flush=True)
        del mfs, lfs
        torch.cuda.empty_cache()
    return 0


def value_and_grad_forms(args, device) -> int:
    from chirpgp_tpu_torch.apps import IFEstimationConfig, make_nll_fn
    from chirpgp_tpu_torch.apps.pipeline import _filter_fns, _on_data
    from chirpgp_tpu_torch.fit import batched_value_and_grad
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter import load_kernel
    from chirpgp_tpu_torch.ops.chirp_filter_grad import (
        ChirpFilterNLL, load_adjoint_kernel)

    print(smi(), flush=True)
    load_kernel(), load_adjoint_kernel()   # built before any turn is timed
    cfg = IFEstimationConfig(method="ghfs", form="sqrt")
    flt, _ = _filter_fns(cfg)
    data = [np.load(ROOT / f"results/data/toydata_{m}.npz")["ys"]
            for m in ("const", "damped", "random")]

    def nll(th, y):
        return make_nll_fn(cfg, y)(th)

    def eager_nll(th, y):
        return flt(cfg.build(g(_on_data(th, y))), y)[2][-1]

    for B, T in [(B, T) for B in args.B for T in args.T]:
        ys = torch.as_tensor(np.concatenate([d[:B // 3, :T] for d in data]),
                             dtype=torch.float32, device=device)
        theta = cfg.default_init_theta(torch.float32).to(device).expand(
            ys.shape[0], -1).clone()
        vmap_grad = torch.func.vmap(torch.func.grad_and_value(eager_nll))
        forms = {"kernels": batched_value_and_grad(nll, (ys,)),
                 "eager": batched_value_and_grad(eager_nll, (ys,)),
                 "eager_grad": lambda th: vmap_grad(th, ys)[::-1]}
        first = None
        for name in ("kernels", "eager", "eager_grad", "kernels"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            ChirpFilterNLL.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            values, grads = forms[name](theta)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
            first = first or (values.detach(), grads.detach())
            dv = float(((values - first[0]).abs() / first[0].abs()).max())
            dg = float((grads - first[1]).abs().max() / first[1].abs().max())
            launches = (f", kernel launches {dict(ChirpFilterNLL.launches)}"
                        if name == "kernels" else "")
            print(f"B={ys.shape[0]} T={T} {FORMS[name]}: {seconds:.4f} s = "
                  f"{1e3 * seconds / T:.4f} ms per step, peak "
                  f"{peak:.3f} GiB{launches}; against the first turn: value "
                  f"rel {dv:.3g}, grad {dg:.3g}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, nargs="+", default=[6, 300])
    ap.add_argument("--T", type=int, nargs="+", default=[300, 3141])
    ap.add_argument("--adjoint", action="store_true")
    ap.add_argument("--designs", action="store_true")
    ap.add_argument("--variants", nargs="*", default=[],
                    choices=sorted(VARIANTS))
    ap.add_argument("--widths", type=int, nargs="*", default=[])
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_sweep_objective: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    device = torch.device("cuda", 0)
    if args.breakdown:
        return breakdown(device)
    if args.adjoint:
        return time_adjoint(args, device)
    return value_and_grad_forms(args, device)


if __name__ == "__main__":
    sys.exit(main())
