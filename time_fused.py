#!/usr/bin/env python3
"""CUDA-event times of the fused filter+smoother's forward kernel F
(``fused_forward``) on one NVIDIA GPU, for the shipped kernel source and
for timing-only variants of it, and the SASS instruction counts of every
kernel instance of the shipped build.

    python3 time_fused.py [--root DIR] [--variants all|none|NAME,...]
                          [--out DIR]

``--root`` times the package of another checkout of this repository (for
example the parent commit unpacked with ``git archive`` under the
git-ignored ``_checkout/``): its ``chirpgp_tpu_torch`` and ``chip_smoke``
are imported, its ``csrc`` is built, and F is launched through its own
``FusedKernels.forward``, so two designs are timed by one script in one
process each.

A variant is ``ghfs_chirp_fused.cu`` (with ``chirp_lcd.cuh``) under a few
text substitutions, built by ``nvcc`` with the port's flags into
``DIR/<variant>/`` (default ``ops/_build/variants`` of the timed
package).  A variant whose text is not in the timed source is skipped
with a note: the ``teamrows_*`` variants apply to the design in which the
team also built and stored the rows, the others (but the first, which
applies to both) to the design with consumer warps.  No variant is used
by the port; each asks what a part of F costs:

- ``no_transcendentals``: the LCD mean's softplus and sincospi replaced
  by two arithmetic operations (wrong values, the same data flow);
- ``teamrows_no_right_columns``: no columns 4..7 of the joint array and no
  maps or row stores (what nothing of the carry reads);
- ``teamrows_no_update``: every member's measurement update replaced by a
  copy of m_p and R11 (the lane's scalar work that every member repeats);
- ``teamrows_no_row_stores``: no row stores, and with them nothing of the
  maps (the member-specific store branches);
- ``no_consumer``: the consumer warps take each step's hand-off and
  release it, and compute and store nothing (the team alone);
- ``no_consumer_rows``: the consumers build and store no row (they store
  the nll and the moments);
- ``consumer_unrolled``: the consumer's triangularization unrolled in
  registers (``joint_tria``) instead of its loops over shared memory:
  the same work in ~1.3k more instructions of code;
- ``team_full_mask``: the team's shuffles under a full warp mask;
- ``ring_8``: the hand-off ring eight steps deep, not four;
- ``one_consumer``: one consumer warp, which takes every step.

For the consumer-warp design it also times F at B=4096 float32 in maps
mode at other launch geometries than ``fused_geometry``'s: blocks of 16
lanes (256 blocks, every SM busy) and a team of 32 with 8 lanes per
block.

Each case of ``chip_smoke.py``'s 6e (GH-3 at B=4096 x T=3141 on its
benchmark measurements, float32 and float64, and the 100 records of
toydata_const at the reference's GHFS optimum, float32) times F in maps
and factor mode and the filter kernel, the mean over 6 launches after one
warm-up (``chip_smoke.event_ms``); the variants run F in maps mode at
B=4096 and B=100, float32, and say whether their rows keep the shipped
source's bits.  Prints the ``nvidia-smi`` name and power limit, one line
per case and variant, and one line per kernel instance: its SASS
instructions in all and by opcode (``cuobjdump -sass``).
"""

import argparse
import collections
import concurrent.futures
import ctypes
import functools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

_FILES = ("ghfs_chirp_fused.cu", "chirp_lcd.cuh")
_LCD = "dsincospi(Real(2) * c.dt * softplus(chi[kV]), &sn, &cs);"
# name -> [(file, text, replacement), ...]
VARIANTS = {
    "no_transcendentals": [("chirp_lcd.cuh", _LCD,
                            "sn = chi[kV] * c.dt; cs = Real(1) - sn;")],
    "teamrows_no_right_columns": [
        ("ghfs_chirp_fused.cu", "for (int j = 0; j < kJCols; ++j) {",
         "for (int j = 0; j < kD; ++j) {"),
        ("ghfs_chirp_fused.cu",
         "if (t > 0) {   // the row that smooths time t-1", "if (false) {")],
    "teamrows_no_update": [
        ("ghfs_chirp_fused.cu",
         "measurement_update(c, R11, mp, y, m, L, nll);",
         "for (int k = 0; k < kD; ++k) m[k] = mp[k] + y * Real(1e-3); "
         "for (int i = 0; i < kD; ++i) for (int j = 0; j <= i; ++j) "
         "L[i][j] = R11[j][i]; nll += y;")],
    "teamrows_no_row_stores": [
        ("ghfs_chirp_fused.cu",
         "if (t > 0) {   // the row that smooths time t-1", "if (false) {")],
    "no_consumer": [
        ("ghfs_chirp_fused.cu", "if (active) {   // the consumer's work",
         "if (false) {")],
    "no_consumer_rows": [
        ("ghfs_chirp_fused.cu", "if (t > 0 && t < T) {", "if (false) {")],
    "consumer_unrolled": [
        ("ghfs_chirp_fused.cu", "joint_tria_shared(W);",
         "{ Real M[kJ][kJCols]; _Pragma(\"unroll\") for (int i = 0; i < "
         "kWork; ++i) M[i / kJCols][i % kJCols] = W[i * kLanes]; "
         "joint_tria<kJCols>(M); _Pragma(\"unroll\") for (int i = 0; i < "
         "kWork; ++i) W[i * kLanes] = M[i / kJCols][i % kJCols]; }")],
    "team_full_mask": [
        ("ghfs_chirp_fused.cu", """  const unsigned mask = team_mask<P>();
  const size_t Bs = static_cast<size_t>(B);
  const int base = kGroup * member;""", """  const unsigned mask = 0xffffffffu;
  const size_t Bs = static_cast<size_t>(B);
  const int base = kGroup * member;""")],
    "ring_8": [("ghfs_chirp_fused.cu", "constexpr int kRing = 4;",
                "constexpr int kRing = 8;")],
    "one_consumer": [("ghfs_chirp_fused.cu", "constexpr int kConsumers = 4;",
                      "constexpr int kConsumers = 1;")],
}


def variant_sources(csrc: Path, name: str):
    """{file name: text} of the sources of variant ``name`` (``"shipped"``
    for the sources as they are), or None where a substitution finds
    nothing to replace in ``csrc``."""
    sources = {f: (csrc / f).read_text() for f in _FILES}
    for file, text, replacement in VARIANTS.get(name, ()):
        if text not in sources[file]:
            return None
        sources[file] = sources[file].replace(text, replacement)
    return sources


def _build_variant(build, csrc: Path, name: str, out: Path):
    """The path of variant ``name``'s library, built into ``out/name``, or
    None where it does not apply to ``csrc``."""
    sources = variant_sources(csrc, name)
    if sources is None:
        return None
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    for file, text in sources.items():
        (d / file).write_text(text)
    lib = d / "lib.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib), str(d / _FILES[0])],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-2000:]}")
    return lib


def sass_counts(nvcc: str, path: Path) -> dict:
    """{kernel instance: Counter of SASS opcodes} of a built library."""
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts, func = collections.defaultdict(collections.Counter), None
    for ln in sass.splitlines():
        found = re.search(r"Function : (\S+)", ln)
        if found:
            found = re.search(r"([a-z_]+)_kernelI([fd])((?:L[ib]\d+E)*)",
                              found[1])
            func = " ".join([found[1], found[2], *re.findall(
                r"\d+", found[3])]) if found else None
            continue
        op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                      ln)
        if op and func:
            counts[func][op[1]] += 1
    return counts


def _declare_like(lib: ctypes.CDLL, like: ctypes.CDLL):
    """The C signatures of ``like``'s F and G entry points on ``lib``."""
    for name in ("fused_forward_f32", "fused_forward_f64",
                 "affine_backward_f32", "affine_backward_f64"):
        fn, ref = getattr(lib, name), getattr(like, name)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return lib


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parent)
    parser.add_argument("--variants", default="all")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    from chip_smoke import (B_FULL, DT, ROOT, T_FULL, XI, event_ms,
                            measurements, nvidia_smi)
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.convert import params_from_jax
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops import _build, chirp_fused
    from chirpgp_tpu_torch.ops.chirp_filter import kernel_launcher
    from chirpgp_tpu_torch.ops.chirp_fused import (
        ROW_WORDS, FusedKernels, load_fused_kernel)
    if not torch.cuda.is_available():
        raise SystemExit("time_fused.py needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    print(f"{nvidia_smi()} | timing the package of {ROOT}", flush=True)
    names = {"all": list(VARIANTS), "none": []}.get(
        args.variants, [n for n in args.variants.split(",") if n])
    out = args.out or _build.BUILD_DIR / "variants"
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool:
        shipped = pool.submit(load_fused_kernel)
        libs = dict(zip(names, pool.map(
            lambda n: _build_variant(_build, _build.CSRC, n, out), names)))
        shipped = shipped.result()
    for name, path in libs.items():
        if path is not None:
            print(f"SASS of {name}: " + ", ".join(
                f"{func} {sum(count.values())}" for func, count in
                sass_counts(_build.find_nvcc(), path).items()
                if func.startswith("fused_forward f")), flush=True)

    cfg = IFEstimationConfig()
    rule = cfg.sigma_points()
    bench = measurements(B_FULL, T_FULL, 999, torch.float64, device)
    y100 = torch.as_tensor(
        np.load(ROOT / "results/data/toydata_const.npz")["ys"],
        dtype=torch.float32, device=device)
    opt = params_from_jax(np.load(
        ROOT / "results/reference/ghfs_const.npz")["params"][0])
    cases = {"B=4096/f32": (g(cfg.default_init_theta()), bench.float()),
             "B=4096/f64": (g(cfg.default_init_theta()), bench),
             "B=100/f32": (opt, y100)}
    for tag, (params, yss) in cases.items():
        B, T = yss.shape
        like = dict(dtype=yss.dtype, device=device)
        kernels = FusedKernels(params, XI, DT, rule, yss.dtype, device)
        ys_t = yss.T.contiguous()
        rows = torch.empty((T - 1, ROW_WORDS, B), **like)
        nll = torch.empty((T, B), **like)
        mf, lf = (torch.empty((1, n, B), **like) for n in (4, 16))
        mfs, lfs = (torch.empty((T, n, B), **like) for n in (4, 16))

        def maps():
            kernels.forward(ys_t, rows, mf, lf, nll, False)

        ms = {"F maps": event_ms(maps)}
        ref = (rows.clone(), nll.clone())
        ms["F factors"] = event_ms(
            lambda: kernels.forward(ys_t, rows, mfs, lfs, nll, True))
        launch, _ = kernel_launcher(params.to(torch.float64).cpu(), XI, DT,
                                    rule, yss)
        ms["filter kernel"] = event_ms(launch)
        del launch, mfs, lfs
        print(f"{tag} T={T}: " + ", ".join(f"{k} {v!r} ms"
                                           for k, v in ms.items()), flush=True)
        if yss.dtype != torch.float32:
            continue
        if B > 100 and hasattr(chirp_fused, "fused_geometry"):
            shipped_geometry = chirp_fused.fused_geometry
            for team, lanes in ((8, 16), (32, 8)):
                chirp_fused.fused_geometry = functools.partial(
                    shipped_geometry, team=team, lanes=lanes)
                t = event_ms(maps)
                print(f"  team {team}, {lanes} lanes per block: F maps {t!r} ms"
                      f" ({t - ms['F maps']:+.3f} ms)", flush=True)
            chirp_fused.fused_geometry = shipped_geometry
        for name, path in libs.items():
            if path is None:
                print(f"  {name}: not in this source", flush=True)
                continue
            kernels.lib = _declare_like(ctypes.CDLL(str(path)), shipped.lib)
            t = event_ms(maps)
            same = (torch.equal(rows, ref[0]), torch.equal(nll, ref[1]))
            print(f"  {name}: F maps {t!r} ms ({t - ms['F maps']:+.3f} ms); "
                  f"bits of the shipped source: rows {same[0]}, nll "
                  f"{same[1]}", flush=True)
        del rows, kernels
        torch.cuda.empty_cache()
    for func, count in sass_counts(_build.find_nvcc(), shipped.path).items():
        print(f"SASS {func}: {sum(count.values())} instructions; " + ", ".join(
            f"{op} {n}" for op, n in count.most_common(14)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
