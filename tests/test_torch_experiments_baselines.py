"""The port's baseline drivers (``chirpgp_tpu_torch/experiments``:
``run_classical``, ``run_kpt``, ``run_fhc``, ``run_fastnls``) against the
JAX package's scripts on the same records, seed by seed, on the CPU at a
small size, and the Table-I driver's ``--monolithic`` path over ranks.

Each JAX script runs in a subprocess (``JAX_ENABLE_X64=1`` where the
comparison runs in float64) while the port's driver runs in this process.

Tolerances, relative per seed: the classical columns (2 seeds, T=300,
float64) 1e-9, but the random records' Hilbert and spectrogram columns
1e-6 (measured 2.7e-7 and 1.9e-7; 1e-14 on the const and damped records:
the random magnitude, an OU path, crosses zero, and there the analytic
signal's angle and the spectrogram's first moment amplify the 5e-15 gap
of the two packages' records) and the polynomial LM 1e-4 (its stop rule falls at rounding
level, so the packages stop an iteration or two apart: measured 1.5e-5;
ROADMAP Queue 3); the spectrogram at T=500 (at T=300 a record is shorter
than a window and both columns are NaN); KPT (2 seeds, T=40, 2
iterations, float64) as ``test_torch_sweeps.py``: params 1e-5 absolute,
IF-RMSE 1e-6; FHC (2 seeds, T=320, float64) 1e-6 (JAX returns the float32
records' estimates in float32: measured 3.7e-7); fastF0NLS (1 seed,
T=1000, float64) 1e-12.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import torch

from chirpgp_tpu_torch.experiments import (
    run_classical, run_fastnls, run_fhc, run_kpt, run_rmse_table)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CLASSICAL_RTOL = {"hilbert": 1e-9, "anf": 1e-9, "poly": 1e-4,
                  "spectrogram": 1e-9}
ZERO_CROSSING_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _default_dtype():
    dtype = torch.get_default_dtype()
    yield
    torch.set_default_dtype(dtype)


def start_jax_script(path, *args, x64=False):
    """Start one of the JAX package's scripts on the CPU (float64 with
    ``x64``); ``finish`` waits for it."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if x64:
        env["JAX_ENABLE_X64"] = "1"
    return subprocess.Popen([sys.executable, str(ROOT / path), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT, env=env)


def finish(proc):
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    return out


def assert_same_columns(jax_dir, port_dir, names, rtol):
    for name in names:
        rj, rt = np.load(jax_dir / name), np.load(port_dir / name)
        assert rt.files == rj.files, name
        for k in rj.files:
            assert rt[k].shape == rj[k].shape and rt[k].dtype == rj[k].dtype
            if rj[k].dtype == bool:
                npt.assert_array_equal(rt[k], rj[k])
            else:
                npt.assert_allclose(rt[k], rj[k], rtol=rtol(name, k),
                                    atol=0, err_msg=f"{name} {k}")


def classical_rtol(name, _key):
    method, mag = name[:-len(".npz")].split("_")
    if mag == "random" and method in ("hilbert", "spectrogram"):
        return ZERO_CROSSING_RTOL
    return CLASSICAL_RTOL[method]


def test_run_classical_matches_jax_script(tmp_path):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    short = start_jax_script("experiments/run_classical.py", "--methods",
                             "hilbert", "anf", "poly", "--seeds", "2",
                             "--T", "300", "--out", str(jax_dir))
    run_classical.main(["--methods", "hilbert", "anf", "poly", "--seeds",
                        "2", "--T", "300", "--out", str(port_dir),
                        "--device", "cpu"])
    finish(short)
    spec = start_jax_script("experiments/run_classical.py", "--methods",
                            "spectrogram", "--seeds", "2", "--T", "500",
                            "--out", str(jax_dir))
    run_classical.main(["--methods", "spectrogram", "--seeds", "2", "--T",
                        "500", "--out", str(port_dir), "--device", "cpu"])
    finish(spec)
    names = [f"{m}_{mag}.npz" for m in CLASSICAL_RTOL
             for mag in ("const", "damped", "random")]
    assert_same_columns(jax_dir, port_dir, names, classical_rtol)
    assert np.all(np.isfinite(np.load(port_dir / "spectrogram_const.npz")
                              ["rmse"]))


def test_spectrogram_of_a_record_shorter_than_a_window_is_nan(tmp_path):
    """As in the JAX package: no frames, an empty estimate, NaN RMSE."""
    run_classical.main(["--methods", "spectrogram", "--seeds", "1", "--T",
                        "300", "--mags", "const", "--out", str(tmp_path),
                        "--device", "cpu"])
    assert np.isnan(np.load(tmp_path / "spectrogram_const.npz")["rmse"][0])


def test_run_kpt_matches_jax_script(tmp_path):
    args = ["--seeds", "2", "--T", "40", "--max-iters", "2"]
    proc = start_jax_script("experiments/run_kpt.py", *args, "--out",
                            str(tmp_path / "jax"), x64=True)
    run_kpt.main(args + ["--out", str(tmp_path / "port"), "--x64",
                         "--device", "cpu"])
    finish(proc)
    names = [f"kpt_{mag}.npz" for mag in ("const", "damped", "random")]
    for name in names:
        rj = np.load(tmp_path / "jax" / name)
        rt = np.load(tmp_path / "port" / name)
        assert rt.files == rj.files == ["params", "rmse", "success"]
        assert rt["params"].shape == (2, 5)
        npt.assert_array_equal(rt["success"], rj["success"])
        npt.assert_allclose(rt["params"], rj["params"], atol=1e-5, rtol=0)
        npt.assert_allclose(rt["rmse"], rj["rmse"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("num_harmonics", [1, 3])
def test_run_fhc_matches_jax_script(num_harmonics, tmp_path):
    """On the committed records cropped to T=320 (5 windows each: a
    window of the harmonic grid takes 38 MB in float64)."""
    prefix = "toydata" if num_harmonics == 1 else f"toydata_h{num_harmonics}"
    data = tmp_path / "data"
    data.mkdir()
    for mag in ("const", "random"):
        d = np.load(ROOT / f"results/data/{prefix}_{mag}.npz")
        np.savez(data / f"{prefix}_{mag}.npz", ys=d["ys"][:2, :320],
                 true_freqs=d["true_freqs"][:320], ts=d["ts"][:320],
                 keys=d["keys"][:2])
    args = ["--seeds", "2", "--num-harmonics", str(num_harmonics), "--mags",
            "const", "random", "--data-dir", str(data)]
    proc = start_jax_script("experiments/run_fhc.py", *args, "--out",
                            str(tmp_path / "jax"), x64=True)
    run_fhc.main(args + ["--out", str(tmp_path / "port"), "--x64",
                         "--device", "cpu"])
    finish(proc)
    prefix = "harmonic_fhc" if num_harmonics > 1 else "fhc"
    assert_same_columns(tmp_path / "jax", tmp_path / "port",
                        [f"{prefix}_{m}.npz" for m in ("const", "random")],
                        lambda *_: 1e-6)


def test_run_fastnls_matches_jax_script(tmp_path):
    args = ["--seeds", "1", "--T", "1000"]
    proc = start_jax_script("experiments/run_fastnls.py", *args, "--out",
                            str(tmp_path / "jax"), x64=True)
    run_fastnls.main(args + ["--out", str(tmp_path / "port"), "--x64",
                             "--device", "cpu"])
    finish(proc)
    assert_same_columns(tmp_path / "jax", tmp_path / "port",
                        [f"fastf0nls_{m}.npz"
                         for m in ("const", "damped", "random")],
                        lambda *_: 1e-12)


def test_monolithic_sweep_splits_over_torchrun_ranks(tmp_path):
    """``--monolithic`` on the JAX package's records of its keys: one rank
    in this process and three ``gloo`` ranks under ``torchrun`` write the
    same column."""
    args = ["--monolithic", "--seeds", "3", "--T", "40", "--max-iters", "3",
            "--mags", "const", "--device", "cpu"]
    ranks = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "3", "-m",
         "chirpgp_tpu_torch.experiments.run_rmse_table", *args, "--out",
         str(tmp_path / "ranks")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    run_rmse_table.main(args + ["--out", str(tmp_path / "one")])
    out = finish(ranks)
    assert "the JAX package's records of its keys" in out \
        and "3 rank(s)" in out
    one = np.load(tmp_path / "one" / "ghfs_const.npz")
    split = np.load(tmp_path / "ranks" / "ghfs_const.npz")
    assert one.files == split.files == ["params", "rmse", "success"]
    assert one["params"].shape == (3, 6)
    for k in one.files:
        npt.assert_array_equal(split[k], one[k])
