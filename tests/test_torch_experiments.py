"""The port's entry points (``chirpgp_tpu_torch/experiments``,
``chirpgp_tpu_torch/demos``) against the JAX package's scripts: the
Table-I driver, its checkpoint resume, the table printer and the Fig. 5
driver, on the CPU at a small size.

Tolerances: ``run_rmse_table`` on the same cropped records (2 seeds of
``toydata_{const,random}``, T=40, 3 iterations, float64) the same
``success``, params within 1e-5 and IF-RMSE within 1e-6 relative, as
``test_torch_sweeps.py::test_sweep_on_measurements_matches_jax``; a
resumed run and a run beside a foreign checkpoint equal an uninterrupted
one bit for bit; ``print_table`` the same text; ``run_crlb`` the
committed file's keys and dtypes, its statistics equal to the in-process
``filter_error_mc_chunked`` on the same draws.
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu_torch.apps.sweeps as ts
from chirpgp_tpu_torch.apps.crlb import filter_error_mc_chunked
from chirpgp_tpu_torch.experiments import (
    print_table, run_crlb, run_rmse_table)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXPERIMENTS = ["gen_toymodel_data", "run_rmse_table", "print_table",
               "run_kpt", "run_classical", "run_fhc", "run_fastnls",
               "run_crlb", "print_time", "run_ligo"]
DEMOS = ["ghfs_mle", "ghfs_harmonics_mle", "classical_methods",
         "bats_analysis", "ligo_analysis"]
# The arguments a module needs besides --device.
REQUIRED = {"bats_analysis": ["--wav", "call.wav"],
            "ligo_analysis": ["--data", "H.txt"]}
SWEEP_ARGS = ["--methods", "ghfs", "--seeds", "2", "--mags", "const",
              "random", "--x64"]


@pytest.fixture(autouse=True)
def _default_dtype():
    """A driver's ``--x64`` sets torch's default dtype for its process;
    each test here gets it back."""
    dtype = torch.get_default_dtype()
    yield
    torch.set_default_dtype(dtype)


def jax_script(path, *args):
    """Run one of the JAX package's scripts on the CPU; its stdout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(ROOT / path), *args],
                          capture_output=True, text=True, check=True,
                          cwd=ROOT, env=env, timeout=900).stdout


def cropped_toydata(tmp_path, mags=("const", "random"), seeds=2, T=40):
    """A data directory of the committed ``toydata_{mag}`` records cropped
    to ``seeds`` seeds and T samples."""
    data = tmp_path / "data"
    data.mkdir()
    for mag in mags:
        d = np.load(ROOT / f"results/data/toydata_{mag}.npz")
        np.savez(data / f"toydata_{mag}.npz", ys=d["ys"][:seeds, :T],
                 true_freqs=d["true_freqs"][:T], ts=d["ts"][:T],
                 keys=d["keys"][:seeds])
    return data


def _module(name):
    package = "demos" if name in DEMOS else "experiments"
    return importlib.import_module(f"chirpgp_tpu_torch.{package}.{name}")


@pytest.mark.parametrize("name", EXPERIMENTS + DEMOS)
def test_entry_point_answers_help(name, capsys):
    with pytest.raises(SystemExit) as exit_:
        _module(name).main(["--help"])
    assert exit_.value.code == 0
    assert "usage:" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(set(EXPERIMENTS + DEMOS)
                                        - {"gen_toymodel_data",
                                           "print_table"}))
@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_point_raises_for_cuda_without_a_card(name):
    """``--device cuda`` (the default of every driver but the host-only
    ``run_fastnls``) never falls back to the CPU."""
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        _module(name).main(REQUIRED.get(name, []) + ["--device", "cuda"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_python_m_raises_for_cuda_without_a_card():
    proc = subprocess.run(
        [sys.executable, "-m", "chirpgp_tpu_torch.experiments.run_crlb",
         "--device", "cuda", "-num_mcs", "64"], capture_output=True,
        text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert proc.stdout == ""


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The port's driver on cropped records, 5 iterations, run once to
    its end: its output directory and the data directory."""
    tmp = tmp_path_factory.mktemp("uninterrupted")
    data = cropped_toydata(tmp)
    out = tmp / "out"
    dtype = torch.get_default_dtype()
    run_rmse_table.main(SWEEP_ARGS + ["--max-iters", "5", "--data-dir",
                                      str(data), "--out", str(out),
                                      "--device", "cpu"])
    torch.set_default_dtype(dtype)
    return out, data


def _assert_same_files(a, b):
    for mag in ("const", "random"):
        ra, rb = np.load(a / f"ghfs_{mag}.npz"), np.load(b / f"ghfs_{mag}.npz")
        assert ra.files == rb.files == ["params", "rmse", "success"]
        for k in ra.files:
            npt.assert_array_equal(ra[k], rb[k])


def test_run_rmse_table_matches_jax_driver(tmp_path, capsys):
    data = cropped_toydata(tmp_path)
    args = SWEEP_ARGS + ["--max-iters", "3", "--data-dir", str(data)]
    jax_script("experiments/run_rmse_table.py", *args, "--out",
               str(tmp_path / "jax"))
    run_rmse_table.main(args + ["--out", str(tmp_path / "port"),
                                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "--T 3141 is ignored" in out
    for mag in ("const", "random"):
        rj = np.load(tmp_path / "jax" / f"ghfs_{mag}.npz")
        rt = np.load(tmp_path / "port" / f"ghfs_{mag}.npz")
        assert rt.files == rj.files
        assert rt["params"].shape == (2, 6) and rt["params"].dtype == np.float64
        npt.assert_array_equal(rt["success"], rj["success"])
        npt.assert_allclose(rt["params"], rj["params"], atol=1e-5, rtol=0)
        npt.assert_allclose(rt["rmse"], rj["rmse"], rtol=1e-6, atol=0)
        assert f"ghfs                     {mag:8s}" in out
    assert not (tmp_path / "port" / ".ckpt_ghfs.npz").exists()


class Killed(Exception):
    pass


def _killed_after_the_stepped_stage(monkeypatch, argv):
    """Run the driver and kill it when the stepped L-BFGS has finished
    (its checkpoint written at iteration 5), before the rescue."""
    def kill(*args, **kwargs):
        raise Killed()

    with monkeypatch.context() as m:
        m.setattr(ts, "_rescue_stuck_lanes", kill)
        with pytest.raises(Killed):
            run_rmse_table.main(argv)


def test_killed_run_resumes_from_its_checkpoint(uninterrupted, tmp_path,
                                                monkeypatch, capsys):
    want, data = uninterrupted
    argv = SWEEP_ARGS + ["--max-iters", "5", "--data-dir", str(data),
                         "--out", str(tmp_path), "--device", "cpu"]
    _killed_after_the_stepped_stage(monkeypatch, argv)
    ckpt = tmp_path / ".ckpt_ghfs.npz"
    assert ckpt.exists() and int(np.load(ckpt)["it"]) == 5
    capsys.readouterr()
    run_rmse_table.main(argv)
    assert f"lbfgs resume from {ckpt} at iter 5" in capsys.readouterr().out
    assert not ckpt.exists()
    _assert_same_files(tmp_path, want)


def test_foreign_checkpoint_is_ignored(uninterrupted, tmp_path, monkeypatch,
                                       capsys):
    """A checkpoint of another sweep (here another ``--T`` in its tag) is
    announced and ignored; the run starts from iteration 0."""
    want, data = uninterrupted
    argv = SWEEP_ARGS + ["--max-iters", "5", "--data-dir", str(data),
                         "--out", str(tmp_path), "--device", "cpu"]
    _killed_after_the_stepped_stage(monkeypatch, argv + ["--T", "999"])
    capsys.readouterr()
    run_rmse_table.main(argv)
    out = capsys.readouterr().out
    assert "ignoring checkpoint" in out and "lbfgs resume" not in out
    _assert_same_files(tmp_path, want)


@pytest.mark.parametrize("mode", [[], ["--markdown"], ["--paired"],
                                  ["--paired", "--markdown"]],
                         ids=["default", "markdown", "paired",
                              "paired-markdown"])
def test_print_table_prints_the_jax_text(mode, capsys):
    args = ["--results", str(ROOT / "results"), "--reference",
            str(ROOT / "results/reference")] + mode
    want = jax_script("experiments/print_table.py", *args)
    print_table.main(args)
    got = capsys.readouterr().out
    assert got == want
    assert ("ghfs" in got) and len(got.splitlines()) > 20


def test_run_crlb_writes_the_committed_format(tmp_path, capsys):
    run_crlb.main(["-num_mcs", "64", "-T", "50", "--chunk", "16", "--pcrlb",
                   "--pcrlb-mcs", "64", "-out", str(tmp_path), "--device",
                   "cpu"])
    out = capsys.readouterr().out
    assert "lam=0.1 b=0.1: filter kernel launches 0" in out
    got = np.load(tmp_path / "crlb_ghf_lam0.1_b0.1.npz")
    committed = np.load(ROOT / "results/crlb_ghf_lam0.1_b0.1.npz")
    assert got.files == committed.files
    for k in got.files:
        assert got[k].dtype == committed[k].dtype, k
        assert got[k].shape == ((50,) if committed[k].ndim else ()), k
    assert int(got["num_mcs"]) == 64 and float(got["dt"]) == 0.01
    want = filter_error_mc_chunked(0.1, 0.1, 0.1, 1.0, 1.0, 0.1, 64, T=50,
                                   chunk=16, device="cpu")
    for k, v in want.items():
        npt.assert_allclose(got[k], v, rtol=1e-12, atol=0)
    assert np.all(np.isfinite(got["pcrlb_x2"])) and got["pcrlb_v"].min() > 0
