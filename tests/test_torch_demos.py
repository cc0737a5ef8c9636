"""The port's demos (``chirpgp_tpu_torch/demos``) against the JAX
package's ``demos/*.py`` on the same records, on the CPU at a small size,
in float64: every number each prints (learnt params, IF-RMSE, iteration
counts, IF ranges) agrees to its last printed digit, or within 1e-6
relative where it is printed in exponent form (1e-12 absolute: a learnt
parameter pinned at its bound of 0 prints as 1e-13 or so, and there the
two packages part by 1e-6 relative).  The JAX demo runs in a
subprocess (``JAX_ENABLE_X64=1``) while the port's runs in this process.

Sizes: ``ghfs_mle`` T=100 and 5 iterations; ``ghfs_harmonics_mle`` T=60;
``classical_methods`` at its fixed T=3141; ``bats_analysis`` on a
synthetic Myotis-like call written by ``scipy.io.wavfile``, cropped to 20
samples (the Myotis configuration amplifies round-off about 3x per step,
so the two packages part at the printed digit within 40 samples; ROADMAP
Queue 3); ``ligo_analysis`` on two 100-sample strain files cut from the
synthetic GW150914 records of ``experiments/run_ligo``.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chirpgp_tpu_torch.demos import (
    bats_analysis, classical_methods, ghfs_harmonics_mle, ghfs_mle,
    ligo_analysis)
from chirpgp_tpu_torch.experiments.run_ligo import synth_gw150914

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


@pytest.fixture(autouse=True)
def _default_dtype():
    dtype = torch.get_default_dtype()
    yield
    torch.set_default_dtype(dtype)


def start_jax_demo(name, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
    return subprocess.Popen([sys.executable, str(ROOT / "demos" / name),
                             *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            env=env)


def numbers(text):
    """The numbers of ``text`` as printed, wall times left out."""
    lines = [ln for ln in text.splitlines() if "wall time" not in ln]
    return NUMBER.findall("\n".join(lines))


def assert_same_printout(port_out, proc):
    jax_out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    got, want = numbers(port_out), numbers(jax_out)
    assert len(got) == len(want) > 0, (port_out, jax_out)
    for g, w in zip(got, want):
        if g == w:
            continue
        if "e" in w.lower():
            np.testing.assert_allclose(float(g), float(w), rtol=1e-6,
                                       atol=1e-12)
        else:
            decimals = len(w.split(".")[1]) if "." in w else 0
            assert abs(float(g) - float(w)) <= 1.01 * 10.0 ** -decimals, \
                (g, w, port_out, jax_out)
    return port_out


def test_ghfs_mle_matches_jax_demo(capsys):
    args = ["--T", "100", "--max-iters", "5", "--x64"]
    proc = start_jax_demo("ghfs_mle.py", *args)
    ghfs_mle.main(args + ["--device", "cpu"])
    out = assert_same_printout(capsys.readouterr().out, proc)
    assert out.count("IF RMSE") == 3 and "[random_ou]" in out


def test_ghfs_harmonics_mle_matches_jax_demo(capsys):
    proc = start_jax_demo("ghfs_harmonics_mle.py", "--T", "60")
    ghfs_harmonics_mle.main(["--T", "60", "--x64", "--device", "cpu"])
    out = assert_same_printout(capsys.readouterr().out, proc)
    assert "converged=" in out and "IF RMSE" in out


def test_classical_methods_match_jax_demo(capsys):
    proc = start_jax_demo("classical_methods.py")
    classical_methods.main(["--x64", "--device", "cpu"])
    out = assert_same_printout(capsys.readouterr().out, proc)
    for name in ("hilbert", "spectrogram", "anf", "poly-mle"):
        assert f"[{name}] IF RMSE" in out


def test_bats_analysis_matches_jax_demo(tmp_path, capsys):
    """A Myotis-like call (4 harmonics sweeping 60 -> 25 kHz at 250 kHz
    under a Gaussian envelope, plus 0.01 N(0, 1)), samples 6600-6700."""
    from scipy.io import wavfile
    fs, n = 250000, 25334
    ts = np.arange(n) / fs
    freq = 60e3 - 35e3 * ts / (n / fs)
    phase = np.cumsum(freq) / fs
    env = np.exp(-0.5 * ((ts - n / fs / 2) / (n / fs / 5)) ** 2)
    call = env * sum(0.6 ** (k - 1) * np.sin(2 * np.pi * k * phase)
                     for k in range(1, 5))
    call += 0.01 * np.random.default_rng(0).standard_normal(n)
    wav = tmp_path / "call.wav"
    wavfile.write(wav, fs, call[6600:6700])
    args = ["--wav", str(wav), "--species", "myotis", "--crop-end", "20"]
    proc = start_jax_demo("bats_analysis.py", *args)
    bats_analysis.main(args + ["--x64", "--device", "cpu"])
    out = assert_same_printout(capsys.readouterr().out, proc)
    assert "T=20 samples at fs=250000 Hz, 4 harmonics" in out


def test_ligo_analysis_matches_jax_demo(tmp_path, capsys):
    paths = []
    for name, (ts, ys, _, _) in zip("HL", synth_gw150914()):
        path = tmp_path / f"{name}.txt"
        np.savetxt(path, np.stack([ts.numpy(), ys.numpy()], 1)[400:500])
        paths.append(str(path))
    proc = start_jax_demo("ligo_analysis.py", "--data", *paths)
    ligo_analysis.main(["--data", *paths, "--x64", "--device", "cpu"])
    out = assert_same_printout(capsys.readouterr().out, proc)
    assert out.count("IF range") == 2
