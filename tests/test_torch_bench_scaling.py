"""The port's scaling harness (``chirpgp_tpu_torch/experiments/
bench_scaling.py``) against the JAX package's ``bench_scaling.py`` on the
CPU: the per-seed value (the final NLL of the sqrt GHFS) on the JAX
script's keys and records against JAX's ``estimate_if(...)["nell"][-1]``
(4 seeds, T=64, float64, 1e-9 relative); two spawned ``gloo`` ranks
against one rank (float64, 1e-12 relative); and the two scripts' JSON
lines (the JAX script on two virtual devices, the port on two ranks):
the same metric and the same keys.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from chirpgp_tpu_torch.apps.sweeps import generate_rnd_keys
from chirpgp_tpu_torch.experiments import bench_scaling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--seeds", "8", "--T", "32"]


def test_seed_nell_matches_jax_script_per_seed():
    """The JAX script's ``per_seed`` in float64 on ``split(PRNGKey(0),
    4)`` against the port's batched values on the same keys."""
    from chirpgp_tpu.apps import IFEstimationConfig, estimate_if
    from chirpgp_tpu.models import g
    from chirpgp_tpu.toymodels import constant_mag, gen_chirp, meow_freq
    T, dt, Xi = 64, bench_scaling.DT, bench_scaling.XI
    ts = jnp.linspace(dt, dt * T, T)
    base = gen_chirp(ts, constant_mag(1.0), meow_freq(offset=8.0)[1])
    cfg = IFEstimationConfig(method="ghfs", form="sqrt")
    params = g(cfg.default_init_theta())
    want = [float(estimate_if(cfg, params, base + math.sqrt(Xi)
                              * jax.random.normal(k, (T,)))["nell"][-1])
            for k in jax.random.split(jax.random.PRNGKey(0), 4)]
    got = bench_scaling.seed_nell(generate_rnd_keys(4, seed=0), T, "cpu",
                                  torch.float64)
    assert got.dtype == torch.float64 and got.shape == (4,)
    npt.assert_allclose(got.numpy(), want, rtol=1e-9, atol=0)


@pytest.fixture(scope="module")
def lines():
    """The last stdout line of the JAX script on two virtual CPU devices
    and of the port's driver on two spawned gloo ranks in float64, run at
    the same time."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               OMP_NUM_THREADS="1")
    procs = {
        "jax": subprocess.Popen(
            [sys.executable, str(ROOT / "bench_scaling.py"), "--platform",
             "cpu", *ARGS], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen(
            [sys.executable, "-m",
             "chirpgp_tpu_torch.experiments.bench_scaling", "--ranks", "2",
             "--device", "cpu", "--x64", *ARGS], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, stderr[-3000:])
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


def test_same_metric_and_keys_as_the_jax_script(lines):
    jax_line, port = lines["jax"], lines["port"]
    assert port["metric"] == jax_line["metric"] \
        == "mc_sweep_seeds_per_sec_scaling"
    for key in ("seeds_per_sec", "efficiency_vs_1dev"):
        assert list(port[key]) == list(jax_line[key]) == ["1", "2"]
        assert all(v > 0 for v in port[key].values())
    assert port["card"] == "cpu"
    assert port["label"] == "contention, not scaling"
    assert port["seeds_per_rank"] == {"1": 8, "2": 4}
    # The CPU runs the kernels' plain versions: no launches.
    assert port["kernel_launches_per_rank"] == {"1": [0], "2": [0, 0]}
    assert port["smoother_launches_per_rank"] == {"1": [0], "2": [0, 0]}


def test_two_ranks_match_one_rank(lines):
    assert 0.0 <= lines["port"]["nell_rel_vs_1dev"]["2"] <= 1e-12


def test_cuda_is_the_default_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        bench_scaling.main(ARGS)
