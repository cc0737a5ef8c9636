"""The batched IF-estimation slice of the PyTorch port against the JAX
package, the seed-0 accuracy gates, the JAX-to-torch conversions, and the
port's import and precision policies."""

import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.apps.pipeline as jp
import chirpgp_tpu.models as jm
import chirpgp_tpu.quad as jq
import chirpgp_tpu_torch
import chirpgp_tpu_torch.apps as tp
import chirpgp_tpu_torch.models as tm
from chirpgp_tpu_torch.convert import params_from_jax, rule_from_jax
from chirpgp_tpu_torch.utils import rmse

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "chirpgp_tpu_torch"


def _np(x):
    return x.detach().cpu().numpy()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_estimate_if_batched_matches_jax(dtype):
    atol_m, atol_P, atol_if = {"float64": (1e-9, 1e-9, 1e-9),
                               "float32": (5e-5, 1e-4, 1e-4)}[dtype]
    ts = 1e-3 * np.arange(1, 65)
    ys = np.sin(2 * np.pi * 8.0 * ts)[None] + np.sqrt(0.1) * \
        np.random.default_rng(3).standard_normal((3, 64))
    params = np.asarray(jm.g(jp.IFEstimationConfig().default_init_theta()),
                        np.float64)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ej = jp.estimate_if_batched(jp.IFEstimationConfig(),
                                jnp.asarray(params, jdt), jnp.asarray(ys, jdt))
    et = tp.estimate_if_batched(tp.IFEstimationConfig(),
                                params_from_jax(params, tdt),
                                torch.tensor(ys, dtype=tdt))
    assert et["if_mean"].shape == (3, 64) and et["nell"].shape == (3,)
    assert et["if_mean"].dtype == tdt
    npt.assert_allclose(_np(et["if_mean"]), np.asarray(ej["if_mean"]),
                        atol=atol_if, rtol=0)
    npt.assert_allclose(_np(et["nell"]), np.asarray(ej["nell"]),
                        atol=atol_m, rtol=0)
    npt.assert_allclose(_np(et["mss"]), np.asarray(ej["mss"]),
                        atol=atol_m, rtol=0)
    gram = lambda L: np.einsum("tikb,tjkb->tijb", L, L)  # noqa: E731
    npt.assert_allclose(gram(_np(et["Lss"])), gram(np.asarray(ej["Lss"])),
                        atol=atol_P, rtol=0)


@pytest.mark.parametrize("name,quadrature,ref_rmse10,ref_nell", [
    ("ckfs", "cubature", 0.77619, 906.6107),
    ("ghfs", "gauss_hermite", 0.78564, 906.7245)])
def test_seed0_accuracy_gate_float32(name, quadrature, ref_rmse10, ref_nell):
    """Seed 0 of the Table-I constant-magnitude data at the reference's
    learnt optimum, full T=3141, float32: the float64 reference's IF-RMSE
    x10 within 0.005 and its final NLL within 1e-4 relative."""
    data = np.load(ROOT / "results/data/toydata_const.npz")
    ref = np.load(ROOT / f"results/reference/{name}_const.npz")
    est = tp.estimate_if_batched(
        tp.IFEstimationConfig(quadrature=quadrature),
        params_from_jax(ref["params"][0], torch.float32),
        torch.tensor(data["ys"][:1], dtype=torch.float32))
    r10 = 10.0 * float(rmse(torch.tensor(data["true_freqs"],
                                         dtype=torch.float32),
                            est["if_mean"][0]))
    assert abs(r10 - ref_rmse10) <= 0.005
    assert abs(r10 - 10.0 * ref["rmse"][0]) <= 0.005
    assert abs(float(est["nell"][0]) - ref_nell) <= 1e-4 * ref_nell


def test_convert_round_trip():
    row = np.load(ROOT / "results/reference/ghfs_const.npz")["params"][0]
    p64 = params_from_jax(row)
    assert p64.dtype == torch.float64 and p64.device.type == "cpu"
    npt.assert_array_equal(_np(p64), row)
    npt.assert_array_equal(_np(params_from_jax(jnp.asarray(row),
                                               torch.float32)),
                           row.astype(np.float32))
    for rj in (jq.gauss_hermite(4, 3), jq.cubature(4), jq.unscented(4)):
        rt = rule_from_jax(rj)
        assert (rt.d, rt.n_points) == (rj.d, rj.n_points)
        npt.assert_array_equal(rt.xi, np.asarray(rj.xi))
        npt.assert_array_equal(rt.w, np.asarray(rj.w))
        assert (rt.wc is None) == (rj.wc is None)
    pj = jm.build_chirp_model(jnp.asarray(row))
    pt = tm.build_chirp_model(p64)
    npt.assert_allclose(_np(pt.P0), np.asarray(pj.P0), atol=1e-12, rtol=0)


def test_config_mirrors_jax():
    for kw in ({}, {"quadrature": "cubature"}, {"gh_order": 2}):
        rj = jp.IFEstimationConfig(**kw).sigma_points()
        rt = tp.IFEstimationConfig(**kw).sigma_points()
        npt.assert_array_equal(rt.xi, np.asarray(rj.xi))
    assert [f.name for f in dataclasses.fields(tp.IFEstimationConfig)] == \
        [f.name for f in dataclasses.fields(jp.IFEstimationConfig)]
    theta_j = jp.IFEstimationConfig().default_init_theta()
    npt.assert_allclose(_np(tp.IFEstimationConfig().default_init_theta()),
                        np.asarray(theta_j), atol=1e-6, rtol=0)
    assert tp.IFEstimationConfig(model="harmonic", num_harmonics=2
                                 ).state_dim() == 6
    with pytest.raises(NotImplementedError, match="later PR"):
        tp.estimate_if_batched(tp.IFEstimationConfig(model="harmonic"),
                               [0.1] * 6, torch.zeros((1, 8)))
    with pytest.raises(ValueError):
        tp.IFEstimationConfig(quadrature="simpson").sigma_points()


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "chirpgp_tpu"), (path, mod)


def test_tf32_is_off():
    assert chirpgp_tpu_torch.__version__
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
