"""The IF-estimation entry points of the PyTorch port against the JAX
package (``estimate_if`` for one record, ``estimate_if_batched``, the
MLE objective) for the chirp, harmonic and La Scala models, the seed-0
accuracy gates, the JAX-to-torch conversions, and the port's import and
precision policies."""

import ast
import dataclasses
from pathlib import Path

import jax
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
from chirpgp_tpu_torch.infer import sqrt_sgp_filter_batched
from chirpgp_tpu_torch.ops.chirp_filter import (
    ghfs_chirp_filter, lascala_chirp_params)
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


@pytest.mark.parametrize("form", ["cov", "sqrt"])
@pytest.mark.parametrize("method", ["ghfs", "ekfs"])
def test_estimate_if_matches_jax(method, form):
    """One record, float64, T=100, at the default params: every output to
    1e-10 (covariances also in sqrt form)."""
    ys = np.load(ROOT / "results/data/toydata_const.npz")["ys"][0, :100] \
        .astype(np.float64)
    params = np.array(jm.g(jp.IFEstimationConfig().default_init_theta()),
                      np.float64)
    ej = jp.estimate_if(jp.IFEstimationConfig(method=method, form=form),
                        jnp.asarray(params), jnp.asarray(ys))
    et = tp.estimate_if(tp.IFEstimationConfig(method=method, form=form),
                        params_from_jax(params), torch.tensor(ys))
    assert et["if_mean"].shape == (100,) and et["Pss"].shape == (100, 4, 4)
    for key in ("mfs", "Pfs", "nell", "mss", "Pss", "if_mean", "if_lower",
                "if_upper"):
        npt.assert_allclose(_np(et[key]), np.asarray(ej[key]), atol=1e-10,
                            rtol=0, err_msg=key)


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
    assert tp.IFEstimationConfig(model="harmonic", num_harmonics=2
                                 ).v_index() == 4
    assert tp.IFEstimationConfig(model="lascala").v_index() == 2
    npt.assert_allclose(
        _np(tp.IFEstimationConfig(model="lascala").default_init_theta(
            torch.float64)),
        np.asarray(jp.IFEstimationConfig(model="lascala").default_init_theta()),
        atol=1e-12, rtol=0)
    with pytest.raises(ValueError, match="Unknown model"):
        tp.IFEstimationConfig(model="tme").build([0.1] * 6)
    with pytest.raises(ValueError):
        tp.IFEstimationConfig(quadrature="simpson").sigma_points()


# The model-based columns of Table I beyond the chirp model: data file,
# config, and the reference file of their learnt params.
FAMILY = {
    "harmonic_ckfs": ("toydata_h3_const", dict(
        method="ghfs", model="harmonic", num_harmonics=3,
        quadrature="cubature", form="sqrt")),
    "harmonic_ekfs": ("toydata_h3_const", dict(
        method="ekfs", model="harmonic", num_harmonics=3, form="sqrt")),
    "lascala_ghfs": ("toydata_const", dict(method="ghfs", model="lascala",
                                           form="cov")),
    "lascala_ekfs": ("toydata_const", dict(method="ekfs", model="lascala",
                                           form="sqrt")),
}


def _family_column(name, T):
    """(config kwargs, seed-0 measurements (T,), reference params)."""
    data, kw = FAMILY[name]
    ys = np.load(ROOT / f"results/data/{data}.npz")["ys"][0, :T]
    params = np.load(ROOT / f"results/reference/{name}_const.npz")["params"][0]
    return kw, ys.astype(np.float64), params


@pytest.mark.parametrize("name", list(FAMILY))
def test_estimate_if_family_matches_jax(name):
    """Seed 0, T=200, float64, at the column's reference optimum: every
    output of ``estimate_if`` to 1e-9 relative (of its largest value)."""
    kw, ys, params = _family_column(name, 200)
    ej = jp.estimate_if(jp.IFEstimationConfig(**kw), jnp.asarray(params),
                        jnp.asarray(ys))
    et = tp.estimate_if(tp.IFEstimationConfig(**kw), params, ys,
                        device="cpu")
    d = tp.IFEstimationConfig(**kw).state_dim()
    assert et["Pss"].shape == (200, d, d)
    for key in ("mfs", "Pfs", "nell", "mss", "Pss", "if_mean", "if_lower",
                "if_upper"):
        want = np.asarray(ej[key])
        npt.assert_allclose(_np(et[key]), want, rtol=1e-9,
                            atol=1e-9 * np.abs(want).max(), err_msg=key)


def test_estimate_if_reads_v_of_the_harmonic_model():
    """The harmonic model's latent frequency is component d-2 (6 at K=3),
    not the chirp model's 2: the IF is the expectation of g over
    ``mss[:, -2]``, as the JAX package reads it."""
    kw, ys, params = _family_column("harmonic_ekfs", 120)
    cfg = tp.IFEstimationConfig(**kw)
    et = tp.estimate_if(cfg, params, ys, device="cpu")
    v_mean = et["mss"][:, -2]
    v_std = torch.sqrt(et["Pss"][:, -2, -2])
    from chirpgp_tpu_torch.quad.expectations import gaussian_expectation_1d
    npt.assert_allclose(_np(et["if_mean"]),
                        _np(gaussian_expectation_1d(v_mean, v_std)),
                        rtol=1e-12)
    ej = jp.estimate_if(jp.IFEstimationConfig(**kw), jnp.asarray(params),
                        jnp.asarray(ys))
    npt.assert_allclose(_np(et["if_mean"]), np.asarray(ej["if_mean"]),
                        rtol=1e-9)


@pytest.mark.parametrize("name", ["harmonic_ckfs", "lascala_ghfs"])
def test_estimate_if_batched_family_matches_jax(name):
    """B=4 records (seeds 0-3 of ``toydata_const``), T=100, float64, at the
    column's reference optimum: the harmonic model (K=1) through the plain
    batched filter, La Scala through the chirp filter's plain version (a
    CPU tensor), against the JAX package's plain batched path, 1e-9
    relative.  At K=3 the harmonic measurement vector reads three
    components, which the batched update does not take: both packages
    raise."""
    _, kw = FAMILY[name]
    kw = dict(kw, form="sqrt", num_harmonics=1)
    ys = np.load(ROOT / "results/data/toydata_const.npz")["ys"][:4, :100] \
        .astype(np.float64)
    params = np.load(ROOT / f"results/reference/{name}_const.npz")["params"][0]
    ej = jp.estimate_if_batched(jp.IFEstimationConfig(**kw),
                                jnp.asarray(params), jnp.asarray(ys))
    et = tp.estimate_if_batched(tp.IFEstimationConfig(**kw), params, ys,
                                device="cpu")
    assert et["if_mean"].shape == (4, 100)
    for key in ("if_mean", "nell", "mss"):
        want = np.asarray(ej[key])
        npt.assert_allclose(_np(et[key]), want, rtol=1e-9,
                            atol=1e-9 * np.abs(want).max(), err_msg=key)
    gram = lambda L: np.einsum("tikb,tjkb->tijb", L, L)  # noqa: E731
    want = gram(np.asarray(ej["Lss"]))
    npt.assert_allclose(gram(_np(et["Lss"])), want, rtol=0,
                        atol=1e-9 * np.abs(want).max())
    if name.startswith("harmonic"):
        kw3 = dict(kw, num_harmonics=3)
        with pytest.raises(ValueError, match="one-hot"):
            jp.estimate_if_batched(jp.IFEstimationConfig(**kw3),
                                   jnp.asarray(params), jnp.asarray(ys))
        with pytest.raises(ValueError, match="one-hot"):
            tp.estimate_if_batched(tp.IFEstimationConfig(**kw3), params, ys,
                                   device="cpu")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_lascala_through_chirp_params_matches_plain_lascala(dtype):
    """The chirp filter at ``lascala_chirp_params`` is the plain batched
    filter of the La Scala model, with its zero process-noise block, to
    round-off: 1e-12 in float64, 1e-6 in float32."""
    tol = {"float64": 1e-12, "float32": 1e-6}[dtype]
    ys = torch.tensor(np.load(ROOT / "results/data/toydata_const.npz")
                      ["ys"][:3, :80], dtype=getattr(torch, dtype))
    params = torch.tensor(np.load(ROOT / "results/reference/"
                                  "lascala_ghfs_const.npz")["params"][0])
    chirp = lascala_chirp_params(params)
    npt.assert_array_equal(_np(chirp[:2]), [0.0, 0.0])
    npt.assert_array_equal(_np(chirp[2:]), _np(params))
    rule = tp.IFEstimationConfig().sigma_points()
    got = ghfs_chirp_filter(chirp, 0.1, 1e-3, rule, ys)
    pack = tm.build_lascala_model(params)
    want = sqrt_sgp_filter_batched(pack.m_and_cov, rule, pack.H, 0.1,
                                   pack.m0, pack.P0, 1e-3, ys)
    for a, b in zip(got, want):
        npt.assert_allclose(_np(a), _np(b), rtol=tol,
                            atol=tol * float(b.abs().max()))
    with pytest.raises(ValueError, match="4 values"):
        lascala_chirp_params([0.1] * 6)


@pytest.mark.parametrize("name", ["harmonic_ckfs", "harmonic_ekfs"])
def test_family_objective_value_and_grad_match_jax(name):
    """``make_nll_fn`` and its ``torch.autograd`` gradient against
    ``jax.grad`` (seed 0, T=80, float64) at the reference optimum."""
    kw, ys, params = _family_column(name, 80)
    theta = np.asarray(jm.g_inv(jnp.asarray(params)))
    vj, gj = jax.value_and_grad(jp.make_nll_fn(jp.IFEstimationConfig(**kw),
                                               jnp.asarray(ys)))(
        jnp.asarray(theta))
    th = torch.tensor(theta, requires_grad=True)
    vt = tp.make_nll_fn(tp.IFEstimationConfig(**kw), ys, device="cpu")(th)
    gt, = torch.autograd.grad(vt, th)
    npt.assert_allclose(float(vt.detach()), float(vj), rtol=1e-9)
    gj = np.asarray(gj)
    npt.assert_allclose(_np(gt), gj, rtol=0, atol=1e-9 * np.abs(gj).max())


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "time_smoother.py",
                                          ROOT / "time_fused.py"]
    assert len(files) > 15
    assert {PORT / "models/kpt.py", PORT / "apps/kpt.py",
            PORT / "ops/chirp_filter.py", PORT / "ops/chirp_smoother.py",
            PORT / "ops/chirp_fused.py",
            PORT / "quad/integrators.py",
            PORT / "fit/gauss_newton.py", PORT / "baselines/classical.py",
            PORT / "baselines/__init__.py", PORT / "utils/lti.py",
            PORT / "models/tme.py", PORT / "models/crlb.py",
            PORT / "models/cov_funcs.py", PORT / "models/matern.py",
            PORT / "apps/crlb.py", PORT / "apps/realdata.py",
            PORT / "baselines/fhc.py", PORT / "baselines/fastnls.py",
            PORT / "ops/native/__init__.py",
            PORT / "infer/parallel_kf.py", PORT / "infer/parallel_sgp.py",
            PORT / "infer/smc.py", PORT / "infer/nuts.py",
            PORT / "apps/posterior.py", PORT / "utils/timing.py",
            PORT / "utils/numerics.py",
            PORT / "parallel/__init__.py", PORT / "parallel/mesh.py",
            PORT / "parallel/multihost.py", PORT / "infer/parallel_sharded.py",
            PORT / "utils/jax_keys.py", PORT / "experiments/__init__.py",
            PORT / "experiments/_common.py",
            PORT / "demos/__init__.py", ROOT / "chip_smoke.py",
            ROOT / "time_smoother.py", ROOT / "time_fused.py"} \
        | {PORT / f"experiments/{name}.py" for name in (
            "gen_toymodel_data", "run_rmse_table", "print_table", "run_kpt",
            "run_classical", "run_fhc", "run_fastnls", "run_crlb",
            "print_time", "run_ligo", "plots", "bench_scaling")} \
        | {PORT / f"demos/{name}.py" for name in (
            "ghfs_mle", "ghfs_harmonics_mle", "classical_methods",
            "bats_analysis", "ligo_analysis")} <= set(files)
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "optax", "chirpgp_tpu"), \
                (path, mod)


def test_tf32_is_off():
    assert chirpgp_tpu_torch.__version__
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
