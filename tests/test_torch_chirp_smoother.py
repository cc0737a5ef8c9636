"""The chirp smoother of the PyTorch port: its plain version (the wrapper on
CPU tensors) against the JAX package's ``sqrt_sgp_smoother_batched`` and
``gaussian_expectation_batched`` over the same filter outputs, La Scala
through the chirp params, ``estimate_if_batched`` end to end against the
JAX package, the work count, the wrapper's refusals and routing.  The CUDA
kernel itself is tested on a card by tests/test_torch_cuda.py."""

import re

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.apps.pipeline as jp
import chirpgp_tpu.models as jm
import chirpgp_tpu.quad as jq
import chirpgp_tpu_torch.apps as tp
import chirpgp_tpu_torch.models as tm
import chirpgp_tpu_torch.quad as tq
from chirpgp_tpu.infer.batched import (
    gaussian_expectation_batched as jax_expectation,
    sqrt_sgp_smoother_batched as jax_smoother)
from chirpgp_tpu_torch.convert import params_from_jax
from chirpgp_tpu_torch.ops import _build
from chirpgp_tpu_torch.ops.chirp_filter import (
    ROWS, TEAMS, ghfs_chirp_filter_reference, lascala_chirp_params)
from chirpgp_tpu_torch.ops.chirp_smoother import (
    MAX_NODES, ghfs_chirp_smoother, ghfs_chirp_smoother_kernel,
    ghfs_chirp_smoother_reference, smoother_cost, smoother_kernel_launcher)

torch.set_num_threads(1)

PARAMS = (0.1, 0.1, 0.1, 1.0, 1.0, 7.0)
LASCALA = (0.1, 1.0, 1.0, 7.0)
DT = 1e-3
# atol on (mss and if_mean, Ls Ls^T): the filter kernel's levels in
# float32 (tests/test_pallas_filter.py); round-off in float64.
TOLS = {"float32": (5e-5, 1e-4), "float64": (1e-10, 1e-10)}
RULES = {"gh3": (lambda: tq.gauss_hermite(4, 3), lambda: jq.gauss_hermite(4, 3)),
         "cubature": (lambda: tq.cubature(4), lambda: jq.cubature(4))}


def _np(x):
    return x.detach().cpu().numpy()


def _gram(L):
    return np.einsum("tikb,tjkb->tijb", L, L)


def _measurements(B, T, seed):
    ts = DT * np.arange(1, T + 1)
    return np.sin(2 * np.pi * 8.0 * ts)[None] + np.sqrt(0.1) * \
        np.random.default_rng(seed).standard_normal((B, T))


def _filter_outputs(chirp_params, rule, B, T, seed):
    """The plain filter's (mfs, Lfs) in float64, as NumPy arrays: the
    inputs both smoothers take."""
    mfs, Lfs, _ = ghfs_chirp_filter_reference(
        chirp_params, 0.1, DT, rule, torch.tensor(_measurements(B, T, seed)))
    return _np(mfs), _np(Lfs)


def _jax_smooth(m_and_cov, rule, mfs, Lfs, dtype, order=10):
    jdt = getattr(jnp, dtype)
    mss, Lss = jax_smoother(m_and_cov, rule, jnp.asarray(mfs, jdt),
                            jnp.asarray(Lfs, jdt), DT)
    v_std = jnp.sqrt(jnp.einsum("tkb,tkb->tb", Lss[:, 2], Lss[:, 2]))
    if_mean = jax_expectation(mss[:, 2], v_std, order=order)
    return [np.asarray(x) for x in (mss, Lss, if_mean)]


def _assert_close(got, want, dtype):
    atol_m, atol_P = TOLS[dtype]
    npt.assert_allclose(got[0], want[0], atol=atol_m, rtol=0)
    npt.assert_allclose(_gram(got[1]), _gram(want[1]), atol=atol_P, rtol=0)
    npt.assert_allclose(got[2], want[2], atol=atol_m, rtol=0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rule", list(RULES))
def test_smoother_matches_jax(rule, dtype):
    """The wrapper on CPU tensors against the JAX package's smoother and
    GH-10 expectation over the same filter outputs (B=4, T=40)."""
    trule, jrule = (f() for f in RULES[rule])
    mfs, Lfs = _filter_outputs(PARAMS, trule, 4, 40, 11)
    tdt = getattr(torch, dtype)
    got = ghfs_chirp_smoother(
        torch.tensor(PARAMS, dtype=tdt), DT, trule,
        torch.tensor(mfs, dtype=tdt), torch.tensor(Lfs, dtype=tdt),
        if_order=10)
    assert [tuple(x.shape) for x in got] == [(40, 4, 4), (40, 4, 4, 4),
                                             (40, 4)]
    assert all(x.dtype == tdt for x in got)
    jpack = jm.build_chirp_model(jnp.asarray(PARAMS, getattr(jnp, dtype)))
    want = _jax_smooth(jpack.m_and_cov, jrule, mfs, Lfs, dtype)
    _assert_close([_np(x) for x in got], want, dtype)


def test_lascala_through_chirp_params_matches_jax_lascala():
    """La Scala's smoother is the chirp smoother at ``lascala_chirp_params``:
    against the JAX package's smoother on the La Scala model, float64."""
    trule, jrule = (f() for f in RULES["gh3"])
    chirp = lascala_chirp_params(torch.tensor(LASCALA, dtype=torch.float64))
    mfs, Lfs = _filter_outputs(chirp, trule, 3, 40, 12)
    got = ghfs_chirp_smoother(chirp, DT, trule, torch.tensor(mfs),
                              torch.tensor(Lfs), if_order=10)
    jpack = jm.build_lascala_model(jnp.asarray(LASCALA, jnp.float64))
    want = _jax_smooth(jpack.m_and_cov, jrule, mfs, Lfs, "float64")
    _assert_close([_np(x) for x in got], want, "float64")


@pytest.mark.parametrize("model", ["chirp", "lascala"])
def test_estimate_if_batched_float64_matches_jax(model):
    """``estimate_if_batched`` on the CPU (the plain filter and smoother
    behind the kernels' wrappers) against the JAX package's, float64,
    B=3, T=50: if_mean and nell to 1e-10."""
    ys = _measurements(3, 50, 13)
    jcfg, tcfg = jp.IFEstimationConfig(model=model), \
        tp.IFEstimationConfig(model=model)
    params = np.asarray(jm.g(jcfg.default_init_theta()), np.float64)
    ej = jp.estimate_if_batched(jcfg, jnp.asarray(params), jnp.asarray(ys))
    et = tp.estimate_if_batched(tcfg, params_from_jax(params),
                                torch.tensor(ys), device="cpu")
    assert et["if_mean"].shape == (3, 50) and et["nell"].shape == (3,)
    npt.assert_allclose(_np(et["if_mean"]), np.asarray(ej["if_mean"]),
                        atol=1e-10, rtol=0)
    npt.assert_allclose(_np(et["nell"]), np.asarray(ej["nell"]), atol=1e-10,
                        rtol=0)
    npt.assert_allclose(_np(et["mss"]), np.asarray(ej["mss"]), atol=1e-10,
                        rtol=0)


@pytest.mark.parametrize("T", [1, 2])
def test_short_records(T):
    """T=1 returns the filter's row; T=2 smooths one step.  Against the
    JAX package, float64."""
    trule, jrule = (f() for f in RULES["cubature"])
    mfs, Lfs = _filter_outputs(PARAMS, trule, 2, T, 14)
    got = [_np(x) for x in ghfs_chirp_smoother(
        PARAMS, DT, trule, torch.tensor(mfs), torch.tensor(Lfs), if_order=5)]
    jpack = jm.build_chirp_model(jnp.asarray(PARAMS, jnp.float64))
    _assert_close(got, _jax_smooth(jpack.m_and_cov, jrule, mfs, Lfs,
                                   "float64", order=5), "float64")
    npt.assert_array_equal(got[0][-1], mfs[-1])
    npt.assert_array_equal(got[1][-1], Lfs[-1])


def test_cpu_wrapper_takes_plain_path_without_launching(monkeypatch):
    monkeypatch.setattr(ghfs_chirp_smoother, "launches", 0)
    rule = tq.gauss_hermite(4, 2)
    mfs, Lfs = (torch.tensor(x) for x in _filter_outputs(PARAMS, rule, 2, 8,
                                                           15))
    got = ghfs_chirp_smoother(PARAMS, DT, rule, mfs, Lfs, if_order=4)
    want = ghfs_chirp_smoother_reference(PARAMS, DT, rule, mfs, Lfs,
                                         if_order=4)
    assert ghfs_chirp_smoother.launches == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_estimate_if_batched_calls_both_wrappers_once(monkeypatch):
    """One ``estimate_if_batched`` call is one filter call and one smoother
    call, the expectation inside the smoother's, for chirp and La Scala;
    the harmonic model calls neither."""
    import chirpgp_tpu_torch.apps.pipeline as pipeline
    calls = []
    for name in ("ghfs_chirp_filter", "ghfs_chirp_smoother"):
        fn = getattr(pipeline, name)
        monkeypatch.setattr(pipeline, name, lambda *a, _n=name, _f=fn, **k:
                            calls.append((_n, k.get("if_order"))) or _f(*a, **k))
    ys = torch.tensor(_measurements(2, 12, 16))
    for model in ("chirp", "lascala", "harmonic"):
        calls.clear()
        cfg = tp.IFEstimationConfig(model=model)
        tp.estimate_if_batched(cfg, tm.g(cfg.default_init_theta(torch.float64)),
                               ys, device="cpu")
        want = [] if model == "harmonic" else [
            ("ghfs_chirp_filter", None),
            ("ghfs_chirp_smoother", cfg.expectation_order)]
        assert calls == want, model


def test_wrapper_rejections():
    rule = tq.cubature(4)
    mfs, Lfs = (torch.tensor(x) for x in _filter_outputs(PARAMS, rule, 2, 6,
                                                           17))
    cases = [
        (dict(sgps=tq.gauss_hermite(4, 4)), "sigma points"),
        (dict(sgps=tq.cubature(2)), "d=4"),
        (dict(sgps=tq.unscented(4, alpha=1.0, beta=0.0, kappa=-2.0)),
         "nonnegative|negative"),
        (dict(mfs=mfs.float()), "float32 or float64"),
        (dict(mfs=mfs.long(), Lfs=Lfs.long()), "float32 or float64"),
        (dict(mfs=mfs[:, :3]), r"\(T, 4, B\)"),
        (dict(Lfs=Lfs[:, :, :, :1]), r"\(T, 4, 4, B\)"),
        (dict(mfs=mfs[:0], Lfs=Lfs[:0]), "T >= 1"),
        (dict(mfs=mfs.clone().requires_grad_(True)), "gradient"),
        (dict(if_order=MAX_NODES + 1), "if_order"),
        (dict(if_order=0), "if_order"),
    ]
    for change, match in cases:
        args = dict(params=PARAMS, dt=DT, sgps=rule, mfs=mfs, Lfs=Lfs,
                    if_order=10)
        args.update(change)
        with pytest.raises(ValueError, match=match):
            ghfs_chirp_smoother(**args)
    with pytest.raises(ValueError, match="6 values"):
        ghfs_chirp_smoother(PARAMS[:4], DT, rule, mfs, Lfs, 10)


def test_kernel_entry_rejects_cpu_tensors(monkeypatch):
    """The kernel's own entry points have no plain fallback."""
    monkeypatch.setattr(ghfs_chirp_smoother, "launches", 0)
    rule = tq.cubature(4)
    mfs, Lfs = (torch.tensor(x) for x in _filter_outputs(PARAMS, rule, 2, 4,
                                                           18))
    for fn in (ghfs_chirp_smoother_kernel, smoother_kernel_launcher):
        with pytest.raises(ValueError, match="cuda"):
            fn(PARAMS, DT, rule, mfs, Lfs, if_order=10, team=8)
    assert ghfs_chirp_smoother.launches == 0


def test_smoother_cost_matches_hand_count():
    """The lesser of two square-root forms per seed-step.  GH-3, S = 81,
    the projected form: per point 20 + 17 + 8 + 8 + 32 + 32 = 117, the
    81 x 4 Householder 1154 + 817 + 488 + 167, the 12 x 8 one 392 + 315 +
    246 + 185 + 132 + 87 + 50 + 21; against the kernel's form, 61 per
    point and the 85 x 8 Householder 10772.  Both have the tail: the gain
    64, the mean update 40, G Ls 80, the 8 x 4 triangularization 227 +
    157 + 99 + 53.  Cubature, S = 8, takes the kernel's form.  The GH-10
    expectation 69 per row; 41 words of traffic per seed-step."""
    tail = 64 + 40 + 80 + (227 + 157 + 99 + 53)
    h12 = 392 + 315 + 246 + 185 + 132 + 87 + 50 + 21
    assert h12 == 1428
    step = 117 * 81 + (1154 + 817 + 488 + 167) + h12 + tail
    assert step == 14251 < 61 * 81 + 10772 + tail == 16433
    two = smoother_cost(81, 2, 1, torch.float32)
    assert two.flop == step + 2 * (9 + 6 * 10)
    assert two.bytes == 2 * 4 * 41
    assert smoother_cost(81, 2, 1, torch.float64, if_order=3) == (
        step + 2 * (9 + 6 * 3), 2 * 8 * 41)
    full = smoother_cost(81, 3141, 4096, torch.float32)
    assert full.flop == (step * 3140 + 69 * 3141) * 4096
    assert full.bytes == 164 * 3141 * 4096
    # Cubature: 61 x 8 + the 12 x 8 Householder + the tail, 2636, is less
    # than the projected 117 x 8 + 290 + 1428 + the tail, 3374.
    cub = 61 * 8 + h12 + tail
    assert cub == 2636 < 117 * 8 + 290 + h12 + tail == 3374
    assert smoother_cost(8, 2, 1).flop == cub + 2 * 69


@pytest.mark.parametrize("rule", list(RULES))
def test_projected_form_has_the_same_gram(rule):
    """What ``smoother_cost`` counts is the smoother's step: Q = sqrt(w) xi
    has orthonormal columns, so with dev_prev = Q Lf^T, C = Q^T dev_pred,
    E = dev_pred - Q C = Q_E R_E, the 12 x 8 array [[C, Lf^T], [R_E, 0],
    [Lq^T, 0]] has the Gram of the (S + 4) x 8 pre-array, hence its R."""
    trule = RULES[rule][0]()
    rng = np.random.default_rng(19)
    S = trule.n_points
    sw = np.sqrt(np.asarray(trule.w))[:, None]
    Q = sw * np.asarray(trule.xi)
    npt.assert_allclose(Q.T @ Q, np.eye(4), atol=1e-13)
    dev_pred = sw * rng.standard_normal((S, 4))
    Lf = np.tril(rng.standard_normal((4, 4)))
    LqT = np.triu(rng.standard_normal((4, 4)))
    z = np.zeros((4, 4))
    pre = np.block([[dev_pred, Q @ Lf.T], [LqT, z]])
    C = Q.T @ dev_pred
    R_E = np.linalg.qr(dev_pred - Q @ C, mode="r")
    small = np.block([[C, Lf.T], [R_E, z], [LqT, z]])
    npt.assert_allclose(small.T @ small, pre.T @ pre, atol=1e-12)


def test_kernel_source_matches_wrapper():
    """The kernel is built from ``csrc`` with the filter's (team, rows)
    instances (which ``launch_geometry`` picks) and the wrapper's node cap;
    its symbols are the ones the wrapper binds."""
    src = (_build.CSRC / "ghfs_chirp_smoother.cu").read_text()
    cases = re.findall(r"case (\d+): return GHFS_LAUNCH\((\d+), (\d+)\);",
                       src)
    assert {(int(p), int(r)) for _, p, r in cases} == {
        (p, r) for p in TEAMS for r in ROWS[p]}
    assert f"constexpr int kMaxNodes = {MAX_NODES};" in src
    for sym in ("f32", "f64", "max_points", "max_nodes", "num_consts",
                "max_threads"):
        assert re.search(rf"\bint ghfs_chirp_smoother_{sym}\(", src), sym
    assert '#include "chirp_lcd.cuh"' in src
    # The epilogue's V is the state the wrapper takes it from.
    lcd = (_build.CSRC / "chirp_lcd.cuh").read_text()
    assert "constexpr int kV = 2;" in lcd and "softplus(chi[kV])" in lcd
    assert tp.IFEstimationConfig(model="chirp").v_index() == 2
    assert tp.IFEstimationConfig(model="lascala").v_index() == 2
