"""The chirp smoother of the PyTorch port: its plain version (the wrapper on
CPU tensors) and the plain twin of the kernels' split (phase A's rows, then
the recursion) against the JAX package's ``sqrt_sgp_smoother_batched`` and
``gaussian_expectation_batched`` over the same filter outputs, La Scala
through the chirp params, ``estimate_if_batched`` end to end against the
JAX package, the work counts, the slabs, the wrapper's refusals and
routing.  The CUDA kernels themselves are tested on a card by
tests/test_torch_cuda.py."""

import re

import jax
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
    _backsub_cf as jax_backsub, gaussian_expectation_batched as jax_expectation,
    sqrt_sgp_smoother_batched as jax_smoother, tria_cf as jax_tria)
from chirpgp_tpu_torch.convert import params_from_jax
from chirpgp_tpu_torch.ops import _build
from chirpgp_tpu_torch.ops import chirp_smoother
from chirpgp_tpu_torch.ops.chirp_filter import (
    ghfs_chirp_filter_reference, lascala_chirp_params)
from chirpgp_tpu_torch.ops.chirp_smoother import (
    KERNELS, MAX_NODES, ROW_WORDS, ROWS, SCRATCH_CAP, TEAM,
    ghfs_chirp_smoother, ghfs_chirp_smoother_kernel,
    ghfs_chirp_smoother_reference, ghfs_chirp_smoother_split, rows_per_member,
    smoother_cost, smoother_expect_reference, smoother_expect_var_reference,
    smoother_kernel_launcher, smoother_phase_costs, smoother_rows_reference,
    smoother_slabs)

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
            fn(PARAMS, DT, rule, mfs, Lfs, if_order=10)
    assert ghfs_chirp_smoother.launches == 0


def test_smoother_cost_matches_hand_count():
    """The lesser of two square-root forms per seed-step.  GH-3, S = 81,
    the projected form: per point 20 + 17 + 8 + 8 + 32 + 32 = 117, the
    81 x 4 Householder 1154 + 817 + 488 + 167, the 12 x 8 one 392 + 315 +
    246 + 185 + 132 + 87 + 50 + 21; against the kernel's form, 61 per
    point and the 85 x 8 Householder 10772.  Both have the tail: the gain
    64, the mean update 40, G Ls 80, the 8 x 4 triangularization 227 +
    157 + 99 + 53.  Cubature, S = 8, takes the kernel's form.  The GH-10
    expectation 66 per row in the pair form (the variance 5, its sqrt 1,
    12 per pair of nodes), GH-3 25 (7 for the centre node); 41 words of
    traffic per seed-step."""
    tail = 64 + 40 + 80 + (227 + 157 + 99 + 53)
    h12 = 392 + 315 + 246 + 185 + 132 + 87 + 50 + 21
    assert h12 == 1428
    step = 117 * 81 + (1154 + 817 + 488 + 167) + h12 + tail
    assert step == 14251 < 61 * 81 + 10772 + tail == 16433
    two = smoother_cost(81, 2, 1, torch.float32)
    assert two.flop == step + 2 * (6 + 12 * 5)
    assert two.bytes == 2 * 4 * 41
    assert smoother_cost(81, 2, 1, torch.float64, if_order=3) == (
        step + 2 * (6 + 12 + 7), 2 * 8 * 41)
    full = smoother_cost(81, 3141, 4096, torch.float32)
    assert full.flop == (step * 3140 + 66 * 3141) * 4096
    assert full.bytes == 164 * 3141 * 4096
    # Cubature: 61 x 8 + the 12 x 8 Householder + the tail, 2636, is less
    # than the projected 117 x 8 + 290 + 1428 + the tail, 3374.
    cub = 61 * 8 + h12 + tail
    assert cub == 2636 < 117 * 8 + 290 + h12 + tail == 3374
    assert smoother_cost(8, 2, 1).flop == cub + 2 * 66


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
    """The kernels are built from ``csrc`` with phase A's team and its
    rows-per-member instances (which ``rows_per_member`` picks), the
    wrapper's node cap and row width (the packed row of ``chirp_lcd.cuh``);
    their symbols are the ones the wrapper binds, and each kernel the
    wrapper counts is a kernel of the source, phase E's second input mode
    (``gaussian_expectation_g``) among them."""
    src = (_build.CSRC / "ghfs_chirp_smoother.cu").read_text()
    lcd = (_build.CSRC / "chirp_lcd.cuh").read_text()
    cases = re.findall(r"case (\d+): return SMOOTHER_ROWS_LAUNCH\((\d+)\);",
                       src)
    assert sorted(int(r) for _, r in cases) == list(ROWS)
    assert all(c == r for c, r in cases)
    assert f"constexpr int kTeam = {TEAM};" in src
    assert f"constexpr int kMaxNodes = {MAX_NODES};" in src
    assert "constexpr int kRowWords = kR22Word + kD * (kD + 1) / 2;" in lcd
    assert ROW_WORDS == 30
    for name in KERNELS + ("smoother_expect_var",):
        assert re.search(rf"__global__ void __launch_bounds__\(\w+\)\n"
                         rf"{name}_kernel\(", src), name
        for dt in ("f32", "f64"):
            assert re.search(rf"\bint {name}_{dt}\(", src), (name, dt)
    for sym in ("max_points", "max_nodes", "num_consts", "row_words"):
        assert re.search(rf"\bint ghfs_chirp_smoother_{sym}\(", src), sym
    # Phase E takes the rule as the host's float64 nodes and weights (the
    # wrapper's ctypes.POINTER(c_double)), and unrolls the main path's
    # order.
    flat = re.sub(r"\s+", " ", src)
    for name in ("smoother_expect", "smoother_expect_var"):
        for dt, real in (("f32", "float"), ("f64", "double")):
            assert re.search(rf"\bint {name}_{dt}\(const {real}\* \w+, "
                             rf"const {real}\* \w+, const double\* ghx, "
                             rf"const double\* ghw, int K, int T, int B, "
                             rf"{real}\* if_out, void\* stream\)", flat), (
                name, dt)
    order = tp.IFEstimationConfig().expectation_order
    assert f"constexpr int kMainOrder = {order};" in src
    assert '#include "chirp_lcd.cuh"' in src
    # The expectation's V is the state the wrapper takes it from.
    assert "constexpr int kV = 2;" in lcd and "softplus(chi[kV])" in lcd
    assert tp.IFEstimationConfig(model="chirp").v_index() == 2
    assert tp.IFEstimationConfig(model="lascala").v_index() == 2


@pytest.mark.parametrize("T", [1, 2, 37])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rule", list(RULES))
def test_split_matches_jax(rule, dtype, T):
    """The plain twin of the kernels' split, phase A's rows then the
    recursion and the expectation, against the JAX package's smoother and
    GH-10 expectation over the same filter outputs (B=5): float64 within
    1e-10, float32 within 5e-5 on the means and the IF mean, 1e-4 on
    L L^T.  Row T-1 is the filter's, bit for bit."""
    trule, jrule = (f() for f in RULES[rule])
    mfs, Lfs = _filter_outputs(PARAMS, trule, 5, T, 20 + T)
    tdt = getattr(torch, dtype)
    got = [_np(x) for x in ghfs_chirp_smoother_split(
        torch.tensor(PARAMS, dtype=tdt), DT, trule,
        torch.tensor(mfs, dtype=tdt), torch.tensor(Lfs, dtype=tdt),
        if_order=10)]
    assert [x.shape for x in got] == [(T, 4, 5), (T, 4, 4, 5), (T, 5)]
    jpack = jm.build_chirp_model(jnp.asarray(PARAMS, getattr(jnp, dtype)))
    want = _jax_smooth(jpack.m_and_cov, jrule, mfs, Lfs, dtype)
    _assert_close(got, want, dtype)
    npt.assert_array_equal(got[0][-1], mfs[-1].astype(dtype))
    npt.assert_array_equal(got[1][-1], Lfs[-1].astype(dtype))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_split_lascala_matches_jax_lascala(dtype):
    """La Scala through ``lascala_chirp_params``: the twin against the JAX
    package's smoother on the La Scala model."""
    trule, jrule = (f() for f in RULES["gh3"])
    chirp = lascala_chirp_params(torch.tensor(LASCALA, dtype=torch.float64))
    mfs, Lfs = _filter_outputs(chirp, trule, 3, 40, 12)
    tdt = getattr(torch, dtype)
    got = ghfs_chirp_smoother_split(chirp, DT, trule,
                                    torch.tensor(mfs, dtype=tdt),
                                    torch.tensor(Lfs, dtype=tdt), if_order=10)
    jpack = jm.build_lascala_model(jnp.asarray(LASCALA, getattr(jnp, dtype)))
    want = _jax_smooth(jpack.m_and_cov, jrule, mfs, Lfs, dtype)
    _assert_close([_np(x) for x in got], want, dtype)


def _jax_rows(m_and_cov, rule, mfs, Lfs):
    """m_p, X and R22 of every step t < T-1, float64, from the JAX
    package's ``tria_cf`` and ``_backsub_cf`` of the joint pre-array, as in
    its ``sqrt_sgp_smoother_batched``."""
    from chirpgp_tpu.models.transitions import as_transition
    from chirpgp_tpu.utils.numerics import psd_cholesky
    trans = as_transition(m_and_cov)
    d, B = 4, mfs.shape[2]
    xi, w = jnp.asarray(rule.xi), jnp.asarray(rule.w)
    sw = jnp.sqrt(w)
    LqT = jnp.broadcast_to(psd_cholesky(trans.cov_const(DT)).T[:, :, None],
                           (d, d, B))
    out = []
    for t in range(mfs.shape[0] - 1):
        mf, Lf = jnp.asarray(mfs[t]), jnp.asarray(Lfs[t])
        chi = mf[None] + jnp.einsum("sj,ijb->sib", xi, Lf)
        mu = trans.mean_channels_first(chi, DT)
        mp = jnp.einsum("s,sib->ib", w, mu)
        M = jnp.concatenate([
            jnp.concatenate([sw[:, None, None] * (mu - mp[None]),
                             sw[:, None, None] * (chi - mf[None])], axis=1),
            jnp.concatenate([LqT, jnp.zeros((d, d, B))], axis=1)], axis=0)
        R = jax_tria(M)
        out.append([np.asarray(x) for x in
                    (mp, jax_backsub(R[:d, :d], R[:d, d:], d), R[d:, d:])])
    return [np.stack(x) for x in zip(*out)]


@pytest.mark.parametrize("rule", list(RULES))
def test_rows_match_jax_tria(rule):
    """Phase A's rows from the twin against the JAX package's ``tria_cf``
    and ``_backsub_cf`` of the same joint pre-arrays, float64: m_p and X
    within 1e-10 of scale, R22 by its Gram R22^T R22 (a row of R22 may
    change sign with the rounding of a near-zero diagonal; the recursion
    reads only the Gram)."""
    trule, jrule = (f() for f in RULES[rule])
    mfs, Lfs = _filter_outputs(PARAMS, trule, 4, 9, 30)
    rows = _np(smoother_rows_reference(PARAMS, DT, trule, torch.tensor(mfs),
                                       torch.tensor(Lfs)))
    assert rows.shape == (8, ROW_WORDS, 4)
    jpack = jm.build_chirp_model(jnp.asarray(PARAMS, jnp.float64))
    mp, X, R22 = _jax_rows(jpack.m_and_cov, jrule, mfs, Lfs)
    npt.assert_allclose(rows[:, :4], mp, atol=1e-10, rtol=0)
    npt.assert_allclose(rows[:, 4:20], X.reshape(8, 16, 4),
                        atol=1e-10 * (1 + np.abs(X).max()), rtol=0)
    up = np.zeros((8, 4, 4, 4))
    iu = np.triu_indices(4)
    up[:, iu[0], iu[1]] = rows[:, 20:]
    npt.assert_allclose(np.einsum("tkib,tkjb->tijb", up, up),
                        np.einsum("tkib,tkjb->tijb", R22, R22), atol=1e-10,
                        rtol=0)


def test_rows_reference_chunks_time(monkeypatch):
    """The twin's phase A runs time in chunks of lane-steps: the same rows
    to round-off (float64) whatever the chunk, a ragged last chunk
    included."""
    rule = tq.cubature(4)
    mfs, Lfs = (torch.tensor(x) for x in _filter_outputs(PARAMS, rule, 3, 12,
                                                           31))
    whole = smoother_rows_reference(PARAMS, DT, rule, mfs, Lfs)
    monkeypatch.setattr(chirp_smoother, "_TWIN_LANE_STEPS", 3 * 5)
    chunked = smoother_rows_reference(PARAMS, DT, rule, mfs, Lfs)
    assert chunked.shape == whole.shape == (11, ROW_WORDS, 3)
    npt.assert_allclose(_np(chunked), _np(whole), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("T,B,itemsize,cap,want", [
    (3141, 4096, 4, 2 << 30, [(0, 4096)]),
    (3141, 4096, 8, 2 << 30, [(0, 2848), (2848, 1248)]),
    (1, 5, 4, 2 << 30, [(0, 5)]),
    (10, 0, 4, 2 << 30, []),
    (11, 100, 8, 11 * 30 * 8 * 40, [(0, 32), (32, 32), (64, 32), (96, 4)]),
    (11, 100, 4, 10 * 30 * 4 * 5, [(b, 5) for b in range(0, 100, 5)]),
    (11, 7, 4, 1, [(b, 1) for b in range(7)]),
    (3141, 4096, 8, SCRATCH_CAP, [(0, 4096)]),
])
def test_smoother_slabs(T, B, itemsize, cap, want):
    """Slabs of lanes whose (T-1, 30, lanes) scratch fits the cap: as few as
    the cap allows, whole warps but the last, one lane at least."""
    assert smoother_slabs(T, B, itemsize, cap) == want


def test_smoother_slabs_default_to_the_module_cap(monkeypatch):
    """Without a cap, the slabs follow ``SCRATCH_CAP`` as it is at the
    call, so that a test may force slabs by setting it."""
    assert smoother_slabs(11, 100, 8) == [(0, 100)]
    monkeypatch.setattr(chirp_smoother, "SCRATCH_CAP", 10 * 30 * 8 * 40)
    assert smoother_slabs(11, 100, 8) == [(0, 32), (32, 32), (64, 32),
                                          (96, 4)]


def test_rows_per_member():
    """Phase A's rows per member: the fewest built that hold the S + 4
    pre-array rows over the team of 8 (GH-3 85, GH-2 20, cubature 12)."""
    assert TEAM == 8
    assert rows_per_member(81) == 11
    assert rows_per_member(16) == 11
    assert rows_per_member(12) == 2
    assert rows_per_member(8) == 2
    assert rows_per_member(1) == 2
    with pytest.raises(ValueError, match="sigma points"):
        rows_per_member(82)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_phase_costs_split_the_smoother_cost(dtype):
    """The kernels' flop add up to ``smoother_cost``'s; their bytes are each
    kernel's own reads and writes, phase A's rows among them.  GH-3, S=81:
    phase A 14251 - 720 + 64 flop per seed-step but the last, phase B the
    mean update, G Ls and the 8 x 4 triangularization, 656; phase E the
    GH-10 expectation in the pair form, 66 per seed-step."""
    isz = torch.empty((), dtype=dtype).element_size()
    S, T, B = 81, 3141, 4096
    costs = smoother_phase_costs(S, T, B, dtype)
    assert tuple(costs) == KERNELS
    assert sum(c.flop for c in costs.values()) == smoother_cost(
        S, T, B, dtype).flop
    steps = (T - 1) * B
    assert costs["smoother_rows"] == ((14251 - 720 + 64) * steps,
                                      isz * 50 * steps)
    assert costs["smoother_backward"] == (
        (40 + 80 + 536) * steps, isz * (34 * steps + 20 * (T + 1) * B))
    assert costs["smoother_expect"] == (66 * T * B, isz * 5 * T * B)


# Phase E's inputs: the mean from -40 to 40 against standard deviations 0,
# 1e-6 and 2 (variances 0, 1e-12, 4; below 0, clamped, in the variance
# mode), then NaN and +-inf in either input.
_E_MEANS = np.linspace(-40.0, 40.0, 33)
_E_VARS = (0.0, 1e-12, 4.0)
_E_SPECIAL = [(np.nan, 1.0), (np.inf, 1.0), (-np.inf, 4.0), (5.0, np.nan),
              (1.0, np.inf), (np.inf, np.inf), (-np.inf, np.inf),
              (np.nan, np.nan), (3.0, -np.inf)]


def _expect_inputs(mode):
    """(T, B) means and variances of V: the sweep (below 0 in the
    variance mode), then the special pairs (the variance mode alone gets
    -inf)."""
    vars_ = _E_VARS + ((-1e-3, -4.0) if mode == "var" else ())
    m, v = np.meshgrid(_E_MEANS, np.asarray(vars_), indexing="ij")
    special = [p for p in _E_SPECIAL if mode == "var" or p[1] != -np.inf]
    m = np.concatenate([m.ravel(), [p[0] for p in special]])
    v = np.concatenate([v.ravel(), [p[1] for p in special]])
    return m.reshape(1, -1), v.reshape(1, -1)


def _assert_expectation(got, want, dtype):
    """NaN where JAX gives NaN, the same infinities, finite values within
    float64 1e-13 relative or float32 5e-5 of max(1, |E|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    npt.assert_array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    assert np.isfinite(got[fin]).all()
    err = np.abs(got[fin] - want[fin])
    if dtype == "float64":
        assert (err <= 1e-13 * np.abs(want[fin])).all(), err.max()
    else:
        assert (err <= 5e-5 * np.maximum(1.0, np.abs(want[fin]))).all(), \
            err.max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_expect_twins_match_jax(dtype):
    """Phase E's pair form (the kernels' plain twins) against the JAX
    package's ``gaussian_expectation_batched`` (jitted, one compile per
    order) for every GH order 1..32, both input modes side by side in one
    call: the smoother's, V ~ N(mss[2], |row 2 of Lss|^2), with JAX's
    standard deviation sqrt(sum_k Lss[2, k]^2) as its pipeline takes it;
    the variance mode with bench.py's sqrt(max(v_var, 0))."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    m1, var1 = _expect_inputs("mss")
    m2, var2 = _expect_inputs("var")
    # Row 2 of a lower factor whose squares sum to the variance.
    T, B = m1.shape
    sd = np.sqrt(var1)
    Lss = np.zeros((T, 4, 4, B))
    Lss[:, 2, 0], Lss[:, 2, 1], Lss[:, 2, 2] = 0.6 * sd, -0.48 * sd, 0.64 * sd
    mss = np.zeros((T, 4, B))
    mss[:, 2] = m1
    mss_t, Lss_t = torch.tensor(mss, dtype=tdt), torch.tensor(Lss, dtype=tdt)
    m2_t, var2_t = torch.tensor(m2, dtype=tdt), torch.tensor(var2, dtype=tdt)
    L2 = jnp.asarray(Lss, jdt)[:, 2]
    j_mean = jnp.concatenate([jnp.asarray(mss, jdt)[:, 2],
                              jnp.asarray(m2, jdt)], axis=1)
    j_std = jnp.concatenate([jnp.sqrt(jnp.einsum("tkb,tkb->tb", L2, L2)),
                             jnp.sqrt(jnp.maximum(jnp.asarray(var2, jdt), 0))],
                            axis=1)
    expectation = jax.jit(jax_expectation, static_argnames=("func", "order"))
    for order in range(1, MAX_NODES + 1):
        want = np.asarray(expectation(j_mean, j_std, order=order))
        got = torch.cat([smoother_expect_reference(mss_t, Lss_t, order),
                         smoother_expect_var_reference(m2_t, var2_t, order)],
                        dim=1)
        assert got.dtype == tdt and got.shape == want.shape
        _assert_expectation(_np(got), want, dtype)


@pytest.mark.parametrize("order", range(1, MAX_NODES + 1))
def test_gauss_hermite_rule_is_symmetric_bit_for_bit(order):
    """The pair form of phase E rests on it: ``gauss_hermite(1, K)`` has
    x_q = -x_{K-1-q} and w_q = w_{K-1-q} exactly, and a centre node of 0
    where K is odd."""
    rule = tq.gauss_hermite(1, order)
    x, w = rule.xi[:, 0], np.asarray(rule.w)
    assert np.array_equal(x, -x[::-1]) and np.array_equal(w, w[::-1])
    assert (x[order - order // 2:] > 0).all()
    if order % 2:
        assert x[order // 2] == 0.0
