"""The fused filter+smoother of the PyTorch port for the chirp model
(``ops/chirp_fused.py``): the wrapper on CPU tensors, which composes the
plain twins of kernels F and G (and of the smoother's phase B), against
the JAX package's ``sqrt_sgp_filter_smoother_batched`` in its three modes,
La Scala through the chirp params, short records, F's factor rows against
phase A's twin, phase E's variance mode against the JAX package's
``gaussian_expectation_batched``, the work counts, the refusals and the
routing.  The CUDA kernels themselves are tested on a card by
tests/test_torch_cuda.py.

Tolerances: float64 atol 1e-10; float32 atol 5e-5 on means and nll and
1e-4 on covariances and Grams (the levels of tests/test_pallas_filter.py).
Factors are compared by their Grams: a row of a triangular factor may
change sign with the rounding of a near-zero pivot."""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.infer.batched as jb
import chirpgp_tpu.models as jm
import chirpgp_tpu.quad as jq
import chirpgp_tpu_torch.infer.batched as tb
import chirpgp_tpu_torch.models as tm
import chirpgp_tpu_torch.quad as tq
from chirpgp_tpu_torch.ops import _build, chirp_fused
from chirpgp_tpu_torch.ops.chirp_filter import TEAMS, lascala_chirp_params
from chirpgp_tpu_torch.ops.chirp_fused import (
    KERNELS, ROWS, affine_backward_reference, fused_cost,
    fused_forward_reference, fused_kernel_launcher, fused_rows,
    ghfs_chirp_filter_smoother, ghfs_chirp_filter_smoother_reference)
from chirpgp_tpu_torch.ops.chirp_smoother import (
    ROW_WORDS, expectation_g_cost, expectation_launcher,
    gaussian_expectation_g, smoother_backward_reference,
    smoother_rows_reference)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PARAMS = (0.1, 0.1, 0.1, 1.0, 1.0, 7.0)
LASCALA = (0.1, 1.0, 1.0, 7.0)
B, T, DT, XI = 3, 48, 1e-3, 0.1
TOLS = {"float64": dict(m=1e-10, P=1e-10), "float32": dict(m=5e-5, P=1e-4)}
RULES = {"gh3": (lambda: tq.gauss_hermite(4, 3), lambda: jq.gauss_hermite(4, 3)),
         "cubature": (lambda: tq.cubature(4), lambda: jq.cubature(4))}
MODES = {"factors": {}, "full": dict(return_factors=False),
         "slim": dict(return_factors=False, out_index=2)}


def _np(x):
    return x.detach().cpu().numpy()


def _gram(L):
    return np.einsum("tikb,tjkb->tijb", L, L)


def _ys(n_t=T):
    """Seeds 0-2 of the committed toy data, float64."""
    return np.load(ROOT / "results/data/toydata_const.npz")["ys"][:B, :n_t] \
        .astype(np.float64)


@functools.lru_cache(maxsize=None)
def _jax(rule, dtype, return_factors, model="chirp", n_t=T):
    """The JAX package's fused filter+smoother on the same model and
    measurements, as NumPy arrays: (mss, Lss, nll) or (mss, Pss, nll)."""
    jdt = getattr(jnp, dtype)
    if model == "chirp":
        pack = jm.build_chirp_model(jnp.asarray(PARAMS, jdt))
    else:
        pack = jm.build_lascala_model(jnp.asarray(LASCALA, jdt))
    out = jb.sqrt_sgp_filter_smoother_batched(
        pack.m_and_cov, RULES[rule][1](), pack.H, jdt(XI), pack.m0, pack.P0,
        jdt(DT), jnp.asarray(_ys(n_t), jdt), return_factors=return_factors)
    return tuple(np.asarray(x) for x in out)


def _assert_mode_close(got, want, mode, dtype):
    """``got`` (the port, in ``mode``) against ``want`` (the JAX package's
    factors or full covariances)."""
    tol = TOLS[dtype]
    m, P, nll = want
    if mode == "slim":
        m, P = m[:, 2], P[:, 2, 2]
    npt.assert_allclose(_np(got[0]), m, atol=tol["m"], rtol=0)
    if mode == "factors":
        npt.assert_allclose(_gram(_np(got[1])), _gram(P), atol=tol["P"],
                            rtol=0)
    else:
        npt.assert_allclose(_np(got[1]), P, atol=tol["P"], rtol=0)
    npt.assert_allclose(_np(got[2]), nll, atol=tol["m"], rtol=0)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rule", list(RULES))
def test_wrapper_matches_jax(rule, dtype, mode):
    """The wrapper on CPU tensors against the JAX package's
    ``sqrt_sgp_filter_smoother_batched`` (B=3, T=48): factors, full
    covariances, and the slim output against the full one's slices."""
    tdt = getattr(torch, dtype)
    got = ghfs_chirp_filter_smoother(
        torch.tensor(PARAMS, dtype=tdt), XI, DT, RULES[rule][0](),
        torch.tensor(_ys(), dtype=tdt), **MODES[mode])
    shapes = {"factors": [(T, 4, B), (T, 4, 4, B)],
              "full": [(T, 4, B), (T, 4, 4, B)], "slim": [(T, B), (T, B)]}
    assert [tuple(x.shape) for x in got] == shapes[mode] + [(T, B)]
    assert all(x.dtype == tdt for x in got)
    _assert_mode_close(got, _jax(rule, dtype, mode == "factors"), mode, dtype)


def test_lascala_through_chirp_params_matches_jax_lascala():
    """La Scala is the chirp model at ``lascala_chirp_params``: against the
    JAX package's fused form on the La Scala model, float64, every mode."""
    chirp = lascala_chirp_params(torch.tensor(LASCALA, dtype=torch.float64))
    for mode, kwargs in MODES.items():
        got = ghfs_chirp_filter_smoother(chirp, XI, DT, tq.gauss_hermite(4, 3),
                                         torch.tensor(_ys()), **kwargs)
        _assert_mode_close(got, _jax("gh3", "float64", mode == "factors",
                                     "lascala"), mode, "float64")


@pytest.mark.parametrize("n_t", [1, 3])
def test_short_records_match_jax(n_t):
    """T=1 (the last filtered moments only) and T=3 (past the row-index
    convention's T=2 case: iteration t's maps smooth time t-1), float64."""
    for mode, kwargs in MODES.items():
        got = ghfs_chirp_filter_smoother(PARAMS, XI, DT, tq.cubature(4),
                                         torch.tensor(_ys(n_t)), **kwargs)
        assert got[2].shape == (n_t, B)
        _assert_mode_close(got, _jax("cubature", "float64", mode == "factors",
                                     n_t=n_t), mode, "float64")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_slim_is_the_full_slices_bit_for_bit(dtype):
    """The slim output is the full output's slices and the plain loops'
    (``infer/batched.py``) bit for bit, in every mode: the same carry."""
    tdt = getattr(torch, dtype)
    ys = torch.tensor(_ys(), dtype=tdt)
    rule = tq.gauss_hermite(4, 3)
    full = ghfs_chirp_filter_smoother(PARAMS, XI, DT, rule, ys,
                                      **MODES["full"])
    slim = ghfs_chirp_filter_smoother(PARAMS, XI, DT, rule, ys,
                                      **MODES["slim"])
    assert torch.equal(slim[0], full[0][:, 2])
    assert torch.equal(slim[1], full[1][:, 2, 2])
    assert torch.equal(slim[2], full[2])
    pack = tm.build_chirp_model(torch.tensor(PARAMS, dtype=torch.float64))
    args = (pack.m_and_cov, rule, pack.H, XI, pack.m0, pack.P0, DT, ys)
    for mode, kwargs in MODES.items():
        got = ghfs_chirp_filter_smoother(PARAMS, XI, DT, rule, ys, **kwargs)
        want = tb.sqrt_sgp_filter_smoother_batched(*args, **kwargs)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), mode


@pytest.mark.parametrize("rule", list(RULES))
def test_factor_rows_match_phase_a_twin(rule):
    """F's factor rows against phase A's twin (``smoother_rows_reference``)
    on F's own filtered moments, float64: row t is what iteration t+1
    emits, so m_p and X agree to 1e-10 and R22 by its Gram; then F's rows
    through phase B's twin are the wrapper's factor mode."""
    trule = RULES[rule][0]()
    ys = torch.tensor(_ys(9))
    fwd = fused_forward_reference(PARAMS, XI, DT, trule, ys, factors=True)
    assert fwd.rows.shape == (8, ROW_WORDS, B)
    assert fwd.mfs.shape == (9, 4, B) and fwd.Lfs.shape == (9, 4, 4, B)
    rows_a = _np(smoother_rows_reference(PARAMS, DT, trule, fwd.mfs,
                                         fwd.Lfs))
    rows = _np(fwd.rows)
    npt.assert_allclose(rows[:, :4], rows_a[:, :4], atol=1e-10, rtol=0)
    npt.assert_allclose(rows[:, 4:20], rows_a[:, 4:20],
                        atol=1e-10 * (1 + np.abs(rows_a[:, 4:20]).max()),
                        rtol=0)
    iu = np.triu_indices(4)
    up, up_a = np.zeros((2, 8, 4, 4, B))
    up[:, iu[0], iu[1]], up_a[:, iu[0], iu[1]] = rows[:, 20:], rows_a[:, 20:]
    npt.assert_allclose(np.einsum("tkib,tkjb->tijb", up, up),
                        np.einsum("tkib,tkjb->tijb", up_a, up_a), atol=1e-10,
                        rtol=0)
    mss, Lss = smoother_backward_reference(fwd.mfs, fwd.Lfs, fwd.rows)
    got = ghfs_chirp_filter_smoother(PARAMS, XI, DT, trule, ys)
    assert torch.equal(got[0], mss) and torch.equal(got[1], Lss)


def test_maps_rows_and_affine_twin():
    """Maps mode: the row of iteration t holds u = mf_{t-1} - G m_p, G and
    the upper triangle of D = R22^T R22 (symmetric), and the last
    filtered moments; G's twin over them is the full output."""
    trule = tq.gauss_hermite(4, 3)
    ys = torch.tensor(_ys(6))
    maps = fused_forward_reference(PARAMS, XI, DT, trule, ys)
    fac = fused_forward_reference(PARAMS, XI, DT, trule, ys, factors=True)
    assert maps.rows.shape == (5, ROW_WORDS, B)
    assert maps.mfs.shape == (1, 4, B) and maps.Lfs.shape == (1, 4, 4, B)
    assert torch.equal(maps.mfs[0], fac.mfs[-1])
    assert torch.equal(maps.Lfs[0], fac.Lfs[-1])
    assert torch.equal(maps.nll, fac.nll)
    mp, X = fac.rows[:, :4], fac.rows[:, 4:20].reshape(5, 4, 4, B)
    G = X.transpose(1, 2)
    npt.assert_allclose(_np(maps.rows[:, 4:20]), _np(G.reshape(5, 16, B)),
                        atol=0, rtol=0)
    u = fac.mfs[:-1] - torch.einsum("tijb,tjb->tib", G, mp)
    npt.assert_allclose(_np(maps.rows[:, :4]), _np(u), atol=1e-14, rtol=0)
    ms, Ps = affine_backward_reference(maps.rows, maps.mfs[0], maps.Lfs[0])
    full = ghfs_chirp_filter_smoother(PARAMS, XI, DT, trule, ys,
                                      **MODES["full"])
    assert torch.equal(ms, full[0]) and torch.equal(Ps, full[1])
    npt.assert_allclose(_np(Ps), _np(Ps.transpose(1, 2)), atol=1e-15, rtol=0)


def test_m0_replaces_the_prior_mean():
    """``m0`` replaces the model's prior mean, as the filter's wrapper."""
    m0 = torch.tensor([0.0, 1.0, 0.0, 0.0], dtype=torch.float64)
    rule = tq.cubature(4)
    ys = torch.tensor(_ys(7))
    got = ghfs_chirp_filter_smoother(PARAMS, XI, DT, rule, ys, m0=m0,
                                     **MODES["full"])
    pack = tm.build_chirp_model(torch.tensor(PARAMS, dtype=torch.float64))
    want = tb.sqrt_sgp_filter_smoother_batched(
        pack.m_and_cov, rule, pack.H, XI, m0, pack.P0, DT, ys,
        **MODES["full"])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gaussian_expectation_g_matches_jax(dtype):
    """Phase E's variance mode on the CPU against the JAX package's
    ``gaussian_expectation_batched(v_mean, sqrt(max(v_var, 0)), g)``,
    bench.py's pipeline, with a variance rounded below 0: 1e-12 (float64),
    1e-6 of scale (float32)."""
    rng = np.random.default_rng(3)
    vm = rng.normal(7.0, 2.0, (T, B))
    vv = rng.uniform(0.0, 0.3, (T, B))
    vv[0, 0] = -1e-9
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = gaussian_expectation_g(torch.tensor(vm, dtype=tdt),
                                 torch.tensor(vv, dtype=tdt), 10)
    assert got.shape == (T, B) and got.dtype == tdt
    vmj, vvj = jnp.asarray(vm, jdt), jnp.asarray(vv, jdt)
    want = jb.gaussian_expectation_batched(
        vmj, jnp.sqrt(jnp.maximum(vvj, 0.0)), jm.g)
    atol = 1e-12 if dtype == "float64" else 1e-6 * float(np.abs(want).max())
    npt.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=0)


def test_fused_cost_matches_hand_count():
    """F per seed-step at GH-3, S=81: per point 53 + 32 + 32 = 117, the
    81 x 4 Householder 1154 + 817 + 488 + 167 = 2626, the 12 x 8 joint one
    with its zeros skipped 212 + 211 + 202 + 185 + 132 + 87 + 50 + 21 =
    1100, the gain 64, the update 116; the maps 36 + 40 per step but the
    first.  G 254 per step but the last and 40 per lane.  Words: F reads y
    and writes the nll per seed-step, a 30-word row per step but the
    first, and 20 words of moments per lane (maps) or per seed-step
    (factors); G reads the rows and the last 20 words and writes 20 or 2
    words per seed-step."""
    assert 212 + 211 + 202 + 185 + 132 + 87 + 50 + 21 == 1100
    step = 117 * 81 + 2626 + 1100 + 64 + 116
    assert step == 13383
    n_t, n_b = 3141, 4096
    steps, rows = n_t * n_b, (n_t - 1) * n_b
    for dtype, isz in ((torch.float32, 4), (torch.float64, 8)):
        c = fused_cost(81, n_t, n_b, dtype)
        assert set(c) == {"fused_forward", "fused_forward_factors",
                          "affine_backward", "affine_backward_slim"}
        assert c["fused_forward"] == (step * steps + 76 * rows,
                                      isz * (2 * steps + 30 * rows
                                             + 20 * n_b))
        assert c["fused_forward_factors"] == (step * steps,
                                              isz * (22 * steps + 30 * rows))
        assert c["affine_backward"] == (254 * rows + 40 * n_b,
                                        isz * (30 * rows + 20 * n_b
                                               + 20 * steps))
        assert c["affine_backward_slim"] == (254 * rows + 40 * n_b,
                                             isz * (30 * rows + 20 * n_b
                                                    + 2 * steps))
    # Cubature, S=8: per point 117, the 8 x 4 Householder 132 + 87 + 50 + 21.
    assert fused_cost(8, 1, 1)["fused_forward_factors"].flop == \
        117 * 8 + (132 + 87 + 50 + 21) + 1100 + 64 + 116 == 2506
    assert expectation_g_cost(n_t, n_b, torch.float32) == (
        62 * steps, 12 * steps)


def test_fused_rows():
    """F's rows of dev per member: the fewest built that hold S rows
    (GH-3 81, cubature 8) over a team of 8 or 32."""
    assert TEAMS == tuple(ROWS) == (8, 32)
    assert [fused_rows(8, s) for s in (81, 16, 9, 8, 1)] == [11, 11, 11, 1, 1]
    assert [fused_rows(32, s) for s in (81, 33, 32, 8)] == [3, 3, 1, 1]
    with pytest.raises(ValueError, match="sigma points"):
        fused_rows(8, 82)


def test_kernel_source_matches_wrapper():
    """The kernels are built from ``csrc`` with the (team, rows) instances
    that ``fused_rows`` picks, the packed row of ``chirp_lcd.cuh``; their
    symbols are the ones the wrapper binds."""
    src = (_build.CSRC / "ghfs_chirp_fused.cu").read_text()
    cases = re.findall(r"case (\d+): return FUSED_LAUNCH\((\d+), (\d+)\);",
                       src)
    assert {(int(p), int(r)) for _, p, r in cases} == {
        (p, r) for p in TEAMS for r in ROWS[p]}
    assert all(int(c) == 100 * int(p) + int(r) for c, p, r in cases)
    assert '#include "chirp_lcd.cuh"' in src
    for name in KERNELS[:2]:
        assert re.search(rf"__global__ void __launch_bounds__\(\w+\)\n"
                         rf"{name}_kernel\(", src), name
        for dt in ("f32", "f64"):
            assert re.search(rf"\bint {name}_{dt}\(", src), (name, dt)
    for sym in ("max_points", "num_consts", "row_words"):
        assert re.search(rf"\bint ghfs_chirp_fused_{sym}\(", src), sym


def test_wrapper_rejections():
    ys = torch.tensor(_ys(6))
    rule = tq.cubature(4)
    cases = [
        (dict(sgps=tq.gauss_hermite(4, 4)), "sigma points"),
        (dict(sgps=tq.cubature(2)), "d=4"),
        (dict(sgps=tq.unscented(4, alpha=1.0, beta=0.0, kappa=-2.0)),
         "nonnegative|negative"),
        (dict(yss=ys.long()), "float32 or float64"),
        (dict(yss=ys[0]), r"\(B, T\)"),
        (dict(yss=ys[:, :0]), "T >= 1"),
        (dict(yss=ys.clone().requires_grad_(True)), "gradient"),
        (dict(out_index=2), "return_factors"),
        (dict(return_factors=False, out_index=4), "out_index"),
    ]
    for change, match in cases:
        args = dict(params=PARAMS, Xi=XI, dt=DT, sgps=rule, yss=ys)
        args.update(change)
        with pytest.raises(ValueError, match=match):
            ghfs_chirp_filter_smoother(**args)
    with pytest.raises(ValueError, match="6 values"):
        ghfs_chirp_filter_smoother(PARAMS[:4], XI, DT, rule, ys)
    with pytest.raises(ValueError, match="float32 or float64"):
        gaussian_expectation_g(ys, ys.float())
    with pytest.raises(ValueError, match="order"):
        gaussian_expectation_g(ys, ys, 33)


def test_cpu_route_launches_nothing_and_kernel_entries_refuse_cpu(
        monkeypatch):
    """A CPU tensor takes the plain twins without building or launching; the
    kernels' own entry points have no plain route."""
    monkeypatch.setattr(ghfs_chirp_filter_smoother, "launches", 0)
    monkeypatch.setattr(ghfs_chirp_filter_smoother, "kernel_launches",
                        dict.fromkeys(KERNELS, 0))
    monkeypatch.setattr(gaussian_expectation_g, "launches", 0)

    def no_build():
        raise AssertionError("built a kernel for a CPU tensor")

    monkeypatch.setattr(chirp_fused, "load_fused_kernel", no_build)
    ys = torch.tensor(_ys(5))
    rule = tq.cubature(4)
    for kwargs in MODES.values():
        got = ghfs_chirp_filter_smoother(PARAMS, XI, DT, rule, ys, **kwargs)
        want = ghfs_chirp_filter_smoother_reference(PARAMS, XI, DT, rule, ys,
                                                    **kwargs)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    gaussian_expectation_g(ys.T, ys.T)
    assert ghfs_chirp_filter_smoother.launches == 0
    assert set(ghfs_chirp_filter_smoother.kernel_launches.values()) == {0}
    assert gaussian_expectation_g.launches == 0
    with pytest.raises(ValueError, match="cuda"):
        fused_kernel_launcher(PARAMS, XI, DT, rule, ys)
    with pytest.raises(ValueError, match="cuda"):
        expectation_launcher(ys.T, ys.T)
