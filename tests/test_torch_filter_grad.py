"""PyTorch port vs the JAX package: the Table-I sweep objective on the
per-lane filter route (``ops/chirp_filter_grad.py``): the sqrt GHFS filter
NLL of the chirp model with one theta per lane and its closed-form
adjoint, here through their plain versions (the CPU route of
``ChirpFilterNLL``), reached by ``make_nll_fn``.

Tolerances: float64 value 1e-8 relative and gradient 1e-8 of max |grad|
against ``jax.vmap(jax.value_and_grad(make_nll_fn))`` (the level of
tests/test_torch_batched.py); float32 (T=300) each lane's gradient no
further from JAX's float64 gradient than twice JAX's own float32
gradient plus 1e-5 of max |grad|; the lane constants 1e-12 of
``_chirp_constants``; the plain adjoint 1e-9 of max |adjoint| of autograd
through the plain forward; the vmapped route against each lane alone
1e-12 relative; a NaN lane leaves the others' bits, and a lane's bits do
not depend on its batch.  The plain adjoint's two parts, as the kernel
splits it: the carry-free part's m_p, P_p and innovation against JAX's
``_sqrt_predict_sgp`` on the same m and L, float64 within 1e-12 of each
one's max |value|, float32 within 5e-6 (JAX in float64 on the
float32-rounded m and L: the float32 rounding of S-point sums); the
carry-free part composed with the chain against autograd through the
plain forward, float64 1e-9 of each lane's max |adjoint| (as above),
float32 no further from the float64 autograd than twice the float32
autograd plus 1e-6."""

import concurrent.futures
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.apps.pipeline as jp
import chirpgp_tpu_torch.apps.pipeline as tp
from chirpgp_tpu_torch.fit import batched_value_and_grad
from chirpgp_tpu_torch.models import g, g_inv
from chirpgp_tpu_torch.ops import chirp_filter_grad as cg
from chirpgp_tpu_torch.ops.chirp_filter import _chirp_constants

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MAGS = ("const", "damped", "random")
QUADS = {"gauss_hermite": "ghfs", "cubature": "ckfs"}


def _seed0(T):
    """ys (3, T): seed 0 of each magnitude's Table-I records."""
    return np.stack([np.load(ROOT / f"results/data/toydata_{m}.npz")["ys"][0, :T]
                     for m in MAGS]).astype(np.float64)


def _thetas(quad, point):
    """(3, 6) float64 theta per lane: the default init (shifted a little
    per lane), or seed 0's committed optimum of the column of each
    magnitude."""
    if point == "init":
        base = np.asarray(tp.IFEstimationConfig().default_init_theta(
            torch.float64))
        return base + 0.05 * np.arange(3.0)[:, None]
    params = np.stack([np.load(ROOT / f"results/{QUADS[quad]}_{m}.npz")
                       ["params"][0] for m in MAGS]).astype(np.float64)
    return g_inv(torch.tensor(params)).numpy()


def _jax_vg(quad, thetas, ys):
    cfg = jp.IFEstimationConfig(method="ghfs", form="sqrt", quadrature=quad)
    vg = jax.vmap(lambda th, y: jax.value_and_grad(jp.make_nll_fn(cfg, y))(th))
    v, gr = vg(jnp.asarray(thetas), jnp.asarray(ys))
    return np.asarray(v), np.asarray(gr)


def _route_vg(quad, thetas, ys):
    cfg = tp.IFEstimationConfig(method="ghfs", form="sqrt", quadrature=quad)
    assert tp._kernel_objective(cfg)
    vg = batched_value_and_grad(lambda th, y: tp.make_nll_fn(cfg, y)(th),
                                (torch.as_tensor(ys),))
    v, gr = vg(torch.as_tensor(thetas))
    return v.numpy(), gr.numpy()


@pytest.mark.parametrize("point", ["init", "optimum"])
@pytest.mark.parametrize("quad", list(QUADS))
def test_route_value_and_grad_match_jax_float64(quad, point):
    """B=3 (seed 0 of each magnitude), T=40, float64."""
    ys, thetas = _seed0(40), _thetas(quad, point)
    vj, gj = _jax_vg(quad, thetas, ys)
    before = dict(cg.ChirpFilterNLL.launches)
    vt, gt = _route_vg(quad, thetas, ys)
    assert cg.ChirpFilterNLL.launches == before   # the CPU: no kernel
    assert vt.dtype == np.float64
    npt.assert_allclose(vt, vj, rtol=1e-8, atol=0)
    npt.assert_allclose(gt, gj, rtol=0, atol=1e-8 * np.abs(gj).max())


@pytest.mark.parametrize("quad", list(QUADS))
def test_route_float32_gradient_against_jax(quad):
    """T=300 on seed 0 of each magnitude at the default init, float32
    theta and data on both sides: per lane, the route's float32 gradient
    is no further from JAX's float64 gradient than twice JAX's float32
    gradient is, plus 1e-5 of max |grad|; the value within 1e-5."""
    ys, thetas = _seed0(300), _thetas(quad, "init")
    v64, g64 = _jax_vg(quad, thetas, ys)
    # JAX in float32 throughout, as without x64 (the TPU's precision).
    with jax.enable_x64(False):
        vj32, gj32 = _jax_vg(quad, thetas.astype(np.float32),
                             ys.astype(np.float32))
    assert vj32.dtype == np.float32
    vt, gt = _route_vg(quad, thetas.astype(np.float32), ys.astype(np.float32))
    assert vt.dtype == np.float32 and gt.dtype == np.float32
    npt.assert_allclose(vt, v64, rtol=1e-5, atol=0)
    for i in range(3):
        scale = np.abs(g64[i]).max()
        route = np.abs(gt[i] - g64[i]).max()
        jax32 = np.abs(gj32[i] - g64[i]).max()
        assert route <= 2.0 * jax32 + 1e-5 * scale, (i, route, jax32, scale)


def test_lane_constants_match_host_constants():
    """``chirp_lane_constants`` under ``torch.func.vmap`` against the
    host's float64 ``_chirp_constants``, lane by lane, to 1e-12."""
    params = g(torch.tensor(np.concatenate(
        [_thetas(q, p) for q in QUADS for p in ("init", "optimum")])))
    for Xi, dt in ((0.1, 1e-3), (0.25, 1e-2)):
        lanes = torch.func.vmap(
            lambda p: cg.chirp_lane_constants(p, Xi, dt))(params)
        assert lanes.shape == (params.shape[0], cg.NUM_CONSTS)
        for i in range(params.shape[0]):
            npt.assert_allclose(lanes[i].numpy(),
                                _chirp_constants(params[i], Xi, dt),
                                rtol=0, atol=1e-12)


def test_plain_adjoint_is_autograd_of_the_plain_forward():
    """dNLL/dconsts of every one of the 43 constants (dt and sqrt(Xi)
    too, the lower triangle of L0, which the kernels read) times a gbar
    per lane: the closed-form reverse loop against autograd through
    ``filter_nll_reference``, float64, both rules, 1e-9 of max |adjoint|
    per lane."""
    ys = torch.tensor(_seed0(25))
    lower = torch.ones(cg.NUM_CONSTS, dtype=torch.bool)
    lower[20:36] = torch.tril(torch.ones(4, 4, dtype=torch.bool)).reshape(-1)
    for quad in QUADS:
        sgps = tp.IFEstimationConfig(quadrature=quad).sigma_points()
        consts = torch.func.vmap(lambda p: cg.chirp_lane_constants(
            p, 0.1, 1e-3))(g(torch.tensor(_thetas(quad, "optimum"))))
        gbar = torch.tensor([1.0, -0.5, 2.0], dtype=torch.float64)
        c = consts.clone().requires_grad_(True)
        _, _, nll = cg.filter_nll_reference(c, sgps, ys)
        auto, = torch.autograd.grad(nll, c, gbar)
        mfs, lfs, nll2 = cg.filter_nll_reference(consts, sgps, ys)
        npt.assert_array_equal(nll2.numpy(), nll.detach().numpy())
        got = cg.filter_nll_adjoint_reference(consts, sgps, ys, mfs, lfs,
                                              gbar)
        assert got.shape == consts.shape
        for i in range(3):
            npt.assert_allclose(got[i, lower].numpy(), auto[i, lower].numpy(),
                                rtol=0, atol=1e-9 * float(auto[i].abs().max()))
            assert not bool(got[i, ~lower].any())


_SPLIT_T = (1, 2, 50)
_LOWER = torch.ones(cg.NUM_CONSTS, dtype=torch.bool)
_LOWER[20:36] = torch.tril(torch.ones(4, 4, dtype=torch.bool)).reshape(-1)


def _split_inputs(quad, T, dtype):
    """B=3 (seed 0 of each magnitude, the default init shifted per lane):
    ``(sgps, thetas (3, 6) float64, consts, ys)``, consts and ys in
    ``dtype``, and the plain forward's means and factors."""
    sgps = tp.IFEstimationConfig(quadrature=quad).sigma_points()
    thetas = _thetas(quad, "init")
    consts = torch.func.vmap(lambda p: cg.chirp_lane_constants(
        p, 0.1, 1e-3))(g(torch.tensor(thetas))).to(dtype)
    ys = torch.tensor(_seed0(T), dtype=dtype)
    mfs, lfs, _ = cg.filter_nll_reference(consts, sgps, ys)
    return sgps, thetas, consts, ys, mfs, lfs


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("quad", list(QUADS))
@pytest.mark.parametrize("T", _SPLIT_T)
def test_carry_free_part_matches_jax_predict(T, quad, dtype):
    """Every step's m_p, P_p and innovation y_t - m_p[1] of
    ``adjoint_carry_free`` (batched over the T steps and 3 lanes) against
    ``chirpgp_tpu/infer/sqrt.py::_sqrt_predict_sgp`` (P_p = Up^T Up) of
    the JAX model at the lane's theta, on the same m_{t-1} and L_{t-1}
    (m0 and L0 at t = 0)."""
    from chirpgp_tpu.infer.sqrt import _sqrt_predict_sgp
    from chirpgp_tpu.models.transitions import as_transition
    sgps, thetas, consts, ys, mfs, lfs = _split_inputs(quad, T,
                                                       getattr(torch, dtype))
    cf = cg.adjoint_carry_free(consts, sgps, ys, mfs, lfs)
    assert cf.t0 == 0 and cf.Pp.shape == (T, 4, 4, 3)
    cfg = jp.IFEstimationConfig(method="ghfs", form="sqrt", quadrature=quad)
    tol = 1e-12 if dtype == "float64" else 5e-6
    for b in range(3):
        trans = as_transition(cfg.build(jp.g(jnp.asarray(thetas[b])))
                              .m_and_cov)
        c = consts[b].double().numpy()
        m = np.concatenate([c[None, 36:40], _np64(mfs[:T - 1, :, b])])
        L = np.concatenate([c[None, 20:36], _np64(lfs[:T - 1, :, b])]
                           ).reshape(T, 4, 4)
        mp, Up = jax.vmap(lambda mm, LL: _sqrt_predict_sgp(
            cfg.sigma_points(), trans, cfg.dt, mm, LL)[:2])(
                jnp.asarray(m), jnp.asarray(L))
        mp = np.asarray(mp)
        Pp = np.einsum("tki,tkj->tij", np.asarray(Up), np.asarray(Up))
        innov = _np64(ys[b]) - mp[:, 1]
        for got, want in ((cf.mp[..., b], mp), (cf.Pp[..., b], Pp),
                          (cf.innov[:, b], innov)):
            npt.assert_allclose(_np64(got), want, rtol=0,
                                atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("quad", list(QUADS))
@pytest.mark.parametrize("T", _SPLIT_T)
def test_split_adjoint_is_autograd_of_the_plain_forward(T, quad, dtype):
    """``adjoint_chain`` over ``adjoint_carry_free``'s part, with a gbar
    per lane, against autograd through ``filter_nll_reference``: every
    constant the kernels read (the lower triangle of L0; its upper words
    0)."""
    tdt = getattr(torch, dtype)
    sgps, _, consts, ys, mfs, lfs = _split_inputs(quad, T, tdt)
    gbar = torch.tensor([1.0, -0.5, 2.0], dtype=tdt)
    got = cg.adjoint_chain(consts, sgps, [cg.adjoint_carry_free(
        consts, sgps, ys, mfs, lfs)], gbar)
    assert got.shape == consts.shape and got.dtype == tdt
    assert not bool(got[:, ~_LOWER].any())

    def auto(dt):
        c = consts.to(dt).clone().requires_grad_(True)
        _, _, nll = cg.filter_nll_reference(c, sgps, ys.to(dt))
        return torch.autograd.grad(nll, c, gbar.to(dt))[0].double()

    a64 = auto(torch.float64)
    scale = a64.abs().amax(1)
    dev = float(((got.double() - a64)[:, _LOWER].abs().amax(1) / scale).max())
    if dtype == "float64":
        assert dev <= 1e-9, dev
        return
    a32 = float(((auto(torch.float32) - a64)[:, _LOWER].abs().amax(1)
                 / scale).max())
    assert dev <= 2.0 * a32 + 1e-6, (dev, a32)


def _np64(x):
    return x.double().numpy()


def _batch_vg(thetas, ys):
    cfg = tp.IFEstimationConfig(method="ghfs", form="sqrt")
    return batched_value_and_grad(lambda th, y: tp.make_nll_fn(cfg, y)(th),
                                  (ys,))(thetas)


def test_nan_lane_leaves_the_others_bit_equal():
    """Lane 1 at delta = softplus(-800) = 0 (P0 singular, L0 NaN): its
    value and gradient are NaN, nothing raises, and lanes 0 and 2 keep the
    bits they have beside a finite lane 1."""
    ys = torch.tensor(_seed0(30))
    thetas = torch.tensor(_thetas("gauss_hermite", "init"))
    v, gr = _batch_vg(thetas, ys)
    bad = thetas.clone()
    bad[1, 2] = -800.0
    vb, gb = _batch_vg(bad, ys)
    assert bool(torch.isnan(vb[1])) and bool(torch.isnan(gb[1]).all())
    for i in (0, 2):
        assert torch.equal(vb[i], v[i]) and torch.equal(gb[i], gr[i])


def test_vmapped_route_equals_each_lane_alone():
    """One vmapped value-and-grad of 3 lanes against ``make_nll_fn`` and
    ``torch.autograd`` on each lane alone (the lane route of
    ``ChirpFilterNLL``), 1e-12 relative; and ``torch.func.vmap`` of the
    objective with the records unbatched (one record, many thetas, as
    NUTS's chains) against the same."""
    cfg = tp.IFEstimationConfig(method="ghfs", form="sqrt")
    ys = torch.tensor(_seed0(30))
    thetas = torch.tensor(_thetas("gauss_hermite", "optimum"))
    values, grads = _batch_vg(thetas, ys)
    for i in range(3):
        th = thetas[i].clone().requires_grad_(True)
        v = tp.make_nll_fn(cfg, ys[i])(th)
        assert v.shape == ()
        gr, = torch.autograd.grad(v, th)
        npt.assert_allclose(float(v.detach()), float(values[i]), rtol=1e-12)
        npt.assert_allclose(gr.numpy(), grads[i].numpy(), rtol=0,
                            atol=1e-12 * float(gr.abs().max()))
    one = tp.make_nll_fn(cfg, ys[0])
    chains = torch.func.vmap(one)(thetas)
    for i in range(3):
        npt.assert_allclose(float(chains[i]), float(one(thetas[i])),
                            rtol=1e-12)


def test_lane_bits_do_not_depend_on_the_batch():
    """A lane's float32 value and gradient have the same bits in a batch
    of 3 as alone (a sweep split over ranks writes the column of one
    rank: test_monolithic_sweep_splits_over_torchrun_ranks)."""
    ys = torch.tensor(_seed0(40), dtype=torch.float32)
    thetas = torch.tensor(_thetas("gauss_hermite", "init"),
                          dtype=torch.float32)
    values, grads = _batch_vg(thetas, ys)
    for i in range(3):
        v, gr = _batch_vg(thetas[i:i + 1], ys[i:i + 1])
        assert torch.equal(v[0], values[i]) and torch.equal(gr[0], grads[i])


def test_route_on_two_threads():
    """The float64 polish evaluates the objective from host threads: two
    lanes of the route, value and gradient, on two threads at once equal
    each alone."""
    cfg = tp.IFEstimationConfig(method="ghfs", form="sqrt")
    ys = torch.tensor(_seed0(30))
    thetas = torch.tensor(_thetas("gauss_hermite", "init"))

    def vg(i):
        th = thetas[i].clone().requires_grad_(True)
        v = tp.make_nll_fn(cfg, ys[i])(th)
        gr, = torch.autograd.grad(v, th)
        return float(v.detach()), gr.numpy()

    alone = [vg(i) for i in range(3)]
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
        together = list(ex.map(vg, range(3)))
    for (va, ga), (vt, gt) in zip(alone, together):
        assert va == vt
        npt.assert_array_equal(ga, gt)


def test_route_is_chosen_by_the_configuration():
    """The sqrt GHFS of the chirp model with GH (orders up to 3: S <= 81)
    or cubature takes the route; every other configuration keeps its
    eager filter.  A tensor on neither the CPU nor a card raises."""
    C = tp.IFEstimationConfig
    assert tp._kernel_objective(C(form="sqrt"))
    assert tp._kernel_objective(C(form="sqrt", quadrature="cubature"))
    assert tp._kernel_objective(C(form="sqrt", gh_order=2))
    for cfg in (C(), C(form="sqrt", gh_order=4), C(form="sqrt",
                                                    method="ekfs"),
                C(form="sqrt", quadrature="unscented"),
                C(form="sqrt", model="lascala"),
                C(form="sqrt", model="harmonic", quadrature="cubature"),
                C(method="cd_ghfs")):
        assert not tp._kernel_objective(cfg)
    consts = torch.zeros((2, cg.NUM_CONSTS), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        cg.chirp_filter_nll(consts, torch.zeros((2, 5), device="meta"),
                            tp.IFEstimationConfig().sigma_points())


def test_costs_count_the_step():
    """The cost functions are linear in T and B, with the per-step counts
    of their docstrings."""
    f = cg.forward_cost(81, 10, 3)
    a = cg.adjoint_cost(81, 10, 3, torch.float64)
    assert a.flop == (178 * 81 + 260) * 30
    assert a.bytes == 8 * (15 * 30 + 87 * 3)
    assert f.bytes == 4 * (21 * 30 + 44 * 3)
    assert cg.forward_cost(81, 20, 6).flop == 4 * f.flop


def test_adjoint_source_matches_the_wrapper():
    """The adjoint kernel is built for the teams and rows and the (rows,
    producers) pairs the wrapper's ``TEAM_ROWS`` and ``CHAIN_PRODUCERS``
    list, with the chain design's team, largest ring and most lanes a
    block; ``adjoint_geometry`` picks only those (the chain design while
    its blocks fit 132 SMs at once, ceil(B / 132) lanes a block up to 3,
    its ring at least one step per producer and at most
    ``CHAIN_MAX_RING``; beyond, the team of 32 up to 16 lanes per SM and
    the team of 8, in one wave at B = 4096), and the kernels read the
    constants at the offsets of
    ``chirp_lane_constants``' layout, and the per-lane forward's C entries
    take the argument count the wrapper declares."""
    import re
    from chirpgp_tpu_torch.ops import _build
    src = (_build.CSRC / "ghfs_chirp_filter_adjoint.cu").read_text()
    cases = {int(c) for c in re.findall(r"case (\d+): return", src)}
    assert cases == {100 * team + r for team, rows in cg.TEAM_ROWS.items()
                     for r in rows} | {
        10000 * k + 100 * cg.CHAIN_TEAM + r for r, k in cg.CHAIN_PRODUCERS}
    assert int(re.search(r"kChainTeam = (\d+);", src)[1]) == cg.CHAIN_TEAM
    assert int(re.search(r"kMaxRing = (\d+);", src)[1]) == cg.CHAIN_MAX_RING
    assert int(re.search(r"kChainLanes = (\d+);", src)[1]) == \
        cg.CHAIN_MAX_LANES
    for quad in QUADS:
        S = tp.IFEstimationConfig(quadrature=quad).sigma_points().n_points
        for dtype in (torch.float32, torch.float64):
            for B, lanes in ((1, 1), (33, 1), (264, 2), (300, 3), (396, 3)):
                geo = cg.adjoint_geometry(B, S, 132, dtype)
                assert geo.design == "chain" and geo.lanes_per_block == lanes
                assert geo.blocks == -(-B // lanes) <= 132   # one wave
                assert (geo.rows, geo.producers) in cg.CHAIN_PRODUCERS
                assert geo.producers <= geo.ring <= cg.CHAIN_MAX_RING
            for B in (397, 1000, 2112):
                geo = cg.adjoint_geometry(B, S, 132, dtype)
                assert (geo.design, geo.team, geo.lanes_per_block,
                        geo.blocks) == ("team", 32, 1, B)
                assert geo.rows in cg.TEAM_ROWS[32] and 32 * geo.rows >= S
            for B in (2113, 4096):
                geo = cg.adjoint_geometry(B, S, 132, dtype)
                assert (geo.design, geo.team, geo.lanes_per_block) == (
                    "team", 8, 4)
                assert geo.rows in cg.TEAM_ROWS[8] and 8 * geo.rows >= S
            # One wave at B = 4096: 8 warps an SM.
            assert cg.adjoint_geometry(4096, S, 132, dtype).blocks == 1024
    header = (_build.CSRC / "chirp_lcd.cuh").read_text()
    words = dict(re.findall(r"k(LqT|L0|M0|Decay|SqrtXi|Dt)Word = (\d+)",
                            header))
    assert {k: int(v) for k, v in words.items()} == {
        "LqT": cg._LQT, "L0": cg._L0, "M0": cg._M0, "Decay": cg._DECAY,
        "SqrtXi": cg._SQRT_XI, "Dt": cg._DT}
    fwd = (_build.CSRC / "ghfs_chirp_filter.cu").read_text()
    entry = re.search(r"int ghfs_chirp_filter_lanes_f32\(([^)]*)\)", fwd)[1]
    assert len(entry.split(",")) == 15
    adj = re.search(r"int ghfs_chirp_filter_adjoint_f32\(([^)]*)\)", src)[1]
    assert len(adj.split(",")) == 17


def test_timing_copies_of_the_adjoint_apply():
    """``time_sweep_objective.py``'s copies of the adjoint source (the
    team design with clock stamps, which ``--breakdown`` builds for the
    chain floor, and each timing variant) find every text they
    change in the shipped source, once, and the stamped copy writes the
    stamps of member 0 of each lane."""
    import re
    import sys
    from chirpgp_tpu_torch.ops import _build
    sys.path.insert(0, str(ROOT))
    import time_sweep_objective as tso
    src = tso.stamped_sources(_build.CSRC)["ghfs_chirp_filter_adjoint.cu"]
    assert set(re.findall(r"STAMP\((\d+)\)", src)) == {
        str(k) for k in range(len(tso.PARTS))}
    assert "g_adjoint_stamps[b * " in src
    shipped = (_build.CSRC / "ghfs_chirp_filter_adjoint.cu").read_text()
    for name, subs in tso.VARIANTS.items():
        for text, _ in subs:
            assert shipped.count(text) == 1, (name, text)
