"""The PyTorch port's parallel-in-time filters and smoothers against the JAX
package: the unrolled solvers, ``jax.lax.associative_scan``, the element
combines, the associative-scan KF/RTS (flat and blocked) on the committed
``results/data/parallel_kf_ref.npz`` record, its gradient, and the
iterated parallel sigma-point smoother.

The same NumPy inputs go to both packages; float64 agrees to round-off
(1e-9 to 1e-12), float32 within 1% of the scale of the float64 truth.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.infer.parallel_kf as jpk
import chirpgp_tpu.infer.parallel_sgp as jps
from chirpgp_tpu.models import build_chirp_model as jax_build_chirp
from chirpgp_tpu.models import disc_m32 as jax_disc_m32
from chirpgp_tpu.quad import gauss_hermite as jax_gh
from chirpgp_tpu.utils.numerics import (
    psd_solve_batched as jax_psd_solve_batched, solve_small as jax_solve_small)

import chirpgp_tpu_torch.infer.parallel_kf as tpk
import chirpgp_tpu_torch.infer.parallel_sgp as tps
from chirpgp_tpu_torch.infer import kf_parallel, kf_rts_parallel, rts_parallel
from chirpgp_tpu_torch.models import (
    build_chirp_model, disc_m32, m32_solution, stationary_cov_m32)
from chirpgp_tpu_torch.quad import gauss_hermite
from chirpgp_tpu_torch.utils.numerics import psd_solve_batched, solve_small

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REF = np.load(ROOT / "results/data/parallel_kf_ref.npz")
XI, DT = 0.1, 1e-3
PARAMS = (0.1, 0.1, 0.1, 1.0, 1.0, 7.0)


def _t(x, dtype=torch.float64):
    return torch.tensor(np.array(x), dtype=dtype)


def _np(x):
    return x.detach().cpu().numpy()


def _close(got, want, rtol):
    """Deviation within ``rtol`` of the scale of ``want``."""
    got, want = np.asarray(got), np.asarray(want)
    npt.assert_allclose(got, want, rtol=0,
                        atol=rtol * max(np.abs(want).max(), 1e-300))


def _psd(rng, n, d, scale=1.0):
    M = scale * rng.standard_normal((n, d, d))
    return M @ np.swapaxes(M, -1, -2)


# -- the unrolled solvers ----------------------------------------------------

@pytest.mark.parametrize("d", [2, 3, 4, 6, 10])
def test_solve_small_matches_jax(d):
    """The combines' systems ``I + C J`` (C, J PSD), as
    tests/test_numerics_policy.py builds them."""
    rng = np.random.default_rng(d)
    A = np.eye(d) + _psd(rng, 7, d, 0.3) @ _psd(rng, 7, d, 0.3)
    B = rng.standard_normal((7, d, d))
    got = _np(solve_small(_t(A), _t(B)))
    _close(got, jax_solve_small(jnp.asarray(A), jnp.asarray(B)), 1e-12)
    _close(got, np.linalg.solve(A, B), 1e-9)


@pytest.mark.parametrize("d", [2, 3, 4, 6, 10])
def test_psd_solve_batched_matches_jax(d):
    rng = np.random.default_rng(10 + d)
    P = _psd(rng, 5, d) + 0.1 * np.eye(d)
    B = rng.standard_normal((5, d, 3))
    got = _np(psd_solve_batched(_t(P), _t(B)))
    _close(got, jax_psd_solve_batched(jnp.asarray(P), jnp.asarray(B)), 1e-12)
    _close(got, np.linalg.solve(P, B), 1e-9)


def test_solve_small_no_pivot_caveat():
    """Without pivoting, a zero leading minor at d = 3 gives non-finite
    output in both packages (the reference's caveat, kept); a pivoted
    solve is finite there, and on the combines' own inputs ``I + C J`` it
    agrees with the unrolled solve to 1e-12."""
    A = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])[None]
    B = np.eye(3)[None]
    assert not np.isfinite(_np(solve_small(_t(A), _t(B)))).all()
    assert not np.isfinite(np.asarray(
        jax_solve_small(jnp.asarray(A), jnp.asarray(B)))).all()
    assert np.isfinite(_np(torch.linalg.solve(_t(A), _t(B)))).all()

    F, Sigma = m32_solution(1.0, 1.0, DT)
    e = tpk._filter_elements(F, Sigma, _t([1.0, 0.0]), XI, _t([0.0, 0.0]),
                             stationary_cov_m32(1.0, 1.0),
                             _t(REF["ys_T3141"][:64]))
    rng = np.random.default_rng(3)
    for d, C, J in ((2, e.C[:-1], e.J[1:]),
                    (4, _t(_psd(rng, 63, 4, 0.5)), _t(_psd(rng, 63, 4, 0.5)))):
        A = torch.eye(d, dtype=torch.float64) + C @ J
        I = torch.eye(d, dtype=torch.float64).expand(A.shape)
        _close(_np(torch.linalg.solve(A, I)), _np(solve_small(A, I)), 1e-12)


# -- the associative scan and the combines -----------------------------------

def _orthogonal(rng, T):
    """Rotations and reflections in 2-D: a non-commutative group whose
    products stay bounded."""
    th = rng.uniform(0.0, 2.0 * np.pi, T)
    sg = rng.choice([-1.0, 1.0], T)
    return np.stack([np.array([[np.cos(a), -np.sin(a)],
                               [s * np.sin(a), s * np.cos(a)]])
                     for a, s in zip(th, sg)])


@pytest.mark.parametrize("T", [1, 2, 7, 3141])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_matches_jax(T, reverse):
    M = _orthogonal(np.random.default_rng(T), T)
    want = jax.jit(lambda m: jax.lax.associative_scan(
        lambda a, b: a @ b, m, reverse=reverse))(jnp.asarray(M))
    got = tpk.associative_scan(lambda a, b: a @ b, _t(M), reverse=reverse)
    _close(_np(got), want, 1e-13)


def _random_filter_element(rng, n, d, pkg):
    C, J = _psd(rng, n, d, 0.5), _psd(rng, n, d, 0.5)
    A = rng.standard_normal((n, d, d))
    b, eta = rng.standard_normal((n, d)), rng.standard_normal((n, d))
    cls, conv = ((jpk._FilterElement, jnp.asarray) if pkg == "jax"
                 else (tpk._FilterElement, _t))
    return cls(*(conv(x) for x in (A, b, C, eta, J)))


@pytest.mark.parametrize("d", [2, 4])
def test_combines_and_identities_match_jax(d):
    """``_combine_filter`` and ``_combine_smoother`` against JAX on random
    elements, and their identities two-sided in both packages."""
    ej = [_random_filter_element(np.random.default_rng(s), 5, d, "jax")
          for s in (1, 2)]
    et = [_random_filter_element(np.random.default_rng(s), 5, d, "torch")
          for s in (1, 2)]
    for got, want in zip(tpk._combine_filter(*et), jpk._combine_filter(*ej)):
        _close(_np(got), want, 1e-12)
    ident = tpk._tree_map(lambda i: i.expand((5,) + i.shape),
                          tpk.filter_identity(d, torch.float64))
    for left, right in ((ident, et[0]), (et[0], ident)):
        for got, want in zip(tpk._combine_filter(left, right), et[0]):
            _close(_np(got), _np(want), 1e-12)

    rng = np.random.default_rng(5)
    sm = [[rng.standard_normal((5, d, d)), rng.standard_normal((5, d)),
           _psd(rng, 5, d)] for _ in range(2)]
    got = tpk._combine_smoother(*(tpk._SmootherElement(*map(_t, s))
                                  for s in sm))
    want = jpk._combine_smoother(*(jpk._SmootherElement(*map(jnp.asarray, s))
                                   for s in sm))
    for g_, w_ in zip(got, want):
        _close(_np(g_), w_, 1e-12)
    se = tpk._SmootherElement(*map(_t, sm[0]))
    sid = tpk._tree_map(lambda i: i.expand((5,) + i.shape),
                        tpk.smoother_identity(d, torch.float64))
    for left, right in ((sid, se), (se, sid)):
        for g_, w_ in zip(tpk._combine_smoother(left, right), se):
            _close(_np(g_), _np(w_), 1e-12)


# -- the associative-scan KF/RTS ----------------------------------------------

def _m32(dtype):
    F, Sigma = m32_solution(1.0, 1.0, DT)
    return (F.to(dtype), Sigma.to(dtype), torch.tensor([1.0, 0.0], dtype=dtype),
            torch.zeros(2, dtype=dtype), stationary_cov_m32(1.0, 1.0).to(dtype))


def _jax_m32():
    from chirpgp_tpu.models import (
        m32_solution as jm32, stationary_cov_m32 as jcov)
    F, Sigma = jm32(1.0, 1.0, DT)
    return F, Sigma, jnp.array([1.0, 0.0]), jnp.zeros(2), jcov(1.0, 1.0)


@pytest.mark.parametrize("block_size", [None, 7, 128, 3141])
def test_kf_rts_parallel_matches_jax(block_size):
    """T=3141 record of parallel_kf_ref.npz, float64: the port against the
    JAX package to 1e-10 of scale, the smoothed means against the committed
    float64 truth to 1e-8."""
    ys = REF["ys_T3141"].astype(np.float64)
    F, Sigma, H, m0, P0 = _jax_m32()
    want = jax.jit(lambda y: jpk.kf_rts_parallel(
        F, Sigma, H, XI, m0, P0, y, block_size=block_size))(jnp.asarray(ys))
    got = kf_rts_parallel(*_m32(torch.float64)[:3], XI,
                          *_m32(torch.float64)[3:], _t(ys),
                          block_size=block_size)
    for g_, w_ in zip(got, want):
        _close(_np(g_), w_, 1e-10)
    _close(_np(got[3]), REF["mss_T3141"], 1e-8)
    npt.assert_allclose(float(got[2][-1]), float(REF["nll_T3141"]), rtol=1e-12)


@pytest.mark.parametrize("block_size", [None, 128, 512])
def test_kf_rts_parallel_float32_within_one_percent(block_size):
    """Float32 from the committed float32 measurement bytes: the smoothed
    means within 1% of the truth's scale (bench.py's contract), float32
    end to end."""
    F, Sigma, H, m0, P0 = _m32(torch.float32)
    out = kf_rts_parallel(F, Sigma, H, XI, m0, P0,
                          torch.from_numpy(REF["ys_T3141"].copy()),
                          block_size=block_size)
    assert all(x.dtype == torch.float32 for x in out)
    truth = REF["mss_T3141"]
    assert np.abs(_np(out[3]) - truth).max() <= 0.01 * np.abs(truth).max()


def test_kf_parallel_nll_gradient_matches_jax():
    """d nll[-1] / d(F, Sigma, Xi) through the flat scan against jax.grad,
    float64, to 1e-8 of scale."""
    ys = REF["ys_T3141"].astype(np.float64)
    F, Sigma, H, m0, P0 = _jax_m32()
    want = jax.jit(jax.grad(
        lambda F_, S_, X_: jpk.kf_parallel(F_, S_, H, X_, m0, P0,
                                           jnp.asarray(ys))[2][-1],
        argnums=(0, 1, 2)))(F, Sigma, XI)
    tF, tS, tH, tm0, tP0 = _m32(torch.float64)
    args = [x.clone().requires_grad_(True)
            for x in (tF, tS, torch.tensor(XI, dtype=torch.float64))]
    nll = kf_parallel(args[0], args[1], tH, args[2], tm0, tP0, _t(ys))[2][-1]
    got = torch.autograd.grad(nll, args)
    for g_, w_ in zip(got, want):
        _close(_np(g_), w_, 1e-8)


def test_rts_parallel_blocked_equals_flat_reversed_padding():
    """A blocked smoother whose block does not divide T-1 pads the tail
    of the reversed sequence with the identity: it equals the flat scan."""
    F, Sigma, H, m0, P0 = _m32(torch.float64)
    mfs, Pfs, _ = kf_parallel(F, Sigma, H, XI, m0, P0,
                              _t(REF["ys_T3141"][:301]))
    flat = rts_parallel(F, Sigma, mfs, Pfs)
    for bs in (7, 64):
        for a, b in zip(rts_parallel(F, Sigma, mfs, Pfs, block_size=bs), flat):
            _close(_np(a), _np(b), 1e-12)


# -- the iterated parallel sigma-point smoother ------------------------------

ELL, SIGMA, DT_LTI, XI_LTI, T_LTI = 0.7, 1.2, 0.01, 0.05, 150


def _lti_inputs():
    rng = np.random.default_rng(11)
    from chirpgp_tpu.models import m32_solution as jm32
    F, Sigma = (np.asarray(x) for x in jm32(ELL, SIGMA, DT_LTI))
    x, xs = np.zeros(2), []
    Lq = np.linalg.cholesky(Sigma)
    for _ in range(T_LTI):
        x = F @ x + Lq @ rng.standard_normal(2)
        xs.append(x)
    return F, Sigma, np.array(xs)[:, 0] + math.sqrt(XI_LTI) * \
        rng.standard_normal(T_LTI)


def test_tv_parallel_and_slr_match_jax_on_lti():
    """kf_parallel_tv, rts_parallel_tv (flat and blocked 32) and
    slr_transitions on the Matern-3/2 LGSSM, float64, to 1e-9."""
    from chirpgp_tpu.models import stationary_cov_m32 as jcov
    F, Sigma, ys = _lti_inputs()
    T = T_LTI
    rng = np.random.default_rng(4)
    Fs = np.broadcast_to(F, (T, 2, 2)) + 0.01 * rng.standard_normal((T, 2, 2))
    cs = 0.1 * rng.standard_normal((T, 2))
    Sig = np.broadcast_to(Sigma, (T, 2, 2)) + 0.1 * _psd(rng, T, 2, 0.1)
    H, m0, P0 = np.array([1.0, 0.0]), np.zeros(2), np.asarray(jcov(ELL, SIGMA))
    jargs = [jnp.asarray(x) for x in (Fs, cs, Sig, H)]
    targs = [_t(x) for x in (Fs, cs, Sig, H)]
    for bs in (None, 32):
        want = jax.jit(lambda *a: jps.kf_parallel_tv(*a, block_size=bs))(
            *jargs, XI_LTI, jnp.asarray(m0), jnp.asarray(P0), jnp.asarray(ys))
        got = tps.kf_parallel_tv(*targs, XI_LTI, _t(m0), _t(P0), _t(ys), bs)
        for g_, w_ in zip(got, want):
            _close(_np(g_), w_, 1e-9)
        want_s = jax.jit(lambda *a: jps.rts_parallel_tv(*a, block_size=bs))(
            *jargs[:3], *want[:2])
        got_s = tps.rts_parallel_tv(*targs[:3], *got[:2], bs)
        for g_, w_ in zip(got_s, want_s):
            _close(_np(g_), w_, 1e-9)

    ms = rng.standard_normal((5, 2))
    Ps = np.broadcast_to(P0, (5, 2, 2))
    want = jps.slr_transitions(jax_disc_m32(ELL, SIGMA), jax_gh(2, 3), DT_LTI,
                               jnp.asarray(ms), jnp.asarray(Ps))
    got = tps.slr_transitions(disc_m32(ELL, SIGMA), gauss_hermite(2, 3),
                              DT_LTI, _t(ms), _t(Ps))
    # On a linear model (F, 0, Sigma) exactly: the offsets are round-off,
    # held to the scale of the nominal means.
    _close(_np(got[0]), want[0], 1e-9)
    npt.assert_allclose(_np(got[1]), want[1], atol=1e-12 * np.abs(ms).max())
    _close(_np(got[2]), want[2], 1e-9)
    _close(_np(got[0]), np.broadcast_to(F, (5, 2, 2)), 1e-9)


def test_psgp_matches_jax_on_lti():
    from chirpgp_tpu.models import stationary_cov_m32 as jcov
    _, _, ys = _lti_inputs()
    H, m0 = np.array([1.0, 0.0]), np.zeros(2)
    P0 = np.asarray(jcov(ELL, SIGMA))
    want = jps.psgp_filter_smoother(
        jax_disc_m32(ELL, SIGMA), jax_gh(2, 3), jnp.asarray(H), XI_LTI,
        jnp.asarray(m0), jnp.asarray(P0), DT_LTI, jnp.asarray(ys),
        num_iters=2)
    got = tps.psgp_filter_smoother(
        disc_m32(ELL, SIGMA), gauss_hermite(2, 3), _t(H), XI_LTI, _t(m0),
        _t(P0), DT_LTI, _t(ys), num_iters=2)
    for g_, w_ in zip(got, want):
        _close(_np(g_), w_, 1e-9)


@pytest.mark.parametrize("variant", ["flat", "blocked32", "init_nominal"])
def test_psgp_matches_jax_on_chirp(variant):
    """The chirp model (d=4, GH-3) on seed 0 of toydata_const cut to T=200,
    two iterations, float64, to 1e-9 of scale."""
    ys = np.load(ROOT / "results/data/toydata_const.npz")["ys"][0, :200] \
        .astype(np.float64)
    T = ys.shape[0]
    jpack = jax_build_chirp(jnp.asarray(PARAMS))
    tpack = build_chirp_model(_t(PARAMS))
    bs = 32 if variant == "blocked32" else None
    nominal = None
    if variant == "init_nominal":
        rng = np.random.default_rng(2)
        nominal = (np.asarray(jpack.m0) + 0.1 * rng.standard_normal((T, 4)),
                   np.tile(np.asarray(jpack.P0), (T, 1, 1)))
    want = jax.jit(lambda y: jps.psgp_filter_smoother(
        jpack.m_and_cov, jax_gh(4, 3), jpack.H, XI, jpack.m0, jpack.P0, DT,
        y, num_iters=2, block_size=bs,
        init_nominal=None if nominal is None else tuple(
            jnp.asarray(x) for x in nominal)))(jnp.asarray(ys))
    got = tps.psgp_filter_smoother(
        tpack.m_and_cov, gauss_hermite(4, 3), tpack.H, XI, tpack.m0,
        tpack.P0, DT, _t(ys), num_iters=2, block_size=bs,
        init_nominal=nominal)
    for g_, w_ in zip(got, want):
        _close(_np(g_), w_, 1e-9)
