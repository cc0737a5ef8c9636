"""PyTorch port vs the JAX package: the fused batched filter+smoother in
square-root form (full factors, covariance branch, slim output) and in
covariance form.  Tolerances: float64 atol 1e-10 on means, nll and
covariances; float32 atol 5e-5 on means and nll and 1e-4 on covariances
(the levels of tests/test_pallas_filter.py).  The slim output is pinned
bit-equal to the full output's slices, as tests/test_batched.py pins it
for JAX."""

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

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PARAMS = [0.1, 0.1, 0.1, 1.0, 1.0, 7.0]
B, T, DT, XI = 3, 48, 1e-3, 0.1
TOLS = {"float64": dict(m=1e-10, P=1e-10), "float32": dict(m=5e-5, P=1e-4)}


def _np(x):
    return x.detach().cpu().numpy()


def _gram(L):
    return np.einsum("tikb,tjkb->tijb", L, L)


def _args(dtype, rule="gh3"):
    """The same model and measurements (seeds 0-2 of the committed toy
    data) for both packages, in ``dtype``."""
    ys = np.load(ROOT / "results/data/toydata_const.npz")["ys"][:B, :T] \
        .astype(np.float64)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pj = jm.build_chirp_model(jnp.asarray(PARAMS, jdt))
    pt = tm.build_chirp_model(torch.tensor(PARAMS, dtype=tdt))
    rj = jq.gauss_hermite(4, 3) if rule == "gh3" else jq.cubature(4)
    rt = tq.gauss_hermite(4, 3) if rule == "gh3" else tq.cubature(4)
    return ((pj.m_and_cov, rj, pj.H, jdt(XI), pj.m0, pj.P0, jdt(DT),
             jnp.asarray(ys, jdt)),
            (pt.m_and_cov, rt, pt.H, XI, pt.m0, pt.P0, DT,
             torch.tensor(ys, dtype=tdt)))


@pytest.mark.parametrize("dtype,rule", [
    ("float64", "gh3"), ("float32", "gh3"), ("float32", "cubature")])
def test_fused_factors_match_jax(dtype, rule):
    tol = TOLS[dtype]
    aj, at = _args(dtype, rule)
    mj, Lj, nj = jb.sqrt_sgp_filter_smoother_batched(*aj)
    mt, Lt, nt = tb.sqrt_sgp_filter_smoother_batched(*at)
    assert mt.dtype == getattr(torch, dtype)
    assert mt.shape == (T, 4, B) and Lt.shape == (T, 4, 4, B)
    npt.assert_allclose(_np(mt), np.asarray(mj), atol=tol["m"], rtol=0)
    npt.assert_allclose(_np(nt), np.asarray(nj), atol=tol["m"], rtol=0)
    npt.assert_allclose(_gram(_np(Lt)), _gram(np.asarray(Lj)),
                        atol=tol["P"], rtol=0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_covariance_branch_and_slim_match_jax(dtype):
    tol = TOLS[dtype]
    aj, at = _args(dtype)
    mj, Pj, nj = jb.sqrt_sgp_filter_smoother_batched(
        *aj, return_factors=False)
    mt, Pt, nt = tb.sqrt_sgp_filter_smoother_batched(
        *at, return_factors=False)
    assert Pt.shape == (T, 4, 4, B)
    npt.assert_allclose(_np(mt), np.asarray(mj), atol=tol["m"], rtol=0)
    npt.assert_allclose(_np(Pt), np.asarray(Pj), atol=tol["P"], rtol=0)
    npt.assert_allclose(_np(nt), np.asarray(nj), atol=tol["m"], rtol=0)

    vm, vv, n2 = tb.sqrt_sgp_filter_smoother_batched(
        *at, return_factors=False, out_index=2)
    assert vm.shape == (T, B) and vv.shape == (T, B)
    # Bit-equal to the full output's slices: the same backward carry.
    assert torch.equal(n2, nt)
    assert torch.equal(vm, mt[:, 2, :])
    assert torch.equal(vv, Pt[:, 2, 2, :])
    vmj, vvj, _ = jb.sqrt_sgp_filter_smoother_batched(
        *aj, return_factors=False, out_index=2)
    npt.assert_allclose(_np(vm), np.asarray(vmj), atol=tol["m"], rtol=0)
    npt.assert_allclose(_np(vv), np.asarray(vvj), atol=tol["P"], rtol=0)
    with pytest.raises(ValueError, match="return_factors"):
        tb.sqrt_sgp_filter_smoother_batched(*at, out_index=2)


def test_fused_matches_separate_filter_and_smoother():
    """Float64: the fused joint triangularization reproduces the port's
    separate filter-then-smoother path (the same Gram algebra)."""
    _, at = _args("float64")
    mfs, Lfs, nll = tb.sqrt_sgp_filter_batched(*at)
    mss, Lss = tb.sqrt_sgp_smoother_batched(at[0], at[1], mfs, Lfs, DT)
    mss2, Lss2, nll2 = tb.sqrt_sgp_filter_smoother_batched(*at)
    npt.assert_allclose(_np(nll2), _np(nll), atol=1e-10, rtol=0)
    npt.assert_allclose(_np(mss2), _np(mss), atol=1e-10, rtol=0)
    npt.assert_allclose(_gram(_np(Lss2)), _gram(_np(Lss)), atol=1e-10, rtol=0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cov_fused_matches_jax(dtype):
    tol = TOLS[dtype]
    aj, at = _args(dtype)
    mj, Pj, nj = jb.cov_sgp_filter_smoother_batched(*aj)
    mt, Pt, nt = tb.cov_sgp_filter_smoother_batched(*at)
    assert mt.shape == (T, 4, B) and Pt.shape == (T, 4, 4, B)
    npt.assert_allclose(_np(mt), np.asarray(mj), atol=tol["m"], rtol=0)
    npt.assert_allclose(_np(Pt), np.asarray(Pj), atol=tol["P"], rtol=0)
    npt.assert_allclose(_np(nt), np.asarray(nj), atol=tol["m"], rtol=0)
    if dtype == "float64":
        ms, Ls, ns = tb.sqrt_sgp_filter_smoother_batched(*at)
        npt.assert_allclose(_np(mt), _np(ms), atol=1e-10, rtol=0)
        npt.assert_allclose(_np(Pt), _gram(_np(Ls)), atol=1e-10, rtol=0)
        npt.assert_allclose(_np(nt), _np(ns), atol=1e-10, rtol=0)


@pytest.mark.parametrize("n,d", [(4, 4), (9, 3)])
def test_chol_and_spd_solve_cf_match_jax(n, d):
    rng = np.random.default_rng(n * d)
    X = rng.standard_normal((n, d, 5))
    P = np.einsum("nib,njb->ijb", X, X) + 0.1 * np.eye(d)[:, :, None]
    C = rng.standard_normal((d, d, 5))
    Lt = tb._chol_cf(torch.tensor(P), d)
    npt.assert_allclose(_np(Lt), np.asarray(jb._chol_cf(jnp.asarray(P), d)),
                        atol=1e-12, rtol=0)
    npt.assert_allclose(np.einsum("ikb,jkb->ijb", _np(Lt), _np(Lt)), P,
                        atol=1e-12)
    Gt = tb._spd_solve_cf(Lt, torch.tensor(C), d)
    npt.assert_allclose(
        _np(Gt), np.asarray(jb._spd_solve_cf(jnp.asarray(_np(Lt)),
                                             jnp.asarray(C), d)),
        atol=1e-10, rtol=0)
    npt.assert_allclose(np.einsum("ikb,kjb->ijb", _np(Gt), P), C, atol=1e-10)
    # A non-positive pivot gives a degenerate factor, not NaNs.
    bad = P.copy()
    bad[0, 0, 0] = -1.0
    assert np.all(np.isfinite(_np(tb._chol_cf(torch.tensor(bad), d))))
