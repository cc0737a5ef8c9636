"""PyTorch port vs the JAX package: the batched channels-first square-root
filter, smoother and Gaussian expectation.  Tolerances: float64 atol 1e-9;
float32 atol 5e-5 on means and nll and 1e-4 on L L^T (the levels of
tests/test_pallas_filter.py)."""

import jax
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

PARAMS = [0.1, 0.1, 0.1, 1.0, 1.0, 7.0]
B, T, DT, XI = 4, 64, 1e-3, 0.1
TOLS = {"float64": dict(m=1e-9, P=1e-9), "float32": dict(m=5e-5, P=1e-4)}


def _np(x):
    return x.detach().cpu().numpy()


def _gram(L):
    return np.einsum("tikb,tjkb->tijb", L, L)


def _measurements(seed):
    rng = np.random.default_rng(seed)
    ts = DT * np.arange(1, T + 1)
    return np.sin(2 * np.pi * 8.0 * ts)[None] + np.sqrt(XI) * \
        rng.standard_normal((B, T))


@pytest.mark.parametrize("dtype,rule", [
    ("float64", "gh3"), ("float32", "gh3"), ("float32", "cubature")])
def test_filter_and_smoother_match_jax(dtype, rule):
    tol = TOLS[dtype]
    ys = _measurements(0)
    rj = jq.gauss_hermite(4, 3) if rule == "gh3" else jq.cubature(4)
    rt = tq.gauss_hermite(4, 3) if rule == "gh3" else tq.cubature(4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pj = jm.build_chirp_model(jnp.asarray(PARAMS, jdt))
    pt = tm.build_chirp_model(torch.tensor(PARAMS, dtype=tdt))

    mj, Lj, nj = jb.sqrt_sgp_filter_batched(
        pj.m_and_cov, rj, pj.H, jdt(XI), pj.m0, pj.P0, jdt(DT),
        jnp.asarray(ys, jdt))
    mt, Lt, nt = tb.sqrt_sgp_filter_batched(
        pt.m_and_cov, rt, pt.H, XI, pt.m0, pt.P0, DT,
        torch.tensor(ys, dtype=tdt))
    assert mt.dtype == tdt and mt.shape == (T, 4, B)
    assert Lt.shape == (T, 4, 4, B) and nt.shape == (T, B)
    npt.assert_allclose(_np(mt), np.asarray(mj), atol=tol["m"], rtol=0)
    npt.assert_allclose(_np(nt), np.asarray(nj), atol=tol["m"], rtol=0)
    npt.assert_allclose(_gram(_np(Lt)), _gram(np.asarray(Lj)),
                        atol=tol["P"], rtol=0)
    assert np.all(np.triu(np.moveaxis(_np(Lt), -1, 1), k=1) == 0)

    msj, Lsj = jb.sqrt_sgp_smoother_batched(pj.m_and_cov, rj, mj, Lj, jdt(DT))
    mst, Lst = tb.sqrt_sgp_smoother_batched(pt.m_and_cov, rt, mt, Lt, DT)
    npt.assert_allclose(_np(mst), np.asarray(msj), atol=tol["m"], rtol=0)
    npt.assert_allclose(_gram(_np(Lst)), _gram(np.asarray(Lsj)),
                        atol=tol["P"], rtol=0)


@pytest.mark.parametrize("n,d", [(85, 4), (5, 5), (16, 8), (8, 4)])
def test_tria_cf_matches_jax_elementwise(n, d):
    M = np.random.default_rng(n + d).standard_normal((n, d, 6))
    Rt = tb.tria_cf(torch.tensor(M))
    Rj = jax.jit(jb.tria_cf)(jnp.asarray(M))
    npt.assert_allclose(_np(Rt), np.asarray(Rj), atol=1e-12, rtol=0)
    # R^T R = M^T M per lane, and the caller's array is untouched.
    npt.assert_allclose(np.einsum("kib,kjb->ijb", _np(Rt), _np(Rt)),
                        np.einsum("nib,njb->ijb", M, M), atol=1e-10)
    npt.assert_array_equal(
        M, np.random.default_rng(n + d).standard_normal((n, d, 6)))


def test_backsub_cf():
    rng = np.random.default_rng(5)
    R11 = np.triu(rng.standard_normal((4, 4, 3)).transpose(2, 0, 1)
                  ).transpose(1, 2, 0) + 3.0 * np.eye(4)[:, :, None]
    R12 = rng.standard_normal((4, 4, 3))
    X = _np(tb._backsub_cf(torch.tensor(R11), torch.tensor(R12), 4))
    npt.assert_allclose(np.einsum("ikb,kjb->ijb", R11, X), R12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gaussian_expectation_batched(dtype):
    rng = np.random.default_rng(7)
    ms = 8.0 + rng.standard_normal((T, B))
    stds = 0.1 + rng.random((T, B))
    ej = jb.gaussian_expectation_batched(
        jnp.asarray(ms, getattr(jnp, dtype)),
        jnp.asarray(stds, getattr(jnp, dtype)))
    et = tb.gaussian_expectation_batched(
        torch.tensor(ms, dtype=getattr(torch, dtype)),
        torch.tensor(stds, dtype=getattr(torch, dtype)))
    npt.assert_allclose(_np(et), np.asarray(ej),
                        atol=1e-12 if dtype == "float64" else 1e-5, rtol=0)


def test_rejections():
    pt = tm.build_chirp_model(torch.tensor(PARAMS, dtype=torch.float64))
    ys = torch.zeros((2, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="nonnegative"):
        tb.sqrt_sgp_filter_batched(pt.m_and_cov, tq.unscented(4), pt.H, XI,
                                   pt.m0, pt.P0, DT, ys)
    with pytest.raises(ValueError, match="one-hot"):
        tb.sqrt_sgp_filter_batched(pt.m_and_cov, tq.cubature(4),
                                   torch.tensor([0.0, 0.5, 0.5, 0.0]), XI,
                                   pt.m0, pt.P0, DT, ys)
