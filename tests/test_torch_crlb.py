"""The PyTorch port's filter-error Monte Carlo and posterior Cramer--Rao
bound (paper Fig. 5) against the JAX package, and the chirp filter's
``m0`` argument.

Torch cannot replay JAX's threefry streams, so each test makes JAX's
normals from the same keys and splits the JAX package uses and feeds them
to the port through ``draws``.  Float64 throughout: the error statistics
and the bounds agree within 1e-9.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.apps.crlb as jcrlb
from chirpgp_tpu.infer import kf
from chirpgp_tpu.models import posterior_cramer_rao as jax_pcr

import chirpgp_tpu_torch.models.crlb as tcrlb
from chirpgp_tpu_torch.apps import (
    filter_error_mc, filter_error_mc_chunked, pcrlb_chirp_mc)
from chirpgp_tpu_torch.models import (
    model_chirp, m32_solution, posterior_cramer_rao, stationary_cov_m32)
from chirpgp_tpu_torch.parallel import make_mesh
from chirpgp_tpu_torch.ops.chirp_filter import (
    ghfs_chirp_filter, ghfs_chirp_filter_reference)
from chirpgp_tpu_torch.quad import gauss_hermite
from chirpgp_tpu_torch.utils.sim import simulate_lgssm

torch.set_num_threads(1)

ARGS = (0.1, 0.1, 0.1, 1.0, 1.0, 0.1)     # lam, b, delta, ell, sigma, Xi
N, T, CHUNK = 64, 50, 32
# float64 agreement with the JAX package on equal draws, relative to the
# largest value of each statistic.
RTOL = 1e-9


def _t(x):
    return torch.from_numpy(np.array(x, np.float64))


def _split3_normals(keys, T):
    """Per key, split in three: the normals of x0, of the state increments
    and of the measurement noise."""
    def one(k):
        k0, kx, ky = jax.random.split(k, 3)
        return (jax.random.normal(k0, (4,)), jax.random.normal(kx, (T, 4)),
                jax.random.normal(ky, (T,)))
    return tuple(_t(z) for z in jax.vmap(one)(keys))


def _chunk_draws(key, T):
    """The normals of filter_error_mc_chunked's chunk ``index``, from
    ``split(fold_in(key, index), n)``."""
    return lambda index, n: _split3_normals(
        jax.random.split(jax.random.fold_in(key, index), n), T)


def _assert_stats_close(got, want, rtol=RTOL):
    assert set(got) == set(want)
    for name in want:
        w = np.asarray(want[name])
        npt.assert_allclose(got[name], w, rtol=0,
                            atol=rtol * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("method,backend", [("ghf", "cf"), ("ghf", "vmap"),
                                            ("ekf", "vmap")])
def test_filter_error_mc_chunked_matches_jax(method, backend):
    key = jax.random.PRNGKey(666)
    want = jcrlb.filter_error_mc_chunked(
        *ARGS, N, method=method, T=T, chunk=CHUNK, backend=backend, key=key,
        dtype=jnp.float64)
    got = filter_error_mc_chunked(*ARGS, N, method=method, T=T, chunk=CHUNK,
                                  backend=backend, dtype=torch.float64,
                                  device="cpu", draws=_chunk_draws(key, T))
    _assert_stats_close(got, want)


def test_filter_error_mc_matches_jax():
    key = jax.random.PRNGKey(2022)

    def draws(_index, n):
        def one(k):
            k_traj, k_noise = jax.random.split(k)
            return (jax.random.normal(k_traj, (4,)),
                    jax.random.normal(jax.random.split(k_traj)[0], (T, 4)),
                    jax.random.normal(k_noise, (T,)))
        return tuple(_t(z) for z in jax.vmap(one)(jax.random.split(key, n)))

    for method in ("ghf", "ekf"):
        want = jcrlb.filter_error_mc(*ARGS, N, method=method, T=T, key=key)
        got = filter_error_mc(*ARGS, N, method=method, T=T, device="cpu",
                              draws=draws)
        _assert_stats_close(got, want)
    # A one-rank mesh (tests/test_torch_sharded.py runs four ranks).
    on_mesh = filter_error_mc(*ARGS, N, method="ekf", T=T, draws=draws,
                              mesh=make_mesh(device="cpu"))
    _assert_stats_close(on_mesh, got, 1e-12)
    with pytest.raises(ValueError):
        filter_error_mc_chunked(*ARGS, N, method="ekf", backend="cf",
                                device="cpu")


def test_pcrlb_chirp_mc_matches_jax():
    key = jax.random.PRNGKey(666)
    n = 300

    def draws(_index, n_):
        return _split3_normals(jax.random.split(key, n_), T)

    want = jcrlb.pcrlb_chirp_mc(*ARGS, num_mcs=n, T=T, key=key,
                                dtype=jnp.float64)
    got = pcrlb_chirp_mc(*ARGS, num_mcs=n, T=T, dtype=torch.float64,
                         device="cpu", draws=draws)
    for name in want:
        npt.assert_allclose(got[name], np.asarray(want[name]), rtol=RTOL)
    assert np.all(got["pcrlb_x2"] > 0) and np.all(got["pcrlb_v"] > 0)


def test_posterior_cramer_rao_matches_jax_and_the_kf(monkeypatch):
    """On an LGSSM the inverse PCRLB is the KF covariance
    (``tests/test_crlb_covfuncs.py::test_pcrlb_equals_kf_cov_on_lgssm``,
    at a smaller Monte-Carlo budget), and the recursion equals the JAX
    package's on the same samples."""
    ell, sigma, dt, T_, n = 1.0, 1.0, 0.01, 30, 200
    F, Sigma = m32_solution(ell, sigma, dt)
    H = _t([1.0, 0.0])
    Xi = 0.1
    P0 = stationary_cov_m32(ell, sigma)
    gen = torch.Generator().manual_seed(0)
    x0s = torch.randn((n, 2), generator=gen, dtype=torch.float64) \
        @ torch.linalg.cholesky(P0).T
    traj = torch.stack([simulate_lgssm(F, Sigma, x0, T_, gen) for x0 in x0s])
    # On an LGSSM the Hessians are constant, so a few hundred trajectories
    # give the bound to round-off.
    xss = torch.cat([x0s[:, None], traj], dim=1).transpose(0, 1)
    yss = xss[1:] @ H + math.sqrt(Xi) * torch.randn(
        (T_, n), generator=gen, dtype=torch.float64)
    Sigma_inv = torch.linalg.inv(Sigma)

    def lt(xt, xs):
        r = xt - F @ xs
        return -0.5 * r @ Sigma_inv @ r

    def ll(y, x):
        return -0.5 * (y - H @ x) ** 2 / Xi

    # 5 steps per Hessian call, so that the steps span several calls.
    monkeypatch.setattr(tcrlb, "SAMPLES_PER_CALL", 1000)
    js = posterior_cramer_rao(xss, yss, torch.linalg.inv(P0), lt, ll)
    _, Pfs, _ = kf(jnp.asarray(F.numpy()), jnp.asarray(Sigma.numpy()),
                   jnp.asarray(H.numpy()), Xi, jnp.zeros(2),
                   jnp.asarray(P0.numpy()), jnp.zeros(T_))
    npt.assert_allclose(torch.linalg.inv(js).numpy(), np.asarray(Pfs),
                        rtol=1e-8, atol=1e-10)

    Fj, Sij, Hj = (jnp.asarray(x.numpy()) for x in (F, Sigma_inv, H))
    want = jax_pcr(jnp.asarray(xss.numpy()), jnp.asarray(yss.numpy()),
                   jnp.asarray(torch.linalg.inv(P0).numpy()),
                   lambda xt, xs: -0.5 * (xt - Fj @ xs) @ Sij @ (xt - Fj @ xs),
                   lambda y, x: -0.5 * (y - Hj @ x) ** 2 / Xi)
    npt.assert_allclose(js.numpy(), np.asarray(want), rtol=0,
                        atol=RTOL * float(jnp.abs(want).max()))


def test_chirp_filter_m0():
    """``m0=None`` is today's filter bit for bit; an ``m0`` replaces the
    packed model's prior mean and nothing else."""
    params = (0.1, 0.1, 0.1, 1.0, 1.0, 0.7)
    sgps = gauss_hermite(4, 3)
    ys = torch.as_tensor(0.3 * np.random.default_rng(4).standard_normal(
        (5, 20)))
    plain = ghfs_chirp_filter_reference(params, 0.1, 0.01, sgps, ys)
    for a, b in zip(ghfs_chirp_filter(params, 0.1, 0.01, sgps, ys,
                                      m0=None), plain):
        assert torch.equal(a, b)
    m0 = model_chirp(*ARGS[:2], 1.0, 1.0, 0.1).m0
    moved = ghfs_chirp_filter(params, 0.1, 0.01, sgps, ys, m0=m0)
    from chirpgp_tpu_torch.infer import sqrt_sgp_filter_batched
    from chirpgp_tpu_torch.models import build_chirp_model
    pack = build_chirp_model(torch.tensor(params, dtype=torch.float64))
    want = sqrt_sgp_filter_batched(pack.m_and_cov, sgps, pack.H, 0.1, m0,
                                   pack.P0, 0.01, ys)
    for a, b in zip(moved, want):
        assert torch.equal(a, b)
    assert not torch.equal(moved[0], plain[0])
    with pytest.raises(ValueError):
        ghfs_chirp_filter(params, 0.1, 0.01, sgps, ys, m0=[0.0, 1.0])
