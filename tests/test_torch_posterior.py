"""The PyTorch port's posterior inference against the JAX package: the
bootstrap particle filter, NUTS, the hyperparameter log posterior and the
SMC NLL, and ``utils.timing`` on the CPU.

Torch cannot replay JAX's threefry streams, so each parity test rebuilds
the JAX package's key schedule with JAX itself and feeds the same draws to
the port (``draws=``): float64 results then agree to 1e-10 of scale, and
every accept decision is the same.  The port's own-generator runs are held
to the JAX tests' known-answer bounds.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.apps.pipeline as jpipe
import chirpgp_tpu.infer.nuts as jnuts
from chirpgp_tpu.apps.posterior import (
    make_logposterior as jax_make_logposterior, smc_nll as jax_smc_nll)
from chirpgp_tpu.infer.smc import (
    bootstrap_filter as jax_bootstrap_filter,
    effective_sample_size as jax_ess,
    systematic_resample as jax_systematic_resample)
from chirpgp_tpu.models import build_chirp_model as jax_build_chirp
from chirpgp_tpu.models import disc_m32 as jax_disc_m32

from chirpgp_tpu_torch.apps import (
    IFEstimationConfig, make_logposterior, sample_hyperposterior, smc_nll)
from chirpgp_tpu_torch.fit.lbfgs import batched_value_and_grad
from chirpgp_tpu_torch.infer import (
    bootstrap_filter, effective_sample_size, kf, nuts_sample,
    systematic_resample)
from chirpgp_tpu_torch.infer.nuts import NUTSDraws, _nuts_transition, nuts_draws
from chirpgp_tpu_torch.infer.smc import SMCDraws
from chirpgp_tpu_torch.models import (
    build_chirp_model, disc_m32, m32_solution, stationary_cov_m32)
from chirpgp_tpu_torch.utils import (
    TimingResult, profile_trace, time_jitted, wall_timer)
from chirpgp_tpu_torch.utils.timing import profile_device, timed

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PARAMS = (0.1, 0.1, 0.1, 1.0, 1.0, 7.0)
ELL, SIGMA, DT_LTI, XI = 1.0, 1.0, 0.01, 0.1
DEPTH = 4
COV = np.array([[1.0, 0.7], [0.7, 2.0]])
PREC = np.linalg.inv(COV)


def _t(x, dtype=torch.float64):
    return torch.tensor(np.array(x), dtype=dtype)


def _np(x):
    return x.detach().cpu().numpy()


def _close(got, want, rtol):
    """Deviation within ``rtol`` of the scale of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    npt.assert_allclose(got, want, rtol=0,
                        atol=rtol * max(np.abs(want).max(), 1e-300))


def _toydata(T):
    return np.load(ROOT / "results/data/toydata_const.npz")["ys"][0, :T] \
        .astype(np.float64)


# -- the bootstrap particle filter --------------------------------------------

def _jax_smc_draws(key, T, N, d):
    """bootstrap_filter's key schedule: the initial normals from the first
    split, then per step the proposal normals and the resampling uniform."""
    key, sub = jax.random.split(key)
    z0 = jax.random.normal(sub, (N, d))

    def step(k):
        k_prop, k_res = jax.random.split(k)
        return jax.random.normal(k_prop, (N, d)), jax.random.uniform(k_res, ())

    z, u = jax.vmap(step)(jax.random.split(key, T))
    return SMCDraws(*(_t(x) for x in (z0, z, u)))


def _lgssm(T):
    """The M32 LGSSM of tests/test_nuts_smc.py, simulated by the JAX
    package."""
    from chirpgp_tpu.models import m32_solution as jm32, stationary_cov_m32
    from chirpgp_tpu.utils import simulate_lgssm
    F, Sigma = jm32(ELL, SIGMA, DT_LTI)
    H = jnp.array([1.0, 0.0])
    key = jax.random.PRNGKey(7)
    xs = simulate_lgssm(F, Sigma, jnp.zeros(2), T, key)
    key, sub = jax.random.split(key)
    ys = xs @ H + math.sqrt(XI) * jax.random.normal(sub, (T,))
    return np.asarray(ys), np.asarray(stationary_cov_m32(ELL, SIGMA))


def test_systematic_resample_and_ess_match_jax():
    log_w = np.log(np.random.default_rng(0).dirichlet(np.ones(64)))
    for i in range(20):
        key = jax.random.PRNGKey(i)
        u = jax.random.uniform(key, ())
        want = jax_systematic_resample(key, jnp.asarray(log_w))
        got = systematic_resample(None, _t(log_w), u=_t(u))
        npt.assert_array_equal(_np(got), np.asarray(want))
    _close(_np(effective_sample_size(_t(log_w))), jax_ess(jnp.asarray(log_w)),
           1e-12)
    npt.assert_allclose(float(effective_sample_size(torch.zeros(100))), 100.0,
                        rtol=1e-6)


@pytest.mark.parametrize("model", ["m32", "chirp"])
def test_bootstrap_filter_matches_jax_on_its_draws(model):
    """T=100, N=256, float64: means, log-ML and ESS to 1e-10 of scale."""
    T, N = 100, 256
    key = jax.random.PRNGKey(8)
    if model == "m32":
        ys, P0 = _lgssm(T)
        jargs = (jax_disc_m32(ELL, SIGMA), jnp.array([1.0, 0.0]), XI,
                 jnp.zeros(2), jnp.asarray(P0), DT_LTI)
        targs = (disc_m32(ELL, SIGMA), _t([1.0, 0.0]), XI,
                 torch.zeros(2, dtype=torch.float64), _t(P0), DT_LTI)
        d = 2
    else:
        ys = _toydata(T)
        jp, tp = jax_build_chirp(jnp.asarray(PARAMS)), build_chirp_model(
            _t(PARAMS))
        jargs = (jp.m_and_cov, jp.H, XI, jp.m0, jp.P0, 1e-3)
        targs = (tp.m_and_cov, tp.H, XI, tp.m0, tp.P0, 1e-3)
        d = 4
    want = jax.jit(lambda y: jax_bootstrap_filter(
        *jargs, y, key, num_particles=N))(jnp.asarray(ys))
    got = bootstrap_filter(*targs, _t(ys), num_particles=N,
                           draws=_jax_smc_draws(key, T, N, d))
    assert bool((got.ess < 0.5 * N).any())    # resampling did run
    for g_, w_ in zip(got, want):
        _close(_np(g_), w_, 1e-10)


def test_bootstrap_filter_own_generator_matches_kf():
    """The port's generator run against the exact KF (the JAX test's
    bounds): log-ML within 2%, mean filter error below 0.05, ESS above 1."""
    T = 100
    ys, P0 = _lgssm(T)
    F, Sigma = m32_solution(ELL, SIGMA, DT_LTI)
    H, m0 = _t([1.0, 0.0]), torch.zeros(2, dtype=torch.float64)
    mfs, _, nll = kf(F, Sigma, H, XI, m0, _t(P0), _t(ys))
    res = bootstrap_filter(disc_m32(ELL, SIGMA), H, XI, m0, _t(P0), DT_LTI,
                           _t(ys), torch.Generator().manual_seed(8),
                           num_particles=4000)
    npt.assert_allclose(float(res.log_ml[-1]), -float(nll[-1]), rtol=0.02)
    assert float((res.means[:, 0] - mfs[:, 0]).abs().mean()) < 0.05
    assert bool((res.ess > 1.0).all())


def test_smc_nll_matches_jax_on_its_draws():
    T, N = 100, 256
    ys = _toydata(T)
    key = jax.random.PRNGKey(3)
    want, _ = jax_smc_nll(jpipe.IFEstimationConfig(), jnp.asarray(PARAMS),
                          jnp.asarray(ys), key, num_particles=N)
    got, _ = smc_nll(IFEstimationConfig(), _t(PARAMS), _t(ys), num_particles=N,
                     draws=_jax_smc_draws(key, T, N, 4))
    npt.assert_allclose(float(got), float(want), rtol=1e-10)


# -- NUTS ----------------------------------------------------------------------

def _jax_transition_draws(k, d, depth):
    """One transition's draws as ``_nuts_kernel`` and ``_build_subtree``
    split them."""
    k_mom, k_dir, k_tree = jax.random.split(k, 3)
    p = jax.random.normal(k_mom, (d,))
    direction = jax.vmap(jax.random.bernoulli)(jax.random.split(k_dir, depth))
    tree_keys = jax.random.split(k_tree, depth)
    leaf_u = jnp.concatenate([
        jax.vmap(lambda kk: jax.random.uniform(kk, ()))(
            jax.random.split(tree_keys[j], 2 ** j)) for j in range(depth)])
    merge_u = jax.vmap(lambda tk: jax.random.uniform(
        jax.random.fold_in(tk, 12345), ()))(tree_keys)
    return p, direction, leaf_u, merge_u


def _jax_nuts_draws(key, num_warmup, num_samples, d, depth):
    """nuts_sample's key schedule: warmup and sampling keys split from the
    two halves of ``key``."""
    kw, ks = jax.random.split(key)
    keys = jnp.concatenate([jax.random.split(kw, num_warmup),
                            jax.random.split(ks, num_samples)])
    draws = jax.vmap(lambda k: _jax_transition_draws(k, d, depth))(keys)
    return NUTSDraws(*(torch.from_numpy(np.array(x)) for x in draws))


def _gauss(xp):
    prec = jnp.asarray(PREC) if xp is jnp else _t(PREC)
    return lambda q: -0.5 * q @ prec @ q


def _banana(xp):
    return lambda q: -0.5 * (q[0] ** 2 / 4.0 + (q[1] - q[0] ** 2 / 4.0) ** 2)


TARGETS = {"gauss": _gauss, "banana": _banana}


@pytest.mark.parametrize("target", ["gauss", "banana"])
def test_nuts_transition_matches_jax(target):
    """One transition at depth 4 from a fixed point: the proposal, its log
    density, the accept statistic and the divergence flag."""
    q0, eps = np.array([0.3, -0.2]), 0.9
    key = jax.random.PRNGKey(5)
    jl = TARGETS[target](jnp)
    want = jnuts._nuts_kernel(jax.value_and_grad(jl), DEPTH)(
        key, jnp.asarray(q0), eps)
    vg = batched_value_and_grad(TARGETS[target](torch))
    q = _t(q0)[None]
    logp, grad = vg(q)
    draws = NUTSDraws(*(torch.from_numpy(np.array(x))[None]
                        for x in _jax_transition_draws(key, 2, DEPTH)))
    qn, lpn, _, acc, div = _nuts_transition(
        vg, q, logp, grad, _t([eps]), draws, DEPTH)
    for g_, w_ in zip((qn[0], lpn[0], acc[0]), want[:3]):
        _close(_np(g_), w_, 1e-10)
    assert bool(div[0]) == bool(want[3])


def test_nuts_nan_log_density_is_no_divergence_in_either_package():
    """A NaN log density is no divergence in the JAX package: its energy
    error is NaN, so the transition's accept statistic is NaN and the
    divergence flag stays down.  The port keeps the reference's behaviour
    (ROADMAP Queue 3: on an H100 it made a float32 hyperposterior's step
    size NaN during warmup)."""
    key = jax.random.PRNGKey(0)

    def jl(q):
        return jnp.where(q[0] < 0.5, -0.5 * q @ q, jnp.nan)

    def tl(q):
        return torch.where(q[0] < 0.5, -0.5 * q @ q, math.nan)

    want = jnuts._nuts_kernel(jax.value_and_grad(jl), DEPTH)(
        key, jnp.zeros(2), 2.0)
    vg = batched_value_and_grad(tl)
    q = torch.zeros(1, 2, dtype=torch.float64)
    logp, grad = vg(q)
    draws = NUTSDraws(*(torch.from_numpy(np.array(x))[None]
                        for x in _jax_transition_draws(key, 2, DEPTH)))
    qn, lpn, _, acc, div = _nuts_transition(
        vg, q, logp, grad, _t([2.0]), draws, DEPTH)
    assert math.isnan(float(want[2])) and math.isnan(float(acc[0]))
    assert not bool(want[3]) and not bool(div[0])
    _close(_np(qn[0]), want[0], 1e-12)


@pytest.mark.parametrize("target", ["gauss", "banana"])
def test_nuts_chain_matches_jax(target):
    """30 warmup + 30 samples at depth 4 on JAX's draws: samples, log
    densities, accept statistics and the adapted step size to 1e-10."""
    key = jax.random.PRNGKey(3)
    init = np.array([0.1, 0.1])
    want = jnuts.nuts_sample(TARGETS[target](jnp), jnp.asarray(init), key,
                             num_samples=30, num_warmup=30, step_size=0.5,
                             max_tree_depth=DEPTH)
    got = nuts_sample(TARGETS[target](torch), _t(init), num_samples=30,
                      num_warmup=30, step_size=0.5, max_tree_depth=DEPTH,
                      draws=_jax_nuts_draws(key, 30, 30, 2, DEPTH))
    for g_, w_ in zip(got, want):
        _close(_np(g_), w_, 1e-10)


def _own_draws(n, chains, depth, seed):
    return nuts_draws(torch.Generator().manual_seed(seed), (n, chains), 2,
                      depth)


def test_nuts_chains_equal_each_chain_alone():
    """Chains on the leading axis, evaluated in one batched call per
    leapfrog, equal each chain run alone on its draws."""
    n_w, n_s, C = 10, 10, 3
    draws = _own_draws(n_w + n_s, C, 5, 0)
    inits = _t([[0.1, 0.1], [-1.0, 0.5], [2.0, -1.0]])
    both = nuts_sample(_banana(torch), inits, num_samples=n_s,
                       num_warmup=n_w, max_tree_depth=5, draws=draws)
    for c in range(C):
        alone = nuts_sample(_banana(torch), inits[c], num_samples=n_s,
                            num_warmup=n_w, max_tree_depth=5,
                            draws=NUTSDraws(*(x[:, c] for x in draws)))
        for g_, w_ in zip(alone, both):
            _close(_np(g_), _np(w_[c]), 1e-12)


def test_nuts_doubling_skip_changes_no_sample():
    """Once every chain has stopped the port skips the rest of a subtree or
    a doubling, which the JAX package runs masked: fewer log-density
    evaluations than JAX's fixed budget, the same samples on JAX's draws
    (the chains-alone test covers the skip of a batch of chains)."""
    key = jax.random.PRNGKey(8)
    n_w, n_s, init = 20, 20, np.array([0.5, -0.5])
    want = jnuts.nuts_sample(_gauss(jnp), jnp.asarray(init), key,
                             num_samples=n_s, num_warmup=n_w, step_size=0.5,
                             max_tree_depth=DEPTH)
    calls = []

    def logdensity(q):
        calls.append(1)
        return _gauss(torch)(q)

    got = nuts_sample(logdensity, _t(init), num_samples=n_s, num_warmup=n_w,
                      step_size=0.5, max_tree_depth=DEPTH,
                      draws=_jax_nuts_draws(key, n_w, n_s, 2, DEPTH))
    assert len(calls) < 1 + (n_w + n_s) * (2 ** DEPTH - 1)
    for g_, w_ in zip(got, want):
        _close(_np(g_), w_, 1e-10)


def test_nuts_gaussian_moments():
    """The correlated 2-D Gaussian of tests/test_nuts_smc.py with chains on
    the leading axis, drawn from a torch.Generator: the JAX test's bounds."""
    C = 16
    inits = torch.zeros(C, 2, dtype=torch.float64)
    res = nuts_sample(_gauss(torch), inits, torch.Generator().manual_seed(0),
                      num_samples=150, num_warmup=150, step_size=0.5,
                      max_tree_depth=6)
    samples = _np(res.samples).reshape(-1, 2)
    assert float(res.accept_prob.mean()) > 0.6
    assert int(res.num_divergent.sum()) == 0
    npt.assert_allclose(samples.mean(axis=0), [0.0, 0.0], atol=0.15)
    npt.assert_allclose(np.cov(samples.T), COV, atol=0.35)


# -- the hyperparameter posterior ---------------------------------------------

def test_make_logposterior_matches_jax():
    """Cov GHFS, float64, toydata seed 0 at T=200: value and gradient to
    1e-9."""
    ys = _toydata(200)
    theta = np.asarray(jpipe.IFEstimationConfig().default_init_theta()) + 0.05
    vj, gj = jax.jit(jax.value_and_grad(jax_make_logposterior(
        jpipe.IFEstimationConfig(), jnp.asarray(ys))))(jnp.asarray(theta))
    th = _t(theta).requires_grad_(True)
    vt = make_logposterior(IFEstimationConfig(), _t(ys))(th)
    gt, = torch.autograd.grad(vt, th)
    npt.assert_allclose(float(vt.detach()), float(vj), rtol=1e-9)
    _close(_np(gt), gj, 1e-9)


def test_sample_hyperposterior_lanes_equal_the_posterior():
    """Two chains of the float64 sqrt GHFS posterior at T=30: every sample
    finite, and each chain's log density that of make_logposterior on the
    sample alone."""
    ys = _t(_toydata(30))
    cfg = IFEstimationConfig(form="sqrt")
    init = cfg.default_init_theta(torch.float64) + _t([[0.0] * 6, [0.05] * 6])
    res = sample_hyperposterior(cfg, ys, torch.Generator().manual_seed(4),
                                init_theta=init, num_samples=2, num_warmup=1,
                                max_tree_depth=2)
    assert res.samples.shape == (2, 2, 6)
    assert bool(torch.isfinite(res.samples).all())
    logpost = make_logposterior(cfg, ys)
    for c in range(2):
        npt.assert_allclose(float(logpost(res.samples[c, -1])),
                            float(res.log_densities[c, -1]), rtol=1e-12)


# -- timing --------------------------------------------------------------------

def test_timing_utilities_on_cpu(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return (x @ x).sum()

    res = time_jitted(fn, torch.ones(8, 8), repeats=3)
    assert isinstance(res, TimingResult) and len(calls) == 4
    out, secs = timed(fn, torch.ones(2, 2))
    assert float(out) == 8.0 and secs > 0 and len(calls) == 5
    assert len(res.times) == 3 and 0 < res.best <= res.median
    assert "over 3 runs" in str(res)
    lines = []
    with wall_timer("block", printer=lines.append):
        fn(torch.ones(4, 4))
    assert lines and lines[0].startswith("[block] ")
    with profile_trace(str(tmp_path)) as prof:
        fn(torch.ones(4, 4))
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


def test_profile_device_needs_the_card():
    """The card's profile has no host fallback: without CUDA it raises
    before calling ``fn`` (``tests/test_torch_cuda.py`` runs it on the
    card)."""
    calls = []
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_device(lambda: calls.append(1))
    assert not calls
