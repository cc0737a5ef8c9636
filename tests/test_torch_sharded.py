"""The port's scale-out layer against the JAX package's: the rank mesh and
its sweeps, the time-sharded KF/RTS, the particle-sharded SMC, the
chain-sharded NUTS and hyperposterior, and the ``mesh`` arguments of the
Monte-Carlo sweeps and the filter-error Monte Carlo.

The port runs SPMD over ``torch.distributed``.  Each check runs twice: on
four ``gloo`` ranks on the CPU, spawned once for the module (every check
in one spawn, results written to a temporary directory), and on an
in-process one-rank mesh.  The JAX side runs on a 4-device mesh of the
virtual CPU devices that ``tests/conftest.py`` makes.  Random checks run
on equal draws: JAX's per-shard key schedule, rebuilt with JAX and fed to
the port.  The spawned ranks import this module by name, so JAX is
imported only inside the functions that build references.
"""

import math
import multiprocessing
import socket

import numpy as np
import numpy.testing as npt
import pytest
import torch
import torch.distributed as dist

from chirpgp_tpu_torch.apps import (
    IFEstimationConfig, filter_error_mc, mc_kpt_sweep, mc_mle_sweep,
    sample_hyperposterior_sharded)
from chirpgp_tpu_torch.apps.sweeps import generate_rnd_keys
from chirpgp_tpu_torch.infer import (
    bootstrap_filter, bootstrap_filter_sharded, kf_parallel,
    kf_parallel_time_sharded, nuts_sample_sharded, rts_parallel,
    rts_parallel_time_sharded)
from chirpgp_tpu_torch.infer.nuts import NUTSDraws
from chirpgp_tpu_torch.infer.smc import SMCDraws
from chirpgp_tpu_torch.models import disc_m32
from chirpgp_tpu_torch.parallel import (
    make_mesh, pad_to_multiple, sharded_mean, sharded_seed_sweep)

torch.set_num_threads(1)

RANKS = 4
JOIN_TIMEOUT_S = 240
MESHES = ["4 ranks", "1 rank"]
# The data of tests/test_parallel_sharded.py (T divisible by 8) and of
# tests/test_nuts_smc.py's LGSSM.
KF_ARGS = (0.7, 1.2, 0.01, 0.05)            # ell, sigma, dt, Xi
KF_T, KF_BLOCK = 240, 8
SMC_ARGS = (1.0, 1.0, 0.01, 0.1)
SMC_T, SMC_N = 100, 256
NUTS_CHAINS, NUTS_DEPTH, NUTS_TRANSITIONS = 8, 4, (10, 10)
COV = np.array([[1.0, 0.7], [0.7, 2.0]])
HYPER_T, HYPER_CHAINS, HYPER_DEPTH = 16, 4, 3
CRLB_ARGS = (0.1, 0.1, 0.1, 1.0, 1.0, 0.1)
CRLB_N, CRLB_T = 64, 50
SWEEP_B, SWEEP_T, SWEEP_ITERS = 8, 40, 3
SEEDS = np.linspace(-1.0, 2.0, 8)


def _seed_fn(x):
    """A function of a batch of float keys, with two leaves."""
    return {"a": torch.sin(x) * x,
            "b": torch.stack([x, x ** 2, torch.cos(x)], 1)}


def _rows(x, mesh, axis=0):
    """This rank's part of axis ``axis`` of ``x`` (all of it on one rank)."""
    x = torch.as_tensor(x)
    n = x.shape[axis] // mesh.size
    return x.narrow(axis, mesh.rank * n, n)


def _nuts_draws(inp, prefix, mesh):
    return NUTSDraws(*(_rows(inp[f"{prefix}_{k}"], mesh, 1)
                       for k in NUTSDraws._fields))


def _run_checks(mesh, inp) -> dict:
    """Every sharded entry point of the port on ``mesh``, on the inputs
    ``inp`` (JAX's data and draws); the results as NumPy arrays."""
    out = {}
    f64 = dict(dtype=torch.float64)
    for name, val in sharded_seed_sweep(_seed_fn, torch.tensor(SEEDS),
                                        mesh).items():
        out[f"sweep_{name}"] = val.numpy()
    for name, val in sharded_mean(_seed_fn, torch.tensor(SEEDS),
                                  mesh).items():
        out[f"mean_{name}"] = val.numpy()

    F, Sigma, H, m0, P0 = (torch.as_tensor(inp[f"kf_{k}"]) for k in
                           ("F", "Sigma", "H", "m0", "P0"))
    for tag, bs in (("flat", None), ("blocked", KF_BLOCK)):
        res = kf_parallel_time_sharded(F, Sigma, H, KF_ARGS[3], m0, P0,
                                       inp["kf_ys"], mesh, block_size=bs)
        res += rts_parallel_time_sharded(F, Sigma, inp["kf_mfs"],
                                         inp["kf_Pfs"], mesh, block_size=bs)
        for name, val in zip(("mfs", "Pfs", "nll", "mss", "Pss"), res):
            out[f"kf_{tag}_{name}"] = val.numpy()

    ell, sigma, dt, Xi = SMC_ARGS
    draws = SMCDraws(_rows(inp["smc_z0"], mesh), _rows(inp["smc_z"], mesh, 1),
                     torch.as_tensor(inp["smc_u"]))
    res = bootstrap_filter_sharded(
        disc_m32(ell, sigma), torch.tensor([1.0, 0.0], **f64), Xi,
        torch.zeros(2, **f64), torch.as_tensor(inp["smc_P0"]), dt,
        inp["smc_ys"], None, mesh, num_particles=SMC_N, draws=draws)
    for name, val in zip(res._fields, res):
        out[f"smc_{name}"] = val.numpy()

    prec = torch.as_tensor(np.linalg.inv(COV))
    n_w, n_s = NUTS_TRANSITIONS
    res = nuts_sample_sharded(
        lambda q: -0.5 * q @ prec @ q, torch.as_tensor(inp["nuts_inits"]),
        None, mesh, num_samples=n_s, num_warmup=n_w, step_size=0.5,
        max_tree_depth=NUTS_DEPTH, draws=_nuts_draws(inp, "nuts", mesh))
    for name, val in zip(res._fields, res):
        out[f"nuts_{name}"] = val.numpy()

    res = sample_hyperposterior_sharded(
        IFEstimationConfig(), torch.as_tensor(inp["hyper_ys"]), None, mesh,
        HYPER_CHAINS, num_samples=1, num_warmup=1,
        init_z=torch.as_tensor(inp["hyper_init_z"]),
        max_tree_depth=HYPER_DEPTH, draws=_nuts_draws(inp, "hyper", mesh))
    for name, val in zip(res._fields, res):
        out[f"hyper_{name}"] = val.numpy()

    def crlb_draws(_index, n):
        return tuple(torch.as_tensor(inp[f"crlb_{k}"][:n])
                     for k in ("z0", "zx", "zy"))

    for method in ("ghf", "ekf"):
        res = filter_error_mc(*CRLB_ARGS, CRLB_N, method=method, T=CRLB_T,
                              mesh=mesh, draws=crlb_draws)
        for name, val in res.items():
            out[f"crlb_{method}_{name}"] = val

    cfg = IFEstimationConfig(method="ekfs", max_iters=SWEEP_ITERS)
    keys = generate_rnd_keys(SWEEP_B)
    for name, val in mc_mle_sweep(cfg, keys, "random", T=SWEEP_T,
                                  mesh=mesh).items():
        out[f"mle_{name}"] = val
    for name, val in mc_kpt_sweep(keys, "damped", T=SWEEP_T,
                                  max_iters=SWEEP_ITERS, mesh=mesh,
                                  stepped=False).items():
        out[f"kpt_{name}"] = val
    return out


def _rank_main(rank, port, workdir):
    """One spawned rank: every check on the 4-rank mesh, then the mesh
    that is too large and a 2-rank one."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=RANKS, rank=rank)
    try:
        inp = dict(np.load(f"{workdir}/inputs.npz"))
        out = _run_checks(make_mesh(RANKS, device="cpu"), inp)
        try:
            make_mesh(RANKS + 1, device="cpu")
            out["too_large_raised"] = np.array(False)
        except ValueError:
            out["too_large_raised"] = np.array(True)
        sub = make_mesh(2, device="cpu")
        out["sub_mesh"] = np.array([-1.0, -1.0]) if sub is None else \
            np.array([sub.size, sharded_mean(lambda x: x, torch.arange(
                4.0, dtype=torch.float64), sub)])
        np.savez(f"{workdir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# -- JAX's data and draws -------------------------------------------------------

def _jax_transition_draws(k, d, depth):
    """One NUTS transition's draws as the JAX package's ``_nuts_kernel``
    and ``_build_subtree`` split them."""
    import jax
    import jax.numpy as jnp
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


def _jax_sharded_nuts_draws(keys, n_shards, n_w, n_s, d, depth):
    """``nuts_sample_sharded``'s schedule: per shard, ``kw, ks =
    split(local_keys[0])`` and ``split(fold_in(kw, i), n_local)`` per
    transition; the shards side by side on the chain axis."""
    import jax
    n_local = keys.shape[0] // n_shards

    def shard(k0):
        kw, ks = jax.random.split(k0)
        per = [jax.vmap(lambda i: jax.random.split(
            jax.random.fold_in(k, i), n_local))(jax.numpy.arange(n))
               for k, n in ((kw, n_w), (ks, n_s))]
        tkeys = jax.numpy.concatenate(per)       # (n_w + n_s, n_local, 2)
        return jax.vmap(jax.vmap(
            lambda k: _jax_transition_draws(k, d, depth)))(tkeys)

    parts = [shard(keys[s * n_local]) for s in range(n_shards)]
    return [np.concatenate([np.asarray(p[i]) for p in parts], 1)
            for i in range(4)]


def _jax_sharded_smc_draws(key, T, N, d, n_shards):
    """``bootstrap_filter_sharded``'s schedule: ``split(key)`` into init
    and scan keys, ``fold_in(., shard)`` for each shard's initial cloud
    and proposals, the resampling uniform from the replicated key."""
    import jax
    n_loc = N // n_shards
    key_init, key_scan = jax.random.split(key)
    step_keys = jax.random.split(key_scan, T)
    z0 = np.concatenate([np.asarray(jax.random.normal(
        jax.random.fold_in(key_init, s), (n_loc, d))) for s in
        range(n_shards)])

    def step(k):
        k_prop, k_res = jax.random.split(k)
        z = jax.numpy.concatenate([jax.random.normal(
            jax.random.fold_in(k_prop, s), (n_loc, d))
            for s in range(n_shards)])
        return z, jax.random.uniform(k_res, ())

    z, u = jax.vmap(step)(step_keys)
    return z0, np.asarray(z), np.asarray(u)


def _m32_lgssm(ell, sigma, dt, Xi, T, seed):
    """The JAX tests' M32 LGSSM, simulated by the JAX package."""
    import jax
    import jax.numpy as jnp
    from chirpgp_tpu.models import m32_solution, stationary_cov_m32
    from chirpgp_tpu.utils import simulate_lgssm
    F, Sigma = m32_solution(ell, sigma, dt)
    H = jnp.array([1.0, 0.0])
    key = jax.random.PRNGKey(seed)
    xs = simulate_lgssm(F, Sigma, jnp.zeros(2), T, key)
    key, sub = jax.random.split(key)
    ys = xs @ H + math.sqrt(Xi) * jax.random.normal(sub, (T,))
    return (np.asarray(F), np.asarray(Sigma), np.asarray(H), np.zeros(2),
            np.asarray(stationary_cov_m32(ell, sigma)), np.asarray(ys))


def _crlb_normals(key, n, T):
    """``filter_error_mc``'s per-seed normals (the JAX package's
    ``simulate_sde`` and noise keys)."""
    import jax

    def one(k):
        k_traj, k_noise = jax.random.split(k)
        return (jax.random.normal(k_traj, (4,)),
                jax.random.normal(jax.random.split(k_traj)[0], (T, 4)),
                jax.random.normal(k_noise, (T,)))

    return [np.asarray(z) for z in jax.vmap(one)(jax.random.split(key, n))]


@pytest.fixture(scope="module")
def inputs():
    import jax
    from chirpgp_tpu.infer import kf
    inp = {}
    F, Sigma, H, m0, P0, ys = _m32_lgssm(*KF_ARGS, KF_T, 21)
    mfs, Pfs, _ = kf(F, Sigma, H, KF_ARGS[3], m0, P0, ys)
    inp.update(kf_F=F, kf_Sigma=Sigma, kf_H=H, kf_m0=m0, kf_P0=P0, kf_ys=ys,
               kf_mfs=np.asarray(mfs), kf_Pfs=np.asarray(Pfs))
    *_, P0, ys = _m32_lgssm(*SMC_ARGS, SMC_T, 7)
    inp.update(smc_P0=P0, smc_ys=ys)
    for k, v in zip(("z0", "z", "u"), _jax_sharded_smc_draws(
            jax.random.PRNGKey(8), SMC_T, SMC_N, 2, RANKS)):
        inp[f"smc_{k}"] = v
    inp["nuts_inits"] = np.asarray(0.1 * jax.random.normal(
        jax.random.PRNGKey(2), (NUTS_CHAINS, 2)))
    for k, v in zip(NUTSDraws._fields, _jax_sharded_nuts_draws(
            jax.random.split(jax.random.PRNGKey(3), NUTS_CHAINS), RANKS,
            *NUTS_TRANSITIONS, 2, NUTS_DEPTH)):
        inp[f"nuts_{k}"] = v
    inp["hyper_ys"] = np.load("results/data/toydata_const.npz")["ys"][
        0, :HYPER_T].astype(np.float64)
    k_init, k_chains = jax.random.split(jax.random.PRNGKey(4))
    inp["hyper_init_z"] = np.asarray(jax.random.normal(
        k_init, (HYPER_CHAINS, 6)))
    for k, v in zip(NUTSDraws._fields, _jax_sharded_nuts_draws(
            jax.random.split(k_chains, HYPER_CHAINS), RANKS, 1, 1, 6,
            HYPER_DEPTH)):
        inp[f"hyper_{k}"] = v
    for k, v in zip(("z0", "zx", "zy"), _crlb_normals(
            jax.random.PRNGKey(2022), CRLB_N, CRLB_T)):
        inp[f"crlb_{k}"] = v
    return {k: np.array(v) for k, v in inp.items()}


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """{mesh: [each rank's results]}: one spawn of four gloo ranks, and
    the in-process one-rank mesh."""
    workdir = tmp_path_factory.mktemp("sharded")
    np.savez(workdir / "inputs.npz", **inputs)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, str(workdir)))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a spawned rank hung"
    assert [p.exitcode for p in procs] == [0] * RANKS
    ranks = [dict(np.load(workdir / f"rank{r}.npz")) for r in range(RANKS)]
    return {"4 ranks": ranks,
            "1 rank": [_run_checks(make_mesh(device="cpu"), inputs)]}


def _close(got, want, rtol):
    """Deviation within ``rtol`` of the scale of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    npt.assert_allclose(got, want, rtol=0,
                        atol=rtol * max(np.abs(want).max(), 1e-300))


# -- the mesh ----------------------------------------------------------------

def test_pad_to_multiple_matches_jax():
    """Edge padding along either axis, and nothing to pad: exact."""
    import jax.numpy as jnp
    from chirpgp_tpu.parallel import pad_to_multiple as jax_pad
    x = np.arange(10.0).reshape(5, 2)
    for m, axis in ((4, 0), (3, 1), (5, 0)):
        got, n = pad_to_multiple(torch.tensor(x), m, axis)
        want, n_want = jax_pad(jnp.asarray(x), m, axis)
        assert n == n_want
        npt.assert_array_equal(got.numpy(), np.asarray(want))


def test_every_rank_returns_the_global_result(runs):
    """Each of the four ranks returns the same gathered results (the
    2-rank mesh spans ranks 0 and 1 only)."""
    first = runs["4 ranks"][0]
    for other in runs["4 ranks"][1:]:
        assert set(other) == set(first)
        for name in set(first) - {"sub_mesh"}:
            npt.assert_array_equal(other[name], first[name], err_msg=name)


def test_make_mesh_beyond_the_group_raises(runs):
    """More ranks than the process group has raise, on four ranks and
    without a group; a 2-rank mesh spans the first two ranks only."""
    assert all(bool(r["too_large_raised"]) for r in runs["4 ranks"])
    with pytest.raises(ValueError, match="process group has 1"):
        make_mesh(2, device="cpu")
    subs = [tuple(r["sub_mesh"]) for r in runs["4 ranks"]]
    assert subs == [(2.0, 1.5), (2.0, 1.5), (-1.0, -1.0), (-1.0, -1.0)]


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_seed_sweep_and_mean_match_jax(runs, mesh):
    """JAX's sharded sweep and mean on 4 devices, 1e-12."""
    import jax
    import jax.numpy as jnp
    from chirpgp_tpu.parallel import make_mesh as jax_mesh
    from chirpgp_tpu.parallel import sharded_mean as jax_mean
    from chirpgp_tpu.parallel import sharded_seed_sweep as jax_sweep

    def per_seed(x):
        return {"a": jnp.sin(x) * x, "b": jnp.stack([x, x ** 2, jnp.cos(x)])}

    res = runs[mesh][0]
    sweep = jax.device_get(jax_sweep(per_seed, jnp.asarray(SEEDS),
                                     jax_mesh(4)))
    mean = jax.device_get(jax_mean(per_seed, jnp.asarray(SEEDS), jax_mesh(4)))
    for name in ("a", "b"):
        _close(res[f"sweep_{name}"], sweep[name], 1e-12)
        _close(res[f"mean_{name}"], mean[name], 1e-12)


# -- the time-sharded KF/RTS -----------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("tag", ["flat", "blocked"])
def test_time_sharded_kf_rts_match_jax(runs, inputs, mesh, tag):
    """JAX's time-sharded KF/RTS on 4 devices (flat and ``block_size=8``)
    and the port's unsharded ``kf_parallel`` / ``rts_parallel``, f64
    1e-10."""
    from chirpgp_tpu.infer.parallel_sharded import (
        kf_parallel_time_sharded as jax_kf, rts_parallel_time_sharded as
        jax_rts)
    import jax.numpy as jnp
    from chirpgp_tpu.parallel import make_mesh as jax_mesh
    bs = KF_BLOCK if tag == "blocked" else None
    arrays = [inputs[f"kf_{k}"] for k in (
        "F", "Sigma", "H", "m0", "P0", "ys", "mfs", "Pfs")]
    F, Sigma, H, m0, P0, ys, mfs, Pfs = (jnp.asarray(x) for x in arrays)
    Xi = KF_ARGS[3]
    jmesh = jax_mesh(4, axis_name="time")
    want = jax_kf(F, Sigma, H, Xi, m0, P0, ys, jmesh, block_size=bs) \
        + jax_rts(F, Sigma, mfs, Pfs, jmesh, block_size=bs)
    t = [torch.as_tensor(x) for x in arrays]
    plain = kf_parallel(*t[:3], Xi, *t[3:6]) + rts_parallel(*t[:2], *t[6:])
    res = runs[mesh][0]
    for i, name in enumerate(("mfs", "Pfs", "nll", "mss", "Pss")):
        _close(res[f"kf_{tag}_{name}"], np.asarray(want[i]), 1e-10)
        _close(res[f"kf_{tag}_{name}"], plain[i].numpy(), 1e-10)


# -- SMC, NUTS and the hyperposterior -----------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
def test_bootstrap_filter_sharded_matches_jax(runs, inputs, mesh):
    """JAX's particle-sharded filter on 4 devices (N=256, T=100) on its
    per-shard draws: means, log-ML and ESS, f64 1e-9; and the port's
    unsharded filter on the same draws."""
    import jax
    import jax.numpy as jnp
    from chirpgp_tpu.infer.smc import bootstrap_filter_sharded as jax_smc
    from chirpgp_tpu.models import disc_m32 as jax_disc_m32
    from chirpgp_tpu.parallel import make_mesh as jax_mesh
    ell, sigma, dt, Xi = SMC_ARGS
    want = jax_smc(jax_disc_m32(ell, sigma), jnp.array([1.0, 0.0]), Xi,
                   jnp.zeros(2), jnp.asarray(inputs["smc_P0"]), dt,
                   jnp.asarray(inputs["smc_ys"]), jax.random.PRNGKey(8),
                   jax_mesh(4, axis_name="particles"), num_particles=SMC_N)
    f64 = dict(dtype=torch.float64)
    plain = bootstrap_filter(
        disc_m32(ell, sigma), torch.tensor([1.0, 0.0], **f64), Xi,
        torch.zeros(2, **f64), torch.as_tensor(inputs["smc_P0"]), dt,
        torch.as_tensor(inputs["smc_ys"]), num_particles=SMC_N,
        draws=SMCDraws(*(torch.as_tensor(inputs[f"smc_{k}"])
                         for k in ("z0", "z", "u"))))
    res = runs[mesh][0]
    assert (res["smc_ess"] < 0.5 * SMC_N).any()      # resampling did run
    for name, w, p in zip(plain._fields, want, plain):
        _close(res[f"smc_{name}"], np.asarray(w), 1e-9)
        _close(res[f"smc_{name}"], p.numpy(), 1e-9)


@pytest.mark.parametrize("mesh", MESHES)
def test_nuts_sample_sharded_matches_jax(runs, inputs, mesh):
    """JAX's chain-sharded NUTS on 4 devices, 8 chains, 10 + 10
    transitions at depth 4 on its per-shard draws: samples, log
    densities, accept statistics, divergences and the one step size,
    1e-8."""
    import jax
    import jax.numpy as jnp
    from chirpgp_tpu.infer.nuts import nuts_sample_sharded as jax_nuts
    from chirpgp_tpu.parallel import make_mesh as jax_mesh
    prec = jnp.asarray(np.linalg.inv(COV))
    n_w, n_s = NUTS_TRANSITIONS
    want = jax_nuts(lambda q: -0.5 * q @ prec @ q,
                    jnp.asarray(inputs["nuts_inits"]),
                    jax.random.split(jax.random.PRNGKey(3), NUTS_CHAINS),
                    jax_mesh(4), num_samples=n_s, num_warmup=n_w,
                    step_size=0.5, max_tree_depth=NUTS_DEPTH)
    res = runs[mesh][0]
    assert res["nuts_samples"].shape == (NUTS_CHAINS, n_s, 2)
    npt.assert_allclose(res["nuts_step_size"], res["nuts_step_size"][0])
    for name, w in zip(want._fields, want):
        _close(res[f"nuts_{name}"], np.asarray(w), 1e-8)


@pytest.mark.parametrize("mesh", MESHES)
def test_sample_hyperposterior_sharded_matches_jax(runs, mesh):
    """JAX's sharded hyperposterior (cov GHFS, f64, seed 0 of toydata at
    T=16, 4 chains, 1 + 1 transitions at depth 3) on its draws, 1e-8."""
    import jax
    import jax.numpy as jnp
    from chirpgp_tpu.apps.pipeline import IFEstimationConfig as JaxConfig
    from chirpgp_tpu.apps.posterior import (
        sample_hyperposterior_sharded as jax_hyper)
    from chirpgp_tpu.parallel import make_mesh as jax_mesh
    ys = np.load("results/data/toydata_const.npz")["ys"][0, :HYPER_T]
    want = jax_hyper(JaxConfig(), jnp.asarray(ys, jnp.float64),
                     jax.random.PRNGKey(4), jax_mesh(4), HYPER_CHAINS,
                     num_samples=1, num_warmup=1, max_tree_depth=HYPER_DEPTH)
    res = runs[mesh][0]
    assert np.isfinite(res["hyper_samples"]).all()
    for name, w in zip(want._fields, want):
        _close(res[f"hyper_{name}"], np.asarray(w), 1e-8)


# -- the mesh arguments of the Monte-Carlo jobs -----------------------------------

@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("method", ["ghf", "ekf"])
def test_filter_error_mc_mesh_matches_jax(runs, inputs, mesh, method):
    """JAX's ``filter_error_mc(mesh=make_mesh(4))`` on its per-seed draws,
    and the port's ``mesh=None`` on the same draws, 1e-10."""
    import jax
    import chirpgp_tpu.apps.crlb as jcrlb
    from chirpgp_tpu.parallel import make_mesh as jax_mesh
    want = jcrlb.filter_error_mc(*CRLB_ARGS, CRLB_N, method=method, T=CRLB_T,
                                 key=jax.random.PRNGKey(2022),
                                 mesh=jax_mesh(4))
    plain = filter_error_mc(
        *CRLB_ARGS, CRLB_N, method=method, T=CRLB_T, device="cpu",
        draws=lambda _i, n: tuple(torch.as_tensor(inputs[f"crlb_{k}"][:n])
                                  for k in ("z0", "zx", "zy")))
    res = runs[mesh][0]
    for name in want:
        _close(res[f"crlb_{method}_{name}"], want[name], 1e-10)
        _close(res[f"crlb_{method}_{name}"], plain[name], 1e-10)


@pytest.fixture(scope="module")
def unsharded_sweeps():
    cfg = IFEstimationConfig(method="ekfs", max_iters=SWEEP_ITERS)
    keys = generate_rnd_keys(SWEEP_B)
    return {"mle": mc_mle_sweep(cfg, keys, "random", T=SWEEP_T,
                                device="cpu"),
            "kpt": mc_kpt_sweep(keys, "damped", T=SWEEP_T,
                                max_iters=SWEEP_ITERS, stepped=False,
                                device="cpu")}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("sweep", ["mle", "kpt"])
def test_mc_sweeps_mesh_match_unsharded(runs, unsharded_sweeps, mesh, sweep):
    """``mc_mle_sweep`` (EKFS) and ``mc_kpt_sweep`` (``stepped=False``) at
    B=8, T=40 with a mesh against ``mesh=None``: rtol 1e-6, atol 1e-8 (the
    JAX package's shard-invariance tolerance).  The port's seeds are not
    JAX's keys, so there is no JAX reference here."""
    res = runs[mesh][0]
    want = unsharded_sweeps[sweep]
    assert want["success"].dtype == bool
    npt.assert_array_equal(res[f"{sweep}_success"], want["success"])
    for name in ("rmse", "params"):
        npt.assert_allclose(res[f"{sweep}_{name}"], want[name], rtol=1e-6,
                            atol=1e-8)


def test_stepped_kpt_sweep_takes_no_mesh():
    """The stepped KPT sweep compares each lane with the whole batch, so it
    is not split: with a mesh it raises (the JAX package runs it
    unsharded)."""
    with pytest.raises(ValueError, match="stepped=False"):
        mc_kpt_sweep(generate_rnd_keys(4), "const", T=SWEEP_T,
                     mesh=make_mesh(device="cpu"), device="cpu")
