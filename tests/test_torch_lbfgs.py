"""PyTorch port vs the JAX package: the batched L-BFGS with zoom line search
(``chirpgp_tpu_torch.fit.lbfgs``) through ``lbfgs_minimize`` and
``lbfgs_minimize_stepped``, on per-lane quartics and Rosenbrocks in
float64.  Tolerance: params within 1e-10 relative (to the largest
|param|), the same ``num_iters`` and ``success`` -- the line search takes
the same path.  The checkpoint, tail-cap and NaN-lane tests hold the port
to its own uninterrupted or NaN-free runs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.fit.mle as jm
import chirpgp_tpu_torch.fit.mle as tm

torch.set_num_threads(1)

B = 4


def quartic_j(p, a):
    return jnp.sum((p - a) ** 2) + 0.1 * jnp.sum(p ** 4)


def quartic_t(p, a):
    return ((p - a) ** 2).sum() + 0.1 * (p ** 4).sum()


def rosenbrock_j(p, a):
    return jnp.sum(100.0 * (p[1:] - p[:-1] ** 2) ** 2
                   + (1.0 - p[:-1]) ** 2) + jnp.sum(a * p)


def rosenbrock_t(p, a):
    return (100.0 * (p[1:] - p[:-1] ** 2) ** 2
            + (1.0 - p[:-1]) ** 2).sum() + (a * p).sum()


PROBLEMS = {"quartic": (quartic_j, quartic_t, 3),
            "rosenbrock": (rosenbrock_j, rosenbrock_t, 6)}


def _inputs(p, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, p)), 0.3 * rng.standard_normal((B, p))


def _assert_same(rt, rj, rtol=1e-10):
    pj = np.asarray(rj.params)
    npt.assert_allclose(rt.params.numpy(), pj, rtol=0,
                        atol=rtol * np.abs(pj).max())
    npt.assert_array_equal(rt.num_iters.numpy(), np.asarray(rj.num_iters))
    npt.assert_array_equal(rt.success.numpy(), np.asarray(rj.success))


@pytest.mark.parametrize("iters", [1, 2, 3, 5])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_stepped_matches_jax(name, iters):
    fj, ft, p = PROBLEMS[name]
    init, tg = _inputs(p)
    kw = dict(max_iters=iters, ftol_rel=1e-12)
    rj = jm.lbfgs_minimize_stepped(fj, jnp.asarray(init), (jnp.asarray(tg),),
                                   **kw)
    rt = tm.lbfgs_minimize_stepped(ft, torch.tensor(init), (torch.tensor(tg),),
                                   **kw)
    _assert_same(rt, rj)
    npt.assert_allclose(rt.fun_val.numpy(), np.asarray(rj.fun_val),
                        rtol=1e-12, atol=0)


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_lbfgs_minimize_matches_jax(name, chunk):
    """One problem per call (the JAX package's contract), plain and
    host-chunked, on two lanes' problems."""
    fj, ft, p = PROBLEMS[name]
    init, tg = _inputs(p, seed=1)
    for i in range(2):
        rj = jm.lbfgs_minimize(lambda x: fj(x, jnp.asarray(tg[i])),
                               jnp.asarray(init[i]), max_iters=40,
                               chunk_iters=chunk)
        rt = tm.lbfgs_minimize(lambda x: ft(x, torch.tensor(tg[i])),
                               torch.tensor(init[i]), max_iters=40,
                               chunk_iters=chunk)
        assert rt.params.shape == (p,) and rt.num_iters.shape == ()
        _assert_same(rt, rj)
        npt.assert_allclose(float(rt.fun_val), float(rj.fun_val),
                            rtol=1e-12, atol=0)


def test_batched_lbfgs_minimize_matches_vmapped_jax():
    """Lanes stop on their own gradient-norm rule, as under ``jax.vmap``."""
    fj, ft, p = PROBLEMS["rosenbrock"]
    init, tg = _inputs(p, seed=2)
    rj = jax.jit(jax.vmap(lambda x, a: jm.lbfgs_minimize(
        lambda y: fj(y, a), x, max_iters=25, jit=False)))(
            jnp.asarray(init), jnp.asarray(tg))
    rt = tm.lbfgs_minimize(ft, torch.tensor(init), max_iters=25,
                           batch_args=(torch.tensor(tg),))
    _assert_same(rt, rj)


def test_stepped_checkpoint_resume(tmp_path, capsys):
    """An interrupted stepped run resumes from its checkpoint and lands on
    the uninterrupted run's optima (fresh L-BFGS memory after resume is
    allowed a small tolerance); a checkpoint of another shape or another
    fingerprint is ignored."""
    init = torch.zeros((B, 3), dtype=torch.float64)
    targets = torch.arange(B * 3, dtype=torch.float64).reshape(B, 3) / 10.0
    ck = str(tmp_path / "ck.npz")

    full = tm.lbfgs_minimize_stepped(quartic_t, init, (targets,),
                                     max_iters=50, ftol_rel=1e-10)
    tm.lbfgs_minimize_stepped(quartic_t, init, (targets,), max_iters=4,
                              checkpoint_path=ck, checkpoint_every=2,
                              checkpoint_tag="a")
    assert os.path.exists(ck)
    resumed = tm.lbfgs_minimize_stepped(quartic_t, init, (targets,),
                                        max_iters=50, ftol_rel=1e-10,
                                        checkpoint_path=ck,
                                        checkpoint_every=2,
                                        checkpoint_tag="a")
    assert "lbfgs resume from" in capsys.readouterr().out
    npt.assert_allclose(resumed.fun_val.numpy(), full.fun_val.numpy(),
                        rtol=1e-3, atol=1e-5)
    # Another tag: the checkpoint is ignored and the run starts afresh.
    fresh = tm.lbfgs_minimize_stepped(quartic_t, init, (targets,),
                                      max_iters=50, ftol_rel=1e-10,
                                      checkpoint_path=ck, checkpoint_tag="b")
    assert "fingerprint mismatch" in capsys.readouterr().out
    npt.assert_array_equal(fresh.params.numpy(), full.params.numpy())
    # Another sweep shape: ignored silently.
    other = tm.lbfgs_minimize_stepped(quartic_t, init[:2], (targets[:2],),
                                      max_iters=3, checkpoint_path=ck)
    assert other.params.shape == (2, 3)
    assert "resume" not in capsys.readouterr().out


def test_stepped_tail_cap_matches_jax():
    """Three lanes converge within a few iterations, one Rosenbrock lane
    does not: with ``tail_frac`` making it the only straggler, at most
    ``tail_iters`` more iterations run, and the port stops where the JAX
    package does."""
    def mixed_j(x, a):
        return jnp.where(a[0] > 0, rosenbrock_j(x, 0.0 * x),
                         jnp.sum((x - a) ** 2))

    def mixed_t(x, a):
        return torch.where(a[0] > 0, rosenbrock_t(x, 0.0 * x),
                           ((x - a) ** 2).sum())

    init = np.full((B, 4), -1.2)
    tg = np.array([[-0.5] * 4, [-0.2] * 4, [-0.3] * 4, [1.0] * 4])
    kw = dict(max_iters=40, tol=1e-12, ftol_rel=0.0, patience=100,
              tail_frac=0.25, tail_iters=3)
    rj = jm.lbfgs_minimize_stepped(mixed_j, jnp.asarray(init),
                                   (jnp.asarray(tg),), **kw)
    rt = tm.lbfgs_minimize_stepped(mixed_t, torch.tensor(init),
                                   (torch.tensor(tg),), **kw)
    _assert_same(rt, rj)
    uncapped = tm.lbfgs_minimize_stepped(
        mixed_t, torch.tensor(init), (torch.tensor(tg),),
        **dict(kw, tail_iters=None))
    assert int(rt.num_iters[3]) < int(uncapped.num_iters[3])


def test_nan_lane_is_a_failed_lane():
    """A lane whose objective is NaN returns success=False and does not
    raise; the other lanes are as in a run without it."""
    init, tg = _inputs(3, seed=3)
    tg[2] = np.nan
    kw = dict(max_iters=8, ftol_rel=1e-12)
    rt = tm.lbfgs_minimize_stepped(quartic_t, torch.tensor(init),
                                   (torch.tensor(tg),), **kw)
    keep = [0, 1, 3]
    alone = tm.lbfgs_minimize_stepped(quartic_t, torch.tensor(init[keep]),
                                      (torch.tensor(tg[keep]),), **kw)
    npt.assert_array_equal(rt.success.numpy(), [True, True, False, True])
    npt.assert_allclose(rt.params.numpy()[keep], alone.params.numpy(),
                        rtol=1e-12, atol=0)
    npt.assert_array_equal(rt.num_iters.numpy()[keep],
                           alone.num_iters.numpy())
    rb = tm.lbfgs_minimize(quartic_t, torch.tensor(init), max_iters=8,
                           batch_args=(torch.tensor(tg),))
    npt.assert_array_equal(rb.success.numpy(), [True, True, False, True])
