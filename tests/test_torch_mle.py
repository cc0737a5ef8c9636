"""PyTorch port vs the JAX package: the MLE objective ``make_nll_fn`` (value
and gradient through the filter), its dtype rule, and ``fit_mle`` with host
SciPy L-BFGS-B and with the in-package L-BFGS.  Tolerances: value and
gradient 1e-8 relative (the gradient relative to max |grad|); fit_mle: the
same ``success``, theta within 1e-5, NLL within 1e-8 relative; with
``optimizer="lbfgs"`` also the same iteration count."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.apps.pipeline as jp
import chirpgp_tpu_torch.apps.pipeline as tp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _ys(T):
    return np.load(ROOT / "results/data/toydata_const.npz")["ys"][0, :T] \
        .astype(np.float64)


def _theta0():
    """The default init theta at float64, as the JAX package gives it
    under x64."""
    return np.array(jp.IFEstimationConfig().default_init_theta(), np.float64)


def _value_and_grad_torch(cfg, ys, theta):
    th = torch.tensor(theta, requires_grad=True)
    value = tp.make_nll_fn(cfg, ys)(th)
    grad, = torch.autograd.grad(value, th)
    return value.detach(), grad


@pytest.mark.parametrize("form", ["cov", "sqrt"])
@pytest.mark.parametrize("method", ["ghfs", "ekfs"])
def test_make_nll_fn_value_and_grad_match_jax(method, form):
    ys, theta = _ys(100), _theta0()
    vj, gj = jax.value_and_grad(jp.make_nll_fn(
        jp.IFEstimationConfig(method=method, form=form), jnp.asarray(ys)))(
            jnp.asarray(theta))
    vt, gt = _value_and_grad_torch(
        tp.IFEstimationConfig(method=method, form=form), torch.tensor(ys),
        theta)
    assert vt.dtype == torch.float64 and vt.shape == ()
    npt.assert_allclose(float(vt), float(vj), rtol=1e-8, atol=0)
    gj = np.asarray(gj)
    npt.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-8 * np.abs(gj).max())


def test_objective_dtype_follows_promotion():
    """Theta and the data promote as the JAX package's do under x64: a
    float64 theta over float32 data computes in float64 (the value JAX
    gives to 1e-8); float32 theta over float32 data computes in float32
    (the JAX package's precision without x64, as on the TPU)."""
    ys, theta = _ys(100), _theta0()
    cfg_j, cfg_t = jp.IFEstimationConfig(form="sqrt"), \
        tp.IFEstimationConfig(form="sqrt")
    vj = jp.make_nll_fn(cfg_j, jnp.asarray(ys, jnp.float32))(
        jnp.asarray(theta))
    assert vj.dtype == jnp.float64
    ys32 = torch.tensor(ys, dtype=torch.float32)
    v64 = tp.make_nll_fn(cfg_t, ys32)(torch.tensor(theta))
    assert v64.dtype == torch.float64
    npt.assert_allclose(float(v64), float(vj), rtol=1e-8, atol=0)
    v32 = tp.make_nll_fn(cfg_t, ys32)(torch.tensor(theta, dtype=torch.float32))
    assert v32.dtype == torch.float32
    npt.assert_allclose(float(v32), float(vj), rtol=1e-5, atol=0)
    # The objective runs where the data are; theta is moved there.
    assert tp.make_nll_fn(cfg_t, ys32)(theta).device == ys32.device


def test_fit_mle_matches_jax():
    ys, theta = _ys(200), _theta0()
    oj = jp.fit_mle(jp.IFEstimationConfig(), jnp.asarray(ys),
                    jnp.asarray(theta))
    ot = tp.fit_mle(tp.IFEstimationConfig(), torch.tensor(ys),
                    torch.tensor(theta))
    assert bool(ot.success) == bool(oj.success)
    assert ot.params.dtype == torch.float64 and ot.fun_val.dtype == torch.float64
    npt.assert_allclose(ot.params.numpy(), np.asarray(oj.params), atol=1e-5,
                        rtol=0)
    npt.assert_allclose(float(ot.fun_val), float(oj.fun_val), rtol=1e-8,
                        atol=0)
    assert int(ot.num_iters) > 0


def test_fit_mle_lbfgs_matches_jax():
    ys, theta = _ys(100), _theta0()
    cfg = dict(optimizer="lbfgs", max_iters=20)
    oj = jp.fit_mle(jp.IFEstimationConfig(**cfg), jnp.asarray(ys),
                    jnp.asarray(theta))
    ot = tp.fit_mle(tp.IFEstimationConfig(**cfg), torch.tensor(ys),
                    torch.tensor(theta))
    assert bool(ot.success) == bool(oj.success)
    assert int(ot.num_iters) == int(oj.num_iters)
    assert ot.params.shape == (6,) and ot.params.dtype == torch.float64
    npt.assert_allclose(ot.params.numpy(), np.asarray(oj.params), atol=1e-5,
                        rtol=0)
    npt.assert_allclose(float(ot.fun_val), float(oj.fun_val), rtol=1e-8,
                        atol=0)


def test_scipy_minimize_records_divergence():
    """A NaN objective is reported as success=False (the reference records
    such Monte-Carlo runs as NaN), not raised."""
    from chirpgp_tpu_torch.fit import scipy_minimize
    res = scipy_minimize(lambda th: (th * th).sum() * float("nan"),
                         torch.zeros(2, dtype=torch.float64))
    assert not bool(res.success)
    res = scipy_minimize(lambda th: ((th - 3.0) ** 2).sum(),
                         np.zeros(2))
    assert bool(res.success)
    npt.assert_allclose(res.params.numpy(), [3.0, 3.0], atol=1e-6)


def test_unported_options_raise():
    ys = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="Unknown model"):
        tp.fit_mle(tp.IFEstimationConfig(model="tme"), ys)
    with pytest.raises(ValueError):
        tp.fit_mle(tp.IFEstimationConfig(optimizer="adam"), ys)
    from chirpgp_tpu_torch.apps import mc_kpt_sweep
    from chirpgp_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError, match="stepped=False"):
        mc_kpt_sweep(np.zeros((1, 2), np.uint32), "const",
                     mesh=make_mesh(device="cpu"))
    for method in ("cd_ghfs", "cd_ekfs"):
        with pytest.raises(ValueError, match="form='sqrt' supports"):
            tp.make_nll_fn(tp.IFEstimationConfig(method=method, form="sqrt"),
                           ys)
    with pytest.raises(ValueError):
        tp.make_nll_fn(tp.IFEstimationConfig(method="pf"), ys)
    with pytest.raises(ValueError):
        tp.estimate_if(tp.IFEstimationConfig(form="info"), [0.1] * 6, ys)
    with pytest.raises(ValueError, match="form='sqrt' supports"):
        tp.estimate_if(tp.IFEstimationConfig(model="lascala",
                                             method="cd_ekfs", form="sqrt"),
                       [0.1] * 4, ys)
