"""The hand-written CUDA kernels of the PyTorch port against their plain
PyTorch versions, on an NVIDIA GPU.  Every test here skips without one.

This file imports neither JAX nor the JAX package, so a machine with a
card and no JAX runs it on its own, without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import torch

from chirpgp_tpu_torch.apps import (
    IFEstimationConfig, estimate_if_batched, make_nll_fn)
from chirpgp_tpu_torch.infer import sqrt_sgp_filter_smoother_batched
from chirpgp_tpu_torch.models import build_chirp_model, g_inv
from chirpgp_tpu_torch.ops.chirp_filter import (
    TEAMS, ghfs_chirp_filter, ghfs_chirp_filter_kernel,
    ghfs_chirp_filter_reference, launch_geometry)
from chirpgp_tpu_torch.quad import cubature, gauss_hermite

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

PARAMS = (0.1, 0.1, 0.1, 1.0, 1.0, 7.0)
# atol on (mfs and nll, L L^T and Lfs): the levels of
# tests/test_pallas_filter.py in float32; round-off in float64.
TOLS = {"float32": (5e-5, 1e-4), "float64": (1e-9, 1e-9)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU "
                    "mode)")
    return torch.device("cuda", 0)


def _np(x):
    return x.detach().cpu().numpy()


def _gram(L):
    return np.einsum("tikb,tjkb->tijb", L, L)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["gh3", "cubature"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_chirp_filter_kernel_matches_plain(cuda, rule, dtype):
    atol_m, atol_P = TOLS[dtype]
    sgps = gauss_hermite(4, 3) if rule == "gh3" else cubature(4)
    ys = torch.tensor(
        0.1 * np.random.default_rng(0).standard_normal((512, 32)),
        dtype=getattr(torch, dtype), device=cuda)
    before = ghfs_chirp_filter.launches
    got = [_np(x) for x in ghfs_chirp_filter(PARAMS, 0.1, 1e-3, sgps, ys)]
    assert ghfs_chirp_filter.launches == before + 1
    want = [_np(x) for x in
            ghfs_chirp_filter_reference(PARAMS, 0.1, 1e-3, sgps, ys)]
    npt.assert_allclose(got[0], want[0], atol=atol_m, rtol=0)
    npt.assert_allclose(got[2], want[2], atol=atol_m, rtol=0)
    npt.assert_allclose(got[1], want[1], atol=atol_P, rtol=0)
    npt.assert_allclose(_gram(got[1]), _gram(want[1]), atol=atol_P, rtol=0)


RULES = {"cubature": lambda: cubature(4), "gh2": lambda: gauss_hermite(4, 2),
         "gh3": lambda: gauss_hermite(4, 3)}


def _check_every_team(cuda, rule, dtype, B, T, seed):
    """Every team size and the default geometry against the plain
    version, on 0.1 N(0, 1) measurements: mfs and nll within atol_m, Lfs
    and L L^T within atol_P.  Returns the geometries launched."""
    atol_m, atol_P = TOLS[dtype]
    sgps = RULES[rule]()
    ys = torch.tensor(0.1 * np.random.default_rng(seed).standard_normal((B, T)),
                      dtype=getattr(torch, dtype), device=cuda)
    want = [_np(x) for x in
            ghfs_chirp_filter_reference(PARAMS, 0.1, 1e-3, sgps, ys)]
    num_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    geos = []
    for team in (None,) + TEAMS:
        before = ghfs_chirp_filter.launches
        got = [_np(x) for x in
               ghfs_chirp_filter_kernel(PARAMS, 0.1, 1e-3, sgps, ys, team=team)]
        assert ghfs_chirp_filter.launches == before + 1
        for g, w, atol in zip(got, want, (atol_m, atol_P, atol_m)):
            assert g.shape == w.shape
            npt.assert_allclose(g, w, atol=atol, rtol=0)
        npt.assert_allclose(_gram(got[1]), _gram(want[1]), atol=atol_P, rtol=0)
        geos.append(launch_geometry(B, sgps.n_points, num_sms, team))
    return geos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("B", [1, 3, 100, 130, 4099])
def test_chirp_filter_kernel_masks_ragged_batch(cuda, B, rule, dtype):
    """Ragged batches, at every team size: B below one lane per SM, and
    B = 4099, which no geometry's lanes per block divide."""
    geos = _check_every_team(cuda, rule, dtype, B, 16, B)
    if B == 4099:
        assert all(B % g.lanes_per_block for g in geos
                   if g.lanes_per_block > 1)
        assert any(g.lanes_per_block > 1 for g in geos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rule", list(RULES))
def test_chirp_filter_kernel_single_step(cuda, rule, dtype):
    _check_every_team(cuda, rule, dtype, 37, 1, 5)


@pytest.mark.cuda
def test_estimate_if_batched_on_card_matches_cpu(cuda):
    ts = 1e-3 * np.arange(1, 129)
    ys = np.sin(2 * np.pi * 8.0 * ts)[None] + np.sqrt(0.1) * \
        np.random.default_rng(1).standard_normal((8, 128))
    params = torch.tensor(PARAMS, dtype=torch.float64)
    cfg = IFEstimationConfig()
    before = ghfs_chirp_filter.launches
    on_card = estimate_if_batched(cfg, params.to(cuda),
                                  torch.tensor(ys, device=cuda))
    assert ghfs_chirp_filter.launches == before + 1
    on_cpu = estimate_if_batched(cfg, params, torch.tensor(ys))
    for key in ("if_mean", "nell", "mss", "Lss"):
        npt.assert_allclose(_np(on_card[key]), _np(on_cpu[key]), atol=1e-9,
                            rtol=0)


@pytest.mark.cuda
def test_chirp_filter_rejects_too_many_sigma_points(cuda):
    ys = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="sigma points"):
        ghfs_chirp_filter(PARAMS, 0.1, 1e-3, gauss_hermite(4, 4), ys)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["ghfs", "ekfs"])
def test_nll_value_and_grad_on_card_match_cpu(cuda, method):
    """The MLE objective (cov form, float64, T=200 of seed 0) and its
    autograd gradient: card against host CPU, 1e-9 relative on the value
    and 1e-7 relative to max |grad| on the gradient."""
    ys = np.load(ROOT / "results/data/toydata_const.npz")["ys"][0, :200]
    cfg = IFEstimationConfig(method=method)
    out = {}
    for device in ("cpu", cuda):
        theta = g_inv(torch.tensor(PARAMS, dtype=torch.float64, device=device)
                      ).requires_grad_(True)
        value = make_nll_fn(cfg, torch.tensor(ys, dtype=torch.float64,
                                              device=device))(theta)
        assert value.device == theta.device
        grad, = torch.autograd.grad(value, theta)
        out[str(device)] = (float(value.detach()), _np(grad))
    (v_cpu, g_cpu), (v_card, g_card) = out["cpu"], out[str(cuda)]
    npt.assert_allclose(v_card, v_cpu, rtol=1e-9, atol=0)
    npt.assert_allclose(g_card, g_cpu, rtol=0,
                        atol=1e-7 * np.abs(g_cpu).max())


@pytest.mark.cuda
def test_fused_slim_output_bit_equal_on_card(cuda):
    ys = torch.tensor(
        0.1 * np.random.default_rng(2).standard_normal((256, 64)),
        dtype=torch.float32, device=cuda)
    pack = build_chirp_model(torch.tensor(PARAMS, dtype=torch.float32,
                                          device=cuda))
    args = (pack.m_and_cov, gauss_hermite(4, 3), pack.H, 0.1, pack.m0,
            pack.P0, 1e-3, ys)
    mss, Pss, nll = sqrt_sgp_filter_smoother_batched(*args,
                                                     return_factors=False)
    v_mean, v_var, nll2 = sqrt_sgp_filter_smoother_batched(
        *args, return_factors=False, out_index=2)
    assert v_mean.device == ys.device
    assert torch.equal(v_mean, mss[:, 2]) and torch.equal(v_var, Pss[:, 2, 2])
    assert torch.equal(nll2, nll)
