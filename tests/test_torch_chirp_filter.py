"""The fused chirp filter of the PyTorch port: its plain version against
the JAX package's Pallas kernel (interpret mode), the wrapper's routing
and launch count, and the kernel's model constants.  The CUDA kernel
itself is tested on a card by tests/test_torch_cuda.py."""

import math

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.models as jm
import chirpgp_tpu.quad as jq
import chirpgp_tpu_torch.quad as tq
from chirpgp_tpu.experimental.pallas_filter import ghfs_chirp_filter_pallas
from chirpgp_tpu.utils.numerics import ou_variance
from chirpgp_tpu_torch.ops import _build
from chirpgp_tpu_torch.ops.chirp_filter import (
    _chirp_constants, ghfs_chirp_filter, ghfs_chirp_filter_reference)

torch.set_num_threads(1)

PARAMS = (0.1, 0.1, 0.1, 1.0, 1.0, 7.0)
TOLS = {"float32": (5e-5, 1e-4), "float64": (1e-9, 1e-9)}


def _np(x):
    return x.detach().cpu().numpy()


def _gram(L):
    return np.einsum("tikb,tjkb->tijb", L, L)


def _assert_outputs_close(got, want, dtype):
    atol_m, atol_P = TOLS[dtype]
    (mg, Lg, ng), (mw, Lw, nw) = [[np.asarray(x) for x in out]
                                  for out in (got, want)]
    npt.assert_allclose(mg, mw, atol=atol_m, rtol=0)
    npt.assert_allclose(ng, nw, atol=atol_m, rtol=0)
    npt.assert_allclose(_gram(Lg), _gram(Lw), atol=atol_P, rtol=0)


@pytest.mark.parametrize("order", [3, 2])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reference_matches_pallas_interpret(order, dtype):
    params = np.asarray(jm.g(jm.g_inv(jnp.array(PARAMS))), np.float64)
    ys = 0.1 * np.random.default_rng(order).standard_normal((4, 32))
    out_j = ghfs_chirp_filter_pallas(
        params, 0.1, 1e-3, jq.gauss_hermite(4, order),
        jnp.asarray(ys, getattr(jnp, dtype)), chunk=8, interpret=True)
    out_t = ghfs_chirp_filter_reference(
        params, 0.1, 1e-3, tq.gauss_hermite(4, order),
        torch.tensor(ys, dtype=getattr(torch, dtype)))
    assert out_t[0].shape == (32, 4, 4) and out_t[1].shape == (32, 4, 4, 4)
    assert out_t[2].shape == (32, 4)
    _assert_outputs_close([_np(x) for x in out_t], out_j, dtype)


def test_cpu_wrapper_takes_plain_path_without_launching(monkeypatch):
    monkeypatch.setattr(ghfs_chirp_filter, "launches", 0)
    ys = torch.tensor(0.1 * np.random.default_rng(0).standard_normal((3, 16)))
    rule = tq.gauss_hermite(4, 2)
    got = ghfs_chirp_filter(torch.tensor(PARAMS, dtype=torch.float64), 0.1,
                            1e-3, rule, ys)
    want = ghfs_chirp_filter_reference(PARAMS, 0.1, 1e-3, rule, ys)
    assert ghfs_chirp_filter.launches == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_rejections(monkeypatch):
    monkeypatch.setattr(ghfs_chirp_filter, "launches", 0)
    rule = tq.gauss_hermite(4, 2)
    ys = torch.zeros((2, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="gradient"):
        ghfs_chirp_filter(PARAMS, 0.1, 1e-3, rule, ys.requires_grad_())
    with pytest.raises(ValueError, match="gradient"):
        ghfs_chirp_filter(torch.tensor(PARAMS, requires_grad=True), 0.1,
                          1e-3, rule, torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ghfs_chirp_filter(PARAMS, 0.1, 1e-3, rule,
                          torch.empty((2, 8), device="meta"))
    with pytest.raises(ValueError, match="6 values"):
        ghfs_chirp_filter(PARAMS[:5], 0.1, 1e-3, rule, torch.zeros((2, 8)))
    assert ghfs_chirp_filter.launches == 0


@pytest.mark.parametrize("params", [
    PARAMS, (4.92912954e-08, 6.88755505e-05, 4.09863245e-01, 1.38293558e+00,
             5.61270940e+00, 9.41084134e+00)], ids=["default", "ckfs-opt"])
def test_kernel_constants_match_pallas_wrapper(params):
    """The constants the CUDA kernel receives, against the Pallas
    wrapper's own construction (pallas_filter.py:117-144)."""
    lam, b, delta, ell, sigma, m0_v = params
    Xi, dt = 0.1, 1e-3
    F32, S32 = (np.asarray(a, np.float64)
                for a in jm.m32_solution(ell, sigma, dt))
    q = float(ou_variance(b, lam, dt))
    Lq = np.zeros((4, 4))
    Lq[0, 0] = Lq[1, 1] = math.sqrt(q)
    Lq[2:, 2:] = np.linalg.cholesky(S32)
    P0 = np.zeros((4, 4))
    P0[:2, :2] = delta * np.eye(2)
    P0[2:, 2:] = np.asarray(jm.stationary_cov_m32(ell, sigma), np.float64)
    want = np.concatenate([
        F32.reshape(-1), Lq.T.reshape(-1), np.linalg.cholesky(P0).reshape(-1),
        [0.0, 0.0, m0_v, 0.0], [math.exp(-lam * dt), math.sqrt(Xi), dt]])
    got = _chirp_constants(params, Xi, dt)
    assert got.dtype == np.float64 and got.shape == (43,)
    npt.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_build_helpers(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(FileNotFoundError):
        _build.load_library("no_such_kernel")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert (_build.CSRC / "ghfs_chirp_filter.cu").is_file()
