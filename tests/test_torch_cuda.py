"""The hand-written CUDA kernels of the PyTorch port against their plain
PyTorch versions, on an NVIDIA GPU.  Every test here skips without one.

This file imports neither JAX nor the JAX package, so a machine with a
card and no JAX runs it on its own, without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

from chirpgp_tpu_torch.apps import IFEstimationConfig, estimate_if_batched
from chirpgp_tpu_torch.ops.chirp_filter import (
    ghfs_chirp_filter, ghfs_chirp_filter_reference)
from chirpgp_tpu_torch.quad import cubature, gauss_hermite

torch.set_num_threads(1)

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


@pytest.mark.cuda
def test_chirp_filter_kernel_masks_ragged_batch(cuda):
    """B not a multiple of the 128-lane block, and B < 128."""
    for B in (1, 130):
        ys = torch.tensor(
            0.1 * np.random.default_rng(B).standard_normal((B, 16)),
            dtype=torch.float64, device=cuda)
        got = ghfs_chirp_filter(PARAMS, 0.1, 1e-3, cubature(4), ys)
        want = ghfs_chirp_filter_reference(PARAMS, 0.1, 1e-3, cubature(4), ys)
        for a, b in zip(got, want):
            npt.assert_allclose(_np(a), _np(b), atol=1e-9, rtol=0)


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
