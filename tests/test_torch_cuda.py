"""The hand-written CUDA kernels of the PyTorch port against their plain
PyTorch versions, and the port's other paths on the card against the host
CPU, on an NVIDIA GPU.  Every test here skips without one.

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
    ghfs_chirp_filter_reference, lascala_chirp_params, launch_geometry)
from chirpgp_tpu_torch.ops import chirp_fused, chirp_smoother
from chirpgp_tpu_torch.ops.chirp_fused import (
    FusedKernels, affine_backward_reference, fused_forward_reference,
    fused_kernel_launcher, ghfs_chirp_filter_smoother,
    ghfs_chirp_filter_smoother_reference)
from chirpgp_tpu_torch.ops.chirp_smoother import (
    ROW_WORDS, SmootherKernels, backward_chunks, gaussian_expectation_g,
    ghfs_chirp_smoother, ghfs_chirp_smoother_kernel,
    ghfs_chirp_smoother_reference, smoother_apply_reference,
    smoother_backward_chunked_reference, smoother_backward_reference,
    smoother_carry_reference, smoother_compose_reference,
    smoother_expect_reference, smoother_expect_var_reference,
    smoother_kernel_launcher, smoother_rows_reference)
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


def _signs_of(L, like):
    """The lower factors L (T, 4, 4, B) with each column's sign made that
    of ``like``'s: two lower factors of one Gram differ by column signs
    only, which the Householder pivots pick, so a factor is compared
    entry by entry once they agree (sign of the diagonals; 0 counts as
    +)."""
    L, like = np.asarray(L), np.asarray(like)
    d = np.where(np.diagonal(L, axis1=1, axis2=2) >= 0, 1.0, -1.0)
    w = np.where(np.diagonal(like, axis1=1, axis2=2) >= 0, 1.0, -1.0)
    return L * (d * w).transpose(0, 2, 1)[:, None]


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
@pytest.mark.parametrize("T", [1, 2, 50, 83])
@pytest.mark.parametrize("B", [1, 33, 100])
@pytest.mark.parametrize("rule", ["gh3", "cubature"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_chirp_smoother_kernel_matches_plain(cuda, dtype, rule, B, T):
    """The smoother's kernels (phases A, B and E) against the plain
    version, on the filter kernel's outputs: mss and the IF mean within
    atol_m, Lss (up to its columns' signs: phase B's chunks pick other
    Householder pivots than the plain recursion) and L L^T within atol_P;
    ragged B (past phase B's 32 lanes per block), T = 1 (the filter's
    row), T = 2, and T = 50 and 83, past phase B's ring of steps and not a
    multiple of it."""
    atol_m, atol_P = TOLS[dtype]
    sgps = RULES[rule]()
    ys = torch.tensor(
        0.1 * np.random.default_rng(B + T).standard_normal((B, T)),
        dtype=getattr(torch, dtype), device=cuda)
    mfs, Lfs, _ = ghfs_chirp_filter(PARAMS, 0.1, 1e-3, sgps, ys)
    want = [_np(x) for x in ghfs_chirp_smoother_reference(
        PARAMS, 1e-3, sgps, mfs, Lfs, 10)]
    before = ghfs_chirp_smoother.launches
    got = [_np(x) for x in ghfs_chirp_smoother_kernel(PARAMS, 1e-3, sgps, mfs,
                                                      Lfs, 10)]
    assert ghfs_chirp_smoother.launches == before + 1
    got[1] = _signs_of(got[1], want[1])
    for g, w, atol in zip(got, want, (atol_m, atol_P, atol_m)):
        assert g.shape == w.shape
        npt.assert_allclose(g, w, atol=atol, rtol=0)
    npt.assert_allclose(_gram(got[1]), _gram(want[1]), atol=atol_P, rtol=0)
    npt.assert_array_equal(got[0][-1], _np(mfs)[-1])


def _upper_gram(words):
    """R22^T R22 of the (..., 10, B) upper-triangle words of R22."""
    iu = np.triu_indices(4)
    up = np.zeros(words.shape[:-2] + (4, 4, words.shape[-1]))
    up[..., iu[0], iu[1], :] = words
    return np.einsum("...kib,...kjb->...ijb", up, up)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["gh3", "cubature"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_chirp_smoother_rows_kernel_matches_twin(cuda, dtype, rule):
    """Phase A alone against the plain twin's rows on the same filter
    outputs (B=37, T=23): m_p within atol_m, X within
    atol_P of its scale, R22 by its Gram within atol_P (a row of R22 may
    change sign with the rounding of a near-zero diagonal; phase B reads
    only the Gram)."""
    atol_m, atol_P = TOLS[dtype]
    sgps = RULES[rule]()
    ys = torch.tensor(0.1 * np.random.default_rng(3).standard_normal((37, 23)),
                      dtype=getattr(torch, dtype), device=cuda)
    mfs, Lfs, _ = ghfs_chirp_filter(PARAMS, 0.1, 1e-3, sgps, ys)
    want = _np(smoother_rows_reference(PARAMS, 1e-3, sgps, mfs, Lfs))
    kernels = SmootherKernels(PARAMS, 1e-3, sgps, 10, mfs.dtype, cuda)
    rows = mfs.new_empty((22, ROW_WORDS, 37))
    before = dict(ghfs_chirp_smoother.kernel_launches)
    kernels.rows(mfs, Lfs, rows)
    assert ghfs_chirp_smoother.kernel_launches == dict(
        before, smoother_rows=before["smoother_rows"] + 1)
    got = _np(rows)
    npt.assert_allclose(got[:, :4], want[:, :4], atol=atol_m, rtol=0)
    npt.assert_allclose(got[:, 4:20], want[:, 4:20],
                        atol=atol_P * (1 + np.abs(want[:, 4:20]).max()), rtol=0)
    npt.assert_allclose(_upper_gram(got[:, 20:]), _upper_gram(want[:, 20:]),
                        atol=atol_P, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_chirp_smoother_slabs_give_the_same_bits(cuda, dtype, monkeypatch):
    """A scratch cap that forces slabs of lanes (here 32, 32, 32, 4 lanes,
    and one lane each) gives the outputs of one slab bit for bit."""
    sgps = gauss_hermite(4, 3)
    ys = torch.tensor(0.1 * np.random.default_rng(4).standard_normal((100, 41)),
                      dtype=getattr(torch, dtype), device=cuda)
    mfs, Lfs, _ = ghfs_chirp_filter(PARAMS, 0.1, 1e-3, sgps, ys)
    whole = ghfs_chirp_smoother_kernel(PARAMS, 1e-3, sgps, mfs, Lfs, 10)
    per_lane = 40 * ROW_WORDS * mfs.element_size()
    # Phase B's chunks come from the whole B, whatever the slab.
    chunks = backward_chunks(41, 100, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert chunks > 1
    for cap, slabs in ((40 * per_lane, 4), (per_lane, 100)):
        before = dict(ghfs_chirp_smoother.kernel_launches)
        monkeypatch.setattr(chirp_smoother, "SCRATCH_CAP", cap)
        launch, out = smoother_kernel_launcher(PARAMS, 1e-3, sgps, mfs, Lfs,
                                               10)
        launch()
        assert ghfs_chirp_smoother.kernel_launches == {
            "smoother_rows": before["smoother_rows"] + slabs,
            "smoother_compose": before["smoother_compose"] + slabs,
            "smoother_carry": before["smoother_carry"] + slabs,
            "smoother_backward": before["smoother_backward"] + slabs,
            "smoother_expect": before["smoother_expect"] + 1}
        for a, b in zip(out, whole):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_chirp_smoother_phases_alone_match_the_launch(cuda, dtype,
                                                      monkeypatch):
    """Each kernel launched alone through ``SmootherKernels``, phases A and
    B slab by slab with B on its own slab's rows (slabs of 32, 32, 32 and 4
    lanes), then phase E, gives a wrapper launch's outputs bit for bit."""
    sgps = gauss_hermite(4, 3)
    ys = torch.tensor(0.1 * np.random.default_rng(7).standard_normal((100, 29)),
                      dtype=getattr(torch, dtype), device=cuda)
    mfs, Lfs, _ = ghfs_chirp_filter(PARAMS, 0.1, 1e-3, sgps, ys)
    want = ghfs_chirp_smoother_kernel(PARAMS, 1e-3, sgps, mfs, Lfs, 10)
    monkeypatch.setattr(chirp_smoother, "SCRATCH_CAP",
                        32 * 28 * ROW_WORDS * mfs.element_size())
    slabs = chirp_smoother.smoother_slabs(29, 100, mfs.element_size())
    assert [nb for _, nb in slabs] == [32, 32, 32, 4]
    kernels = SmootherKernels(PARAMS, 1e-3, sgps, 10, mfs.dtype, cuda)
    mss, lss = torch.empty_like(mfs), mfs.new_empty((29, 16, 100))
    if_mean = mfs.new_empty((29, 100))
    for b0, nb in reversed(slabs):
        rows = mfs.new_empty((28, ROW_WORDS, nb))
        kernels.rows(mfs, Lfs, rows, b0)
        kernels.backward(mfs, Lfs, rows, mss, lss, b0)
    kernels.expect(mss, lss, if_mean)
    for a, b in zip((mss, lss.view(29, 4, 4, 100), if_mean), want):
        assert torch.equal(a, b)


def _phase_b_inputs(cuda, dtype, B, T):
    """The filter kernel's outputs on 0.1 N(0, 1) measurements and phase
    A's rows of them, GH-3."""
    sgps = gauss_hermite(4, 3)
    ys = torch.tensor(
        0.1 * np.random.default_rng(B + T).standard_normal((B, T)),
        dtype=getattr(torch, dtype), device=cuda)
    mfs, Lfs, _ = ghfs_chirp_filter(PARAMS, 0.1, 1e-3, sgps, ys)
    kernels = SmootherKernels(PARAMS, 1e-3, sgps, 10, mfs.dtype, cuda)
    rows = mfs.new_empty((T - 1, ROW_WORDS, B))
    kernels.rows(mfs, Lfs, rows)
    return kernels, mfs, Lfs, rows


# (B, T, chunks): one lane, a ragged warp, the Table-I width, at T = 1, 2,
# 3 and 64 with 1, 2, 5 and T - 1 chunks and backward_chunks' own (None);
# at T = 3141 the Table-I width and the benchmark's B=4096.
PHASE_B_CASES = [(B, T, c) for B in (1, 33, 100) for T in (1, 2, 3, 64)
                 for c in sorted({1, 2, 5, T - 1} & set(range(1, max(T, 2))))
                 + [None]] + [(100, 3141, 2), (100, 3141, None),
                              (4096, 3141, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,chunks", PHASE_B_CASES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_phase_b_kernels_match_chunked_twins(cuda, dtype, B, T, chunks):
    """Phase B's Compose, Carry and Apply, each launched alone on the same
    inputs as its plain twin (Carry on Compose's aggregates, Apply on
    Carry's bounds), then the three against the chunked twin and the
    sequential recursion: scaled 1e-4 (float32) or 1e-9 (float64); R22 of
    an aggregate and every factor by its Gram."""
    bound = FUSED_SCALED[dtype]
    kernels, mfs, Lfs, rows = _phase_b_inputs(cuda, dtype, B, T)
    back = kernels.back
    C = back.chunks(T, B) if chunks is None else chunks
    agg, bounds = back.scratch(B, C)
    mss, lss = torch.empty_like(mfs), mfs.new_empty((T, 16, B))
    before = dict(ghfs_chirp_smoother.kernel_launches)
    back.compose(mfs, rows, agg, C)
    back.carry(mfs, Lfs, agg, bounds, C)
    back.apply(mfs, Lfs, rows, bounds, mss, lss, C)
    torch.cuda.synchronize()
    more = int(C > 1)
    assert ghfs_chirp_smoother.kernel_launches == dict(
        before, smoother_compose=before["smoother_compose"] + more,
        smoother_carry=before["smoother_carry"] + more,
        smoother_backward=before["smoother_backward"] + 1)
    want = _np(smoother_compose_reference(mfs, rows, C))
    got = _np(agg)
    assert got.shape == want.shape == (C - 1, 34, B)
    assert _scaled(got[:, :24], want[:, :24]) <= bound
    assert _scaled(_upper_gram(got[:, 24:]), _upper_gram(want[:, 24:])) \
        <= bound
    assert np.isfinite(got).all()
    il = np.tril_indices(4)

    def lower(words):
        L = np.zeros(words.shape[:-2] + (4, 4, words.shape[-1]))
        L[..., il[0], il[1], :] = words
        return L

    want = _np(smoother_carry_reference(mfs, Lfs, agg, C))
    got = _np(bounds)
    assert _scaled(got[:, :4], want[:, :4]) <= bound
    assert _scaled(_gram(lower(got[:, 4:])), _gram(lower(want[:, 4:]))) \
        <= bound
    Lss = lss.view(T, 4, 4, B)
    for ms_w, Ls_w in (smoother_apply_reference(mfs, Lfs, rows, bounds, C),
                       smoother_backward_chunked_reference(mfs, Lfs, rows,
                                                           C),
                       smoother_backward_reference(mfs, Lfs, rows)):
        assert _scaled(_np(mss), _np(ms_w)) <= bound
        assert _scaled(_gram(_np(Lss)), _gram(_np(Ls_w))) <= bound
    assert torch.equal(mss[-1], mfs[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_phase_b_one_chunk_is_the_recursion(cuda, dtype):
    """With one chunk, Apply alone runs the recursion: phase B through
    ``BackwardKernels.run`` launches no Compose or Carry, and its outputs
    are those of Apply at one chunk, bit for bit."""
    kernels, mfs, Lfs, rows = _phase_b_inputs(cuda, dtype, 37, 50)
    mss, lss = torch.empty_like(mfs), mfs.new_empty((50, 16, 37))
    before = dict(ghfs_chirp_smoother.kernel_launches)
    kernels.backward(mfs, Lfs, rows, mss, lss, chunks=1)
    assert ghfs_chirp_smoother.kernel_launches == dict(
        before, smoother_backward=before["smoother_backward"] + 1)
    again = [torch.empty_like(x) for x in (mss, lss)]
    kernels.back.apply(mfs, Lfs, rows, mfs.new_empty((0, 14, 37)), *again, 1)
    assert torch.equal(mss, again[0]) and torch.equal(lss, again[1])


@pytest.mark.cuda
def test_chirp_smoother_launch_keeps_its_tensors(cuda):
    """A bare ``launch`` whose caller keeps only the IF mean still writes
    its own outputs and reads its own tables: repeated launches, with the
    caching allocator handing the freed memory of other tensors around,
    give the first launch's IF mean bit for bit."""
    import gc
    sgps = gauss_hermite(4, 3)
    ys = torch.tensor(0.1 * np.random.default_rng(6).standard_normal((64, 150)),
                      dtype=torch.float32, device=cuda)
    mfs, Lfs, _ = ghfs_chirp_filter(PARAMS, 0.1, 1e-3, sgps, ys)
    launch, (_, _, if_mean) = smoother_kernel_launcher(PARAMS, 1e-3, sgps,
                                                       mfs, Lfs, 10)
    gc.collect()
    launch()
    first = if_mean.clone()
    for k in range(6):
        junk = [torch.full((n,), float(k + 1), device=cuda)
                for n in (64 * 150 * 4, 64 * 150 * 16, 81 * 4, 81)]
        launch()
        del junk
        assert torch.equal(if_mean, first), k


@pytest.mark.cuda
def test_chirp_smoother_kernel_refusals(cuda):
    """Non-contiguous inputs and mixed devices are refused, and a launch
    repeats its outputs bit for bit."""
    sgps = gauss_hermite(4, 3)
    ys = torch.tensor(0.1 * np.random.default_rng(5).standard_normal((9, 20)),
                      device=cuda)
    mfs, Lfs, _ = ghfs_chirp_filter(PARAMS, 0.1, 1e-3, sgps, ys)
    first = ghfs_chirp_smoother(PARAMS, 1e-3, sgps, mfs, Lfs, 10)
    for a, b in zip(first, ghfs_chirp_smoother(PARAMS, 1e-3, sgps, mfs, Lfs,
                                               10)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="contiguous"):
        ghfs_chirp_smoother(PARAMS, 1e-3, sgps, mfs.transpose(0, 1)
                            .contiguous().transpose(0, 1), Lfs, 10)
    with pytest.raises(ValueError, match="Lfs on"):
        ghfs_chirp_smoother(PARAMS, 1e-3, sgps, mfs, Lfs.cpu(), 10)


@pytest.mark.cuda
def test_estimate_if_batched_on_card_matches_cpu(cuda):
    ts = 1e-3 * np.arange(1, 129)
    ys = np.sin(2 * np.pi * 8.0 * ts)[None] + np.sqrt(0.1) * \
        np.random.default_rng(1).standard_normal((8, 128))
    params = torch.tensor(PARAMS, dtype=torch.float64)
    cfg = IFEstimationConfig()
    before = ghfs_chirp_filter.launches, ghfs_chirp_smoother.launches
    on_card = estimate_if_batched(cfg, params.to(cuda),
                                  torch.tensor(ys, device=cuda))
    assert (ghfs_chirp_filter.launches, ghfs_chirp_smoother.launches) == (
        before[0] + 1, before[1] + 1)
    on_cpu = estimate_if_batched(cfg, params, torch.tensor(ys))
    for key in ("if_mean", "nell", "mss", "Lss"):
        got, want = _np(on_card[key]), _np(on_cpu[key])
        if key == "Lss":   # up to its columns' signs (phase B's chunks)
            got = _signs_of(got, want)
        npt.assert_allclose(got, want, atol=1e-9, rtol=0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["sqrt", "cov"])
def test_vmapped_sweep_objective_on_card_matches_cpu(cuda, form):
    """The sweep's objective, one ``torch.func.vmap`` of value-and-grad
    over 4 lanes (float64, T=100 of seed 0 of each magnitude and seed 1
    of the first): card against host CPU, 1e-9 relative on the values and
    1e-7 relative to max |grad| on the gradients."""
    from chirpgp_tpu_torch.fit import batched_value_and_grad
    ys = np.stack([np.load(ROOT / f"results/data/toydata_{m}.npz")["ys"][i, :100]
                   for m, i in (("const", 0), ("damped", 0), ("random", 0),
                                ("const", 1))]).astype(np.float64)
    cfg = IFEstimationConfig(form=form)
    theta = cfg.default_init_theta(torch.float64).expand(4, 6) \
        + 0.05 * torch.arange(4.0, dtype=torch.float64)[:, None]
    out = {}
    for device in ("cpu", cuda):
        vg = batched_value_and_grad(
            lambda th, y: make_nll_fn(cfg, y)(th),
            (torch.tensor(ys, device=device),))
        values, grads = vg(theta.to(device))
        assert values.device == grads.device == torch.device(device)
        out[str(device)] = (_np(values), _np(grads))
    (v_cpu, g_cpu), (v_card, g_card) = out["cpu"], out[str(cuda)]
    npt.assert_allclose(v_card, v_cpu, rtol=1e-9, atol=0)
    npt.assert_allclose(g_card, g_cpu, rtol=0, atol=1e-7 * np.abs(g_cpu).max())


@pytest.mark.cuda
def test_sweep_on_measurements_runs_on_card(cuda):
    """The whole sweep with host NumPy data lands on the card by default:
    stepped L-BFGS there, the float64 polish on the host, the estimate
    there; every lane finite with ``success`` (float32, T=120, seed 0 of
    each magnitude, 8 iterations)."""
    from chirpgp_tpu_torch.apps import mle_sweep_on_measurements
    ys = np.stack([np.load(ROOT / f"results/data/toydata_{m}.npz")["ys"][0, :120]
                   for m in ("const", "damped", "random")])
    tf = np.load(ROOT / "results/data/toydata_const.npz")["true_freqs"][:120]
    res = mle_sweep_on_measurements(
        IFEstimationConfig(form="sqrt", max_iters=8), tf, ys)
    assert res["params"].shape == (3, 6)
    assert np.all(np.isfinite(res["rmse"])) and np.all(res["success"])


LASCALA = np.load(ROOT / "results/reference/lascala_ghfs_const.npz")["params"][0]


# Kernel against plain at the Table-I data's scale: max |d mfs| and max
# |d L L^T| over (1 + the plain version's largest), and the relative
# deviation of nll[-1] -- chip_smoke.py's FULL_BOUNDS.
SCALED_BOUNDS = {"float64": (1e-9, 1e-9, 1e-12),
                 "float32": (1e-4, 1e-4, 2e-5)}


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["gh3", "cubature"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lascala_through_the_kernel_matches_plain(cuda, rule, dtype):
    """La Scala (zero noise on the pair: zero pivots in the kernel's Lq)
    through the kernel at every team size, on 64 records of
    ``toydata_const`` (T=200) at the column's reference optimum, against
    the plain version, within ``SCALED_BOUNDS``."""
    sgps = RULES[rule]()
    data = np.load(ROOT / "results/data/toydata_const.npz")["ys"][:64, :200]
    ys = torch.tensor(data, dtype=getattr(torch, dtype), device=cuda)
    params = lascala_chirp_params(torch.tensor(LASCALA))
    mp, lp, np_ = [x.double() for x in
                   ghfs_chirp_filter_reference(params, 0.1, 1e-3, sgps, ys)]
    Pp = torch.einsum("tikb,tjkb->tijb", lp, lp)
    for team in (None,) + TEAMS:
        mk, lk, nk = [x.double() for x in ghfs_chirp_filter_kernel(
            params, 0.1, 1e-3, sgps, ys, team=team)]
        assert bool(torch.isfinite(mk).all() and torch.isfinite(lk).all())
        Pk = torch.einsum("tikb,tjkb->tijb", lk, lk)
        got = (float((mk - mp).abs().max() / (1 + mp.abs().max())),
               float((Pk - Pp).abs().max() / (1 + Pp.abs().max())),
               float(((nk[-1] - np_[-1]).abs() / np_[-1].abs()).max()))
        for val, bound in zip(got, SCALED_BOUNDS[dtype]):
            assert val <= bound, (team, got)


@pytest.mark.cuda
def test_lascala_estimate_if_batched_on_card_matches_cpu(cuda):
    """``estimate_if_batched(model="lascala")`` launches the kernel on the
    card and matches the plain version on the host (float64, B=8, T=128)."""
    ys = np.load(ROOT / "results/data/toydata_const.npz")["ys"][:8, :128] \
        .astype(np.float64)
    cfg = IFEstimationConfig(model="lascala")
    params = torch.tensor(LASCALA)
    before = ghfs_chirp_filter.launches, ghfs_chirp_smoother.launches
    on_card = estimate_if_batched(cfg, params.to(cuda),
                                  torch.tensor(ys, device=cuda))
    assert (ghfs_chirp_filter.launches, ghfs_chirp_smoother.launches) == (
        before[0] + 1, before[1] + 1)
    on_cpu = estimate_if_batched(cfg, params, torch.tensor(ys))
    for key in ("if_mean", "nell", "mss", "Lss"):
        got, want = _np(on_card[key]), _np(on_cpu[key])
        if key == "Lss":   # up to its columns' signs (phase B's chunks)
            got = _signs_of(got, want)
        npt.assert_allclose(got, want, atol=1e-9, rtol=0)


@pytest.mark.cuda
def test_family_objectives_on_card_match_cpu(cuda):
    """The harmonic CKFS sweep objective and the KPT objective (float64,
    T=100 of seed 0): value and gradient on the card against the host
    CPU, 1e-9 relative and 1e-7 of max |grad|."""
    from chirpgp_tpu_torch.apps import kpt_filter
    from chirpgp_tpu_torch.models import g
    h3 = np.load(ROOT / "results/data/toydata_h3_const.npz")["ys"][0, :100] \
        .astype(np.float64)
    cfg = IFEstimationConfig(method="ghfs", model="harmonic", num_harmonics=3,
                             quadrature="cubature", form="sqrt")
    objectives = {
        "harmonic_ckfs": (lambda th, y: make_nll_fn(cfg, y)(th),
                          cfg.default_init_theta(torch.float64)),
        "harmonic_kpt": (lambda th, y: kpt_filter(g(th), 1000.0, 0.1, y,
                                                  num_harmonics=3)[2][-1],
                         g_inv(torch.tensor([0.02, 1e-5, 1e-5, 8.0, 1.0],
                                            dtype=torch.float64)))}
    for name, (fn, theta0) in objectives.items():
        out = {}
        for device in ("cpu", cuda):
            th = theta0.to(device).requires_grad_(True)
            value = fn(th, torch.tensor(h3, device=device))
            grad, = torch.autograd.grad(value, th)
            out[str(device)] = (float(value.detach()), _np(grad))
        (v_cpu, g_cpu), (v_card, g_card) = out["cpu"], out[str(cuda)]
        npt.assert_allclose(v_card, v_cpu, rtol=1e-9, atol=0, err_msg=name)
        npt.assert_allclose(g_card, g_cpu, rtol=0,
                            atol=1e-7 * np.abs(g_cpu).max(), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cd_ghfs", "cd_ekfs"])
def test_cd_objective_and_estimate_on_card_match_cpu(cuda, method):
    """The continuous-discrete objective (float64, T=60 of seed 0, value
    and gradient: 1e-9 relative, 1e-7 of max |grad|) and its
    ``estimate_if`` IF mean (1e-9) on the card against the host CPU."""
    ys = np.load(ROOT / "results/data/toydata_const.npz")["ys"][0, :60] \
        .astype(np.float64)
    params = np.load(ROOT / f"results/reference/{method}_const.npz")[
        "params"][0]
    cfg = IFEstimationConfig(method=method)
    from chirpgp_tpu_torch.apps import estimate_if
    out = {}
    for device in ("cpu", cuda):
        th = g_inv(torch.tensor(params)).to(device).requires_grad_(True)
        value = make_nll_fn(cfg, torch.tensor(ys, device=device))(th)
        grad, = torch.autograd.grad(value, th)
        est = estimate_if(cfg, torch.tensor(params, device=device),
                          torch.tensor(ys, device=device))
        out[str(device)] = (float(value.detach()), _np(grad),
                            _np(est["if_mean"]))
    (v_cpu, g_cpu, if_cpu), (v_card, g_card, if_card) = \
        out["cpu"], out[str(cuda)]
    npt.assert_allclose(v_card, v_cpu, rtol=1e-9, atol=0)
    npt.assert_allclose(g_card, g_cpu, rtol=0, atol=1e-7 * np.abs(g_cpu).max())
    npt.assert_allclose(if_card, if_cpu, rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_classical_methods_on_card_match_cpu(cuda):
    """Hilbert, the spectrogram, the ANF and the batched polynomial LM on
    three float64 records (T=1000) on the card against the host CPU:
    1e-9 relative on each IF; the LM's params 1e-6 relative (its
    ill-conditioned degree-5 steps amplify the QR's rounding)."""
    from chirpgp_tpu_torch.baselines import (
        adaptive_notch_filter, butter_lowpass, hilbert_method,
        mean_power_spectrum, mle_polynomial_batched)
    from chirpgp_tpu_torch.toymodels import (
        constant_mag, gen_chirp, gen_chirp_envelope, meow_freq)
    T = 1000
    freq, phase = meow_freq(offset=8.0)
    noise = np.random.default_rng(3).standard_normal((3, T))
    fit = np.polynomial.Polynomial.fit(1e-3 * np.arange(1, T + 1),
                                       freq(torch.linspace(1e-3, 1.0, T,
                                            dtype=torch.float64)).numpy(), 5)
    init = np.concatenate([[1.0], fit.convert().coef])
    out = {}
    for device in ("cpu", cuda):
        ts = torch.linspace(1e-3, 1e-3 * T, T, dtype=torch.float64,
                            device=device)
        nz = 0.1 ** 0.5 * torch.tensor(noise, device=device)
        ys = gen_chirp(ts, constant_mag(1.0), phase) + nz
        env = gen_chirp_envelope(ts, constant_mag(1.0), phase) + nz
        yf = butter_lowpass(ys, 18.0, 1000.0)
        assert yf.device == ts.device
        mu = 0.015
        res = mle_polynomial_batched(
            ts, ys, 0.1, torch.tensor(init, device=device).expand(3, -1),
            max_iters=20)
        out[str(device)] = dict(
            hilbert=hilbert_method(ts, yf),
            spectrogram=mean_power_spectrum(ts, yf, nperseg=450,
                                            noverlap=449,
                                            window="cosine")[1],
            anf=adaptive_notch_filter(ts, env, 0.0, 8.0, 1.0 + 0.0j, mu,
                                      mu ** 3 / 8, mu ** 2 / 2)[0],
            poly=res.params)
    for key, x in out["cpu"].items():
        y = out[str(cuda)][key]
        assert y.is_cuda, key
        rtol = 1e-6 if key == "poly" else 1e-9
        npt.assert_allclose(_np(y), _np(x), rtol=rtol,
                            atol=rtol * float(x.abs().max()), err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_crlb_chunks_launch_the_kernel_once_each(cuda, dtype):
    """``filter_error_mc_chunked(backend="cf")`` on the card filters each
    chunk with one launch of the CUDA kernel (at model_chirp's prior mean)
    and agrees with the plain version on the host on the same normals:
    round-off in float64, 1e-3 of the largest statistic in float32."""
    from chirpgp_tpu_torch.apps import filter_error_mc_chunked
    T, n, chunk = 40, 100, 32
    gen = torch.Generator().manual_seed(5)
    z = {i: tuple(torch.randn(s, generator=gen, dtype=torch.float64)
                  for s in ((m, 4), (m, T, 4), (m, T)))
         for i, m in enumerate((32, 32, 32, 4))}
    args = (0.1, 0.1, 0.1, 1.0, 1.0, 0.1, n)
    kw = dict(T=T, chunk=chunk, dtype=getattr(torch, dtype),
              draws=lambda i, m: z[i])
    ghfs_chirp_filter.launches = 0
    card = filter_error_mc_chunked(*args, device=cuda, **kw)
    assert ghfs_chirp_filter.launches == 4
    host = filter_error_mc_chunked(*args, device="cpu", **kw)
    assert ghfs_chirp_filter.launches == 4
    tol = 1e-9 if dtype == "float64" else 1e-3
    for key, want in host.items():
        npt.assert_allclose(card[key], want, rtol=0,
                            atol=tol * np.abs(want).max(), err_msg=key)


@pytest.mark.cuda
def test_analysis_and_baselines_on_card_match_cpu(cuda):
    """The PCRLB, the FHC tracker and the Myotis bat pipeline on the card
    against the host CPU, float64: 1e-9 relative on the bound and the bat
    IF (a 12-sample call: the configuration amplifies round-off before the
    filter locks on), 1e-6 Hz on the FHC track."""
    from chirpgp_tpu_torch.apps import MYOTIS, analyze_bat_call, pcrlb_chirp_mc
    from chirpgp_tpu_torch.baselines import fhc_pitch_track_batch
    T = 30
    gen = torch.Generator().manual_seed(6)
    z = tuple(torch.randn(s, generator=gen, dtype=torch.float64)
              for s in ((200, 4), (200, T, 4), (200, T)))
    ys = np.load(ROOT / "results/data/toydata_h3_const.npz")["ys"][:2, :340]
    n = np.arange(1, 13) / 250e3
    call = np.sin(2 * np.pi * (80e3 * n - 2e8 * n ** 2)) \
        + 0.01 * np.random.default_rng(0).standard_normal(12)
    out = {}
    for device in ("cpu", cuda):
        pc = pcrlb_chirp_mc(0.1, 0.1, 0.1, 1.0, 1.0, 0.1, num_mcs=200, T=T,
                            dtype=torch.float64, device=device,
                            draws=lambda _i, _n: z)
        _, f0 = fhc_pitch_track_batch(ys.astype(np.float64), 1000.0, 3,
                                      device=device)
        bat, _ = analyze_bat_call(call, 250e3, MYOTIS, device=device)
        out[str(device)] = (pc["pcrlb_x2"], pc["pcrlb_v"], f0,
                            _np(bat["if_mean"]))
    for name, a, b, rtol, atol in zip(
            ("pcrlb_x2", "pcrlb_v", "fhc", "bat"), out["cpu"],
            out[str(cuda)], (1e-9, 1e-9, 0, 0), (0, 0, 1e-6, None)):
        if atol is None:
            atol = 1e-9 * np.abs(a).max()
        npt.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=name)


def _m32_inputs(device, dtype, T):
    from chirpgp_tpu_torch.models import m32_solution, stationary_cov_m32
    F, Sigma = m32_solution(1.0, 1.0, 1e-3)
    ys = np.load(ROOT / "results/data/parallel_kf_ref.npz")["ys_T3141"][:T]
    return [torch.as_tensor(x, dtype=dtype, device=device) for x in (
        F, Sigma, [1.0, 0.0], 0.1, [0.0, 0.0], stationary_cov_m32(1.0, 1.0),
        ys)]


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", [None, 128])
def test_parallel_kf_rts_on_card_matches_cpu(cuda, block_size):
    """The flat and blocked associative-scan KF/RTS on the card against the
    same call on the host CPU: float64 to 1e-10 of scale, float32 to 1e-3
    of scale (float32 is 2e-5 of scale from float64 on the host CPU; the
    two devices round the scans' sums differently)."""
    from chirpgp_tpu_torch.infer import kf_rts_parallel
    for dtype, rtol in ((torch.float64, 1e-10), (torch.float32, 1e-3)):
        outs = [kf_rts_parallel(*_m32_inputs(dev, dtype, 3141),
                                block_size=block_size)
                for dev in ("cpu", cuda)]
        for a, b in zip(*outs):
            assert b.device.type == "cuda" and b.dtype == dtype
            a = _np(a)
            npt.assert_allclose(_np(b), a, rtol=0,
                                atol=rtol * np.abs(a).max())


@pytest.mark.cuda
def test_smc_and_nuts_on_a_cuda_generator_run_finite(cuda):
    from chirpgp_tpu_torch.apps import IFEstimationConfig, smc_nll
    from chirpgp_tpu_torch.infer import nuts_sample
    gen = torch.Generator(device=cuda).manual_seed(0)
    ys = torch.as_tensor(np.load(ROOT / "results/data/toydata_const.npz")
                         ["ys"][0, :200], device=cuda)
    nll, res = smc_nll(IFEstimationConfig(), torch.tensor(PARAMS), ys, gen,
                       num_particles=512)
    assert res.means.device.type == "cuda"
    assert bool(torch.isfinite(nll)) and bool(torch.isfinite(res.means).all())
    prec = torch.tensor([[2.0, -0.5], [-0.5, 1.0]], device=cuda)
    out = nuts_sample(lambda q: -0.5 * q @ prec @ q,
                      torch.zeros(8, 2, device=cuda), gen, num_samples=20,
                      num_warmup=20, max_tree_depth=5)
    assert out.samples.shape == (8, 20, 2) and out.samples.device.type == "cuda"
    assert bool(torch.isfinite(out.samples).all())
    assert bool((out.accept_prob.mean() > 0.0))


@pytest.mark.cuda
def test_profile_device_counts_the_card_kernels(cuda):
    from chirpgp_tpu_torch.utils.timing import profile_device
    x = torch.ones(4, device=cuda)

    def fn():
        y = x
        for _ in range(50):
            y = y + 1.0
        return y

    fn()
    prof = profile_device(fn)
    assert prof.launches == 50 == len(prof.names) and prof.kernel_s > 0.0
    assert prof.wall_s > 0.0 and prof.profiled_wall_s > 0.0
    assert 0.0 < prof.busy


@pytest.mark.cuda
def test_sharded_paths_on_one_nccl_rank(cuda):
    """A one-rank NCCL process group: the mesh's collectives run on the
    card, and the sweep, the mean and the time-sharded KF/RTS equal their
    unsharded forms (tests/test_torch_sharded.py runs four gloo ranks)."""
    import socket
    import torch.distributed as dist
    from chirpgp_tpu_torch.infer import (
        kf_parallel, kf_parallel_time_sharded, rts_parallel,
        rts_parallel_time_sharded)
    from chirpgp_tpu_torch.models import m32_solution, stationary_cov_m32
    from chirpgp_tpu_torch.parallel import (
        make_mesh, sharded_mean, sharded_seed_sweep)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        assert mesh.group is not None and mesh.device == cuda
        x = torch.linspace(-1.0, 2.0, 8, dtype=torch.float64, device=cuda)
        npt.assert_array_equal(
            _np(sharded_seed_sweep(lambda k: {"a": k * k}, x, mesh)["a"]),
            _np(x * x))
        npt.assert_allclose(float(sharded_mean(torch.sin, x, mesh)),
                            float(torch.sin(x).mean()), rtol=1e-15)
        F, Sigma = (torch.as_tensor(a, device=cuda)
                    for a in m32_solution(0.7, 1.2, 0.01))
        H = torch.tensor([1.0, 0.0], dtype=torch.float64, device=cuda)
        m0 = torch.zeros(2, dtype=torch.float64, device=cuda)
        P0 = torch.as_tensor(stationary_cov_m32(0.7, 1.2), device=cuda)
        ys = torch.sin(0.1 * torch.arange(240, dtype=torch.float64,
                                          device=cuda))
        want = kf_parallel(F, Sigma, H, 0.05, m0, P0, ys)
        got = kf_parallel_time_sharded(F, Sigma, H, 0.05, m0, P0, ys, mesh)
        want += rts_parallel(F, Sigma, want[0], want[1])
        got += rts_parallel_time_sharded(F, Sigma, want[0], want[1], mesh)
        for g_, w_ in zip(got, want):
            assert g_.device.type == "cuda"
            npt.assert_allclose(_np(g_), _np(w_), rtol=1e-12, atol=1e-14)
    finally:
        dist.destroy_process_group()


# The fused filter+smoother's kernels (ops/chirp_fused.py) against their
# plain twins.  Bounds: max |d| over (1 + max |twin|), 1e-4 in float32 (the
# filter kernel's scaled bound at the benchmark's shape, chip_smoke.py
# FULL_BOUNDS) and 1e-9 in float64.  Factors and R22 are compared by their
# Grams: a row of R may change sign with the rounding of a near-zero pivot.
FUSED_SCALED = {"float32": 1e-4, "float64": 1e-9}
# (rule, B, T): one lane, the Table-I width, a block of 2 lanes (B=133 on
# 132 SMs), the benchmark's width and one lane more (a ragged last block),
# at T = 1 (the last filtered moments only) and 2, a short odd batch, and
# the benchmark's T=3141 with GH-3 at B=100 and 4097 (the twins' eager
# loops take ~25-35 s a case there; cubature is held at T=29 too, in
# test_fused_wrapper_matches_reference).
FUSED_CASES = [(rule, B, T) for rule in ("gh3", "cubature")
               for B in (1, 100, 133, 4096, 4097) for T in (1, 2)] + [
                   ("gh3", 3, 2), ("gh3", 100, 3141), ("gh3", 4097, 3141)]


def _scaled(a, b):
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max())) if a.size \
        else 0.0


def _fused_inputs(cuda, dtype, B, T, seed):
    ts = 1e-3 * np.arange(1, T + 1)
    ys = np.sin(2 * np.pi * 8.0 * ts)[None] + np.sqrt(0.1) * \
        np.random.default_rng(seed).standard_normal((B, T))
    return torch.tensor(ys, dtype=getattr(torch, dtype), device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("rule,B,T", FUSED_CASES)
@pytest.mark.parametrize("factors", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_kernels_match_twins(cuda, dtype, rule, factors, B, T):
    """Kernel F alone against its twin on the same measurements (maps: u,
    G, D; factors: m_p, X, R22 by its Gram, every filtered mean and factor
    by its Gram; the nll), then kernel G (full and slim) or the smoother's
    phase B on F's own rows against their twins."""
    bound = FUSED_SCALED[dtype]
    sgps = RULES[rule]()
    ys = _fused_inputs(cuda, dtype, B, T, B + T)
    like = dict(dtype=ys.dtype, device=cuda)
    kernels = FusedKernels(PARAMS, 0.1, 1e-3, sgps, ys.dtype, cuda)
    rows = torch.empty((T - 1, ROW_WORDS, B), **like)
    n = T if factors else 1
    mfs, lfs = torch.empty((n, 4, B), **like), torch.empty((n, 16, B), **like)
    nll = torch.empty((T, B), **like)
    before = dict(ghfs_chirp_filter_smoother.kernel_launches)
    kernels.forward(ys.T.contiguous(), rows, mfs, lfs, nll, factors)
    want = fused_forward_reference(PARAMS, 0.1, 1e-3, sgps, ys,
                                   factors=factors)
    got = [_np(x) for x in (rows, mfs, lfs.view(n, 4, 4, B), nll)]
    exp = [_np(x) for x in want]
    assert [g.shape for g in got] == [e.shape for e in exp]
    assert _scaled(got[0][:, :20], exp[0][:, :20]) <= bound
    if factors:
        assert _scaled(_upper_gram(got[0][:, 20:]),
                       _upper_gram(exp[0][:, 20:])) <= bound
    else:
        assert _scaled(got[0][:, 20:], exp[0][:, 20:]) <= bound
    assert _scaled(got[1], exp[1]) <= bound
    assert _scaled(_gram(got[2]), _gram(exp[2])) <= bound
    assert _scaled(got[3], exp[3]) <= bound

    if factors:
        mss, lss = torch.empty_like(mfs), torch.empty_like(lfs)
        kernels.rows_backward(mfs, lfs, rows, mss, lss)
        ms_t, Ls_t = smoother_backward_reference(mfs, lfs.view(T, 4, 4, B),
                                                 rows)
        assert _scaled(_np(mss), _np(ms_t)) <= bound
        assert _scaled(_gram(_np(lss.view(T, 4, 4, B))), _gram(_np(Ls_t))) \
            <= bound
        more = int(kernels.back.chunks(T, B) > 1)
        launched = {"fused_forward": 1, "smoother_compose": more,
                    "smoother_carry": more, "smoother_backward": 1}
    else:
        outs = {}
        for oi in (None, 2):
            shape = ((T, 4, B), (T, 16, B)) if oi is None else ((T, B),) * 2
            o_m, o_p = (torch.empty(sh, **like) for sh in shape)
            kernels.backward(rows, mfs, lfs, o_m, o_p, oi)
            w_m, w_p = affine_backward_reference(rows, mfs[0],
                                                 lfs[0].view(4, 4, B), oi)
            assert _scaled(_np(o_m), _np(w_m)) <= bound
            assert _scaled(_np(o_p.view(w_p.shape)), _np(w_p)) <= bound
            outs[oi] = (o_m, o_p.view(w_p.shape))
        # Slim is the full output's slices, bit for bit: the same carry.
        assert torch.equal(outs[2][0], outs[None][0][:, 2])
        assert torch.equal(outs[2][1], outs[None][1][:, 2, 2])
        launched = {"fused_forward": 1, "affine_backward": 2}
    assert ghfs_chirp_filter_smoother.kernel_launches == {
        k: v + launched.get(k, 0) for k, v in before.items()}


# (B, T): one lane, a ragged team warp, the Table-I width, the benchmark's
# width, at T = 1, 2, 3 and 64, and at T = 3141.
AFFINE_CASES = [(B, T) for B in (1, 33, 100, 4096) for T in (1, 2, 3, 64)] \
    + [(100, 3141), (4096, 3141)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", AFFINE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_affine_backward_team_matches_twin(cuda, dtype, B, T):
    """G (a team of four threads per lane) on F's maps against its twin,
    full and slim at every out_index, at ``affine_geometry``'s lanes per
    block and at 8 and 32: scaled 1e-4 (float32) or 1e-9 (float64); the
    slim output is the full output's slices and every geometry gives the
    same bits."""
    bound = FUSED_SCALED[dtype]
    ys = _fused_inputs(cuda, dtype, B, T, 3 * B + T)
    like = dict(dtype=ys.dtype, device=cuda)
    kernels = FusedKernels(PARAMS, 0.1, 1e-3, gauss_hermite(4, 3), ys.dtype,
                           cuda)
    rows, mf, lf, nll = _forward_outputs(ys, T, B, False)
    kernels.forward(ys.T.contiguous(), rows, mf, lf, nll, False)
    w_m, w_p = affine_backward_reference(rows, mf[0], lf[0].view(4, 4, B))
    full = torch.empty((T, 4, B), **like), torch.empty((T, 16, B), **like)
    kernels.backward(rows, mf, lf, *full)
    assert _scaled(_np(full[0]), _np(w_m)) <= bound
    assert _scaled(_np(full[1].view(T, 4, 4, B)), _np(w_p)) <= bound
    Pss = full[1].view(T, 4, 4, B)
    assert torch.equal(Pss, Pss.transpose(1, 2))
    for geo in (dict(), dict(lanes=8), dict(lanes=32)):
        for oi in (None, 0, 1, 2, 3):
            shape = ((T, 4, B), (T, 16, B)) if oi is None else ((T, B),) * 2
            o_m, o_p = (torch.empty(sh, **like) for sh in shape)
            kernels.backward(rows, mf, lf, o_m, o_p, oi, **geo)
            if oi is None:
                assert torch.equal(o_m, full[0]) and torch.equal(o_p, full[1])
            else:
                assert torch.equal(o_m, full[0][:, oi]), (geo, oi)
                assert torch.equal(o_p, Pss[:, oi, oi]), (geo, oi)


def _forward_outputs(ys, T, B, factors):
    like = dict(dtype=ys.dtype, device=ys.device)
    n = T if factors else 1
    return (torch.empty((T - 1, ROW_WORDS, B), **like),
            torch.empty((n, 4, B), **like), torch.empty((n, 16, B), **like),
            torch.empty((T, B), **like))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_forward_every_instance_matches_twin(cuda, dtype):
    """Every (team, groups per member) instance of F on GH-3 and cubature
    laid out for it (``fused_layout``), launched at ``fused_geometry``'s
    lanes for that team, against the twin on the rule as it is, maps and
    factors (B=37, T=6)."""
    bound = FUSED_SCALED[dtype]
    B, T = 37, 6
    ys = _fused_inputs(cuda, dtype, B, T, 12)
    suffix = "f32" if dtype == "float32" else "f64"
    for rule in ("gh3", "cubature"):
        sgps = RULES[rule]()
        n_groups = len(chirp_fused.group_points(sgps))
        kernels = FusedKernels(PARAMS, 0.1, 1e-3, sgps, ys.dtype, cuda)
        for team, per_member in chirp_fused.GROUPS.items():
            for groups in per_member:
                if team * groups < n_groups:
                    continue
                layout = chirp_fused.fused_layout(sgps, team, groups)
                w = np.asarray(layout.w, np.float64)
                xi, w, sw = (torch.as_tensor(a, dtype=ys.dtype, device=cuda)
                             for a in (np.ascontiguousarray(layout.xi), w,
                                       np.sqrt(w)))
                lanes = chirp_fused.fused_geometry(B, n_groups,
                                                   team=team).lanes_per_block
                for factors in (False, True):
                    rows, mfs, lfs, nll = _forward_outputs(ys, T, B, factors)
                    rc = getattr(kernels.lib, f"fused_forward_{suffix}")(
                        ys.T.contiguous().data_ptr(), xi.data_ptr(),
                        w.data_ptr(), sw.data_ptr(), kernels.consts,
                        layout.n_points, T, B, team, groups, lanes,
                        int(factors), rows.data_ptr(), mfs.data_ptr(),
                        lfs.data_ptr(), nll.data_ptr(),
                        torch.cuda.current_stream(cuda).cuda_stream)
                    assert rc == 0, (rule, team, groups)
                    torch.cuda.synchronize()
                    want = fused_forward_reference(PARAMS, 0.1, 1e-3, sgps,
                                                   ys, factors=factors)
                    case = (rule, team, groups, factors)
                    assert _scaled(_np(rows[:, :20]),
                                   _np(want.rows[:, :20])) <= bound, case
                    got_22, want_22 = _np(rows[:, 20:]), _np(want.rows[:, 20:])
                    if factors:
                        got_22, want_22 = (_upper_gram(x) for x in
                                           (got_22, want_22))
                    assert _scaled(got_22, want_22) <= bound, case
                    n = T if factors else 1
                    assert _scaled(_np(mfs), _np(want.mfs)) <= bound, case
                    assert _scaled(_gram(_np(lfs.view(n, 4, 4, B))),
                                   _gram(_np(want.Lfs))) <= bound, case
                    assert _scaled(_np(nll), _np(want.nll)) <= bound, case


@pytest.mark.cuda
@pytest.mark.parametrize("B", [5, 4096])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_forward_runs_a_rule_of_single_point_groups(cuda, dtype, B):
    """GH-3 turned in the plane of its last two axes: no two points share
    xi[0..2], so F takes 81 groups of one point, a team of 32 with 3 groups
    per member whatever B.  Such a rule is not symmetric under the sign of
    a factor's column, and round-off picks those signs (the Householders'
    pivots), so its filter is defined only to that: the twin itself moves
    by ~2e-7 of scale when two of its points swap places.  F is held to
    the twin within the float32 bound, 1e-4 of scale, in both dtypes, and
    its nll within FUSED_SCALED (the nll hardly feels the signs)."""
    c, s = np.cos(0.6), np.sin(0.6)
    rot = np.eye(4)
    rot[2:, 2:] = [[c, -s], [s, c]]
    gh = gauss_hermite(4, 3)
    sgps = gh._replace(xi=np.asarray(gh.xi) @ rot.T)
    assert len(chirp_fused.group_points(sgps)) == 81
    geo = chirp_fused.fused_geometry(B, 81)
    assert (geo.team, geo.groups) == (32, 3)
    T = 5
    ys = _fused_inputs(cuda, dtype, B, T, 11)
    kernels = FusedKernels(PARAMS, 0.1, 1e-3, sgps, ys.dtype, cuda)
    for factors in (False, True):
        rows, mfs, lfs, nll = _forward_outputs(ys, T, B, factors)
        kernels.forward(ys.T.contiguous(), rows, mfs, lfs, nll, factors)
        want = fused_forward_reference(PARAMS, 0.1, 1e-3, sgps, ys,
                                       factors=factors)
        n = T if factors else 1
        for got, exp in ((rows[:, :20], want.rows[:, :20]), (mfs, want.mfs)):
            assert bool(torch.isfinite(got).all())
            assert _scaled(_np(got), _np(exp)) <= 1e-4
        assert _scaled(_gram(_np(lfs.view(n, 4, 4, B))),
                       _gram(_np(want.Lfs))) <= 1e-4
        assert _scaled(_np(nll), _np(want.nll)) <= FUSED_SCALED[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rule", ["gh3", "cubature"])
def test_fused_wrapper_matches_reference(cuda, rule, dtype):
    """The wrapper on CUDA tensors in its three modes against its plain
    version (B=37, T=29), one launch each; the factor mode's rows against
    phase A's kernel on F's filtered moments (m_p and X, R22 by its Gram);
    La Scala through ``lascala_chirp_params``."""
    bound = FUSED_SCALED[dtype]
    sgps = RULES[rule]()
    ys = _fused_inputs(cuda, dtype, 37, 29, 5)
    for params in (PARAMS, lascala_chirp_params(torch.tensor(PARAMS[2:]))):
        for mode in (dict(), dict(return_factors=False),
                     dict(return_factors=False, out_index=2)):
            before = ghfs_chirp_filter_smoother.launches
            got = ghfs_chirp_filter_smoother(params, 0.1, 1e-3, sgps, ys,
                                             **mode)
            assert ghfs_chirp_filter_smoother.launches == before + 1
            want = ghfs_chirp_filter_smoother_reference(params, 0.1, 1e-3,
                                                        sgps, ys, **mode)
            for i, (g, w) in enumerate(zip(got, want)):
                assert g.shape == w.shape and g.dtype == ys.dtype
                assert g.device == ys.device
                g, w = _np(g), _np(w)
                if not mode and i == 1:
                    g, w = _gram(g), _gram(w)
                assert _scaled(g, w) <= bound, (mode, i)
    kernels = FusedKernels(PARAMS, 0.1, 1e-3, sgps, ys.dtype, cuda)
    like = dict(dtype=ys.dtype, device=cuda)
    rows = torch.empty((28, ROW_WORDS, 37), **like)
    mfs, lfs = torch.empty((29, 4, 37), **like), torch.empty((29, 16, 37),
                                                             **like)
    kernels.forward(ys.T.contiguous(), rows, mfs, lfs,
                    torch.empty((29, 37), **like), True)
    rows_a = torch.empty_like(rows)
    SmootherKernels(PARAMS, 1e-3, sgps, 10, ys.dtype, cuda).rows(
        mfs, lfs.view(29, 4, 4, 37), rows_a)
    assert _scaled(_np(rows[:, :20]), _np(rows_a[:, :20])) <= bound
    assert _scaled(_upper_gram(_np(rows[:, 20:])),
                   _upper_gram(_np(rows_a[:, 20:]))) <= bound


@pytest.mark.cuda
def test_fused_wrapper_raises_when_the_kernel_cannot_load(cuda, monkeypatch):
    """A CUDA tensor never reaches the plain version: with the loader made
    to fail, the wrapper raises, and the plain twins are not called."""
    def fail():
        raise RuntimeError("nvcc failed (made to fail)")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(chirp_fused, "load_fused_kernel", fail)
    monkeypatch.setattr(chirp_fused, "ghfs_chirp_filter_smoother_reference",
                        plain)
    monkeypatch.setattr(chirp_fused, "fused_forward_reference", plain)
    ys = _fused_inputs(cuda, "float32", 4, 8, 1)
    before = ghfs_chirp_filter_smoother.launches
    with pytest.raises(RuntimeError, match="made to fail"):
        ghfs_chirp_filter_smoother(PARAMS, 0.1, 1e-3, gauss_hermite(4, 3), ys,
                                   return_factors=False, out_index=2)
    assert ghfs_chirp_filter_smoother.launches == before


@pytest.mark.cuda
def test_fused_launch_keeps_its_tensors(cuda):
    """A bare ``launch`` whose caller keeps only the slim outputs writes the
    same bits at every repeat, other tensors taking the freed memory."""
    import gc
    ys = _fused_inputs(cuda, "float32", 64, 150, 6)
    launch, (vm, vv, nll) = fused_kernel_launcher(
        PARAMS, 0.1, 1e-3, gauss_hermite(4, 3), ys, return_factors=False,
        out_index=2)
    gc.collect()
    launch()
    first = [x.clone() for x in (vm, vv, nll)]
    for k in range(4):
        junk = [torch.full((n,), float(k + 1), device=cuda)
                for n in (149 * ROW_WORDS * 64, 150 * 64, 81 * 4)]
        launch()
        del junk
        assert all(torch.equal(a, b) for a, b in zip((vm, vv, nll), first))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gaussian_expectation_g_matches_plain(cuda, dtype):
    """Phase E's second input mode against its plain version, a variance
    below 0 clamped to 0 as bench.py's pipeline clamps it; one launch."""
    rng = np.random.default_rng(8)
    vm = torch.tensor(rng.normal(7.0, 1.0, (33, 70)),
                      dtype=getattr(torch, dtype), device=cuda)
    vv = torch.tensor(rng.uniform(-1e-6, 0.5, (33, 70)),
                      dtype=getattr(torch, dtype), device=cuda)
    before = gaussian_expectation_g.launches
    got = gaussian_expectation_g(vm, vv, 10)
    assert gaussian_expectation_g.launches == before + 1
    want = gaussian_expectation_g(vm.cpu(), vv.cpu(), 10)
    assert gaussian_expectation_g.launches == before + 1
    assert got.shape == (33, 70) and got.dtype == vm.dtype
    assert _scaled(_np(got), _np(want)) <= FUSED_SCALED[dtype] * 1e-1


# Phase E's inputs: the mean from -40 to 40 against variances 0, 1e-12 and
# 4 (and, in the variance mode, below 0: clamped), then NaN and +-inf in
# either input, cycled over (T, B) with T >= 3.
_E_MEANS = np.linspace(-40.0, 40.0, 33)
_E_SPECIAL = [(np.nan, 1.0), (np.inf, 1.0), (-np.inf, 4.0), (5.0, np.nan),
              (1.0, np.inf), (np.inf, np.inf), (-np.inf, np.inf),
              (np.nan, np.nan)]


def _expect_inputs(mode, B):
    vars_ = (0.0, 1e-12, 4.0) + ((-1e-3, -4.0, -np.inf) if mode == "var"
                                 else ())
    m, v = np.meshgrid(_E_MEANS, np.asarray(vars_), indexing="ij")
    m = np.concatenate([m.ravel(), [p[0] for p in _E_SPECIAL]])
    v = np.concatenate([v.ravel(), [p[1] for p in _E_SPECIAL]])
    T = max(3, -(-m.size // B))
    return np.resize(m, (T, B)), np.resize(v, (T, B))


def _assert_expect_within(got, twin):
    """Phase E's kernel against its float64 pair-form twin on the same
    inputs: NaN where the twin has NaN, the same infinities; finite
    values within 1e-12 relative (float64) or 2e-6 max(1, |E|)
    (float32: ex2 and lg2 on the special-function unit)."""
    g, w = _np(got).astype(np.float64), _np(twin)
    npt.assert_array_equal(np.isnan(g), np.isnan(w))
    inf = np.isinf(w)
    npt.assert_array_equal(g[inf], w[inf])
    fin = np.isfinite(w)
    err = np.abs(g[fin] - w[fin])
    allow = (1e-12 * np.abs(w[fin]) if got.dtype == torch.float64
             else 2e-6 * np.maximum(1.0, np.abs(w[fin])))
    assert (err <= allow).all(), float((err / np.maximum(allow, 1e-300)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 4, 10, 11, 32])
@pytest.mark.parametrize("B", [1, 33, 100, 4096])
@pytest.mark.parametrize("mode", ["mss", "var"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_expect_kernels_match_pair_twin(cuda, dtype, mode, B, order):
    """Phase E in either input mode (``smoother_expect`` through
    ``SmootherKernels.expect``, ``smoother_expect_var`` through
    ``gaussian_expectation_g``) against its pair-form twin in float64 on
    the same inputs, at ragged and whole widths (the scalar edge and the
    16-byte path), the main path's unrolled order 10 and the loop's
    others; one launch per call."""
    tdt = getattr(torch, dtype)
    m, var = _expect_inputs(mode, B)
    T = m.shape[0]
    if mode == "mss":
        sd = np.sqrt(var)
        lss = np.random.default_rng(B).standard_normal((T, 16, B))
        lss[:, 8], lss[:, 9], lss[:, 10] = 0.6 * sd, -0.48 * sd, 0.64 * sd
        mss = np.random.default_rng(B + 1).standard_normal((T, 4, B))
        mss[:, 2] = m
        mss, lss = (torch.tensor(x, dtype=tdt, device=cuda) for x in (mss, lss))
        kernels = SmootherKernels(PARAMS, 1e-3, gauss_hermite(4, 3), order,
                                  tdt, cuda)
        got = mss.new_full((T, B), -7.0)
        before = dict(ghfs_chirp_smoother.kernel_launches)
        kernels.expect(mss, lss, got)
        torch.cuda.synchronize()
        before["smoother_expect"] += 1
        assert ghfs_chirp_smoother.kernel_launches == before
        twin = smoother_expect_reference(mss.double(),
                                         lss.double().view(T, 4, 4, B), order)
    else:
        vm, vv = (torch.tensor(x, dtype=tdt, device=cuda) for x in (m, var))
        before = gaussian_expectation_g.launches
        got = gaussian_expectation_g(vm, vv, order)
        torch.cuda.synchronize()
        assert gaussian_expectation_g.launches == before + 1
        twin = smoother_expect_var_reference(vm.double(), vv.double(), order)
    assert got.shape == (T, B) and got.dtype == tdt
    assert torch.isnan(got).any()
    _assert_expect_within(got, twin)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_expect_var_kernel_takes_unaligned_tensors(cuda, dtype):
    """Tensors that start 4 or 8 bytes past a 16-byte boundary take the
    scalar edge where B alone would allow the 16-byte path, with the same
    values."""
    tdt = getattr(torch, dtype)
    m, var = _expect_inputs("var", 4096)
    T, B = m.shape
    vm, vv = (torch.tensor(x, dtype=tdt, device=cuda) for x in (m, var))
    aligned = gaussian_expectation_g(vm, vv, 10)
    bufs = [torch.empty(T * B + 1, dtype=tdt, device=cuda) for _ in range(2)]
    for buf, x in zip(bufs, (vm, vv)):
        buf[1:].view(T, B).copy_(x)
    shifted = gaussian_expectation_g(bufs[0][1:].view(T, B),
                                     bufs[1][1:].view(T, B), 10)
    assert bufs[0][1:].data_ptr() % 16 != 0
    assert torch.equal(torch.isnan(shifted), torch.isnan(aligned))
    ok = ~torch.isnan(aligned)
    assert torch.equal(shifted[ok], aligned[ok])


def _lane_deviation(got, want):
    """The largest over lanes of max |got - want| over the lane's max
    |want| (rows are lanes)."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float((np.abs(g - w).max(axis=1) / np.abs(w).max(axis=1)).max())


def _theta_grads(cfg, theta):
    """``dconsts (B, 43) -> (B, 6)``: adjoints of the lanes' constants
    carried to their thetas through ``chirp_lane_constants`` in float64."""
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter_grad import chirp_lane_constants
    th = theta.double().requires_grad_(True)
    consts = torch.func.vmap(lambda p: chirp_lane_constants(
        p, cfg.Xi, cfg.dt))(g(th))

    def to_theta(dconsts):
        grad, = torch.autograd.grad(consts, th, dconsts.double(),
                                    retain_graph=True)
        return grad

    return to_theta


def _lane_inputs(device, dtype, quad, B, T):
    """Per-lane constants (B, 43) at thetas spread around the default
    init, and B of the Table-I records cut to T (repeated past their 300),
    on ``device``."""
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter_grad import chirp_lane_constants
    cfg = IFEstimationConfig(method="ghfs", form="sqrt", quadrature=quad)
    data = np.resize(np.concatenate(
        [np.load(ROOT / f"results/data/toydata_{m}.npz")["ys"][:, :T]
         for m in ("const", "damped", "random")]), (B, T))
    theta = cfg.default_init_theta(torch.float64) + 0.1 * torch.tensor(
        np.random.default_rng(B).standard_normal((B, 6)))
    consts = torch.func.vmap(lambda p: chirp_lane_constants(
        p, cfg.Xi, cfg.dt))(g(theta))
    return (cfg, theta.to(device, dtype), consts.to(device, dtype),
            torch.as_tensor(data, dtype=dtype, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 300])
@pytest.mark.parametrize("quad", ["gauss_hermite", "cubature"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_filter_grad_kernels_match_plain(cuda, dtype, quad, B):
    """The per-lane forward and the adjoint kernel, each launched once
    (counted), against their plain versions on the same inputs on the
    card, T=300: float64 nll 1e-12 relative, means and L L^T 1e-9, the
    adjoint within 1e-9 of each lane's max |adjoint|; float32 against the
    float64 kernel (the on-card oracle), the adjoint carried to theta, no
    further over the lanes than twice the float32 plain versions are,
    plus 1e-5 of each lane's max |grad|, the nll within 2e-5."""
    from chirpgp_tpu_torch.ops.chirp_filter_grad import (
        ChirpFilterNLL, adjoint_launcher, filter_nll_adjoint_reference,
        filter_nll_reference, forward_launcher)
    tdt = getattr(torch, dtype)
    T = 300
    cfg, theta, consts, ys = _lane_inputs(cuda, tdt, quad, B, T)
    sgps = cfg.sigma_points()
    gbar = torch.linspace(0.5, 1.5, B, dtype=tdt, device=cuda)

    def kernels(c, y, gb):
        before = dict(ChirpFilterNLL.launches)
        launch, (mfs, lfs, nll) = forward_launcher(c, sgps, y)
        launch()
        alaunch, dconsts = adjoint_launcher(c, sgps, y, mfs, lfs, gb)
        alaunch()
        torch.cuda.synchronize()
        assert ChirpFilterNLL.launches == {
            "forward": before["forward"] + 1, "adjoint": before["adjoint"] + 1}
        return mfs, lfs, nll, dconsts

    mfs, lfs, nll, dconsts = kernels(consts, ys, gbar)
    pm, pl, pn = filter_nll_reference(consts, sgps, ys)
    pd = filter_nll_adjoint_reference(consts, sgps, ys, pm, pl, gbar)
    assert bool(torch.isfinite(dconsts).all())
    if dtype == "float64":
        npt.assert_allclose(_np(nll), _np(pn), rtol=1e-12, atol=0)
        npt.assert_allclose(_np(mfs), _np(pm), rtol=0, atol=1e-9)
        npt.assert_allclose(_gram(_np(lfs.view(T, 4, 4, B))),
                            _gram(_np(pl.view(T, 4, 4, B))), rtol=0, atol=1e-9)
        dev = _lane_deviation(dconsts, pd)
        assert dev <= 1e-9, dev
        return
    _, _, n64, d64 = kernels(consts.double(), ys.double(), gbar.double())
    npt.assert_allclose(_np(nll), _np(n64), rtol=2e-5, atol=0)
    # Through the constants to theta, what the sweep's gradient is: dt and
    # sqrt(Xi) have adjoints but are no functions of theta.
    to_theta = _theta_grads(cfg, theta)
    kern = _lane_deviation(to_theta(dconsts), to_theta(d64))
    plain = _lane_deviation(to_theta(pd), to_theta(d64))
    assert kern <= 2.0 * plain + 1e-5, (kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("quad", ["gauss_hermite", "cubature"])
def test_sweep_objective_takes_the_kernels(cuda, quad):
    """``make_nll_fn``'s route under ``batched_value_and_grad`` on the card:
    one forward and one adjoint launch per evaluation of all lanes, the
    values and gradients of the host CPU's plain versions (float64, B=33,
    T=200; 1e-12 relative, 1e-9 of max |grad|); a NaN lane (delta = 0)
    leaves the others' bits and raises nothing."""
    from chirpgp_tpu_torch.fit import batched_value_and_grad
    from chirpgp_tpu_torch.ops.chirp_filter_grad import ChirpFilterNLL
    cfg, theta, _, ys = _lane_inputs(cuda, torch.float64, quad, 33, 200)
    out = {}
    for device in ("cpu", cuda):
        vg = batched_value_and_grad(lambda th, y: make_nll_fn(cfg, y)(th),
                                    (ys.to(device),))
        before = dict(ChirpFilterNLL.launches)
        values, grads = vg(theta.to(device))
        launched = {k: ChirpFilterNLL.launches[k] - before[k]
                    for k in before}
        assert launched == ({"forward": 0, "adjoint": 0} if device == "cpu"
                            else {"forward": 1, "adjoint": 1})
        out[str(device)] = (_np(values), _np(grads))
    (v_cpu, g_cpu), (v_card, g_card) = out["cpu"], out[str(cuda)]
    npt.assert_allclose(v_card, v_cpu, rtol=1e-12, atol=0)
    npt.assert_allclose(g_card, g_cpu, rtol=0, atol=1e-9 * np.abs(g_cpu).max())
    bad = theta.clone()
    bad[1, 2] = -800.0
    vb, gb = batched_value_and_grad(lambda th, y: make_nll_fn(cfg, y)(th),
                                    (ys,))(bad)
    assert bool(torch.isnan(vb[1])) and bool(torch.isnan(gb[1]).all())
    for i in (0, 2):
        assert float(vb[i]) == float(v_card[i])
        npt.assert_array_equal(_np(gb[i]), g_card[i])


@pytest.mark.cuda
def test_per_lane_filter_at_one_theta_is_the_filter(cuda):
    """Every lane at the same constants: the per-lane forward's means,
    factors and final nll equal the one-theta kernel's bit for bit on the
    float64 host constants cast to the lanes' dtype (float64)."""
    from chirpgp_tpu_torch.ops.chirp_filter import _chirp_constants
    from chirpgp_tpu_torch.ops.chirp_filter_grad import forward_launcher
    ys = torch.as_tensor(np.load(ROOT / "results/data/toydata_const.npz")
                         ["ys"][:40, :300], dtype=torch.float64, device=cuda)
    rule = gauss_hermite(4, 3)
    consts = torch.as_tensor(_chirp_constants(PARAMS, 0.1, 1e-3),
                             device=cuda).expand(40, -1).contiguous()
    launch, (mfs, lfs, nll) = forward_launcher(consts, rule, ys)
    launch()
    m1, l1, n1 = ghfs_chirp_filter_kernel(PARAMS, 0.1, 1e-3, rule, ys)
    torch.cuda.synchronize()
    assert torch.equal(mfs, m1) and torch.equal(lfs.view(300, 4, 4, 40), l1)
    assert torch.equal(nll, n1[-1])


def _adjoint_vs_plain(cuda, dtype, quad, B, T, geometry=None, nan_lane=None):
    """The adjoint kernel in ``geometry`` (default: the wrapper's) and its
    plain version on the same inputs (the per-lane forward kernel's means
    and factors, gbar from 0.5 to 1.5), lane ``nan_lane`` at delta = 0
    (L0 NaN).  Returns (cfg, theta, kernel dconsts, plain dconsts)."""
    from chirpgp_tpu_torch.ops.chirp_filter_grad import (
        ChirpFilterNLL, adjoint_launcher, filter_nll_adjoint_reference,
        forward_launcher)
    tdt = getattr(torch, dtype)
    cfg, theta, consts, ys = _lane_inputs(cuda, tdt, quad, B, T)
    if nan_lane is not None:
        consts[nan_lane, 20] = float("nan")
    sgps = cfg.sigma_points()
    launch, (mfs, lfs, _) = forward_launcher(consts, sgps, ys)
    launch()
    gbar = torch.linspace(0.5, 1.5, B, dtype=tdt, device=cuda)
    before = ChirpFilterNLL.launches["adjoint"]
    alaunch, dconsts = adjoint_launcher(consts, sgps, ys, mfs, lfs, gbar,
                                        geometry)
    alaunch()
    torch.cuda.synchronize()
    assert ChirpFilterNLL.launches["adjoint"] == before + 1
    plain = filter_nll_adjoint_reference(consts, sgps, ys, mfs, lfs, gbar)
    return cfg, theta, dconsts, plain


def _assert_adjoint_within(cuda, dtype, quad, B, T, cfg, theta, dconsts,
                           plain):
    """7a's tolerances: float64 within 1e-9 of each lane's max |adjoint|
    of the plain version; float32, carried to theta, no further from the
    float64 kernel's (the wrapper's geometry, the on-card oracle) than
    twice the float32 plain version is, plus 1e-5 of each lane's max
    |grad|."""
    assert bool(torch.isfinite(dconsts).all())
    if dtype == "float64":
        dev = _lane_deviation(dconsts, plain)
        assert dev <= 1e-9, dev
        return
    _, _, d64, _ = _adjoint_vs_plain(cuda, "float64", quad, B, T)
    to_theta = _theta_grads(cfg, theta)
    kern = _lane_deviation(to_theta(dconsts), to_theta(d64))
    ref = _lane_deviation(to_theta(plain), to_theta(d64))
    assert kern <= 2.0 * ref + 1e-5, (kern, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 785])
@pytest.mark.parametrize("B", [1, 33, 300, 1000, 4096])
@pytest.mark.parametrize("quad", ["gauss_hermite", "cubature"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_adjoint_kernel_matches_plain(cuda, dtype, quad, B, T):
    """The adjoint kernel in the geometry its wrapper picks (the chain
    design up to B=396, the team of 32 at B=1000, the team of 8 at
    B=4096) against its plain version on the same inputs, gbar != 1, at
    7a's tolerances."""
    cfg, theta, dconsts, plain = _adjoint_vs_plain(cuda, dtype, quad, B, T)
    _assert_adjoint_within(cuda, dtype, quad, B, T, cfg, theta, dconsts,
                           plain)


def _every_geometry(B, S, dtype):
    """Every geometry the wrapper can be asked for at B lanes of S points:
    the chain design at each producer count it is built for, with the
    smallest and the largest ring, one lane a block and the most (the
    last block part empty), and the team design with each team."""
    from chirpgp_tpu_torch.ops.chirp_filter_grad import (
        CHAIN_MAX_LANES, CHAIN_MAX_RING, CHAIN_PRODUCERS, adjoint_geometry)
    geos = []
    for rows, K in CHAIN_PRODUCERS:
        if 32 * rows >= S and (rows == 1 or S > 32):
            g = adjoint_geometry(B, S, 132, dtype, design="chain",
                                 producers=K)
            geos += [g._replace(ring=K), g._replace(ring=CHAIN_MAX_RING),
                     g._replace(ring=CHAIN_MAX_RING,
                                lanes_per_block=CHAIN_MAX_LANES,
                                blocks=-(-B // CHAIN_MAX_LANES))]
    return geos + [adjoint_geometry(B, S, 132, dtype, design="team",
                                    team=team) for team in (8, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("quad", ["gauss_hermite", "cubature"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_adjoint_every_geometry_matches_plain(cuda, dtype, quad):
    """Each geometry the wrapper can pick (chain: each producer count, the
    ring at its least and at CHAIN_MAX_RING, 1 and 3 lanes a block; the
    teams of 8 and 32), B=33,
    T=200, against the plain version at 7a's tolerances; an unbuilt
    geometry raises."""
    from chirpgp_tpu_torch.ops.chirp_filter_grad import adjoint_launcher
    B, T = 33, 200
    S = IFEstimationConfig(quadrature=quad).sigma_points().n_points
    geos = _every_geometry(B, S, getattr(torch, dtype))
    assert {g.design for g in geos} == {"chain", "team"}
    for geo in geos:
        cfg, theta, dconsts, plain = _adjoint_vs_plain(cuda, dtype, quad, B,
                                                       T, geo)
        _assert_adjoint_within(cuda, dtype, quad, B, T, cfg, theta, dconsts,
                               plain)
    cfg, _, consts, ys = _lane_inputs(cuda, getattr(torch, dtype), quad, B, T)
    zeros = torch.zeros((T, 4, B), dtype=ys.dtype, device=cuda)
    bad = geos[0]._replace(ring=geos[0].producers - 1)
    launch, _ = adjoint_launcher(consts, cfg.sigma_points(), ys, zeros,
                                 torch.zeros((T, 16, B), dtype=ys.dtype,
                                             device=cuda),
                                 torch.ones(B, dtype=ys.dtype, device=cuda),
                                 bad)
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch()


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["chain", "team", "team32"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_adjoint_nan_lane_leaves_the_others_bit_equal(cuda, dtype, design):
    """One lane with a NaN L0 (a singular P0): its adjoint is NaN, and the
    other lanes keep the bits they have beside a finite lane, in each
    design (``team`` the team of 8; B=33, T=200, GH-3)."""
    from chirpgp_tpu_torch.ops.chirp_filter_grad import adjoint_geometry
    B, T = 33, 200
    geo = adjoint_geometry(B, 81, 132, getattr(torch, dtype),
                           design="team" if design.startswith("team")
                           else design,
                           team={"team": 8, "team32": 32}.get(design))
    _, _, clean, _ = _adjoint_vs_plain(cuda, dtype, "gauss_hermite", B, T,
                                       geo)
    _, _, dirty, _ = _adjoint_vs_plain(cuda, dtype, "gauss_hermite", B, T,
                                       geo, nan_lane=5)
    assert bool(torch.isnan(dirty[5]).any())
    others = torch.arange(B, device=cuda) != 5
    assert torch.equal(dirty[others], clean[others])
