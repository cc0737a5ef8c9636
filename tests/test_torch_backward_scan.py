"""The two backward recursions of the port's main path as they run on the
card, on the CPU: phase B's chunked square-root scan over time (the plain
twins of Compose, Carry and Apply, ``ops/chirp_smoother.py``) against the
JAX package's ``sqrt_sgp_smoother_batched`` and
``sqrt_sgp_filter_smoother_batched`` (factor branch) and against the
sequential twin, bit for bit at one chunk; the chunk count and G's launch
geometry (``ops/chirp_fused.py::affine_geometry``); the chunked scan's
work counts; and the constants the kernels' sources share with their
wrappers.  The CUDA kernels themselves are tested on a card by
tests/test_torch_cuda.py.

Tolerances: float64 1e-9 on means and Grams; float32 the smoother tests'
levels, 5e-5 on means and 1e-4 on Grams.  Factors are compared by their
Grams: a row of a triangular factor may change sign with the rounding of
a near-zero pivot."""

import functools
import re

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.models as jm
import chirpgp_tpu.quad as jq
import chirpgp_tpu_torch.quad as tq
from chirpgp_tpu.infer.batched import (
    sqrt_sgp_filter_smoother_batched as jax_fused,
    sqrt_sgp_smoother_batched as jax_smoother)
from chirpgp_tpu_torch.ops import _build
from chirpgp_tpu_torch.ops.chirp_filter import (
    ghfs_chirp_filter_reference, lascala_chirp_params)
from chirpgp_tpu_torch.ops.chirp_fused import (
    BACK_LANES, BACK_STAGES, BACK_TEAM, AffineGeometry, affine_geometry,
    fused_forward_reference)
from chirpgp_tpu_torch.ops.chirp_smoother import (
    BACK_WARPS_PER_SM, BACKWARD_KERNELS, CARRY_STEP_WEIGHT, CARRY_WORDS,
    KERNELS, STEP_WORDS,
    backward_chunks, chunk_starts, smoother_apply_reference,
    smoother_backward_chunked_reference, smoother_backward_reference,
    smoother_carry_reference, smoother_compose_reference, smoother_cost,
    smoother_phase_costs, smoother_rows_reference)

torch.set_num_threads(1)

PARAMS = (0.1, 0.1, 0.1, 1.0, 1.0, 7.0)
LASCALA = (0.1, 1.0, 1.0, 7.0)
DT, XI, B = 1e-3, 0.1, 5
TOLS = {"float64": (1e-9, 1e-9), "float32": (5e-5, 1e-4)}
# (T, chunks): T = 1, 2, 3, 37 and 64 with 1, 2, 5 and T-1 chunks.
T_CHUNKS = [(T, c) for T in (1, 2, 3, 37, 64)
            for c in sorted({1, 2, 5, T - 1} & set(range(1, max(T, 2))))]


def _np(x):
    return x.detach().cpu().numpy()


def _gram(L):
    return np.einsum("tikb,tjkb->tijb", L, L)


def _measurements(B, T, seed):
    ts = DT * np.arange(1, T + 1)
    return np.sin(2 * np.pi * 8.0 * ts)[None] + np.sqrt(XI) * \
        np.random.default_rng(seed).standard_normal((B, T))


@functools.lru_cache(maxsize=None)
def _filtered(T, model="chirp"):
    """The plain float64 filter's (mfs, Lfs) on seeded measurements, GH-3,
    as NumPy arrays, and the chirp params it ran with."""
    params = PARAMS if model == "chirp" else lascala_chirp_params(
        torch.tensor(LASCALA, dtype=torch.float64))
    mfs, Lfs, _ = ghfs_chirp_filter_reference(
        params, XI, DT, tq.gauss_hermite(4, 3),
        torch.tensor(_measurements(B, T, 40 + T)))
    return params, _np(mfs), _np(Lfs)


@functools.lru_cache(maxsize=None)
def _jax_smoothed(T, dtype, model="chirp"):
    """The JAX package's smoother over the same filter outputs."""
    _, mfs, Lfs = _filtered(T, model)
    jdt = getattr(jnp, dtype)
    pack = (jm.build_chirp_model(jnp.asarray(PARAMS, jdt)) if model == "chirp"
            else jm.build_lascala_model(jnp.asarray(LASCALA, jdt)))
    mss, Lss = jax_smoother(pack.m_and_cov, jq.gauss_hermite(4, 3),
                            jnp.asarray(mfs, jdt), jnp.asarray(Lfs, jdt), DT)
    return np.asarray(mss), np.asarray(Lss)


def _inputs(T, dtype, model="chirp"):
    params, mfs, Lfs = _filtered(T, model)
    tdt = getattr(torch, dtype)
    mfs, Lfs = torch.tensor(mfs, dtype=tdt), torch.tensor(Lfs, dtype=tdt)
    rows = smoother_rows_reference(params, DT, tq.gauss_hermite(4, 3), mfs,
                                   Lfs)
    return mfs, Lfs, rows


def _assert_smoothed(got, want, dtype):
    atol_m, atol_P = TOLS[dtype]
    npt.assert_allclose(_np(got[0]), want[0], atol=atol_m, rtol=0)
    npt.assert_allclose(_gram(_np(got[1])), _gram(want[1]), atol=atol_P,
                        rtol=0)


@pytest.mark.parametrize("T,chunks", T_CHUNKS)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chunked_twin_matches_jax(dtype, T, chunks):
    """Compose, Carry and Apply's twins over phase A's rows against the JAX
    package's smoother over the same filter outputs (B=5, GH-3); row T-1
    is the filter's, bit for bit."""
    mfs, Lfs, rows = _inputs(T, dtype)
    got = smoother_backward_chunked_reference(mfs, Lfs, rows, chunks)
    assert [tuple(x.shape) for x in got] == [(T, 4, B), (T, 4, 4, B)]
    assert all(x.dtype == mfs.dtype for x in got)
    _assert_smoothed(got, _jax_smoothed(T, dtype), dtype)
    assert torch.equal(got[0][-1], mfs[-1]) and torch.equal(got[1][-1],
                                                            Lfs[-1])


@pytest.mark.parametrize("T", [1, 2, 3, 37, 64])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_one_chunk_is_the_sequential_twin_bit_for_bit(dtype, T):
    """At one chunk Compose and Carry have nothing to do and Apply runs the
    sequential recursion: ``smoother_backward_reference``'s bits."""
    mfs, Lfs, rows = _inputs(T, dtype)
    agg = smoother_compose_reference(mfs, rows, 1)
    bounds = smoother_carry_reference(mfs, Lfs, agg, 1)
    assert agg.shape == (0, STEP_WORDS, B) and bounds.shape == (0,
                                                                CARRY_WORDS, B)
    got = smoother_apply_reference(mfs, Lfs, rows, bounds, 1)
    want = smoother_backward_reference(mfs, Lfs, rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    whole = smoother_backward_chunked_reference(mfs, Lfs, rows, 1)
    assert torch.equal(whole[0], want[0]) and torch.equal(whole[1], want[1])


@pytest.mark.parametrize("chunks", [2, 3, 7, 8, 39])
def test_chunked_twin_matches_sequential_twin(chunks):
    """At T=40 in float64, any chunking gives the sequential recursion to
    round-off (1e-12 of scale), chunks that do not divide the 39 steps
    included; the parts' shapes are the kernels'."""
    mfs, Lfs, rows = _inputs(40, "float64")
    agg = smoother_compose_reference(mfs, rows, chunks)
    bounds = smoother_carry_reference(mfs, Lfs, agg, chunks)
    assert agg.shape == (chunks - 1, STEP_WORDS, B)
    assert bounds.shape == (chunks - 1, CARRY_WORDS, B)
    # An aggregate's reference point is the filtered mean at its chunk's
    # later end; the carry at that end is Apply's start there.
    starts = chunk_starts(40, chunks)
    for k in range(1, chunks):
        assert torch.equal(agg[k - 1, 4:8], mfs[starts[k + 1]])
    ms, Ls = smoother_apply_reference(mfs, Lfs, rows, bounds, chunks)
    ms0, Ls0 = smoother_backward_reference(mfs, Lfs, rows)
    npt.assert_allclose(_np(ms), _np(ms0), atol=1e-12 * (1 + float(
        ms0.abs().max())), rtol=0)
    npt.assert_allclose(_gram(_np(Ls)), _gram(_np(Ls0)), atol=1e-12, rtol=0)
    for k in range(chunks - 1):
        npt.assert_allclose(_np(bounds[k, :4]), _np(ms0[starts[k + 1]]),
                            atol=1e-12 * (1 + float(ms0.abs().max())),
                            rtol=0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_lascala_chunked_twin_matches_jax_lascala(dtype):
    """La Scala through ``lascala_chirp_params``: the chunked twin against
    the JAX package's smoother on the La Scala model (T=37, 5 chunks)."""
    mfs, Lfs, rows = _inputs(37, dtype, "lascala")
    got = smoother_backward_chunked_reference(mfs, Lfs, rows, 5)
    _assert_smoothed(got, _jax_smoothed(37, dtype, "lascala"), dtype)


@pytest.mark.parametrize("chunks", [1, 2, 5, None])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_factor_rows_through_chunked_twin_match_jax(dtype, chunks):
    """The fused factor path as the card runs it: F's factor rows (its
    twin), then the chunked phase B, against the JAX package's
    ``sqrt_sgp_filter_smoother_batched`` with ``return_factors`` (B=5,
    T=48); ``None``: ``backward_chunks`` at 132 SMs."""
    T = 48
    ys = _measurements(B, T, 9)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    fwd = fused_forward_reference(torch.tensor(PARAMS, dtype=tdt), XI, DT,
                                  tq.gauss_hermite(4, 3),
                                  torch.tensor(ys, dtype=tdt), factors=True)
    C = backward_chunks(T, B) if chunks is None else chunks
    got = smoother_backward_chunked_reference(fwd.mfs, fwd.Lfs, fwd.rows, C)
    pack = jm.build_chirp_model(jnp.asarray(PARAMS, jdt))
    want = jax_fused(pack.m_and_cov, jq.gauss_hermite(4, 3), pack.H, jdt(XI),
                     pack.m0, pack.P0, jdt(DT), jnp.asarray(ys, jdt),
                     return_factors=True)
    _assert_smoothed(got, [np.asarray(x) for x in want[:2]], dtype)


@pytest.mark.parametrize("T,Bs,want", [
    (1, (1, 31, 33, 100, 1024, 4096), 1),
    (2, (1, 31, 33, 100, 1024, 4096), 1),
    (64, (1, 31, 33, 100, 1024), 9),
    (64, (4096,), 8),
    (3141, (1, 31, 33, 100), 65),
    (3141, (1024,), 33),
    (3141, (4096,), 8),
])
def test_backward_chunks(T, Bs, want):
    """C fills 132 SMs with BACK_WARPS_PER_SM (chunk, lane) warps each (B /
    32 warps a chunk: 8 chunks at B=4096, 33 at B=1024), up to the C ~
    sqrt(2 (T-1) / CARRY_STEP_WEIGHT) of the shortest chain (65 at
    T=3141, 9 at T=64); one chunk below two steps."""
    assert (BACK_WARPS_PER_SM, CARRY_STEP_WEIGHT) == (8, 1.5)
    for B_ in Bs:
        assert backward_chunks(T, B_) == want, B_
        assert backward_chunks(T, B_, num_sms=132) == want, B_


def test_backward_chunks_follow_the_card_and_stay_in_range():
    assert backward_chunks(3141, 4096, num_sms=66) == 4
    assert backward_chunks(3141, 4096, num_sms=264) == 16
    assert backward_chunks(3, 5) == 2
    assert backward_chunks(3141, 0) == 1
    for T in (1, 2, 3, 4, 10, 64, 500, 3141, 25000):
        for B_ in (1, 7, 32, 33, 100, 1024, 4096, 100000):
            C = backward_chunks(T, B_)
            assert 1 <= C <= max(T - 1, 1)
            starts = chunk_starts(T, C)
            assert starts[0] == 0 and starts[-1] == T - 1
            assert all(b > a for a, b in zip(starts, starts[1:])) or T < 2


def test_chunk_starts():
    """Chunk k covers steps k (T-1) // C .. (k+1) (T-1) // C - 1, the
    kernels' ``chunk_start``."""
    assert chunk_starts(10, 3) == [0, 3, 6, 9]
    assert chunk_starts(11, 3) == [0, 3, 6, 10]
    assert chunk_starts(3141, 8) == [0, 392, 785, 1177, 1570, 1962, 2355,
                                     2747, 3140]
    assert chunk_starts(1, 1) == [0, 0]
    assert chunk_starts(2, 1) == [0, 1]
    for bad in ((1, 2), (10, 10), (10, 0)):
        with pytest.raises(ValueError, match="chunks"):
            chunk_starts(*bad)


@pytest.mark.parametrize("B_,want", [
    (1, (4, 8, 1)), (31, (4, 8, 4)), (33, (4, 8, 5)), (100, (4, 8, 13)),
    (1024, (4, 8, 128)), (2000, (4, 16, 125)), (4096, (4, 32, 128)),
    (4097, (4, 32, 129)), (20000, (4, 32, 625)),
])
def test_affine_geometry(B_, want):
    """G's geometry on 132 SMs: a team of 4 threads per lane, one warp per
    member; a block takes ceil(B / 132) lanes in multiples of 8, up to 32:
    128 blocks of 32 at B=4096 (four warps, one per scheduler), 13 blocks
    of 8 at B=100.  Whatever T: the geometry does not depend on it."""
    assert (BACK_TEAM, BACK_LANES, BACK_STAGES) == (4, 32, 8)
    geo = affine_geometry(B_)
    assert geo == AffineGeometry(*want)
    assert geo.blocks * geo.lanes_per_block >= B_
    assert (geo.blocks - 1) * geo.lanes_per_block < B_
    assert (geo.team * geo.lanes_per_block) % 32 == 0


def test_affine_geometry_overrides_and_refusals():
    assert affine_geometry(4096, lanes=8) == (4, 8, 512)
    assert affine_geometry(100, num_sms=4) == (4, 32, 4)
    assert affine_geometry(100, num_sms=10) == (4, 16, 7)
    for bad in (0, 4, 12, 40):
        with pytest.raises(ValueError, match="lanes"):
            affine_geometry(4096, lanes=bad)


def test_chunked_costs():
    """The chunked scan's own work at C=8, GH-3, B=4096, T=3141 (the
    first chunk's 392 steps are not composed): Compose the step (656
    flop) and A <- X^T A (128) per composed lane-step, reading 34 words
    and, per aggregate, x_ref (4) and writing 34; Carry the step per
    aggregate, reading 34 words, the filter's last row (20) and writing
    14; Apply the recursion as before plus 14 words read per aggregate.
    At one chunk the split is :func:`smoother_cost`'s."""
    S, T, B_ = 81, 3141, 4096
    isz = 4
    one = smoother_phase_costs(S, T, B_)
    assert tuple(one) == KERNELS and KERNELS[1:4] == BACKWARD_KERNELS
    assert one["smoother_compose"] == one["smoother_carry"] == (0, 0)
    assert sum(c.flop for c in one.values()) == smoother_cost(S, T, B_).flop
    costs = smoother_phase_costs(S, T, B_, chunks=8)
    folded, n = (3140 - 392) * B_, 7 * B_
    assert costs["smoother_compose"] == ((656 + 128) * folded,
                                         isz * (34 * folded + 38 * n))
    assert costs["smoother_carry"] == (656 * n, isz * (48 * n + 20 * B_))
    assert costs["smoother_backward"] == (
        one["smoother_backward"].flop,
        one["smoother_backward"].bytes + isz * 14 * n)
    for k in ("smoother_rows", "smoother_expect"):
        assert costs[k] == one[k]


def test_kernel_sources_match_the_wrappers():
    """Phase B's step, aggregate and carry words, its three kernels and
    their entry points in the smoother's source; G's team, ring and block
    limits and its entry points in the fused one."""
    src = (_build.CSRC / "ghfs_chirp_smoother.cu").read_text()
    assert "constexpr int kStepWords = kD + kRowWords;" in src
    assert STEP_WORDS == 34 and CARRY_WORDS == 14
    assert "constexpr int kCarryWords = kD + kD * (kD + 1) / 2;" in src
    assert "constexpr int kStages = 3;" in src
    for name in BACKWARD_KERNELS:
        assert re.search(rf"__global__ void __launch_bounds__\(kBackLanes\)\n"
                         rf"{name}_kernel\(", src), name
    for sym in ("carry_words", "row_words"):
        assert re.search(rf"\bint ghfs_chirp_smoother_{sym}\(", src), sym
    fused = (_build.CSRC / "ghfs_chirp_fused.cu").read_text()
    assert f"constexpr int kBackTeam = {BACK_TEAM};" in fused
    assert f"constexpr int kGStages = {BACK_STAGES};" in fused
    assert f"constexpr int kGLanes = {BACK_LANES};" in fused
    for sym in ("back_team", "back_stages", "back_lanes"):
        assert re.search(rf"\bint ghfs_chirp_fused_{sym}\(", fused), sym
    for dt in ("f32", "f64"):
        assert re.search(rf"\bint affine_backward_{dt}\([^)]*int lanes, int "
                         rf"out_index", fused), dt
