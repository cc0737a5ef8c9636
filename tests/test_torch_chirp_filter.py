"""The fused chirp filter of the PyTorch port: its plain version against
the JAX package's Pallas kernel (interpret mode), the wrapper's routing
and launch count, the kernel's model constants, its launch geometry and
work count, and the Householder algebra the kernel's teams use.  The CUDA
kernel itself is tested on a card by tests/test_torch_cuda.py."""

import math
import re

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chirpgp_tpu.models as jm
import chirpgp_tpu.quad as jq
import chirpgp_tpu_torch.quad as tq
from chirpgp_tpu.experimental.pallas_filter import ghfs_chirp_filter_pallas
from chirpgp_tpu.infer.batched import tria_cf as tria_cf_jax
from chirpgp_tpu.utils.numerics import ou_variance
from chirpgp_tpu_torch.infer.batched import tria_cf
from chirpgp_tpu_torch.ops import _build
from chirpgp_tpu_torch.ops.chirp_filter import (
    MAX_THREADS, ROWS, TEAMS, _chirp_constants, filter_cost,
    ghfs_chirp_filter, ghfs_chirp_filter_kernel, ghfs_chirp_filter_reference,
    launch_geometry)

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


def test_kernel_entry_rejects_cpu_tensors(monkeypatch):
    """The kernel's own entry point has no plain fallback."""
    monkeypatch.setattr(ghfs_chirp_filter, "launches", 0)
    with pytest.raises(ValueError, match="cuda"):
        ghfs_chirp_filter_kernel(PARAMS, 0.1, 1e-3, tq.cubature(4),
                                 torch.zeros((2, 8)), team=8)
    assert ghfs_chirp_filter.launches == 0


def _team_sum(x, team):
    """Sum over the rows of ``x`` as one team of the kernel does: member p
    adds its rows p, p + team, ... (padding rows are zero), then a
    butterfly over the team leaves the same sum on every member."""
    n = x.shape[0]
    slots = -(-n // team)
    pad = x.new_zeros((slots * team - n,) + x.shape[1:])
    part = torch.cat([x, pad]).reshape((slots, team) + x.shape[1:]).sum(0)
    o = team // 2
    while o:
        part = part + part[torch.arange(team) ^ o]
        o //= 2
    assert torch.equal(part, part[:1].expand_as(part))
    return part[0]


def _tria_gram(M, team):
    """The kernel's Householder triangularization of ``M`` (n, d, B): per
    column j, one team sum of the Gram row G_jk = sum_{r >= j} M_rj M_rk,
    alpha = -sign(M_jj) sqrt(G_jj), |v|^2 = 2 (G_jj - alpha M_jj),
    w_k = G_jk - alpha M_jk, R_jk = M_jk - beta (M_jj - alpha) w_k, and
    columns k > j of the rows below j reflected.  Returns R (d, d, B) and
    the number of reflections the |v|^2 <= 1e-30 guard skipped."""
    n, d, B = M.shape
    M = M.clone()
    R = M.new_zeros((d, d, B))
    rows = torch.arange(n)[:, None]
    skipped = 0
    for j in range(d):
        x = torch.where(rows >= j, M[:, j], 0.0)
        G = _team_sum(x[:, None, :] * M[:, j:], team)      # (d-j, B)
        Mj = M[j, j:]
        norm = torch.sqrt(G[0])
        alpha = torch.where(Mj[0] >= 0, -norm, norm)
        vn2 = 2.0 * (G[0] - alpha * Mj[0])
        ok = vn2 > 1e-30
        skipped += int((~ok).sum())
        beta = torch.where(ok, 2.0 / torch.where(ok, vn2, 1.0), 0.0)
        wk = G - alpha * Mj
        R[j, j:] = Mj - beta * (Mj[0] - alpha) * wk
        v = torch.where(rows > j, M[:, j], 0.0)
        M[:, j + 1:] = M[:, j + 1:] - beta * v[:, None] * wk[None, 1:]
    return R, skipped


@pytest.mark.parametrize("team", [8, 32])
@pytest.mark.parametrize("case", ["random", "zero_column", "small_pivot"])
def test_team_householder_matches_tria_cf(team, case):
    """The kernel's fused Householder algebra against ``tria_cf`` of the
    port and of the JAX package, float64, on (85, 4, B) pre-arrays: R
    elementwise to 1e-12.  A zero column hits the |v|^2 guard."""
    rng = np.random.default_rng(team)
    M = rng.standard_normal((85, 4, 6))
    if case == "zero_column":
        M[:, 2, 0] = 0.0
        M[:, 3, 1] = 0.0
    elif case == "small_pivot":
        M[:4] *= 1e-6
        M[:4, :, 2] *= -1.0
    R, skipped = _tria_gram(torch.tensor(M), team)
    assert skipped == (2 if case == "zero_column" else 0)
    npt.assert_allclose(R.numpy(), tria_cf(torch.tensor(M)).numpy(),
                        rtol=0, atol=1e-12)
    npt.assert_allclose(R.numpy(), np.asarray(tria_cf_jax(jnp.asarray(M))),
                        rtol=0, atol=1e-12)


@pytest.mark.parametrize("S", [8, 16, 81])
@pytest.mark.parametrize("B", [1, 3, 100, 130, 4096])
def test_launch_geometry_covers_every_lane_once(B, S):
    for team in (None,) + TEAMS:
        geo = launch_geometry(B, S, num_sms=132, team=team)
        assert geo.team in TEAMS and geo.rows in ROWS[geo.team]
        # The fewest rows built for the team that hold the pre-array.
        assert geo.team * geo.rows >= S + 4
        assert all(geo.team * r < S + 4 for r in ROWS[geo.team]
                   if r < geo.rows)
        assert geo.team * geo.lanes_per_block <= MAX_THREADS
        per_warp = 32 // geo.team
        if geo.lanes_per_block > 1:
            assert geo.lanes_per_block % per_warp == 0   # whole warps
        lanes = [blk * geo.lanes_per_block + k for blk in range(geo.blocks)
                 for k in range(geo.lanes_per_block)]
        assert [b for b in lanes if b < B] == list(range(B))
        assert len(lanes) - B < geo.lanes_per_block      # no dead block
        # Spread over the SMs as far as B allows: one lane a block up to
        # one lane an SM, else at least one warp of lanes an SM.
        want = B if B <= 132 else min(-(-B // per_warp), 132)
        assert geo.blocks >= want


def test_launch_geometry_default_team_and_rejections():
    """P = 32 up to 16 lanes per SM, P = 8 beyond (the fastest team at
    B = 100 and B = 4096 on an H100, PERF.md); the rows follow S."""
    assert launch_geometry(100, 81).team == 32
    assert launch_geometry(100, 81).blocks == 100
    assert launch_geometry(2112, 81).team == 32
    assert launch_geometry(2113, 81).team == 8
    assert launch_geometry(4096, 81).team == 8
    assert [launch_geometry(4096, S).rows for S in (8, 16, 81)] == [2, 11, 11]
    assert [launch_geometry(100, S).rows for S in (8, 16, 81)] == [1, 1, 3]
    with pytest.raises(ValueError, match="team"):
        launch_geometry(100, 81, team=4)
    with pytest.raises(ValueError, match="sigma points"):
        launch_geometry(100, 82)


def test_filter_cost_matches_hand_count():
    """~7.2k flop and 88 B (float32) per seed-step at S = 81, counted as
    the step needs them: chi with L lower 1620, LCD mean 1377, mean and
    deviations 1296, Householder 1210 + 857 + 512 + 175, the 5 x 5 update
    63 + 36, innovation and nll 17."""
    one = filter_cost(81, 1, 1, torch.float32)
    assert one.flop == 1620 + 1377 + 1296 + 2754 + 99 + 17 == 7163
    assert one.bytes == 88
    assert filter_cost(81, 1, 1, torch.float64).bytes == 176
    full = filter_cost(81, 3141, 4096, torch.float32)
    assert full == (one.flop * 3141 * 4096, 88 * 3141 * 4096)
    # Cubature, S = 8: 8 x 53 + (188 + 127 + 74 + 29) + 99 + 17.
    assert filter_cost(8, 1, 1).flop == 958


def test_row_counts_match_the_kernel_instances():
    """ROWS lists the (team, rows) instances the kernel source launches."""
    src = (_build.CSRC / "ghfs_chirp_filter.cu").read_text()
    cases = re.findall(r"case (\d+): return GHFS_LAUNCH\((\d+), (\d+)\);",
                       src)
    assert {(int(p), int(r)) for _, p, r in cases} == {
        (p, r) for p in TEAMS for r in ROWS[p]}
    assert all(int(c) == 100 * int(p) + int(r) for c, p, r in cases)
