"""Fused square-root GHFS filter + smoother for the chirp model (d=4,
H = e_1): the hand-written CUDA kernels of ``csrc/ghfs_chirp_fused.cu``,
their plain twins, and the wrapper.

Counterpart of ``chirpgp_tpu.infer.batched.sqrt_sgp_filter_smoother_batched``
for the chirp model, the JAX package's benchmarked fused form (bench.py's
slim GH-3 headline); it replaces no Pallas kernel but that function's
XLA-compiled scans.  :func:`ghfs_chirp_filter_smoother` takes the filter's
6 constrained chirp params (La Scala through
:func:`~chirpgp_tpu_torch.ops.chirp_filter.lascala_chirp_params`) and runs
the plain twins for a tensor on the CPU and the kernels for a tensor on a
CUDA device; there is no fallback from one to the other, and no gradient.

The kernels split the function where its two scans meet:

- ``fused_forward`` (kernel F), the forward scan: per step the filter's
  prediction, the projected joint triangularization that yields the
  smoother's gain ``X = R11^-1 R12`` and conditional factor R22, the
  measurement update and the NLL.  Row t-1 of its ``(T-1, ROW_WORDS, B)``
  output is what iteration t emits, the one that smooths time t-1.  In maps
  mode a row holds the affine recursion's ``u`` (4), ``G = X^T`` (16,
  row-major) and ``D = R22^T R22``'s upper triangle (10, row by row), and F
  writes the last filtered moments; in factor mode a row holds m_p, X and
  R22's upper triangle, the row the smoother's phase B reads
  (``ops/chirp_smoother.py``), and F writes every filtered mean and
  factor.  A team of threads per lane runs the carry's chain and hands
  each step off to consumer warps, one thread per lane, that build and
  store the row; the team takes the sigma points in groups that share
  ``xi[0..2]`` (:func:`group_points`, :func:`fused_layout`) and its
  launch geometry from :func:`fused_geometry`.
- ``affine_backward`` (kernel G), the covariance branch's reverse scan:
  ``ms <- u + G ms``, ``Ps <- D + G Ps G^T`` from the last filtered
  moments, full or slim.  The factor branch's reverse scan is the
  smoother's phase B (``smoother_backward``), unchanged.

:func:`fused_forward_reference` and :func:`affine_backward_reference` are
the plain twins of F and G (the loops of ``infer/batched.py`` in the
kernels' packing), the kernels' oracle; the wrapper's CPU route composes
them.  :func:`fused_cost` counts each kernel's least work.
"""

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from chirpgp_tpu_torch.infer.batched import _affine_backward, _fused_forward
from chirpgp_tpu_torch.infer.sqrt import _require_nonneg_weights
from chirpgp_tpu_torch.ops.chirp_filter import (
    MAX_POINTS, _chirp_constants, _chirp_pack)
from chirpgp_tpu_torch.ops.chirp_smoother import (
    ROW_WORDS, SmootherCost, _householder_column_flop, _householder_flop,
    load_smoother_kernel, smoother_backward_reference)
from chirpgp_tpu_torch.quad.sigma_points import SigmaPoints

__all__ = ["FusedGeometry", "FusedKernels", "GROUP", "GROUPS", "KERNELS",
           "ForwardOut", "affine_backward_reference", "fused_cost",
           "fused_forward_reference", "fused_geometry", "fused_groups",
           "fused_kernel_launcher", "fused_layout",
           "ghfs_chirp_filter_smoother",
           "ghfs_chirp_filter_smoother_reference", "group_points",
           "load_fused_kernel"]

_D = 4
_KERNEL = "ghfs_chirp_fused"
# The CUDA kernels a wrapper call launches: F, then G (maps) or the
# smoother's phase B (factors).
KERNELS = ("fused_forward", "affine_backward", "smoother_backward")
# F's sigma points come in groups of at most GROUP points that share
# xi[0..2] (their transition's angle); GROUPS lists, for each team size
# it is built for, the groups per member of its instances (cubature's 7
# and GH-3's 27 groups at P = 8; up to 96 groups at P = 32, which holds
# any rule of MAX_POINTS singletons).  A block holds at most
# FORWARD_LANES lanes (a consumer warp's threads) and FORWARD_THREADS
# threads: the team's and FORWARD_CONSUMERS consumer warps.
GROUP = 3
GROUPS = {8: (1, 4), 32: (1, 3)}
FORWARD_LANES = 32
FORWARD_CONSUMERS = 4
FORWARD_THREADS = 384
_WARP = 32
_IU = torch.triu_indices(_D, _D)


def group_points(sgps: SigmaPoints) -> list:
    """The rule's point indices in groups that share ``xi[0..2]`` (equal
    values), in the order of their first points, each group cut into runs
    of at most ``GROUP`` points.  GH-3 at d=4 gives 27 consecutive
    triples, cubature 7 groups (the two points on the last axis share
    one); a rule whose prefixes all differ gives one group per point."""
    groups = {}
    for s, row in enumerate(np.asarray(sgps.xi, np.float64)):
        groups.setdefault(tuple(row[:_D - 1].tolist()), []).append(s)
    return [pts[i:i + GROUP] for pts in groups.values()
            for i in range(0, len(pts), GROUP)]


def fused_groups(team: int, n_groups: int) -> int:
    """F's groups per member for ``n_groups`` groups and a team of
    ``team``: the fewest of ``GROUPS[team]`` that hold them (a member owns
    ``GROUP`` point rows per group)."""
    if team not in GROUPS:
        raise ValueError(f"team must be one of {tuple(GROUPS)}, got {team}")
    fits = [g for g in GROUPS[team] if team * g >= n_groups]
    if not 1 <= n_groups or not fits:
        raise ValueError(f"a team of {team} takes 1..{team * GROUPS[team][-1]}"
                         f" groups of sigma points, got {n_groups}")
    return min(fits)


def fused_layout(sgps: SigmaPoints, team: Optional[int] = None,
                 groups_per_member: Optional[int] = None) -> SigmaPoints:
    """The rule in F's order: the groups of :func:`group_points` one after
    another, each padded to ``GROUP`` point slots, and with ``team`` the
    groups padded to ``team * groups_per_member`` (by default
    :func:`fused_groups`'s); group g in slots ``GROUP g ..``, member ``g %
    team``'s.  A padding slot repeats its group's first point (or point
    0) at weight 0, which adds exact zeros to every sum of the step.
    Without ``team`` it is the unpadded permutation of the rule, whose
    plain filter+smoother is the same to round-off."""
    groups = group_points(sgps)
    if team is None:
        order = [s for g in groups for s in g]
        return sgps._replace(xi=np.asarray(sgps.xi)[order],
                             w=np.asarray(sgps.w)[order],
                             n_points=len(order))
    gpm = groups_per_member or fused_groups(team, len(groups))
    slots = team * gpm * GROUP
    order, w = np.zeros(slots, np.int64), np.zeros(slots)
    for g, pts in enumerate(groups):
        order[GROUP * g:GROUP * (g + 1)] = pts[0]
        order[GROUP * g:GROUP * g + len(pts)] = pts
        w[GROUP * g:GROUP * g + len(pts)] = np.asarray(sgps.w)[pts]
    return sgps._replace(xi=np.asarray(sgps.xi)[order], w=w, n_points=slots)


class FusedGeometry(NamedTuple):
    team: int              # team threads per lane
    groups: int            # point groups per team member
    lanes_per_block: int   # a consumer warp's active threads
    blocks: int


def fused_geometry(B: int, n_groups: int, num_sms: int = 132,
                   team: Optional[int] = None,
                   lanes: Optional[int] = None) -> FusedGeometry:
    """F's launch geometry for ``B`` lanes and a rule of ``n_groups``
    groups on a card with ``num_sms`` SMs (``launch_geometry`` stays the
    filter's).

    The team is 32 threads up to 16 lanes per SM, where the step's chain
    sets the time (the Table-I width, B = 100), and 8 beyond (the
    benchmark's B = 4096); 32 also where 8 would need more groups per
    member than it is built for.  Up to one lane per SM every lane gets a
    block of its own; beyond, a block takes ``ceil(B / num_sms)`` lanes,
    whole team warps, up to a consumer warp's 32 (``FORWARD_THREADS`` in
    all): at B = 4096, 128 blocks of 32, and no SM can hold fewer than 32
    lanes.  ``lanes`` overrides the lanes per block."""
    if team is None:
        team = 32 if B <= 16 * max(num_sms, 1) else 8
        if n_groups > 8 * GROUPS[8][-1]:
            team = 32
    groups = fused_groups(team, n_groups)
    per_warp = _WARP // team
    most = (FORWARD_THREADS - _WARP * FORWARD_CONSUMERS) // team
    if lanes is None:
        lanes = 1 if B <= num_sms else min(most, -(-B // num_sms))
        lanes = -(-lanes // per_warp) * per_warp
    if not 1 <= lanes <= most or (team * lanes) % _WARP:
        raise ValueError(f"a team of {team} takes 1..{most} lanes per block "
                         f"in whole warps, got {lanes}")
    return FusedGeometry(team, groups, lanes, -(-B // lanes))


class ForwardOut(NamedTuple):
    rows: torch.Tensor   # (T-1, ROW_WORDS, B): row t-1 smooths time t-1
    mfs: torch.Tensor    # (T, 4, B) in factor mode; (1, 4, B), time T-1
    Lfs: torch.Tensor    # (T, 4, 4, B) lower; (1, 4, 4, B), time T-1
    nll: torch.Tensor    # (T, B) cumulative


def _upper(M: torch.Tensor) -> torch.Tensor:
    """The (10, B) upper triangle of a (4, 4, B) array, row by row."""
    return M[_IU[0], _IU[1]]


def _full_symmetric(words: torch.Tensor) -> torch.Tensor:
    """The (4, 4, B) symmetric array of its (10, B) upper triangle."""
    M = words.new_zeros((_D, _D) + words.shape[1:])
    M[_IU[0], _IU[1]] = words
    M[_IU[1], _IU[0]] = words
    return M


def fused_forward_reference(params, Xi, dt, sgps: SigmaPoints,
                            yss: torch.Tensor, m0=None,
                            factors: bool = False) -> ForwardOut:
    """F's plain twin: the forward scan of ``sqrt_sgp_filter_smoother_batched``
    on the chirp model built from ``params`` in float64 on the host (its
    constants cast to ``yss.dtype``), packed as the kernel writes it."""
    pack = _chirp_pack(params, m0)
    B, T = yss.shape
    nll, steps, m, L = _fused_forward(pack.m_and_cov, sgps, pack.H, float(Xi),
                                      pack.m0, pack.P0, float(dt), yss,
                                      factors)
    if factors:
        rows = [torch.cat([mp, X.reshape(_D * _D, B), _upper(R22)])
                for _, _, mp, X, R22 in steps[1:]]
        mfs = torch.stack([s[0] for s in steps])
        Lfs = torch.stack([s[1] for s in steps])
    else:
        rows = [torch.cat([u, G.reshape(_D * _D, B), _upper(D)])
                for u, G, D in steps[1:]]
        mfs, Lfs = m[None], L[None]
    rows = torch.stack(rows) if rows else yss.new_empty((0, ROW_WORDS, B))
    return ForwardOut(rows, mfs, Lfs, nll)


def affine_backward_reference(rows: torch.Tensor, mf: torch.Tensor,
                              Lf: torch.Tensor, out_index=None):
    """G's plain twin: the covariance branch's reverse scan (``bstep_cov``)
    over F's maps ``rows`` (T-1, 30, B) from the last filtered moments
    ``mf`` (4, B), ``Lf`` (4, 4, B).  Returns ``(mss (T, 4, B), Pss (T, 4,
    4, B))``, or with ``out_index`` that state's ``(v_mean (T, B), v_var
    (T, B))``."""
    B = mf.shape[-1]
    maps = [(row[:_D], row[_D:_D + _D * _D].reshape(_D, _D, B),
             _full_symmetric(row[_D + _D * _D:])) for row in rows]
    return _affine_backward(mf, torch.einsum("ikb,jkb->ijb", Lf, Lf), maps,
                            out_index)


def ghfs_chirp_filter_smoother_reference(params, Xi, dt, sgps: SigmaPoints,
                                         yss: torch.Tensor, m0=None,
                                         return_factors: bool = True,
                                         out_index: Optional[int] = None):
    """The plain version: F's twin, then G's (maps) or phase B's
    (``smoother_backward_reference``, factors).  Same contract as
    :func:`ghfs_chirp_filter_smoother`."""
    _check(sgps, yss, return_factors, out_index)
    fwd = fused_forward_reference(params, Xi, dt, sgps, yss, m0,
                                  factors=return_factors)
    if return_factors:
        mss, Lss = smoother_backward_reference(fwd.mfs, fwd.Lfs, fwd.rows)
        return mss, Lss, fwd.nll
    ms, Ps = affine_backward_reference(fwd.rows, fwd.mfs[0], fwd.Lfs[0],
                                       out_index)
    return ms, Ps, fwd.nll


def _check(sgps: SigmaPoints, yss, return_factors, out_index):
    """The inputs both versions take; raises ``ValueError`` otherwise."""
    _require_nonneg_weights(sgps, "ghfs_chirp_filter_smoother")
    if sgps.d != _D:
        raise ValueError(f"the chirp kernels are d={_D} only, got a "
                         f"d={sgps.d} rule")
    if not 1 <= sgps.n_points <= MAX_POINTS:
        raise ValueError(f"the kernels take 1..{MAX_POINTS} sigma points, "
                         f"got S={sgps.n_points}")
    if yss.requires_grad:
        raise ValueError("ghfs_chirp_filter_smoother has no gradient; pass "
                         "yss that does not require grad")
    if yss.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"yss must be float32 or float64, got {yss.dtype}")
    if yss.dim() != 2 or yss.shape[1] < 1:
        raise ValueError(f"yss must be (B, T) with T >= 1, got shape "
                         f"{tuple(yss.shape)}")
    if out_index is not None:
        if return_factors:
            raise ValueError("out_index (slim output) requires "
                             "return_factors=False")
        if not 0 <= out_index < _D:
            raise ValueError(f"out_index must be in 0..{_D - 1}, got "
                             f"{out_index}")


def ghfs_chirp_filter_smoother(params, Xi, dt, sgps: SigmaPoints,
                               yss: torch.Tensor, m0=None,
                               return_factors: bool = True,
                               out_index: Optional[int] = None):
    """Fused sqrt GHFS filter + smoother for the chirp model (d=4, H = e_1).

    Parameters
    ----------
    params : 6 constrained values ``[lam, b, delta, ell, sigma, m0_v]``.
    Xi, dt : floats.
    sgps : sigma-point rule for d=4 with nonnegative weights, S <= 81.
    yss : (B, T) float32 or float64 measurements, T >= 1.
    m0 : optional 4 values that replace the prior mean ``[0, 0, m0_v, 0]``
        of ``build_chirp_model(params)``; ``P0`` stays the model's.
    return_factors, out_index : as ``sqrt_sgp_filter_smoother_batched``.

    Returns, in ``yss.dtype`` on ``yss.device``, the contract of
    ``sqrt_sgp_filter_smoother_batched``: ``(mss (T, 4, B), Lss (T, 4, 4,
    B) lower, nll (T, B))`` with ``return_factors``; else ``(mss, Pss (T, 4,
    4, B), nll)``, or with ``out_index`` ``(v_mean (T, B), v_var (T, B),
    nll)``.  A CPU tensor runs the plain twins; a CUDA tensor launches the
    kernels (built on first use) or raises.
    ``ghfs_chirp_filter_smoother.launches`` counts the calls that launched
    them, ``ghfs_chirp_filter_smoother.kernel_launches`` each kernel's
    launches.
    """
    _check(sgps, yss, return_factors, out_index)
    if yss.device.type == "cpu":
        return ghfs_chirp_filter_smoother_reference(
            params, Xi, dt, sgps, yss, m0, return_factors, out_index)
    if yss.device.type != "cuda":
        raise ValueError(f"ghfs_chirp_filter_smoother runs on cpu or cuda "
                         f"tensors, got {yss.device}")
    launch, outputs = fused_kernel_launcher(params, Xi, dt, sgps, yss, m0,
                                            return_factors, out_index)
    launch()
    return outputs


def load_fused_kernel():
    """Build (on first use) and load the kernel library, with the C
    signatures declared.  Returns ``_build.BuiltLibrary``."""
    from chirpgp_tpu_torch.ops._build import load_library
    built = load_library(_KERNEL)
    lib = built.lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "f64"):
        fwd = getattr(lib, f"fused_forward_{dt}")
        fwd.argtypes = ([ptr] * 4 + [ctypes.POINTER(ctypes.c_double)]
                        + [i32] * 7 + [ptr] * 5)
        back = getattr(lib, f"affine_backward_{dt}")
        back.argtypes = [ptr] * 3 + [i32] * 3 + [ptr] * 3
        for fn in (fwd, back):
            fn.restype = i32
    for fn in (lib.ghfs_chirp_fused_max_points,
               lib.ghfs_chirp_fused_max_slots,
               lib.ghfs_chirp_fused_num_consts,
               lib.ghfs_chirp_fused_row_words):
        fn.argtypes = []
        fn.restype = i32
    if (lib.ghfs_chirp_fused_max_points() != MAX_POINTS
            or lib.ghfs_chirp_fused_max_slots() != 32 * GROUPS[32][-1] * GROUP
            or lib.ghfs_chirp_fused_row_words() != ROW_WORDS):
        raise RuntimeError("the fused kernels' limits do not match the "
                           "wrapper's")
    return built


class FusedKernels:
    """The fused form's CUDA kernels for one model (``params``, ``Xi``,
    ``dt``, ``m0``), rule, dtype and device, built on first use.  Each
    method launches one kernel on the tensors it is given, on the current
    stream, and counts it in ``ghfs_chirp_filter_smoother.kernel_launches``;
    it does no host work besides the ctypes call, so CUDA events around it
    time the kernel alone.  The tensors are contiguous, on ``device``, in
    ``dtype``, with B lanes minor."""

    def __init__(self, params, Xi, dt, sgps: SigmaPoints, dtype: torch.dtype,
                 device: torch.device, m0=None):
        self.lib = load_fused_kernel().lib
        consts = _chirp_constants(params, Xi, dt, m0)
        if consts.size != self.lib.ghfs_chirp_fused_num_consts():
            raise RuntimeError("model constants do not match the kernel's "
                               "layout")
        self.consts = (ctypes.c_double * consts.size)(*consts.tolist())
        like = dict(dtype=dtype, device=device)
        self.device, self.n_groups = device, len(group_points(sgps))
        self.num_sms = torch.cuda.get_device_properties(
            device).multi_processor_count
        # F's grouped rule for each (team, groups per member) it may launch,
        # on the card before any launch.
        self.tables = {}
        for team in GROUPS:
            try:
                gpm = fused_groups(team, self.n_groups)
            except ValueError:
                continue
            rule = fused_layout(sgps, team, gpm)
            w = np.asarray(rule.w, np.float64)
            self.tables[team, gpm] = tuple(torch.as_tensor(a, **like) for a in (
                np.ascontiguousarray(rule.xi), w, np.sqrt(w)))
        self.suffix = "f32" if dtype == torch.float32 else "f64"
        self._smoother = None

    def _run(self, kernel, fn, *args):
        rc = fn(*args, torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ghfs_chirp_filter_smoother kernel {kernel} "
                               f"launch failed: CUDA error {rc}")
        ghfs_chirp_filter_smoother.kernel_launches[kernel] += 1

    def forward(self, ys_t, rows, mfs, lfs, nll, factors: bool):
        """F on the (T, B) measurements ``ys_t``: the (T-1, 30, B) ``rows``,
        the nll (T, B), and ``mfs`` (T, 4, B), ``lfs`` (T, 16, B) in factor
        mode, else their row 0 at time T-1; the team size, groups and
        blocks are ``fused_geometry``'s."""
        T, B = ys_t.shape
        geo = fused_geometry(B, self.n_groups, self.num_sms)
        xi, w, sw = self.tables[geo.team, geo.groups]
        self._run("fused_forward", getattr(self.lib,
                                           f"fused_forward_{self.suffix}"),
                  ys_t.data_ptr(), xi.data_ptr(), w.data_ptr(),
                  sw.data_ptr(), self.consts, w.numel(), T, B, geo.team,
                  geo.groups, geo.lanes_per_block, int(factors),
                  rows.data_ptr(), mfs.data_ptr(), lfs.data_ptr(),
                  nll.data_ptr())

    def backward(self, rows, mf, lf, out_m, out_p,
                 out_index: Optional[int] = None):
        """G over the maps ``rows`` from the last filtered ``mf`` (4, B) and
        ``lf`` (16, B): ``out_m`` (T, 4, B) and ``out_p`` (T, 16, B), or
        with ``out_index`` that state's (T, B) mean and variance."""
        T, B = rows.shape[0] + 1, mf.shape[-1]
        self._run("affine_backward", getattr(self.lib,
                                             f"affine_backward_{self.suffix}"),
                  rows.data_ptr(), mf.data_ptr(), lf.data_ptr(), T, B,
                  -1 if out_index is None else out_index, out_m.data_ptr(),
                  out_p.data_ptr())

    def rows_backward(self, mfs, lfs, rows, mss, lss):
        """The smoother's phase B over F's factor rows: ``mss`` (T, 4, B)
        and ``lss`` (T, 16, B) from ``mfs``, ``lfs`` and ``rows``."""
        if self._smoother is None:
            self._smoother = load_smoother_kernel().lib
        T, _, B = mfs.shape
        self._run("smoother_backward",
                  getattr(self._smoother, f"smoother_backward_{self.suffix}"),
                  mfs.data_ptr(), lfs.data_ptr(), rows.data_ptr(), T, B, B,
                  mss.data_ptr(), lss.data_ptr())


def fused_kernel_launcher(params, Xi, dt, sgps: SigmaPoints,
                          yss: torch.Tensor, m0=None,
                          return_factors: bool = True,
                          out_index: Optional[int] = None):
    """Check the inputs of :func:`ghfs_chirp_filter_smoother` for the
    kernels, build them (:class:`FusedKernels`), the transposed
    measurements, F's rows and every output, and return ``(launch,
    outputs)``: each ``launch()`` runs F, then G (maps) or phase B
    (factors), on the current stream, writes the outputs and counts one
    launch.  It does no host work besides the ctypes calls, so CUDA events
    around it time the kernels alone."""
    _check(sgps, yss, return_factors, out_index)
    if yss.device.type != "cuda":
        raise ValueError(f"the ghfs_chirp_filter_smoother kernels run on "
                         f"cuda tensors; a cpu tensor takes the plain "
                         f"version; got {yss.device}")
    B, T = yss.shape
    kernels = FusedKernels(params, Xi, dt, sgps, yss.dtype, yss.device, m0)
    like = dict(dtype=yss.dtype, device=yss.device)
    ys_t = yss.T.contiguous()
    rows = torch.empty((T - 1, ROW_WORDS, B), **like)
    nll = torch.empty((T, B), **like)
    n = T if return_factors else 1
    mfs = torch.empty((n, _D, B), **like)
    lfs = torch.empty((n, _D * _D, B), **like)
    if return_factors or out_index is None:
        out_m = torch.empty((T, _D, B), **like)
        out_p = torch.empty((T, _D * _D, B), **like)
        outputs = (out_m, out_p.view(T, _D, _D, B), nll)
    else:
        out_m = torch.empty((T, B), **like)
        out_p = torch.empty((T, B), **like)
        outputs = (out_m, out_p, nll)

    # The closure holds every tensor a kernel reads or writes, so that they
    # live as long as ``launch``, whatever the caller keeps.
    def launch():
        with torch.cuda.device(yss.device):
            kernels.forward(ys_t, rows, mfs, lfs, nll, return_factors)
            if return_factors:
                kernels.rows_backward(mfs, lfs, rows, out_m, out_p)
            else:
                kernels.backward(rows, mfs, lfs, out_m, out_p, out_index)
        ghfs_chirp_filter_smoother.launches += 1

    return launch, outputs


def _joint_flop() -> int:
    """Flop of the Householder triangularization of the 12 x 8 joint array
    with its structural zeros skipped (``joint_row`` in the source):
    column j < 4 over its 6 + j live rows, column j >= 4 over 12 - j."""
    return sum(_householder_column_flop(6 + j if j < _D else 3 * _D - j,
                                        2 * _D - j) for j in range(2 * _D))


def fused_cost(S: int, T: int, B: int, dtype=torch.float32) -> dict:
    """Least work of each kernel of the fused form on ``B`` lanes of ``T``
    steps with ``S`` sigma points (an FMA is 2 flop; the 3 transcendentals
    per sigma point are not counted), as ``{kernel: SmootherCost}`` for F in
    maps mode (``fused_forward``) and factor mode
    (``fused_forward_factors``) and G full (``affine_backward``) and slim
    (``affine_backward_slim``).

    F, per step: per sigma point chi, the LCD mean, the weighted mean and
    dev (``filter_cost``'s 53), A = Q^T dev, 32, and dev - Q A, 32; the
    S x 4 Householder; the 12 x 8 one (1100 flop with its zeros skipped);
    the gain, 64 (as ``smoother_cost``); the update, innovation and nll,
    116 (as ``filter_cost``); in maps mode u = m - G m_p, 36, and D's upper
    triangle, 40, over the T - 1 steps that emit them.  Every step is
    counted whole, the first too.  Bytes: y read and the nll written per
    seed-step, the 30-word row per seed-step but the first; maps mode the
    last 20 words of m and L per lane, factor mode 20 per seed-step.

    G, per seed-step but the last: u + G ms, 36; W = Ps G^T, 128; D + the
    upper triangle of G W, 90; and Ps = Lf Lf^T once per lane, 40.  Bytes:
    the rows and the last 20 words read, and per seed-step the 4 + 16
    words of ms and Ps (full) or 2 (slim) written."""
    d = _D
    itemsize = torch.empty((), dtype=dtype).element_size()
    step = ((53 + 64) * S + _householder_flop(S, d) + _joint_flop() + 64
            + 116)
    maps = 36 + 40
    steps, rows = T * B, (T - 1) * B
    last = d + d * d
    return {
        "fused_forward": SmootherCost(
            step * steps + maps * rows,
            itemsize * (2 * steps + ROW_WORDS * rows + last * B)),
        "fused_forward_factors": SmootherCost(
            step * steps, itemsize * ((2 + last) * steps + ROW_WORDS * rows)),
        "affine_backward": SmootherCost(
            (36 + 128 + 90) * rows + 40 * B,
            itemsize * (ROW_WORDS * rows + last * B + last * steps)),
        "affine_backward_slim": SmootherCost(
            (36 + 128 + 90) * rows + 40 * B,
            itemsize * (ROW_WORDS * rows + last * B + 2 * steps)),
    }


ghfs_chirp_filter_smoother.launches = 0
# Launches of each CUDA kernel of the wrapper (F once per call, then G or
# the smoother's phase B once).
ghfs_chirp_filter_smoother.kernel_launches = dict.fromkeys(KERNELS, 0)
