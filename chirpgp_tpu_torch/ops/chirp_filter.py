"""Fused square-root GHFS filter for the chirp model (d=4, H = e_1): the
hand-written CUDA kernel ``csrc/ghfs_chirp_filter.cu`` and its plain
PyTorch version.

Counterpart of ``chirpgp_tpu.experimental.pallas_filter.ghfs_chirp_filter_pallas``,
with its signature and output contract minus the TPU grid knobs
(``chunk``, ``bblock``, ``interpret``).  :func:`ghfs_chirp_filter` runs
the plain version for a tensor on the CPU and the kernel for a tensor on
a CUDA device; there is no fallback from one to the other.  Neither has a
gradient: the objective differentiated through the filter, one parameter
vector per lane, is ``ops/chirp_filter_grad.py``'s, on this kernel's
per-lane instances and an adjoint kernel.  :func:`launch_geometry`
chooses the kernel's team size, rows and blocks, and :func:`filter_cost`
counts its work; both are plain Python.  The La Scala model is the chirp model at ``lam = b = 0``
(``models.chirp.disc_model_lascala_lcd``), so the same kernel filters it
with :func:`lascala_chirp_params`.  The optional ``m0`` replaces the
packed model's prior mean ``[0, 0, m0_v, 0]``: the filter-error Monte
Carlo (``apps/crlb.py``) starts from ``model_chirp``'s ``[0, 1, 0, 0]``.
"""

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from chirpgp_tpu_torch.infer.batched import sqrt_sgp_filter_batched
from chirpgp_tpu_torch.infer.sqrt import _require_nonneg_weights
from chirpgp_tpu_torch.models.chirp import build_chirp_model
from chirpgp_tpu_torch.models.matern import m32_solution
from chirpgp_tpu_torch.quad.sigma_points import SigmaPoints
from chirpgp_tpu_torch.utils.numerics import psd_cholesky

__all__ = ["LaunchGeometry", "filter_cost", "ghfs_chirp_filter",
           "ghfs_chirp_filter_kernel", "ghfs_chirp_filter_reference",
           "kernel_launcher", "lascala_chirp_params", "launch_geometry",
           "load_kernel"]

_D = 4
_KERNEL = "ghfs_chirp_filter"
# The kernel's limits (csrc/ghfs_chirp_filter.cu): the team sizes and, for
# each, the pre-array rows per member it is built for (those of cubature
# and GH-3 at d = 4, the rules of Table I); threads per block; sigma points.
TEAMS = (8, 32)
ROWS = {8: (2, 11), 32: (1, 3)}
MAX_THREADS = 256
MAX_POINTS = 81
_WARP = 32
# Resident blocks per SM on Hopper.
_MAX_BLOCKS_PER_SM = 32


class LaunchGeometry(NamedTuple):
    team: int              # threads per Monte-Carlo lane
    rows: int              # pre-array rows per team member
    lanes_per_block: int
    blocks: int


def _default_team(B: int, num_sms: int) -> int:
    """P = 32 up to 16 lanes per SM, where the step's latency bounds the
    time (the Table-I width, B = 100); P = 8, which repeats less work per
    lane, beyond (the benchmark's B = 4096).  Measured on an H100 with
    GH-3 (PERF.md)."""
    return 32 if B <= 16 * max(num_sms, 1) else 8


def launch_geometry(B: int, S: int, num_sms: int = 132,
                    team: Optional[int] = None) -> LaunchGeometry:
    """The kernel's launch geometry for ``B`` lanes and ``S`` sigma points
    on a card with ``num_sms`` SMs.

    Up to one lane per SM, every lane gets a block of its own, so a small
    batch spreads over the SMs.  Beyond that a block is one warp of lanes
    (``32 // team``), grown only when the SMs could not hold all blocks at
    once.  ``team`` defaults to :func:`_default_team`; the rows are the
    fewest built for that team that hold the S + 4 rows of the pre-array.
    """
    team = _default_team(B, num_sms) if team is None else team
    if team not in TEAMS:
        raise ValueError(f"team must be one of {TEAMS}, got {team}")
    if not 1 <= S <= MAX_POINTS:
        raise ValueError(f"the kernel takes 1..{MAX_POINTS} sigma points, "
                         f"got S={S}")
    rows = min(r for r in ROWS[team] if team * r >= S + _D)
    per_warp = _WARP // team
    if B <= num_sms:
        lanes = 1
    else:
        warps = -(-B // per_warp)
        lanes = per_warp * -(-warps // (num_sms * _MAX_BLOCKS_PER_SM))
        lanes = min(lanes, MAX_THREADS // team)
    return LaunchGeometry(team, rows, lanes, -(-B // lanes))


class FilterCost(NamedTuple):
    flop: int    # floating-point operations of the whole call
    bytes: int   # each input read once, each output written once


def filter_cost(S: int, T: int, B: int, dtype=torch.float32) -> FilterCost:
    """Work of one filter call on ``B`` lanes of ``T`` steps with ``S``
    sigma points: the flop the step needs (an FMA is 2 flop; the 3
    transcendentals per sigma point are not counted), not the kernel's
    redundant work.  Per sigma point: chi = m + xi L with L lower, 10 FMA,
    20; the chirp-LCD mean (softplus 2, angle 1, decay 2, rotation 6,
    Matern step 6), 17; its weighted mean, 8, and deviation sqrt(w)(mu -
    mp), 8.  Householder column j of the n = S + 4 row pre-array: the
    Gram row, 2(n-j)(d-j); alpha, |v|^2, beta, M_jj - alpha, 6; w_k,
    2(d-j); row j of R, 1 + 2(d-j); beta w_k and the rank-one update of
    columns k > j of the rows below j, (d-j-1)(1 + 2(n-j-1)).  The 5 x 5
    update: reflections over rows 0..2 and 1..2 of the trailing 4 and 3
    columns, each m rows by c columns 2m + 5 + c(4m + 1), 99 (the
    one-row reflections are negations); innovation, mean update and nll,
    17.  Bytes: one y read and 4 + 16 + 1 words written per seed-step."""
    d, n = _D, S + _D
    householder = sum(2 * (n - j) * (d - j) + 6 + 2 * (d - j)
                      + 1 + 2 * (d - j) + (d - j - 1) * (1 + 2 * (n - j - 1))
                      for j in range(d))
    per_step = (20 + 17 + 8 + 8) * S + householder + 99 + 17
    itemsize = torch.empty((), dtype=dtype).element_size()
    words = 1 + d + d * d + 1
    return FilterCost(per_step * T * B, itemsize * words * T * B)


def lascala_chirp_params(params) -> torch.Tensor:
    """The chirp params ``[0, 0, delta, ell, sigma, m0_v]`` of La Scala's
    ``[delta, ell, sigma, m0_v]``: no damping and no noise on the pair,
    which is the La Scala model exactly (decay ``exp(0) = 1``, pair
    variance ``ou_variance(0, 0, dt) = 0``, same ``m0``, ``P0`` and
    ``H``).  Keeps the dtype and device of a tensor."""
    p = torch.as_tensor(params)
    if p.shape != (4,):
        raise ValueError(f"La Scala params must hold 4 values, got shape "
                         f"{tuple(p.shape)}")
    return torch.cat([p.new_zeros(2), p])


def _host_params(params) -> torch.Tensor:
    """The 6 constrained params ``[lam, b, delta, ell, sigma, m0_v]`` as a
    float64 host tensor."""
    if isinstance(params, torch.Tensor):
        if params.requires_grad:
            raise ValueError("ghfs_chirp_filter has no gradient (the "
                             "differentiable objective is ops.chirp_filter_"
                             "grad.chirp_filter_nll); pass params that do "
                             "not require grad")
        p = params.detach().to("cpu", torch.float64)
    else:
        p = torch.from_numpy(np.array(params, np.float64))
    if p.shape != (6,):
        raise ValueError(f"params must hold 6 values, got shape {tuple(p.shape)}")
    return p


def _host_m0(m0) -> Optional[torch.Tensor]:
    """The 4 values of a prior mean ``m0`` as a float64 host tensor, or
    ``None``."""
    if m0 is None:
        return None
    m = torch.as_tensor(m0).detach().to("cpu", torch.float64)
    if m.shape != (_D,):
        raise ValueError(f"m0 must hold {_D} values, got shape {tuple(m.shape)}")
    return m


def _chirp_pack(params, m0):
    """``build_chirp_model`` of ``params`` in float64 on the host, with its
    prior mean replaced by ``m0`` unless that is ``None``."""
    pack = build_chirp_model(_host_params(params))
    m0 = _host_m0(m0)
    return pack if m0 is None else pack._replace(m0=m0)


def _chirp_constants(params, Xi, dt, m0=None) -> np.ndarray:
    """The kernel's model constants, in float64 on the host and in the
    order the kernel reads them: F32 (2x2), Lq^T (4x4), L0 (4x4), m0 (4),
    exp(-lam dt), sqrt(Xi), dt."""
    p = _host_params(params)
    pack = _chirp_pack(p, m0)
    F32, _ = m32_solution(p[3], p[4], float(dt))
    Lq = psd_cholesky(pack.m_and_cov.cov_const(float(dt)))
    L0 = torch.linalg.cholesky(pack.P0)
    scalars = [math.exp(-float(p[0]) * float(dt)), math.sqrt(float(Xi)),
               float(dt)]
    return np.concatenate([F32.reshape(-1).numpy(), Lq.T.reshape(-1).numpy(),
                           L0.reshape(-1).numpy(), pack.m0.numpy(), scalars])


def ghfs_chirp_filter_reference(params, Xi, dt, sgps: SigmaPoints,
                                yss: torch.Tensor, m0=None
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The plain version: the chirp model built from ``params`` in float64
    on the host, run through ``sqrt_sgp_filter_batched``, which casts its
    constants to ``yss.dtype``.  Same contract as :func:`ghfs_chirp_filter`."""
    pack = _chirp_pack(params, m0)
    return sqrt_sgp_filter_batched(pack.m_and_cov, sgps, pack.H, float(Xi),
                                   pack.m0, pack.P0, float(dt), yss)


def load_kernel():
    """Build (on first use) and load the kernel library, with the C
    signatures declared.  Returns ``_build.BuiltLibrary``."""
    from chirpgp_tpu_torch.ops._build import load_library
    built = load_library(_KERNEL)
    lib = built.lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ghfs_chirp_filter_f32, lib.ghfs_chirp_filter_f64):
        fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.POINTER(ctypes.c_double),
                       i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr]
        fn.restype = i32
    # The per-lane instances (ops/chirp_filter_grad.py): the constants a
    # (B, 43) tensor on the card.
    for fn in (lib.ghfs_chirp_filter_lanes_f32,
               lib.ghfs_chirp_filter_lanes_f64):
        fn.argtypes = [ptr] * 5 + [i32] * 6 + [ptr] * 4
        fn.restype = i32
    for fn in (lib.ghfs_chirp_filter_max_points,
               lib.ghfs_chirp_filter_num_consts,
               lib.ghfs_chirp_filter_max_threads):
        fn.argtypes = []
        fn.restype = i32
    if (lib.ghfs_chirp_filter_max_points() != MAX_POINTS
            or lib.ghfs_chirp_filter_max_threads() != MAX_THREADS):
        raise RuntimeError("the kernel's limits do not match the wrapper's")
    return built


def ghfs_chirp_filter(params, Xi, dt, sgps: SigmaPoints, yss: torch.Tensor,
                      m0=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused sqrt GHFS filter for the chirp model (d=4, H = e_1).

    Parameters
    ----------
    params : 6 constrained values ``[lam, b, delta, ell, sigma, m0_v]``.
    Xi, dt : floats.
    sgps : sigma-point rule for d=4 with nonnegative weights.
    yss : (B, T) float32 or float64 measurements.
    m0 : optional 4 values that replace the prior mean ``[0, 0, m0_v, 0]``
        of ``build_chirp_model(params)``; ``P0`` stays the model's.

    Returns ``(mfs (T, 4, B), Lfs (T, 4, 4, B) lower, nll (T, B)
    cumulative)`` in ``yss.dtype`` on ``yss.device`` -- the contract of
    ``sqrt_sgp_filter_batched``.  A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel (built on first use) or raises.
    ``ghfs_chirp_filter.launches`` counts the kernel launches.
    """
    if yss.requires_grad:
        raise ValueError("ghfs_chirp_filter has no gradient; pass yss "
                         "that does not require grad")
    if yss.device.type == "cpu":
        return ghfs_chirp_filter_reference(params, Xi, dt, sgps, yss, m0)
    if yss.device.type != "cuda":
        raise ValueError(f"ghfs_chirp_filter runs on cpu or cuda tensors, "
                         f"got {yss.device}")
    return ghfs_chirp_filter_kernel(params, Xi, dt, sgps, yss, m0=m0)


def ghfs_chirp_filter_kernel(params, Xi, dt, sgps: SigmaPoints,
                             yss: torch.Tensor, team: Optional[int] = None,
                             m0=None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The kernel alone, for a CUDA tensor ``yss``: :func:`ghfs_chirp_filter`
    with the team size ``team`` (8 or 32; ``None`` lets
    :func:`launch_geometry` choose it), and without its gradient check:
    the outputs never carry one."""
    launch, outputs = kernel_launcher(params, Xi, dt, sgps, yss, team, m0)
    launch()
    return outputs


def kernel_launcher(params, Xi, dt, sgps: SigmaPoints, yss: torch.Tensor,
                    team: Optional[int] = None, m0=None):
    """Check the inputs of :func:`ghfs_chirp_filter_kernel`, build the
    kernel, its constants and its outputs, and return ``(launch,
    (mfs, Lfs, nll))``: each ``launch()`` runs the kernel once on the
    current stream, writes the outputs and counts the launch.  It does no
    host work besides the ctypes call, so CUDA events around it time the
    kernel alone."""
    if yss.device.type != "cuda":
        raise ValueError(f"the ghfs_chirp_filter kernel runs on cuda "
                         f"tensors; a cpu tensor takes the plain version; "
                         f"got {yss.device}")
    _require_nonneg_weights(sgps, "ghfs_chirp_filter")
    if sgps.d != _D:
        raise ValueError(f"the chirp kernel is d={_D} only, got a d={sgps.d} rule")
    if yss.dim() != 2:
        raise ValueError(f"yss must be (B, T), got shape {tuple(yss.shape)}")
    if yss.dtype == torch.float32:
        suffix = "f32"
    elif yss.dtype == torch.float64:
        suffix = "f64"
    else:
        raise ValueError(f"yss must be float32 or float64, got {yss.dtype}")
    B, T = yss.shape
    S = sgps.n_points
    num_sms = torch.cuda.get_device_properties(yss.device).multi_processor_count
    geo = launch_geometry(B, S, num_sms, team)

    lib = load_kernel().lib
    consts = _chirp_constants(params, Xi, dt, m0)
    if consts.size != lib.ghfs_chirp_filter_num_consts():
        raise RuntimeError("model constants do not match the kernel's layout")

    like = dict(dtype=yss.dtype, device=yss.device)
    ys_t = yss.T.contiguous()                               # (T, B)
    xi = torch.as_tensor(np.ascontiguousarray(sgps.xi), **like)
    w = torch.as_tensor(np.asarray(sgps.w), **like)
    sw = torch.sqrt(w)
    mfs = torch.empty((T, _D, B), **like)
    lfs = torch.empty((T, _D * _D, B), **like)
    nll = torch.empty((T, B), **like)
    c_consts = (ctypes.c_double * consts.size)(*consts.tolist())
    entry = getattr(lib, f"ghfs_chirp_filter_{suffix}")
    inputs, outputs = (ys_t, xi, w, sw), (mfs, lfs, nll)

    def launch():
        with torch.cuda.device(yss.device):
            rc = entry(*[x.data_ptr() for x in inputs], c_consts, S, T, B,
                       geo.team, geo.rows, geo.lanes_per_block,
                       *[x.data_ptr() for x in outputs],
                       torch.cuda.current_stream(yss.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ghfs_chirp_filter kernel launch failed: "
                               f"CUDA error {rc}")
        ghfs_chirp_filter.launches += 1

    return launch, (mfs, lfs.reshape(T, _D, _D, B), nll)


ghfs_chirp_filter.launches = 0
