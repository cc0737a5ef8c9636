"""Square-root GHFS smoother for the chirp model (d=4), with the
Gauss-Hermite expectation of ``g(V)`` as its epilogue: the hand-written
CUDA kernel ``csrc/ghfs_chirp_smoother.cu`` and its plain PyTorch version.

It replaces no Pallas kernel: on the JAX package's main path
(``chirpgp_tpu.apps.pipeline.estimate_if_batched``) the smoother is an
XLA-compiled reverse ``lax.scan`` (``chirpgp_tpu.infer.batched.
sqrt_sgp_smoother_batched``) followed by ``gaussian_expectation_batched``;
the port's plain versions of both are eager loops of small launches.
:func:`ghfs_chirp_smoother` runs the plain versions for tensors on the
CPU and the kernel for tensors on a CUDA device; there is no fallback from
one to the other, and no gradient.  It reads the filter's outputs
(:func:`~chirpgp_tpu_torch.ops.chirp_filter.ghfs_chirp_filter`) as they
are, takes the filter's params (La Scala through
:func:`~chirpgp_tpu_torch.ops.chirp_filter.lascala_chirp_params`), its
model constants and its launch geometry.  :func:`smoother_cost` counts
the least work of the call.
"""

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from chirpgp_tpu_torch.infer.batched import (
    smoothed_expectation_batched, sqrt_sgp_smoother_batched)
from chirpgp_tpu_torch.infer.sqrt import _require_nonneg_weights
from chirpgp_tpu_torch.ops.chirp_filter import (
    MAX_POINTS, MAX_THREADS, _chirp_constants, _chirp_pack, launch_geometry)
from chirpgp_tpu_torch.quad.sigma_points import SigmaPoints, gauss_hermite

__all__ = ["ghfs_chirp_smoother", "ghfs_chirp_smoother_kernel",
           "ghfs_chirp_smoother_reference", "load_smoother_kernel",
           "smoother_cost", "smoother_kernel_launcher"]

_D = 4
_V = 2   # the state V whose g is the frequency (kV in csrc/chirp_lcd.cuh)
_KERNEL = "ghfs_chirp_smoother"
# The epilogue's cap on Gauss-Hermite nodes (csrc/ghfs_chirp_smoother.cu).
MAX_NODES = 32


def ghfs_chirp_smoother_reference(params, dt, sgps: SigmaPoints,
                                  mfs: torch.Tensor, Lfs: torch.Tensor,
                                  if_order: int):
    """The plain version: ``sqrt_sgp_smoother_batched`` on the chirp model
    built from ``params`` in float64 on the host (constants cast to
    ``mfs.dtype``), then ``smoothed_expectation_batched`` of ``g(V)``.
    Same contract as :func:`ghfs_chirp_smoother`."""
    pack = _chirp_pack(params, None)
    mss, Lss = sqrt_sgp_smoother_batched(pack.m_and_cov, sgps, mfs, Lfs,
                                         float(dt))
    return mss, Lss, smoothed_expectation_batched(mss, Lss, _V, if_order)


def _check(sgps: SigmaPoints, mfs, Lfs, if_order):
    """The inputs both versions take; raises ``ValueError`` otherwise."""
    _require_nonneg_weights(sgps, "ghfs_chirp_smoother")
    if sgps.d != _D:
        raise ValueError(f"the chirp smoother is d={_D} only, got a "
                         f"d={sgps.d} rule")
    if sgps.n_points > MAX_POINTS:
        raise ValueError(f"the smoother takes 1..{MAX_POINTS} sigma points, "
                         f"got S={sgps.n_points}")
    if mfs.requires_grad or Lfs.requires_grad:
        raise ValueError("ghfs_chirp_smoother has no gradient; pass filter "
                         "outputs that do not require grad")
    if mfs.dtype not in (torch.float32, torch.float64) \
            or Lfs.dtype != mfs.dtype:
        raise ValueError(f"mfs and Lfs must both be float32 or float64, got "
                         f"{mfs.dtype} and {Lfs.dtype}")
    if mfs.device != Lfs.device:
        raise ValueError(f"mfs on {mfs.device}, Lfs on {Lfs.device}")
    if mfs.dim() != 3 or mfs.shape[1] != _D or mfs.shape[0] < 1:
        raise ValueError(f"mfs must be (T, {_D}, B) with T >= 1, got shape "
                         f"{tuple(mfs.shape)}")
    T, _, B = mfs.shape
    if tuple(Lfs.shape) != (T, _D, _D, B):
        raise ValueError(f"Lfs must be (T, {_D}, {_D}, B) = "
                         f"{(T, _D, _D, B)}, got {tuple(Lfs.shape)}")
    if not 1 <= if_order <= MAX_NODES:
        raise ValueError(f"if_order must be in 1..{MAX_NODES}, got {if_order}")


def ghfs_chirp_smoother(params, dt, sgps: SigmaPoints, mfs: torch.Tensor,
                        Lfs: torch.Tensor, if_order: int):
    """Sqrt GHFS smoother for the chirp model (d=4) over the filter's
    outputs, with the IF expectation ``E[g(V)]`` of each smoothed step.

    Parameters
    ----------
    params : 6 constrained values ``[lam, b, delta, ell, sigma, m0_v]``,
        those the filter ran with.
    dt : float.
    sgps : sigma-point rule for d=4 with nonnegative weights, S <= 81.
    mfs, Lfs : the filter's ``(T, 4, B)`` means and ``(T, 4, 4, B)`` lower
        factors, float32 or float64, T >= 1.
    if_order : the order K <= 32 of the Gauss-Hermite rule of ``E[g(V)]``,
        ``V ~ N(ms[2], |row 2 of Ls|^2)``: V is the chirp model's state 2,
        whose ``g`` is the frequency.

    Returns ``(mss (T, 4, B), Lss (T, 4, 4, B) lower, if_mean (T, B))`` in
    ``mfs.dtype`` on ``mfs.device``: the contract of
    ``sqrt_sgp_smoother_batched`` and ``smoothed_expectation_batched``.
    Row T-1 is the filter's.  CPU tensors run the plain version; CUDA
    tensors launch the kernel (built on first use) or raise.
    ``ghfs_chirp_smoother.launches`` counts the kernel launches.
    """
    _check(sgps, mfs, Lfs, if_order)
    if mfs.device.type == "cpu":
        return ghfs_chirp_smoother_reference(params, dt, sgps, mfs, Lfs,
                                             if_order)
    if mfs.device.type != "cuda":
        raise ValueError(f"ghfs_chirp_smoother runs on cpu or cuda tensors, "
                         f"got {mfs.device}")
    return ghfs_chirp_smoother_kernel(params, dt, sgps, mfs, Lfs, if_order)


def ghfs_chirp_smoother_kernel(params, dt, sgps: SigmaPoints,
                               mfs: torch.Tensor, Lfs: torch.Tensor,
                               if_order: int, team: Optional[int] = None):
    """The kernel alone, for CUDA tensors: :func:`ghfs_chirp_smoother` with
    the team size ``team`` (8 or 32; ``None`` lets ``launch_geometry``
    choose it)."""
    launch, outputs = smoother_kernel_launcher(params, dt, sgps, mfs, Lfs,
                                               if_order, team)
    launch()
    return outputs


def load_smoother_kernel():
    """Build (on first use) and load the kernel library, with the C
    signatures declared.  Returns ``_build.BuiltLibrary``."""
    from chirpgp_tpu_torch.ops._build import load_library
    built = load_library(_KERNEL)
    lib = built.lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ghfs_chirp_smoother_f32, lib.ghfs_chirp_smoother_f64):
        fn.argtypes = ([ptr] * 7 + [ctypes.POINTER(ctypes.c_double)]
                       + [i32] * 7 + [ptr] * 4)
        fn.restype = i32
    for fn in (lib.ghfs_chirp_smoother_max_points,
               lib.ghfs_chirp_smoother_max_nodes,
               lib.ghfs_chirp_smoother_num_consts,
               lib.ghfs_chirp_smoother_max_threads):
        fn.argtypes = []
        fn.restype = i32
    if (lib.ghfs_chirp_smoother_max_points() != MAX_POINTS
            or lib.ghfs_chirp_smoother_max_nodes() != MAX_NODES
            or lib.ghfs_chirp_smoother_max_threads() != MAX_THREADS):
        raise RuntimeError("the smoother kernel's limits do not match the "
                           "wrapper's")
    return built


def smoother_kernel_launcher(params, dt, sgps: SigmaPoints,
                             mfs: torch.Tensor, Lfs: torch.Tensor,
                             if_order: int, team: Optional[int] = None):
    """Check the inputs of :func:`ghfs_chirp_smoother_kernel`, build the
    kernel, its constants and its outputs, and return ``(launch,
    outputs)``: each ``launch()`` runs the kernel once on the current
    stream, writes the outputs and counts the launch.  It does no host work
    besides the ctypes call, so CUDA events around it time the kernel
    alone."""
    _check(sgps, mfs, Lfs, if_order)
    if mfs.device.type != "cuda":
        raise ValueError(f"the ghfs_chirp_smoother kernel runs on cuda "
                         f"tensors; a cpu tensor takes the plain version; "
                         f"got {mfs.device}")
    if not (mfs.is_contiguous() and Lfs.is_contiguous()):
        raise ValueError("the smoother kernel takes contiguous mfs and Lfs")
    T, _, B = mfs.shape
    S = sgps.n_points
    num_sms = torch.cuda.get_device_properties(mfs.device).multi_processor_count
    geo = launch_geometry(B, S, num_sms, team)

    lib = load_smoother_kernel().lib
    # Xi is not read by the smoother: the filter's layout with sqrt(Xi) = 1.
    consts = _chirp_constants(params, 1.0, dt)
    if consts.size != lib.ghfs_chirp_smoother_num_consts():
        raise RuntimeError("model constants do not match the kernel's layout")

    like = dict(dtype=mfs.dtype, device=mfs.device)
    xi = torch.as_tensor(np.ascontiguousarray(sgps.xi), **like)
    w = torch.as_tensor(np.asarray(sgps.w), **like)
    sw = torch.sqrt(w)
    gh = gauss_hermite(1, if_order)
    ghx = torch.as_tensor(np.ascontiguousarray(gh.xi[:, 0]), **like)
    ghw = torch.as_tensor(np.asarray(gh.w), **like)
    mss = torch.empty((T, _D, B), **like)
    lss = torch.empty((T, _D * _D, B), **like)
    if_mean = torch.empty((T, B), **like)
    c_consts = (ctypes.c_double * consts.size)(*consts.tolist())
    entry = getattr(lib, "ghfs_chirp_smoother_f32" if mfs.dtype ==
                    torch.float32 else "ghfs_chirp_smoother_f64")
    inputs = (mfs, Lfs, xi, w, sw, ghx, ghw)
    outputs = (mss, lss, if_mean)

    def launch():
        with torch.cuda.device(mfs.device):
            rc = entry(*[x.data_ptr() for x in inputs], c_consts, S,
                       if_order, T, B, geo.team, geo.rows,
                       geo.lanes_per_block, *[x.data_ptr() for x in outputs],
                       torch.cuda.current_stream(mfs.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ghfs_chirp_smoother kernel launch failed: "
                               f"CUDA error {rc}")
        ghfs_chirp_smoother.launches += 1

    return launch, (mss, lss.reshape(T, _D, _D, B), if_mean)


class SmootherCost(NamedTuple):
    flop: int    # floating-point operations of the whole call
    bytes: int   # each input read once, each output written once


def _householder_flop(n: int, m: int) -> int:
    """Flop of the Householder triangularization of a dense n x m array
    (n >= m) as the kernel does it: column j, c = m - j columns left: the
    Gram row, 2(n-j)c; alpha, |v|^2, beta, M_jj - alpha, 6; w_k, 2c; row j
    of R, 1 + 2c; beta w_k and the rank-one update of the columns k > j of
    the rows below j, (c-1)(1 + 2(n-j-1))."""
    return sum(2 * (n - j) * (m - j) + 6 + 4 * (m - j) + 1
               + (m - j - 1) * (1 + 2 * (n - j - 1)) for j in range(m))


def smoother_cost(S: int, T: int, B: int, dtype=torch.float32,
                  if_order: int = 10) -> SmootherCost:
    """Least work of one smoother call on ``B`` lanes of ``T`` steps with
    ``S`` sigma points: over the T - 1 smoothing steps, the lesser of the
    two square-root forms of the step below (an FMA is 2 flop; the 3
    transcendentals per sigma point and 2 per GH node are not counted).

    Both forms: per sigma point chi = mf + xi Lf with Lf lower, 10 FMA,
    20; the chirp-LCD mean, 17 (as ``filter_cost``); its weighted mean, 8;
    dev_pred = sqrt(w)(mu - mp), 8.  Then the gain by back-substitution,
    per column of R12 and row i, 2(3-i) + 1: 64; the mean update (ms - mp,
    G times it, + mf), 4 + 32 + 4; G Ls with Ls lower, 80; the dense 8 x 4
    triangularization, column j over m = 8 - j rows and c = 4 - j columns:
    the norm 2m, alpha and v_j 2, |v|^2 2m, beta 1, and per column w_k and
    the update 4m, m + 4m: 4m + 3 + c(6m).

    The kernel's form: dev_prev = sqrt(w)(chi - mf), 8 per point, and the
    Householder of the (S + 4) x 8 pre-array ``[[dev_pred, dev_prev],
    [Lq^T, 0]]``.  The projected form: a rule exact to degree two has
    ``sum w xi xi^T = I``, so Q = sqrt(w) xi has orthonormal columns and
    dev_prev = Q Lf^T; the same R comes from C = Q^T dev_pred, 32 per
    point, E = dev_pred - Q C, 32 per point, the Householder of the S x 4
    array E to R_E, and that of the 12 x 8 array ``[[C, Lf^T], [R_E, 0],
    [Lq^T, 0]]``.  The projected form is the lesser from S = 30 on (GH-3,
    S = 81: 14251 flop per step against 16433); the kernel's at cubature's
    S = 8 (2636 against 3374).

    The expectation, per step (T of them): the variance of V, 8, its
    sqrt, 1; per GH node the point, 2, softplus, 2, and the weighted sum,
    2.  Bytes: 4 + 16 words read and 4 + 16 + 1 written per seed-step."""
    d = _D
    tria = sum(4 * (8 - j) + 3 + (4 - j) * 6 * (8 - j) for j in range(d))
    tail = 64 + 40 + 80 + tria
    full = 61 * S + _householder_flop(S + d, 2 * d)
    projected = (117 * S + _householder_flop(S, d)
                 + _householder_flop(3 * d, 2 * d))
    per_step = min(full, projected) + tail
    per_row = 9 + 6 * if_order
    itemsize = torch.empty((), dtype=dtype).element_size()
    words = (d + d * d) * 2 + 1
    return SmootherCost((per_step * (T - 1) + per_row * T) * B,
                        itemsize * words * T * B)


ghfs_chirp_smoother.launches = 0
