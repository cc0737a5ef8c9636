"""Fused square-root GHFS filter for the chirp model (d=4, H = e_1): the
hand-written CUDA kernel ``csrc/ghfs_chirp_filter.cu`` and its plain
PyTorch version.

Counterpart of ``chirpgp_tpu.experimental.pallas_filter.ghfs_chirp_filter_pallas``,
with its signature and output contract minus the TPU grid knobs
(``chunk``, ``bblock``, ``interpret``).  :func:`ghfs_chirp_filter` runs
the plain version for a tensor on the CPU and the kernel for a tensor on
a CUDA device; there is no fallback from one to the other.  Neither has a
gradient yet.
"""

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from chirpgp_tpu_torch.infer.batched import sqrt_sgp_filter_batched
from chirpgp_tpu_torch.infer.sqrt import _require_nonneg_weights
from chirpgp_tpu_torch.models.chirp import build_chirp_model
from chirpgp_tpu_torch.models.matern import m32_solution
from chirpgp_tpu_torch.quad.sigma_points import SigmaPoints
from chirpgp_tpu_torch.utils.numerics import psd_cholesky

__all__ = ["ghfs_chirp_filter", "ghfs_chirp_filter_reference",
           "load_kernel"]

_D = 4
_KERNEL = "ghfs_chirp_filter"


def _host_params(params) -> torch.Tensor:
    """The 6 constrained params ``[lam, b, delta, ell, sigma, m0_v]`` as a
    float64 host tensor."""
    if isinstance(params, torch.Tensor):
        if params.requires_grad:
            raise ValueError("ghfs_chirp_filter has no gradient yet; pass "
                             "params that do not require grad")
        p = params.detach().to("cpu", torch.float64)
    else:
        p = torch.from_numpy(np.array(params, np.float64))
    if p.shape != (6,):
        raise ValueError(f"params must hold 6 values, got shape {tuple(p.shape)}")
    return p


def _chirp_constants(params, Xi, dt) -> np.ndarray:
    """The kernel's model constants, in float64 on the host and in the
    order the kernel reads them: F32 (2x2), Lq^T (4x4), L0 (4x4), m0 (4),
    exp(-lam dt), sqrt(Xi), dt."""
    p = _host_params(params)
    pack = build_chirp_model(p)
    F32, _ = m32_solution(p[3], p[4], float(dt))
    Lq = psd_cholesky(pack.m_and_cov.cov_const(float(dt)))
    L0 = torch.linalg.cholesky(pack.P0)
    scalars = [math.exp(-float(p[0]) * float(dt)), math.sqrt(float(Xi)),
               float(dt)]
    return np.concatenate([F32.reshape(-1).numpy(), Lq.T.reshape(-1).numpy(),
                           L0.reshape(-1).numpy(), pack.m0.numpy(), scalars])


def ghfs_chirp_filter_reference(params, Xi, dt, sgps: SigmaPoints,
                                yss: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The plain version: the chirp model built from ``params`` in float64
    on the host, run through ``sqrt_sgp_filter_batched``, which casts its
    constants to ``yss.dtype``.  Same contract as :func:`ghfs_chirp_filter`."""
    pack = build_chirp_model(_host_params(params))
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
                       i32, i32, i32, ptr, ptr, ptr, ptr]
        fn.restype = i32
    for fn in (lib.ghfs_chirp_filter_max_points,
               lib.ghfs_chirp_filter_num_consts):
        fn.argtypes = []
        fn.restype = i32
    return built


def ghfs_chirp_filter(params, Xi, dt, sgps: SigmaPoints, yss: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused sqrt GHFS filter for the chirp model (d=4, H = e_1).

    Parameters
    ----------
    params : 6 constrained values ``[lam, b, delta, ell, sigma, m0_v]``.
    Xi, dt : floats.
    sgps : sigma-point rule for d=4 with nonnegative weights.
    yss : (B, T) float32 or float64 measurements.

    Returns ``(mfs (T, 4, B), Lfs (T, 4, 4, B) lower, nll (T, B)
    cumulative)`` in ``yss.dtype`` on ``yss.device`` -- the contract of
    ``sqrt_sgp_filter_batched``.  A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel (built on first use) or raises.
    ``ghfs_chirp_filter.launches`` counts the kernel launches.
    """
    if yss.requires_grad:
        raise ValueError("ghfs_chirp_filter has no gradient yet; pass yss "
                         "that does not require grad")
    if yss.device.type == "cpu":
        return ghfs_chirp_filter_reference(params, Xi, dt, sgps, yss)
    if yss.device.type != "cuda":
        raise ValueError(f"ghfs_chirp_filter runs on cpu or cuda tensors, "
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

    lib = load_kernel().lib
    S = sgps.n_points
    if S > lib.ghfs_chirp_filter_max_points():
        raise ValueError(f"the kernel takes at most "
                         f"{lib.ghfs_chirp_filter_max_points()} sigma points, "
                         f"got S={S}")
    consts = _chirp_constants(params, Xi, dt)
    if consts.size != lib.ghfs_chirp_filter_num_consts():
        raise RuntimeError("model constants do not match the kernel's layout")

    B, T = yss.shape
    like = dict(dtype=yss.dtype, device=yss.device)
    ys_t = yss.T.contiguous()                               # (T, B)
    xi = torch.as_tensor(np.ascontiguousarray(sgps.xi), **like)
    w = torch.as_tensor(np.asarray(sgps.w), **like)
    sw = torch.sqrt(w)
    mfs = torch.empty((T, _D, B), **like)
    lfs = torch.empty((T, _D * _D, B), **like)
    nll = torch.empty((T, B), **like)
    c_consts = (ctypes.c_double * consts.size)(*consts.tolist())
    with torch.cuda.device(yss.device):
        stream = torch.cuda.current_stream(yss.device).cuda_stream
        rc = getattr(lib, f"ghfs_chirp_filter_{suffix}")(
            ys_t.data_ptr(), xi.data_ptr(), w.data_ptr(), sw.data_ptr(),
            c_consts, S, T, B, mfs.data_ptr(), lfs.data_ptr(),
            nll.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ghfs_chirp_filter kernel launch failed: CUDA "
                           f"error {rc}")
    ghfs_chirp_filter.launches += 1
    return mfs, lfs.reshape(T, _D, _D, B), nll


ghfs_chirp_filter.launches = 0
