"""End-to-end IF estimation with one typed config (counterpart of
``chirpgp_tpu.apps.pipeline``).

``make_nll_fn`` (theta -> filter NLL) -> :func:`fit_mle` ->
:func:`estimate_if` (filter + smooth + Gaussian expectation of g(V)), and
:func:`run_pipeline` for all three; :func:`estimate_if_batched` for a
batch of Monte-Carlo records at fixed hyperparameters.

Measurements given as tensors stay where they are; anything else (NumPy
arrays, lists) becomes a tensor on ``device``, the card unless the caller
passes ``device="cpu"``.
"""

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from chirpgp_tpu_torch.fit.mle import MLEResult, lbfgs_minimize, scipy_minimize
from chirpgp_tpu_torch.infer import (
    ekf, eks, sgp_filter, sgp_smoother, cd_ekf, cd_eks, cd_sgp_filter,
    cd_sgp_smoother, sqrt_ekf, sqrt_eks, sqrt_sgp_filter, sqrt_sgp_smoother)
from chirpgp_tpu_torch.infer.batched import (
    smoothed_expectation_batched, sqrt_sgp_filter_batched,
    sqrt_sgp_smoother_batched)
from chirpgp_tpu_torch.models.bijections import g, g_inv
from chirpgp_tpu_torch.models.chirp import (
    build_chirp_model, build_harmonic_chirp_model, build_lascala_model)
from chirpgp_tpu_torch.ops.chirp_filter import (
    MAX_POINTS, ghfs_chirp_filter, lascala_chirp_params)
from chirpgp_tpu_torch.ops.chirp_filter_grad import (
    chirp_filter_nll, chirp_lane_constants)
from chirpgp_tpu_torch.ops.chirp_smoother import ghfs_chirp_smoother
from chirpgp_tpu_torch.quad.expectations import gaussian_expectation_1d
from chirpgp_tpu_torch.quad.sigma_points import (
    SigmaPoints, cubature, gauss_hermite, unscented)

__all__ = ["IFEstimationConfig", "make_nll_fn", "fit_mle", "estimate_if",
           "run_pipeline", "estimate_if_batched"]


@dataclasses.dataclass(frozen=True)
class IFEstimationConfig:
    """Experiment contract for one IF-estimation run; the fields of the
    JAX package's config.  Defaults reproduce the canonical toymodel setup:
    dt=1e-3, Xi=0.1, GH order 3, init theta = g^{-1}([0.1, 0.1, 0.1, 1, 1, 7]).
    Every method runs for every model; the continuous-discrete ones
    (``cd_ghfs``, ``cd_ekfs``) in the covariance form only, as in the JAX
    package.  ``scan_unroll`` is carried for the JAX package's signature
    and has no effect on a Python loop.
    """

    dt: float = 1e-3
    Xi: float = 0.1
    method: str = "ghfs"          # ghfs | ekfs | cd_ghfs | cd_ekfs
    model: str = "chirp"          # chirp | harmonic | lascala
    num_harmonics: int = 1
    freq_scale: float = 1.0
    quadrature: str = "gauss_hermite"   # gauss_hermite | cubature | unscented
    gh_order: int = 3
    optimizer: str = "scipy"      # scipy | lbfgs
    max_iters: int = 200
    chunk_iters: int = 0
    ftol_rel: float = 1e-9
    stall_patience: int = 10
    expectation_order: int = 10   # GH order for E[g(V)]
    form: str = "cov"             # cov | sqrt
    scan_unroll: int = 1

    def state_dim(self) -> int:
        return 2 * self.num_harmonics + 2 if self.model == "harmonic" else 4

    def sigma_points(self) -> SigmaPoints:
        d = self.state_dim()
        if self.quadrature == "gauss_hermite":
            return gauss_hermite(d, order=self.gh_order)
        if self.quadrature == "cubature":
            return cubature(d)
        if self.quadrature == "unscented":
            return unscented(d)
        raise ValueError(f"Unknown quadrature {self.quadrature!r}")

    def build(self, params):
        if self.model == "chirp":
            return build_chirp_model(params)
        if self.model == "harmonic":
            return build_harmonic_chirp_model(
                params, num_harmonics=self.num_harmonics,
                freq_scale=self.freq_scale)
        if self.model == "lascala":
            return build_lascala_model(params)
        raise ValueError(f"Unknown model {self.model!r}")

    def v_index(self) -> int:
        """The state component of the latent frequency V."""
        return self.state_dim() - 2 if self.model == "harmonic" else 2

    def default_init_theta(self, dtype=None) -> torch.Tensor:
        """``g_inv`` of the default constrained params, in ``dtype`` or
        else torch's default dtype (as the JAX package uses JAX's)."""
        if self.model == "lascala":
            return g_inv(torch.tensor([0.1, 1.0, 1.0, 7.0], dtype=dtype))
        return g_inv(torch.tensor([0.1, 0.1, 0.1, 1.0, 1.0, 7.0],
                                  dtype=dtype))


def _filter_fns(cfg: IFEstimationConfig):
    """(filter, smoother) closures ``(pack, ys) -> ...`` for the configured
    method.  In sqrt form the second moment returned is a Cholesky factor,
    not a covariance."""
    if cfg.method not in ("ghfs", "ekfs", "cd_ghfs", "cd_ekfs"):
        raise ValueError(f"Unknown method {cfg.method!r}")
    if cfg.form not in ("cov", "sqrt"):
        raise ValueError(f"Unknown form {cfg.form!r}")
    if cfg.form == "sqrt" and cfg.method not in ("ghfs", "ekfs"):
        raise ValueError(
            f"form='sqrt' supports methods ghfs/ekfs, got {cfg.method!r}")
    sgps = cfg.sigma_points() if cfg.method in ("ghfs", "cd_ghfs") else None

    if cfg.form == "sqrt" and cfg.method == "ghfs":
        def flt(pack, ys):
            return sqrt_sgp_filter(pack.m_and_cov, sgps, pack.H, cfg.Xi,
                                   pack.m0, pack.P0, cfg.dt, ys)

        def smt(pack, mfs, Lfs):
            return sqrt_sgp_smoother(pack.m_and_cov, sgps, mfs, Lfs, cfg.dt)
    elif cfg.form == "sqrt":
        def flt(pack, ys):
            return sqrt_ekf(pack.m_and_cov, pack.H, cfg.Xi, pack.m0,
                            pack.P0, cfg.dt, ys)

        def smt(pack, mfs, Lfs):
            return sqrt_eks(pack.m_and_cov, mfs, Lfs, cfg.dt)
    elif cfg.method == "ghfs":
        def flt(pack, ys):
            return sgp_filter(pack.m_and_cov, sgps, pack.H, cfg.Xi,
                              pack.m0, pack.P0, cfg.dt, ys)

        def smt(pack, mfs, Pfs):
            return sgp_smoother(pack.m_and_cov, sgps, mfs, Pfs, cfg.dt)
    elif cfg.method == "ekfs":
        def flt(pack, ys):
            return ekf(pack.m_and_cov, pack.H, cfg.Xi, pack.m0, pack.P0,
                       cfg.dt, ys)

        def smt(pack, mfs, Pfs):
            return eks(pack.m_and_cov, mfs, Pfs, cfg.dt)
    elif cfg.method == "cd_ghfs":
        # remat=True as in the JAX package (its reverse mode needs the step
        # checkpointing); a Python loop keeps every step's graph either way.
        def flt(pack, ys):
            return cd_sgp_filter(pack.drift, pack.dispersion(pack.m0), sgps,
                                 pack.H, cfg.Xi, pack.m0, pack.P0, cfg.dt,
                                 ys, remat=True, unroll=cfg.scan_unroll)

        def smt(pack, mfs, Pfs):
            return cd_sgp_smoother(pack.drift, pack.dispersion(pack.m0), sgps,
                                   mfs, Pfs, cfg.dt)
    else:
        # The chirp family's dispersion does not depend on the state, so it
        # is built once and not at every RK4 stage (the same values).
        def flt(pack, ys):
            B = pack.dispersion(pack.m0)
            return cd_ekf(pack.drift, lambda _m: B, pack.H, cfg.Xi, pack.m0,
                          pack.P0, cfg.dt, ys, remat=True,
                          unroll=cfg.scan_unroll)

        def smt(pack, mfs, Pfs):
            B = pack.dispersion(pack.m0)
            return cd_eks(pack.drift, lambda _m: B, mfs, Pfs, cfg.dt)
    return flt, smt


def _measurements(ys, device) -> torch.Tensor:
    """A tensor as it is; anything else as a tensor on ``device`` (NumPy
    keeps its dtype, Python floats become float64)."""
    if isinstance(ys, torch.Tensor):
        return ys
    return torch.as_tensor(np.asarray(ys), device=device)


def _init_theta(cfg: IFEstimationConfig, init_theta, ys: torch.Tensor):
    """The caller's theta, or else the default one computed in the dtype
    it and the data promote to (float64 over float64 data, as the JAX
    package's default under x64), on the data's device."""
    if init_theta is None:
        init_theta = cfg.default_init_theta(
            torch.promote_types(torch.get_default_dtype(), ys.dtype))
    return _on_data(init_theta, ys)


def _on_data(x, ys: torch.Tensor) -> torch.Tensor:
    """``x`` (theta or params) on the measurements' device, in the dtype
    that ``x`` and ``ys`` promote to -- what the JAX package computes in
    under x64: float64 parameters make a float64 filter over float32
    data, and float32 ones over float32 data a float32 filter."""
    x = torch.as_tensor(x)
    dtype = torch.promote_types(x.dtype, ys.dtype)
    return x.to(dtype=dtype, device=ys.device)


def _kernel_objective(cfg: IFEstimationConfig) -> bool:
    """Whether ``make_nll_fn`` takes the per-lane filter kernels
    (``ops/chirp_filter_grad.py``): the square-root GHFS of the chirp
    model with a Gauss-Hermite or cubature rule of at most the kernels'
    ``MAX_POINTS`` points -- the ``ghfs`` and ``ckfs`` columns of Table
    I.  Every other configuration runs the eager filter."""
    return (cfg.method == "ghfs" and cfg.form == "sqrt"
            and cfg.model == "chirp"
            and cfg.quadrature in ("gauss_hermite", "cubature")
            and cfg.sigma_points().n_points <= MAX_POINTS)


def make_nll_fn(cfg: IFEstimationConfig, ys, device="cuda") -> Callable:
    """The MLE objective: softplus-reparametrized params ``theta`` ->
    final filter NLL, differentiable with ``torch.autograd`` and
    ``torch.func``.  Runs on ``ys``' device (theta is moved there).

    The square-root GHFS of the chirp model (:func:`_kernel_objective`)
    builds the lane's model constants from ``theta`` and evaluates
    ``ops.chirp_filter_grad.chirp_filter_nll``: on a CUDA tensor the
    forward kernel and, for the gradient, the adjoint kernel, one launch
    each for all the lanes of a ``torch.func.vmap``; on the CPU their
    plain versions.  Every other configuration runs its eager filter."""
    flt, _ = _filter_fns(cfg)
    ys = _measurements(ys, device)
    if _kernel_objective(cfg):
        sgps = cfg.sigma_points()

        def kernel_nll(theta):
            theta = _on_data(theta, ys)
            consts = chirp_lane_constants(g(theta), cfg.Xi, cfg.dt)
            return chirp_filter_nll(consts, ys.to(consts.dtype), sgps)

        return kernel_nll

    def nll(theta):
        theta = _on_data(theta, ys)
        pack = cfg.build(g(theta))
        return flt(pack, ys)[2][-1]

    return nll


def fit_mle(cfg: IFEstimationConfig, ys, init_theta=None,
            device="cuda") -> MLEResult:
    """Maximize the filter-marginal likelihood, each value-and-grad on
    ``ys``' device.  ``optimizer="scipy"``: host SciPy L-BFGS-B in float64,
    the result on the host.  ``optimizer="lbfgs"``: :func:`lbfgs_minimize`
    (``chunk_iters`` if nonzero) in the dtype theta and the data promote
    to, the result on ``ys``' device.  Returns the result in theta
    (unconstrained) space."""
    if cfg.optimizer not in ("scipy", "lbfgs"):
        raise ValueError(f"Unknown optimizer {cfg.optimizer!r}")
    ys = _measurements(ys, device)
    init_theta = _init_theta(cfg, init_theta, ys)
    nll = make_nll_fn(cfg, ys)
    if cfg.optimizer == "lbfgs":
        return lbfgs_minimize(nll, init_theta, max_iters=cfg.max_iters,
                              chunk_iters=cfg.chunk_iters or None)
    return scipy_minimize(nll, init_theta,
                          options={"maxiter": cfg.max_iters})


def estimate_if(cfg: IFEstimationConfig, params, ys, device="cuda") -> dict:
    """Filter + smooth one record at fixed (constrained) params and push the
    V posterior through g.

    Returns dict with the filtering/smoothing moments (covariances, also in
    sqrt form), ``nell``, the IF posterior mean ``E[g(V_t)]`` (order
    ``expectation_order`` GH) and the 95% band endpoints mapped through g.
    """
    flt, smt = _filter_fns(cfg)
    ys = _measurements(ys, device)
    pack = cfg.build(_on_data(params, ys))
    mfs, Pfs, nell = flt(pack, ys)
    mss, Pss = smt(pack, mfs, Pfs)
    v_idx = cfg.v_index()
    v_mean = mss[:, v_idx]
    if cfg.form == "sqrt":
        # Second moments are Cholesky factors: var = ||row_v(L)||^2.
        v_std = torch.linalg.norm(Pss[:, v_idx, :], dim=-1)
        Pfs = Pfs @ Pfs.transpose(-1, -2)
        Pss = Pss @ Pss.transpose(-1, -2)
    else:
        v_std = torch.sqrt(Pss[:, v_idx, v_idx].clamp_min(0.0))
    if_mean = gaussian_expectation_1d(v_mean, v_std,
                                      order=cfg.expectation_order)
    if_mean = if_mean * cfg.freq_scale
    lo = g(v_mean - 1.96 * v_std) * cfg.freq_scale
    hi = g(v_mean + 1.96 * v_std) * cfg.freq_scale
    return dict(mfs=mfs, Pfs=Pfs, nell=nell, mss=mss, Pss=Pss,
                if_mean=if_mean, if_lower=lo, if_upper=hi)


def estimate_if_batched(cfg: IFEstimationConfig, params, yss,
                        device="cuda") -> dict:
    """Fixed-params IF estimation over a batch of sequences ``yss (B, T)``:
    a batched sqrt sigma-point filter, the batched sqrt smoother, and the
    order-``expectation_order`` Gauss-Hermite expectation of ``g(V)``.

    The model decides the path; neither falls back to the other.  The
    chirp and La Scala models (d = 4) run the fused chirp filter
    (``ops.chirp_filter.ghfs_chirp_filter``) and the chirp smoother with
    the expectation as its epilogue (``ops.chirp_smoother.
    ghfs_chirp_smoother``): for a CUDA tensor two kernel launches, on the
    CPU their plain versions; La Scala through the chirp params
    :func:`~chirpgp_tpu_torch.ops.chirp_filter.lascala_chirp_params`.  The
    harmonic model (d = 2K + 2 and another mean, beyond the chirp-only
    kernels) runs the plain ``sqrt_sgp_filter_batched``,
    ``sqrt_sgp_smoother_batched`` and ``smoothed_expectation_batched`` on
    either device; the filter's update takes a one-hot measurement vector:
    K = 1 only, as in the JAX package (at K > 1 it raises ``ValueError``).

    ``params`` are the constrained params of ``cfg.model``.  Returns dict
    with ``if_mean`` (B, T), ``nell`` (B,), ``mss`` (T, d, B) and ``Lss``
    (T, d, d, B).
    """
    yss = _measurements(yss, device)
    params = torch.as_tensor(params)
    sgps = cfg.sigma_points()
    if cfg.model == "harmonic":
        pack = cfg.build(params)
        mfs, Lfs, nll = sqrt_sgp_filter_batched(
            pack.m_and_cov, sgps, pack.H, cfg.Xi, pack.m0, pack.P0, cfg.dt,
            yss)
        mss, Lss = sqrt_sgp_smoother_batched(pack.m_and_cov, sgps, mfs, Lfs,
                                             cfg.dt)
        if_mean = smoothed_expectation_batched(
            mss, Lss, cfg.v_index(), order=cfg.expectation_order)
    else:
        chirp = params if cfg.model == "chirp" else lascala_chirp_params(params)
        mfs, Lfs, nll = ghfs_chirp_filter(chirp, cfg.Xi, cfg.dt, sgps, yss)
        mss, Lss, if_mean = ghfs_chirp_smoother(
            chirp, cfg.dt, sgps, mfs, Lfs, if_order=cfg.expectation_order)
    return dict(if_mean=(if_mean * cfg.freq_scale).T, nell=nll[-1], mss=mss,
                Lss=Lss)


def run_pipeline(cfg: IFEstimationConfig, ys,
                 init_theta: Optional[torch.Tensor] = None, device="cuda"):
    """MLE then estimation; returns (opt_result, constrained params,
    estimate dict).  A divergent optimization (success=False) still
    returns the estimate at the last iterate (the reference records such
    runs as NaN upstream)."""
    ys = _measurements(ys, device)
    opt = fit_mle(cfg, ys, init_theta)
    params = g(opt.params)
    est = estimate_if(cfg, params, ys)
    return opt, params, est
