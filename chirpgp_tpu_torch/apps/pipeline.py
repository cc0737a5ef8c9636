"""IF estimation at fixed hyperparameters over a batch of Monte-Carlo
records (counterpart of ``chirpgp_tpu.apps.pipeline``; the MLE half --
``make_nll_fn``, ``fit_mle``, ``estimate_if``, ``run_pipeline`` -- is
not ported yet).
"""

import dataclasses

import torch

from chirpgp_tpu_torch.infer.batched import (
    sqrt_sgp_smoother_batched, gaussian_expectation_batched)
from chirpgp_tpu_torch.models.bijections import g_inv
from chirpgp_tpu_torch.models.chirp import build_chirp_model
from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
from chirpgp_tpu_torch.quad.sigma_points import (
    SigmaPoints, cubature, gauss_hermite, unscented)

__all__ = ["IFEstimationConfig", "estimate_if_batched"]


@dataclasses.dataclass(frozen=True)
class IFEstimationConfig:
    """Experiment contract for one IF-estimation run; the fields of the
    JAX package's config.  Defaults reproduce the canonical toymodel setup:
    dt=1e-3, Xi=0.1, GH order 3, init theta = g^{-1}([0.1, 0.1, 0.1, 1, 1, 7]).
    Only ``model="chirp"`` is ported; ``method``, ``form``, ``optimizer``
    and the L-BFGS fields are carried for the MLE half, which is not.
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
        if self.model in ("harmonic", "lascala"):
            raise NotImplementedError(
                f"model={self.model!r} is not ported yet (later PR); the "
                "port runs model='chirp'")
        raise ValueError(f"Unknown model {self.model!r}")

    def default_init_theta(self) -> torch.Tensor:
        """``g_inv`` of the default constrained params, in torch's default
        dtype (as the JAX package uses JAX's)."""
        if self.model == "lascala":
            return g_inv(torch.tensor([0.1, 1.0, 1.0, 7.0]))
        return g_inv(torch.tensor([0.1, 0.1, 0.1, 1.0, 1.0, 7.0]))


def estimate_if_batched(cfg: IFEstimationConfig, params,
                        yss: torch.Tensor) -> dict:
    """Fixed-params IF estimation over a batch of sequences ``yss (B, T)``:
    the fused chirp filter (``ops.chirp_filter.ghfs_chirp_filter``: the
    CUDA kernel for a CUDA tensor, its plain version on the CPU), the
    batched sqrt smoother, and the order-``expectation_order``
    Gauss-Hermite expectation of ``g(V)``.

    ``params`` are the constrained ``[lam, b, delta, ell, sigma, m0_v]``.
    Returns dict with ``if_mean`` (B, T), ``nell`` (B,), ``mss``
    (T, d, B) and ``Lss`` (T, d, d, B).
    """
    if cfg.model != "chirp":
        raise NotImplementedError(
            f"estimate_if_batched: model={cfg.model!r} is not ported yet "
            "(later PR); the fused filter kernel is d=4 chirp only")
    params = torch.as_tensor(params)
    pack = cfg.build(params)
    sgps = cfg.sigma_points()
    mfs, Lfs, nll = ghfs_chirp_filter(params, cfg.Xi, cfg.dt, sgps, yss)
    mss, Lss = sqrt_sgp_smoother_batched(pack.m_and_cov, sgps, mfs, Lfs,
                                         cfg.dt)
    v_idx = 2
    v_mean = mss[:, v_idx, :]
    v_std = torch.sqrt(torch.einsum("tkb,tkb->tb", Lss[:, v_idx],
                                    Lss[:, v_idx]))
    if_mean = gaussian_expectation_batched(
        v_mean, v_std, order=cfg.expectation_order) * cfg.freq_scale
    return dict(if_mean=if_mean.T, nell=nll[-1], mss=mss, Lss=Lss)
