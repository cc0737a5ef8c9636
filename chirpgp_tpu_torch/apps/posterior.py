"""Bayesian hyperparameter posteriors over the filter-marginal likelihood
(counterpart of ``chirpgp_tpu.apps.posterior``): NUTS chains and SMC
marginal-likelihood estimates over the chirp model's hyperparameters, on
the same ``IFEstimationConfig`` pipelines as the point MLE.

Measurements given as tensors stay where they are; anything else becomes
a tensor on ``device``, the card unless the caller passes ``device="cpu"``.
"""

from typing import Optional

import torch

from chirpgp_tpu_torch.apps.pipeline import (
    IFEstimationConfig, _init_theta, _measurements, _on_data, make_nll_fn)
from chirpgp_tpu_torch.infer.nuts import (
    NUTSResult, nuts_sample, nuts_sample_sharded)
from chirpgp_tpu_torch.infer.smc import SMCDraws, bootstrap_filter
from chirpgp_tpu_torch.parallel.mesh import Mesh

__all__ = ["make_logposterior", "sample_hyperposterior",
           "sample_hyperposterior_sharded", "smc_nll"]


def make_logposterior(cfg: IFEstimationConfig, ys, prior_scale: float = 10.0,
                      device="cuda"):
    """Unnormalized log posterior over unconstrained theta:
    ``-filter_nll(g(theta)) + log N(theta; 0, prior_scale^2 I)``.  The weak
    Gaussian prior regularizes the directions the likelihood leaves flat.
    Runs on ``ys``' device, and under ``torch.func.vmap``."""
    nll = make_nll_fn(cfg, ys, device)

    def logpost(theta):
        return -nll(theta) - 0.5 * torch.sum((theta / prior_scale) ** 2)

    return logpost


def sample_hyperposterior(cfg: IFEstimationConfig, ys,
                          generator: Optional[torch.Generator] = None,
                          init_theta: Optional[torch.Tensor] = None,
                          num_samples: int = 500, num_warmup: int = 300,
                          device="cuda", **nuts_kwargs) -> NUTSResult:
    """NUTS over the hyperparameter posterior.  ``init_theta`` (p,) runs one
    chain, (C, p) C chains whose log densities are evaluated together in
    one batched call per leapfrog; the default is the config's init theta,
    in the dtype it and the data promote to, on the data's device.
    ``generator`` or ``draws`` (in ``nuts_kwargs``) as in
    :func:`~chirpgp_tpu_torch.infer.nuts.nuts_sample`."""
    ys = _measurements(ys, device)
    init_theta = _init_theta(cfg, init_theta, ys)
    return nuts_sample(make_logposterior(cfg, ys), init_theta, generator,
                       num_samples=num_samples, num_warmup=num_warmup,
                       **nuts_kwargs)


def sample_hyperposterior_sharded(cfg: IFEstimationConfig, ys,
                                  generator: Optional[torch.Generator],
                                  mesh: Mesh, num_chains: int,
                                  init_theta: Optional[torch.Tensor] = None,
                                  num_samples: int = 500,
                                  num_warmup: int = 300, jitter: float = 0.1,
                                  init_z: Optional[torch.Tensor] = None,
                                  **nuts_kwargs) -> NUTSResult:
    """Multi-chain NUTS over the hyperparameter posterior with the chains
    split over ``mesh``'s ranks and one step size adapted for all of them
    (:func:`~chirpgp_tpu_torch.infer.nuts.nuts_sample_sharded`).  The
    chains start at ``init_theta + jitter * init_z``, ``init_z``
    (num_chains, p) standard normals drawn from ``generator`` by default
    (seed it alike on every rank).  The data go to the mesh's device."""
    ys = _measurements(ys, mesh.device).to(mesh.device)
    init_theta = _init_theta(cfg, init_theta, ys)
    if init_z is None:
        init_z = torch.randn((num_chains,) + init_theta.shape,
                             generator=generator, dtype=init_theta.dtype,
                             device=generator.device)
    inits = init_theta + jitter * init_z.to(init_theta)
    return nuts_sample_sharded(make_logposterior(cfg, ys), inits, generator,
                               mesh, num_samples=num_samples,
                               num_warmup=num_warmup, **nuts_kwargs)


def smc_nll(cfg: IFEstimationConfig, params, ys,
            generator: Optional[torch.Generator] = None,
            num_particles: int = 1024, device="cuda",
            draws: Optional[SMCDraws] = None):
    """Particle (SMC) estimate of the negative log marginal likelihood at
    fixed constrained params -- an unbiased cross-check of the Gaussian
    filters' NLL.  Returns ``(nll, SMCResult)``."""
    ys = _measurements(ys, device)
    pack = cfg.build(_on_data(params, ys))
    res = bootstrap_filter(pack.m_and_cov, pack.H, cfg.Xi, pack.m0, pack.P0,
                           cfg.dt, ys, generator, num_particles=num_particles,
                           draws=draws)
    return -res.log_ml[-1], res
