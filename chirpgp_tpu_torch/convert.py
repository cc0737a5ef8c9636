"""Conversions from the JAX package's objects to the port's, so that both
packages can be fed the same inputs.  Duck-typed: nothing here imports
JAX; arrays go through NumPy."""

import numpy as np
import torch

from chirpgp_tpu_torch.quad.sigma_points import SigmaPoints

__all__ = ["params_from_jax", "rule_from_jax"]


def params_from_jax(params_np, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """Constrained params -- a row of ``results/reference/*.npz["params"]``
    or ``g(theta)`` of the JAX package, as any array-like, of any length:
    the 6 ``[lam, b, delta, ell, sigma, m0_v]`` of the chirp and harmonic
    models, the 4 ``[delta, ell, sigma, m0_v]`` of La Scala's, the 5
    ``[q1, q2, p0, f0, a0]`` of the KPT model -- as a tensor of ``dtype``
    on ``device``.  The values pass through float64, so nothing is rounded
    twice."""
    return torch.from_numpy(np.array(params_np, np.float64)).to(
        dtype=dtype, device=device)


def rule_from_jax(sgps) -> SigmaPoints:
    """A JAX ``SigmaPoints`` rule as the port's (host NumPy arrays)."""
    wc = None if sgps.wc is None else np.asarray(sgps.wc, np.float64)
    return SigmaPoints(d=int(sgps.d), n_points=int(sgps.n_points),
                       w=np.asarray(sgps.w, np.float64), wc=wc,
                       xi=np.asarray(sgps.xi, np.float64))
