"""Positivity bijection for the instantaneous frequency.

``g`` is the softplus map, ``g_inv`` its inverse (counterpart of
``chirpgp_tpu.models.bijections``).  ``torch.nn.functional.softplus`` is
NOT used: above its ``threshold=20`` it returns ``x`` itself, which breaks
float64 parity with ``jax.nn.softplus``.
"""

import torch

__all__ = ["g", "g_inv"]


def g(x: torch.Tensor) -> torch.Tensor:
    """Softplus ``log(1 + exp(x))`` in the stable form
    ``max(x, 0) + log1p(exp(-|x|))`` (the same as ``jnp.logaddexp(x, 0)``)."""
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def g_inv(x: torch.Tensor) -> torch.Tensor:
    """Inverse softplus: ``log(exp(x) - 1) = x + log(1 - exp(-x))``."""
    return x + torch.log(-torch.expm1(-x))
