"""Transition (discretization) abstraction (counterpart of
``chirpgp_tpu.models.transitions``).

A :class:`Transition` is the discrete-time conditional law of an SDE over a
step ``dt``: ``X_k | X_{k-1} = u ~ N(mean(u, dt), cov(u, dt))``.  ``mean``
broadcasts over leading batch axes; ``mean_cf`` is the channels-first
form ``(..., d, B)`` the batched filters use; ``const_cov`` marks a
state-independent covariance.
"""

import dataclasses
from typing import Callable, Optional, Tuple

import torch

__all__ = ["Transition", "as_transition"]


@dataclasses.dataclass(frozen=True)
class Transition:
    """Conditional mean/covariance of a discretized SDE step.

    Attributes
    ----------
    mean : callable ``(..., d), dt -> (..., d)``
    cov : callable ``(..., d), dt -> (..., d, d)``; if ``const_cov`` it may
        ignore the state and return one ``(d, d)`` tensor.
    const_cov : bool
    mean_cf : callable ``(..., d, B), dt -> (..., d, B)`` or None
        Channels-first conditional mean; when None the batched filters
        transpose around ``mean``.
    """

    mean: Callable
    cov: Callable
    const_cov: bool = False
    mean_cf: Optional[Callable] = None

    def mean_channels_first(self, u_cf: torch.Tensor, dt) -> torch.Tensor:
        """The conditional mean in channels-first layout ``(..., d, B)``."""
        if self.mean_cf is not None:
            return self.mean_cf(u_cf, dt)
        return self.mean(u_cf.transpose(-1, -2), dt).transpose(-1, -2)

    def __call__(self, u: torch.Tensor, dt) -> Tuple[torch.Tensor, torch.Tensor]:
        m = self.mean(u, dt)
        c = self.cov(u, dt)
        if self.const_cov:
            c = c.expand(u.shape[:-1] + c.shape[-2:])
        return m, c

    def cov_const(self, dt) -> torch.Tensor:
        """The (d, d) state-independent covariance (requires ``const_cov``)."""
        if not self.const_cov:
            raise ValueError("Transition covariance is state-dependent.")
        return self.cov(None, dt)


def as_transition(m_and_cov) -> Transition:
    """Pass a :class:`Transition` through.  Wrapping a reference-style
    ``m_and_cov(u, dt)`` closure (the JAX package's ``vmap`` fallback) is
    not ported yet."""
    if isinstance(m_and_cov, Transition):
        return m_and_cov
    raise NotImplementedError(
        "as_transition: wrapping an m_and_cov closure is not ported yet "
        "(later PR); pass a Transition")
