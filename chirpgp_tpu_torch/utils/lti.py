"""LTI SDE discretization (counterpart of ``chirpgp_tpu.utils.lti``).

``lti_sde_to_disc`` converts ``dX = A X dt + B dW`` into the exact discrete
transition ``X_k = F X_{k-1} + q, q ~ N(0, Sigma)`` through the
matrix-fraction (van Loan) construction, over ``torch.linalg.matrix_exp``.
"""

from typing import Tuple

import torch

from chirpgp_tpu_torch.utils.numerics import as_real_tensor

__all__ = ["lti_sde_to_disc"]


def _gram(z: torch.Tensor) -> torch.Tensor:
    """B B^T for scalar / vector / matrix dispersion."""
    if z.dim() == 0:
        return (z ** 2).reshape(1, 1)
    if z.dim() == 1:
        return torch.outer(z, z)
    return z @ z.T


def lti_sde_to_disc(A, B, dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact discretization of an LTI SDE over an interval ``dt``.

    Returns the transition matrix ``F = expm(A dt)`` and the noise
    covariance ``Sigma`` from the 2d-by-2d matrix exponential of
    ``[[A, BB^T], [0, -A^T]]``.  ``A`` and ``B`` that are not tensors
    become float64 host tensors.
    """
    A, B = as_real_tensor(A), as_real_tensor(B)
    dim = A.shape[0]
    F = torch.linalg.matrix_exp(A * dt)
    phi = torch.cat([torch.cat([A, _gram(B).to(A)], dim=1),
                     torch.cat([torch.zeros_like(A), -A.T], dim=1)], dim=0)
    AB = torch.linalg.matrix_exp(phi * dt)[:, dim:]
    Sigma = AB[0:dim, :] @ F.T
    return F, Sigma
