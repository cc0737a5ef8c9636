"""Metrics (counterpart of ``chirpgp_tpu.utils.metrics``)."""

import torch

__all__ = ["rmse"]


def rmse(x1: torch.Tensor, x2: torch.Tensor,
         reduce_sum: bool = True) -> torch.Tensor:
    """Per-dimension RMSE over the time axis; summed over dimensions when
    ``reduce_sum``."""
    val = torch.sqrt(torch.mean((x1 - x2) ** 2, dim=0))
    return val.sum() if reduce_sum else val
