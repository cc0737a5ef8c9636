"""End-to-end applications (ported so far: batched IF estimation)."""

from chirpgp_tpu_torch.apps.pipeline import (
    IFEstimationConfig, estimate_if_batched)

__all__ = ["IFEstimationConfig", "estimate_if_batched"]
