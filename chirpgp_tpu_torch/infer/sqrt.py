"""Square-root filter helpers (counterpart of ``chirpgp_tpu.infer.sqrt``;
only the weight check the batched filters share is ported so far)."""

import numpy as np

from chirpgp_tpu_torch.quad.sigma_points import SigmaPoints


def _require_nonneg_weights(sgps: SigmaPoints, where: str):
    """Sqrt forms take sqrt(w): negative weights (default unscented rule)
    would silently produce NaNs."""
    if np.any(np.asarray(sgps.w) < 0) or (
            sgps.wc is not None and np.any(np.asarray(sgps.wc) < 0)):
        raise ValueError(
            f"{where} requires nonnegative sigma-point weights "
            "(use cubature or gauss_hermite; the default unscented rule "
            "has a negative center weight -- use the covariance form, or "
            "unscented(d, kappa=0)).")
