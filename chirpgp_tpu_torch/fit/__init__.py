"""Hyperparameter estimation: host SciPy L-BFGS-B over a PyTorch
value-and-grad."""

from chirpgp_tpu_torch.fit.mle import scipy_minimize, MLEResult

__all__ = ["scipy_minimize", "MLEResult"]
