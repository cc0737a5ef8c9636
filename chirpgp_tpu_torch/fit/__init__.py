"""Hyperparameter estimation: the batched L-BFGS with zoom line search
(``lbfgs_minimize``, the sweeps' ``lbfgs_minimize_stepped``) and host
SciPy L-BFGS-B, over a PyTorch value-and-grad."""

from chirpgp_tpu_torch.fit.lbfgs import LBFGS, LBFGSState, batched_value_and_grad
from chirpgp_tpu_torch.fit.mle import (
    lbfgs_minimize, lbfgs_minimize_stepped, scipy_minimize, MLEResult)

__all__ = ["LBFGS", "LBFGSState", "batched_value_and_grad", "lbfgs_minimize",
           "lbfgs_minimize_stepped", "scipy_minimize", "MLEResult"]
