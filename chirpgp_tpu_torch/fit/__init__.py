"""Hyperparameter estimation: the batched L-BFGS with zoom line search
(``lbfgs_minimize``, the sweeps' ``lbfgs_minimize_stepped``), host SciPy
L-BFGS-B over a PyTorch value-and-grad, and Gauss-Newton /
Levenberg-Marquardt nonlinear least squares."""

from chirpgp_tpu_torch.fit.lbfgs import LBFGS, LBFGSState, batched_value_and_grad
from chirpgp_tpu_torch.fit.mle import (
    lbfgs_minimize, lbfgs_minimize_stepped, scipy_minimize, MLEResult)
from chirpgp_tpu_torch.fit.gauss_newton import (
    NLSResult, gauss_newton, levenberg_marquardt, gauss_newton_while,
    levenberg_marquardt_while)

__all__ = ["LBFGS", "LBFGSState", "batched_value_and_grad", "lbfgs_minimize",
           "lbfgs_minimize_stepped", "scipy_minimize", "MLEResult",
           "NLSResult", "gauss_newton", "levenberg_marquardt",
           "gauss_newton_while", "levenberg_marquardt_while"]
