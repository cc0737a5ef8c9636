"""Hyperparameter MLE by gradient-through-the-filter (counterpart of
``chirpgp_tpu.fit.mle``; the in-graph L-BFGS ``lbfgs_minimize`` and the
batched ``lbfgs_minimize_stepped`` wait for the Monte-Carlo sweeps).

:func:`scipy_minimize` is the reference's optimizer contract: host SciPy
L-BFGS-B, one value-and-grad of the objective per evaluation, and the
``success`` flag with which divergent Monte-Carlo runs are recorded as
NaN.
"""

from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["scipy_minimize", "MLEResult"]


class MLEResult(NamedTuple):
    params: torch.Tensor
    fun_val: torch.Tensor
    num_iters: torch.Tensor
    success: torch.Tensor   # bool; False when the optimizer diverged


def scipy_minimize(fun: Callable, init_params, method: str = "L-BFGS-B",
                   **kwargs) -> MLEResult:
    """Host SciPy optimization of ``fun`` (tensor -> scalar tensor) with
    the gradient from ``torch.autograd``.

    At each evaluation the float64 NumPy iterate becomes a float64 tensor
    on ``init_params``' device (the host for a non-tensor) that requires
    grad; the value and gradient come back as float64 NumPy.  ``kwargs``
    go to ``scipy.optimize.minimize``.  The result lives on the host.
    """
    from scipy.optimize import minimize

    device = init_params.device if isinstance(init_params, torch.Tensor) \
        else torch.device("cpu")

    def fun_np(x):
        theta = torch.tensor(x, dtype=torch.float64, device=device,
                             requires_grad=True)
        value = fun(theta)
        grad, = torch.autograd.grad(value, theta)
        return float(value.detach()), grad.cpu().numpy().astype(np.float64)

    x0 = torch.as_tensor(init_params).detach().cpu().numpy()
    res = minimize(fun_np, np.asarray(x0, dtype=np.float64), method=method,
                   jac=True, **kwargs)
    return MLEResult(torch.as_tensor(res.x),
                     torch.as_tensor(res.fun, dtype=torch.float64),
                     torch.as_tensor(res.nit),
                     torch.as_tensor(bool(res.success)))
