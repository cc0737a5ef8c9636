"""Hyperparameter MLE by gradient-through-the-filter (counterpart of
``chirpgp_tpu.fit.mle``).

- :func:`lbfgs_minimize`: L-BFGS with zoom line search
  (:class:`~chirpgp_tpu_torch.fit.lbfgs.LBFGS`, ``optax.lbfgs``'s
  configuration) driven by a host loop with a gradient-norm stopping rule;
  one problem, or a batch of lanes that each stop on their own.
- :func:`lbfgs_minimize_stepped`: the Monte-Carlo sweeps' batched L-BFGS,
  one iteration of every lane per step, with the stall freeze,
  best-iterate tracking, the tail cap and an atomic checkpoint.
- :func:`scipy_minimize`: the reference's optimizer contract: host SciPy
  L-BFGS-B, one value-and-grad of the objective per evaluation, and the
  ``success`` flag with which divergent Monte-Carlo runs are recorded as
  NaN.

The batched optimizers evaluate the objective for all lanes at once as
``torch.func.vmap(torch.func.grad_and_value(fun))``.
"""

import hashlib
import json
import os
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from chirpgp_tpu_torch.fit.lbfgs import LBFGS, batched_value_and_grad

__all__ = ["lbfgs_minimize", "lbfgs_minimize_stepped", "scipy_minimize",
           "MLEResult"]


class MLEResult(NamedTuple):
    params: torch.Tensor
    fun_val: torch.Tensor
    num_iters: torch.Tensor
    success: torch.Tensor   # bool; False when the optimizer diverged


def _grad_norm(state) -> torch.Tensor:
    return torch.sqrt((state.grad * state.grad).sum(-1))


def lbfgs_minimize(fun: Callable, init_params, max_iters: int = 200,
                   tol: float = 1e-6, memory_size: int = 15,
                   chunk_iters: Optional[int] = None,
                   batch_args: Optional[Sequence] = None) -> MLEResult:
    """Minimize the scalar, differentiable ``fun`` with ``optax.lbfgs``'s
    L-BFGS (zoom line search of at most 20 steps, first trial step 1).

    Without ``batch_args``, ``fun(params)`` takes the 1-D ``init_params``
    (the JAX package's contract).  With ``batch_args``, ``init_params`` is
    ``(B, p)`` and lane ``i`` minimizes ``fun(params_i, *args_i)``, as a
    ``jax.vmap`` of the JAX function would: each lane iterates while its
    count is 0 or (below ``max_iters`` and its gradient norm at least
    ``tol``), and a lane that stops keeps its result.

    ``chunk_iters`` checks the stopping rule between chunks of at most
    that many iterations, as the JAX package's host-chunked dispatches
    do; the result is the same.
    """
    single = batch_args is None
    params = torch.as_tensor(init_params)
    if single:
        if params.dim() != 1:
            raise ValueError("lbfgs_minimize without batch_args takes 1-D "
                             "params")
        params = params[None]
        value_and_grad = batched_value_and_grad(fun)
    else:
        value_and_grad = batched_value_and_grad(fun, batch_args)
    opt = LBFGS(memory_size=memory_size)
    state = opt.init(params)

    def run_until(params, state, bound):
        while True:
            going = (state.count == 0) | ((state.count < bound)
                                          & (_grad_norm(state) >= tol))
            if not bool(going.any()):
                return params, state
            params, state = opt.step(value_and_grad, params, state, going)

    if chunk_iters is None:
        params, state = run_until(params, state, max_iters)
    else:
        bound = 0
        while bound < max_iters:
            bound = min(bound + chunk_iters, max_iters)
            params, state = run_until(params, state, bound)
            if bool(((state.count < bound)
                     | (_grad_norm(state) < tol)).all()):
                break
    value, count = state.value, state.count
    finite = torch.isfinite(value) & torch.isfinite(params).all(-1)
    if single:
        return MLEResult(params[0], value[0], count[0], finite[0])
    return MLEResult(params, value, count, finite)


def _ckpt_fingerprint(tag: str, init_params, batch_args) -> str:
    """Checkpoint identity: the caller's tag (method/T/form/...) plus the
    shapes and dtypes of the init and every batch arg.  A checkpoint from
    a different objective or measurement set must never be resumed just
    because the (B, n_params) shape happens to match."""
    def spec(a):
        return [list(map(int, a.shape)), str(a.dtype).replace("torch.", "")]
    return hashlib.sha256(json.dumps(
        [str(tag), spec(init_params), [spec(a) for a in batch_args]]
    ).encode()).hexdigest()


def lbfgs_minimize_stepped(fun: Callable, init_params, batch_args=(),
                           max_iters: int = 200, tol: float = 1e-6,
                           memory_size: int = 15,
                           max_linesearch_steps: int = 15,
                           ftol_rel: float = 1e-6, patience: int = 3,
                           checkpoint_path: Optional[str] = None,
                           checkpoint_every: int = 5,
                           checkpoint_tag: str = "",
                           tail_frac: float = 0.01,
                           tail_iters: Optional[int] = None,
                           verbose: bool = False) -> MLEResult:
    """Batched L-BFGS that advances every lane by one iteration per step.

    ``fun(params, *args)`` is the per-seed scalar objective;
    ``init_params`` is ``(B, p)`` and every entry of ``batch_args`` has
    the same leading batch axis.  The line search is
    ``scale_by_zoom_linesearch(max_linesearch_steps)`` with its default
    first trial step, the last step size (``"keep"``).  Seeds whose
    gradient norm drops below ``tol`` (or goes non-finite) are frozen.

    ``ftol_rel``/``patience``: a seed whose NLL improves by less than
    ``ftol_rel * max(1, |f|)`` for ``patience`` consecutive iterations is
    frozen (scipy L-BFGS-B's ftol rule adapted to float32).

    The returned iterate of each seed is the lowest-NLL one it visited,
    starting from ``f(init)``: a failed zoom line search can step uphill.

    ``tail_frac``/``tail_iters``: once the active lanes drop to
    ``max(1, tail_frac * B)`` and at least one lane has been frozen, at
    most ``tail_iters`` further iterations run before the stragglers are
    frozen at their best iterate (every step evaluates the whole batch).
    ``tail_iters=None`` disables the cap; the sweeps use 30.

    ``checkpoint_path``: every ``checkpoint_every`` iterations the host
    state (current and best iterates, stall counters, iteration) is
    written atomically there, and a later call with the same path and
    the same fingerprint (``checkpoint_tag``, shapes, dtypes) resumes from
    it; the L-BFGS memory is not saved, so a resumed run warm-restarts
    from the saved iterate.  A checkpoint of another shape or fingerprint
    is ignored.  The file is not deleted here.
    """
    params = torch.as_tensor(init_params)
    if params.dim() != 2:
        raise ValueError("lbfgs_minimize_stepped requires a 2-D (batch, "
                         "params) array")
    opt = LBFGS(memory_size=memory_size,
                max_linesearch_steps=max_linesearch_steps,
                initial_guess_strategy="keep")
    value_and_grad = batched_value_and_grad(fun, batch_args)
    B, device = params.shape[0], params.device

    fingerprint = _ckpt_fingerprint(checkpoint_tag, params, batch_args)
    ckpt = None
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        ckpt = np.load(checkpoint_path)
        if ckpt["params"].shape != tuple(params.shape):
            ckpt = None
        elif ("fingerprint" not in ckpt
              or str(ckpt["fingerprint"]) != fingerprint):
            print(f"  lbfgs: ignoring checkpoint {checkpoint_path} "
                  f"(fingerprint mismatch -- different sweep)", flush=True)
            ckpt = None

    if ckpt is not None:
        it0 = int(ckpt["it"])
        params_np = np.asarray(ckpt["params"]).copy()
        params = torch.as_tensor(params_np, device=device)
        best = np.asarray(ckpt["best"], dtype=np.float64)
        best_params = np.asarray(ckpt["best_params"]).copy()
        best_count = np.asarray(ckpt["best_count"]).copy()
        stall = np.asarray(ckpt["stall"]).copy()
        still_going = torch.as_tensor(ckpt["still_going"], device=device)
        # Always announced: silently resuming is how foreign state sneaks
        # into results.
        print(f"  lbfgs resume from {checkpoint_path} at iter {it0} "
              f"(active={int(np.sum(ckpt['still_going']))})", flush=True)
        state = opt.init(params)
    else:
        it0 = 0
        state = opt.init(params)
        # f(init) seeds the best iterate, and its gradient the first
        # iteration (value_and_grad_from_state would compute the same).
        values0, grads0 = value_and_grad(params)
        state = state._replace(value=values0, grad=grads0)
        best = values0.cpu().numpy().astype(np.float64)
        stall = np.zeros((B,), dtype=np.int64)
        still_going = torch.ones(B, dtype=torch.bool, device=device)
        best_params = params.cpu().numpy().copy()
        best_count = np.zeros((B,), dtype=np.int64)
        params_np = best_params

    def save_ckpt(it_next):
        tmp = checkpoint_path + ".tmp.npz"   # np.savez appends .npz itself
        np.savez(tmp[:-4], it=it_next, params=params_np, best=best,
                 best_params=best_params, best_count=best_count, stall=stall,
                 still_going=still_going.cpu().numpy(),
                 fingerprint=np.asarray(fingerprint))
        os.replace(tmp, checkpoint_path)

    tail_thresh = max(1, int(np.ceil(tail_frac * B)))
    tail_left = None
    for it in range(it0, max_iters):
        active = still_going & ((state.count == 0)
                                | (_grad_norm(state) >= tol))
        params, state = opt.step(value_and_grad, params, state, active)
        vals = state.value.cpu().numpy()
        with np.errstate(invalid="ignore"):   # NaN seeds never "improve"
            improved = vals < best - ftol_rel * np.maximum(1.0, np.abs(best))
            better = vals < best
        params_np = params.cpu().numpy()
        best_params = np.where(better[:, None], params_np, best_params)
        best_count = np.where(better, it + 1, best_count)
        stall = np.where(improved, 0, stall + 1)
        # fmin ignores NaN: a transient NaN iteration must not poison the
        # tracked best, which stays consistent with best_params.
        best = np.fmin(best, vals)
        still_going = active & torch.as_tensor(stall < patience,
                                               device=device)
        n_active = int(still_going.sum())
        if checkpoint_path is not None and (it + 1) % checkpoint_every == 0:
            save_ckpt(it + 1)
        if verbose:
            print(f"  lbfgs iter {it + 1}: active={n_active} "
                  f"median_nll={float(np.nanmedian(vals)):.3f}", flush=True)
        if n_active == 0:
            break
        if (tail_iters is not None and 0 < n_active <= tail_thresh
                and n_active < B):
            tail_left = tail_iters if tail_left is None else tail_left - 1
            if tail_left <= 0:
                if verbose:
                    print(f"  lbfgs tail cap: freezing {n_active} straggler "
                          f"lane(s) at best iterate after {tail_iters} tail "
                          f"iterations", flush=True)
                break

    value = torch.as_tensor(best.astype(params_np.dtype), device=device)
    params = torch.as_tensor(best_params, device=device)
    finite = torch.isfinite(value) & torch.isfinite(params).all(-1)
    return MLEResult(params, value, torch.as_tensor(best_count, device=device),
                     finite)


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
