"""Gauss--Newton and Levenberg--Marquardt nonlinear least squares
(counterpart of ``chirpgp_tpu.fit.gauss_newton``), for the polynomial-IF
baseline.

Each step solves the linearized least-squares subproblem by thin QR of
the Jacobian and a triangular solve; LM damping is the augmented-rows
form (``sqrt(mu) * diag(||J_col||)`` rows under ``J``, zeros under the
residual), with Marquardt scaling from the column norms.

The ``*_while`` solvers take ``init_params (..., P)`` and ``ys (..., T)``
and run every lane at once with the semantics of a ``jax.vmap`` of the
JAX package's ``lax.while_loop``: the loop runs while any lane is active,
a lane that has stopped keeps its carry, and each lane has its own
``num_iters`` and NaN-padded ``obj_trace``.  The model ``f`` maps ONE
lane's params ``(P,)`` to its prediction ``(T,)``; the solvers apply it
and its Jacobian (``torch.func.jacfwd``) over the lanes with
``torch.func.vmap``.
"""

from typing import Callable, NamedTuple, Tuple

import torch

__all__ = ["NLSResult", "gauss_newton_while", "levenberg_marquardt_while",
           "gauss_newton", "levenberg_marquardt"]


class NLSResult(NamedTuple):
    """Nonlinear-LSQ result, with the leading (lane) dims of the inputs.

    ``obj_trace`` has fixed length ``max_iters + 1`` (entry 0 is the
    initial objective); entries past ``num_iters`` hold NaN padding.
    """
    params: torch.Tensor
    obj_val: torch.Tensor
    obj_trace: torch.Tensor
    num_iters: torch.Tensor
    converged: torch.Tensor


def _qr_lsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve min ||A x - b|| via thin QR + back substitution, over leading
    dims: ``A (..., n, p)``, ``b (..., n)``."""
    Q, R = torch.linalg.qr(A, mode="reduced")
    rhs = (Q.transpose(-1, -2) @ b[..., None])
    return torch.linalg.solve_triangular(R, rhs, upper=True)[..., 0]


def _nls_while(propose: Callable, obj: Callable, init_params: torch.Tensor,
               init_damping, tol: float, max_iters: int) -> NLSResult:
    """The shared loop over lanes ``init_params (B, P)``.

    ``propose(params, damping, obj_val) -> (new_params, new_damping,
    new_obj)`` is one candidate step of every lane (GN: the damping is the
    fixed step size; LM: the adaptive mu, with accept/reject folded in).
    A lane stops when its objective change falls to ``tol``, its objective
    is not finite, or it has run ``max_iters``; it always runs once.
    """
    B = init_params.shape[0]
    obj0 = obj(init_params)
    dtype = torch.promote_types(obj0.dtype, torch.float32)
    trace = torch.full((B, max_iters + 1), float("nan"), dtype=dtype,
                       device=obj0.device)
    trace[:, 0] = obj0
    it = torch.zeros(B, dtype=torch.int64, device=obj0.device)
    params = init_params
    damping = torch.full((B,), float(init_damping), dtype=obj0.dtype,
                         device=obj0.device)
    prev = torch.full_like(obj0, float("inf"))
    cur = obj0
    lanes = torch.arange(B, device=obj0.device)

    def active():
        return (it == 0) | ((it < max_iters) & ((cur - prev).abs() > tol)
                            & torch.isfinite(cur))

    going = active()
    while bool(going.any()):
        new_params, new_damping, new_obj = propose(params, damping, cur)
        # The vmapped while_loop writes trace[it + 1] of the lanes that go
        # (JAX drops a write past the end, as at max_iters = 0).
        slot = (it + 1).clamp_max(max_iters)
        write = going & (it + 1 <= max_iters)
        trace[lanes, slot] = torch.where(write, new_obj.to(dtype),
                                         trace[lanes, slot])
        params = torch.where(going[:, None], new_params, params)
        damping = torch.where(going, new_damping, damping)
        prev = torch.where(going, cur, prev)
        cur = torch.where(going, new_obj, cur)
        it = it + going.to(it.dtype)
        going = active()
    converged = torch.isfinite(cur) & ((cur - prev).abs() <= tol)
    return NLSResult(params, cur, trace, it, converged)


def _problem(f: Callable, init_params, ys, Xi):
    """Lanes of the problem: params (B, P) and ys (B, T) in the dtype the
    two promote to, the residual and objective over lanes, the Jacobian
    over lanes, and the batch shape."""
    init_params, ys = torch.as_tensor(init_params), torch.as_tensor(ys)
    dtype = torch.promote_types(init_params.dtype, ys.dtype)
    init_params = init_params.to(dtype)
    ys = ys.to(dtype=dtype, device=init_params.device)
    batch_shape = tuple(init_params.shape[:-1])
    P = init_params.shape[-1]
    ys = ys.expand(batch_shape + ys.shape[-1:])
    params = init_params.reshape(-1, P)
    ys = ys.reshape(params.shape[0], -1)
    f_lanes = torch.func.vmap(f)
    jac_lanes = torch.func.vmap(torch.func.jacfwd(f))

    def residual(p):
        return ys - f_lanes(p)

    def obj(p):
        r = residual(p)
        return (r * r).sum(-1) / Xi

    return params, residual, obj, jac_lanes, batch_shape


def _unbatch(res: NLSResult, batch_shape) -> NLSResult:
    return NLSResult(*(x.reshape(batch_shape + x.shape[1:]) for x in res))


def gauss_newton_while(f: Callable, init_params, ys, Xi, lr: float = 1.0,
                       tol: float = 1e-10, max_iters: int = 100) -> NLSResult:
    """Gauss--Newton over lanes: each step solves ``min ||J dx - r||`` by QR
    and moves ``params + lr * dx``."""
    params, residual, obj, jac, batch_shape = _problem(f, init_params, ys, Xi)

    def propose(p, step, _cur):
        dx = _qr_lsq(jac(p).to(p.dtype), residual(p))
        new = p + step[:, None] * dx
        return new, step, obj(new)

    return _unbatch(_nls_while(propose, obj, params, lr, tol, max_iters),
                    batch_shape)


def levenberg_marquardt_while(f: Callable, init_params, ys, Xi,
                              init_mu: float = 1.0, nu: float = 2.0,
                              tol: float = 1e-10,
                              max_iters: int = 100) -> NLSResult:
    """Levenberg--Marquardt over lanes via the augmented-rows QR form.

    The damped subproblem ``min ||J dx - r||^2 + mu ||S dx||^2`` with
    Marquardt scaling ``S = diag(||J_col||)`` is the plain least-squares
    problem on ``[J; sqrt(mu) S]`` against ``[r; 0]``.  A step that fails
    to reduce the objective is rejected and ``mu`` grows by ``nu``;
    otherwise it shrinks by ``nu``.
    """
    params, residual, obj, jac, batch_shape = _problem(f, init_params, ys, Xi)

    def propose(p, mu, cur):
        r = residual(p)
        J = jac(p).to(p.dtype)                                # (B, T, P)
        # Guard zero columns so the augmented block stays full-rank.
        col_scale = torch.linalg.vector_norm(J, dim=-2).clamp_min(1e-12)
        A = torch.cat([J, torch.sqrt(mu)[:, None, None]
                       * torch.diag_embed(col_scale)], dim=-2)
        b = torch.cat([r, torch.zeros_like(p)], dim=-1)
        cand = p + _qr_lsq(A, b)
        # ``cur`` is obj(p): the objective of the lane's current params.
        obj_cand = obj(cand)
        improved = obj_cand < cur
        return (torch.where(improved[:, None], cand, p),
                torch.where(improved, mu / nu, mu * nu),
                torch.where(improved, obj_cand, cur))

    return _unbatch(_nls_while(propose, obj, params, init_mu, tol,
                               max_iters), batch_shape)


def _trim(res: NLSResult) -> Tuple[torch.Tensor, torch.Tensor]:
    n = int(res.num_iters) + 1
    return res.params, res.obj_trace[:n]


def gauss_newton(f: Callable, init_params, ys, Xi, lr: float = 1.0,
                 stop_tolerance: float = 1e-10,
                 max_iters: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """One problem (``init_params (P,)``): ``(params, objective
    trajectory)`` of :func:`gauss_newton_while`, the trajectory trimmed to
    the iterations run."""
    return _trim(gauss_newton_while(f, init_params, ys, Xi, lr=lr,
                                    tol=stop_tolerance, max_iters=max_iters))


def levenberg_marquardt(f: Callable, init_params, ys, Xi, lr: float = 1.0,
                        nu: float = 2.0, stop_tolerance: float = 1e-10,
                        max_iters: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """One problem: ``(params, objective trajectory)`` of
    :func:`levenberg_marquardt_while`; ``lr`` is the initial damping
    ``mu``."""
    return _trim(levenberg_marquardt_while(
        f, init_params, ys, Xi, init_mu=lr, nu=nu, tol=stop_tolerance,
        max_iters=max_iters))
