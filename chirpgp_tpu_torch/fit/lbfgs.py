"""Batched L-BFGS with a zoom line search, for params with a leading lane
axis ``(B, p)`` (the optimizer that ``chirpgp_tpu.fit.mle`` takes from
optax).

A PyTorch copy of optax 0.2.6 (Apache-2.0, Copyright 2019 DeepMind
Technologies Limited and the Optax authors):

- ``scale_by_lbfgs`` with ``scale_init_precond=True`` and its two-loop
  recursion ``_precondition_by_lbfgs`` (``optax/_src/transform.py``),
  chained with ``scale(-1)`` as ``optax.lbfgs`` does (``optax/_src/alias.py``);
- ``zoom_linesearch`` / ``scale_by_zoom_linesearch``
  (``optax/_src/linesearch.py``): ``_cubicmin``, ``_quadmin``, the interval
  search, the zoom, the safe step and the approximate (Hager-Zhang)
  decrease criterion;
- ``value_and_grad_from_state`` (``optax/_src/utils.py``): the next
  iteration reuses the line search's value and gradient when finite.

The arithmetic follows optax's order, so a lane takes the path its
``jax.vmap``'d optax run takes.  Every lane carries its own state.  The
line search's while-loop runs on the host until every lane's search has
ended; each round evaluates the objective once for all lanes, at each
lane's own trial step, and a lane whose search has ended keeps its state,
as the lanes of a vmapped ``lax.while_loop`` do.  A lane whose objective
is not finite carries NaN and never raises for the batch.
"""

from typing import Callable, NamedTuple, Optional, Sequence

import torch

__all__ = ["LBFGS", "LBFGSState", "batched_value_and_grad"]

# optax's defaults for the zoom line search, the only values the JAX
# package runs: no step-size cap, tolerance 0, step doubling in the
# interval search, Armijo and curvature constants 1e-4 and 0.9, the
# approximate-decrease switch at 1e-6 of |f|, and the interval length
# below which a step with sufficient decrease is taken.
_TOL = 0.0
_INCREASE_FACTOR = 2.0
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5


class LBFGSState(NamedTuple):
    """Per-lane optimizer state, every field with the lane axis first.

    ``count``, ``params``, ``updates`` and the three memories are
    ``ScaleByLBFGSState``'s (``updates`` holds the last gradient);
    ``learning_rate``, ``value`` and ``grad`` are
    ``ScaleByZoomLinesearchState``'s."""
    count: torch.Tensor                 # (B,) int64
    params: torch.Tensor                # (B, p)
    updates: torch.Tensor               # (B, p)
    diff_params_memory: torch.Tensor    # (B, m, p)
    diff_updates_memory: torch.Tensor   # (B, m, p)
    weights_memory: torch.Tensor        # (B, m)
    learning_rate: torch.Tensor         # (B,)
    value: torch.Tensor                 # (B,)
    grad: torch.Tensor                  # (B, p)


def batched_value_and_grad(fun: Callable, batch_args: Sequence = ()) -> Callable:
    """``params (B, p) -> (values (B,), grads (B, p))`` for the per-lane
    scalar objective ``fun(params_i, *args_i)``, all lanes at once: the
    values from one ``torch.func.vmap(fun)``, the gradients from one
    ``torch.autograd.grad`` of their sum.  The lanes do not interact, so
    lane i's gradient is ``grad(fun)(params_i, *args_i)`` -- what
    ``vmap(grad_and_value(fun))`` gives, at 1/1.6 of its host time on a
    float32 sqrt GHFS objective (B=3, T=300, one CPU thread), since no
    ``grad`` transform wraps every operation of the filter."""
    values_of = torch.func.vmap(fun)

    def value_and_grad(params):
        params = params.detach().requires_grad_(True)
        with torch.enable_grad():
            values = values_of(params, *batch_args)
            grads, = torch.autograd.grad(values.sum(), params)
        return values.detach(), grads

    return value_and_grad


def _vdot(a, b):
    return (a * b).sum(-1)


def _where(cond, x, y):
    """``torch.where`` with a per-lane ``cond`` (B,) over (B, ...) fields."""
    return torch.where(cond.reshape(cond.shape + (1,) * (x.dim() - 1)), x, y)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when the radical is negative."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    e1 = fb - fa - C * db
    e2 = fc - fa - C * dc
    A = (dc ** 2 * e1 + -(db ** 2) * e2) / denom
    B = (-(dc ** 3) * e1 + db ** 3 * e2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2.0 * B)


class LBFGS:
    """``optax.chain(scale_by_lbfgs(memory_size), scale(-1),
    scale_by_zoom_linesearch(max_linesearch_steps,
    initial_guess_strategy=...))`` over lanes, the line search at optax's
    other defaults.

    ``optax.lbfgs(memory_size)`` is ``LBFGS(memory_size,
    max_linesearch_steps=20, initial_guess_strategy="one")``;
    ``scale_by_zoom_linesearch``'s own default strategy is ``"keep"``.
    """

    def __init__(self, memory_size: int = 10, max_linesearch_steps: int = 20,
                 initial_guess_strategy: str = "one"):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        if initial_guess_strategy not in ("one", "keep"):
            raise ValueError(
                f"Unknown initial guess strategy: {initial_guess_strategy}")
        self.memory_size = memory_size
        self.max_linesearch_steps = max_linesearch_steps
        self.initial_guess_strategy = initial_guess_strategy

    # -- state ------------------------------------------------------------
    def init(self, params: torch.Tensor) -> LBFGSState:
        B, p = params.shape
        zeros = torch.zeros_like(params)
        mem = params.new_zeros((B, self.memory_size, p))
        count = torch.zeros(B, dtype=torch.int64, device=params.device)
        return LBFGSState(
            count=count, params=zeros, updates=zeros,
            diff_params_memory=mem, diff_updates_memory=mem,
            weights_memory=params.new_zeros((B, self.memory_size)),
            learning_rate=params.new_ones(B),
            value=params.new_full((B,), float("inf")), grad=zeros)

    @staticmethod
    def value_and_grad_from_state(value_and_grad: Callable,
                                  params: torch.Tensor, state: LBFGSState):
        """The state's value and gradient where the value is finite; a
        fresh evaluation at ``params`` elsewhere."""
        need = ~torch.isfinite(state.value)
        if not bool(need.any()):
            return state.value, state.grad
        value, grad = value_and_grad(params)
        return (torch.where(need, value, state.value),
                _where(need, grad, state.grad))

    # -- scale_by_lbfgs ---------------------------------------------------
    def _precondition(self, updates, dpm, dum, rhos, identity_scale,
                      memory_idx):
        m = self.memory_size
        lanes = torch.arange(updates.shape[0], device=updates.device)
        indices = (memory_idx[:, None]
                   + torch.arange(m, device=updates.device)) % m
        vec, alphas = updates, [None] * m
        for k in reversed(range(m)):                # right product
            idx = indices[:, k]
            dwi, dui = dpm[lanes, idx], dum[lanes, idx]
            alphas[k] = rhos[lanes, idx] * _vdot(dwi, vec)
            vec = vec + (-alphas[k])[:, None] * dui
        vec = identity_scale[:, None] * vec
        for k in range(m):                          # left product
            idx = indices[:, k]
            dwi, dui = dpm[lanes, idx], dum[lanes, idx]
            beta = rhos[lanes, idx] * _vdot(dui, vec)
            vec = vec + (alphas[k] - beta)[:, None] * dwi
        return vec

    def _lbfgs_direction(self, grad, state, params):
        """``scale_by_lbfgs``'s update: the memory refreshed with the last
        step, and ``P_k grad``.  Returns (direction, memories)."""
        m = self.memory_size
        lanes = torch.arange(grad.shape[0], device=grad.device)
        memory_idx = state.count % m
        prev_memory_idx = (state.count - 1) % m
        started = state.count > 0

        diff_params = params - state.params
        diff_updates = grad - state.updates
        vdot_diff = _vdot(diff_updates, diff_params)
        weight = torch.where(vdot_diff == 0.0, 0.0, 1.0 / vdot_diff)
        diff_params = _where(started, diff_params, torch.zeros_like(diff_params))
        diff_updates = _where(started, diff_updates,
                              torch.zeros_like(diff_updates))
        weight = torch.where(started, weight, torch.zeros_like(weight))
        dpm = state.diff_params_memory.clone()
        dum = state.diff_updates_memory.clone()
        wm = state.weights_memory.clone()
        dpm[lanes, prev_memory_idx] = diff_params
        dum[lanes, prev_memory_idx] = diff_updates
        wm[lanes, prev_memory_idx] = weight

        numerator = _vdot(diff_updates, diff_params)
        denominator = _vdot(diff_updates, diff_updates)
        identity_scale = torch.where(denominator > 0.0,
                                     numerator / denominator, 1.0)
        update_norm = torch.sqrt(_vdot(grad, grad))
        capped_inv_norm = torch.clamp(1.0 / update_norm, max=1.0)
        identity_scale = torch.where(started, identity_scale, capped_inv_norm)
        direction = self._precondition(grad, dpm, dum, wm, identity_scale,
                                       memory_idx)
        return direction, (dpm, dum, wm)

    # -- zoom line search -------------------------------------------------
    @staticmethod
    def _decrease_error(stepsize, value_step, slope_step, value_init,
                        slope_init):
        """The smaller of the Armijo and the approximate (Hager-Zhang)
        decrease errors, 0 where met, inf where NaN."""
        decrease_error = (value_step - value_init
                          - _SLOPE_RTOL * stepsize * slope_init)
        approx = slope_step - (2 * _SLOPE_RTOL - 1.0) * slope_init
        delta_values = (value_step - value_init
                        - _APPROX_DEC_RTOL * torch.abs(value_init))
        approx = torch.maximum(approx, delta_values)
        decrease_error = torch.minimum(approx, decrease_error)
        decrease_error = torch.clamp(decrease_error, min=0.0)
        return torch.where(torch.isnan(decrease_error), torch.inf,
                           decrease_error)

    @staticmethod
    def _curvature_error(slope_step, slope_init):
        curvature_error = torch.clamp(
            torch.abs(slope_step) - _CURV_RTOL * torch.abs(slope_init),
            min=0.0)
        return torch.where(torch.isnan(curvature_error), torch.inf,
                           curvature_error)

    def _ls_init(self, updates, params, value, grad, prev_stepsize):
        zero = torch.zeros_like(value)
        inf = torch.full_like(value, torch.inf)
        false = torch.zeros_like(value, dtype=torch.bool)
        slope = _vdot(updates, grad)
        guess = (torch.ones_like(value) if self.initial_guess_strategy == "one"
                 else prev_stepsize)
        return dict(
            count=torch.zeros_like(value, dtype=torch.int64),
            params=params, updates=updates, stepsize_guess=guess,
            stepsize=zero, value=value, grad=grad, slope=slope,
            value_init=value, slope_init=slope,
            decrease_error=inf, curvature_error=inf, error=inf,
            interval_found=false, done=false, failed=false,
            low=zero, value_low=value, slope_low=slope,
            high=zero, value_high=value, slope_high=slope,
            cubic_ref=zero, value_cubic_ref=value,
            safe_stepsize=zero, safe_value=value, safe_grad=grad)

    @staticmethod
    def _zoom_middle(s):
        """The zoom's trial step: cubic, else quadratic, else bisection."""
        low, high = s["low"], s["high"]
        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        middle_cubic = _cubicmin(low, s["value_low"], s["slope_low"], high,
                                 s["value_high"], s["cubic_ref"],
                                 s["value_cubic_ref"])
        use_cubic = (middle_cubic > left + cubic_chk) & (
            middle_cubic < right - cubic_chk)
        middle_quad = _quadmin(low, s["value_low"], s["slope_low"], high,
                               s["value_high"])
        middle_quad_valid = (middle_quad > left + quad_chk) & (
            middle_quad < right - quad_chk)
        use_quad = (~use_cubic) & middle_quad_valid
        middle_bisection = (low + high) / 2.0
        use_bisection = (~use_cubic) & (~use_quad)
        middle = torch.where(use_cubic, middle_cubic, s["cubic_ref"])
        middle = torch.where(use_quad, middle_quad, middle)
        middle = torch.where(use_bisection, middle_bisection, middle)
        return middle, delta <= _INTERVAL_THRESHOLD

    def _search_interval(self, s, new_stepsize, new_value, new_grad,
                         new_slope, dec, curv):
        """Algorithm 3.5 of Nocedal and Wright, given the trial point (no
        step-size cap: the search ends when the point is good)."""
        tol = _TOL
        iter_num = s["count"]
        new_error = torch.maximum(dec, curv)
        safe = dec <= tol
        prev = (s["stepsize"], s["value"], s["slope"])
        new = (new_stepsize, new_value, new_slope)
        set_high_to_new = (dec > 0.0) | ((new_value >= s["value"])
                                         & (iter_num > 0))
        set_low_to_new = (new_slope >= 0.0) & (~set_high_to_new)
        low, value_low, slope_low = [torch.where(set_low_to_new, n, p)
                                     for n, p in zip(new, prev)]
        high, value_high, slope_high = [torch.where(set_low_to_new, p, n)
                                        for n, p in zip(new, prev)]
        interval_found = set_high_to_new | set_low_to_new | (new_error <= tol)
        done = new_error <= tol
        failed = (iter_num + 1 >= self.max_linesearch_steps) & (~done)
        return dict(
            s, count=iter_num + 1, stepsize=new_stepsize, value=new_value,
            grad=new_grad, slope=new_slope, decrease_error=dec,
            curvature_error=curv, error=new_error,
            interval_found=interval_found, done=done, failed=failed,
            low=low, value_low=value_low, slope_low=slope_low, high=high,
            value_high=value_high, slope_high=slope_high, cubic_ref=low,
            value_cubic_ref=value_low,
            safe_stepsize=torch.where(safe, new_stepsize, s["safe_stepsize"]),
            safe_value=torch.where(safe, new_value, s["safe_value"]),
            safe_grad=_where(safe, new_grad, s["safe_grad"]))

    def _zoom_into_interval(self, s, middle, too_small_int, value_middle,
                            grad_middle, slope_middle, dec, curv):
        """Algorithm 3.6 of Nocedal and Wright, given the trial point."""
        tol = _TOL
        iter_num = s["count"]
        low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
        high, value_high, slope_high = (s["high"], s["value_high"],
                                        s["slope_high"])
        new_error = torch.maximum(dec, curv)
        update_safe = (dec <= tol) & (value_middle < s["safe_value"])
        new_safe_stepsize = torch.where(update_safe, middle,
                                        s["safe_stepsize"])
        done = new_error <= tol
        set_high_to_middle = (dec > 0.0) | (value_middle >= value_low)
        secant_interval = slope_middle * (high - low)
        set_high_to_low = (secant_interval >= 0.0) & (~set_high_to_middle)
        set_low_to_middle = ~set_high_to_middle
        mid = (middle, value_middle, slope_middle)
        new_high = [torch.where(set_high_to_middle, c, d)
                    for c, d in zip(mid, (high, value_high, slope_high))]
        new_high = [torch.where(set_high_to_low, c, d)
                    for c, d in zip((low, value_low, slope_low), new_high)]
        new_low = [torch.where(set_low_to_middle, c, d)
                   for c, d in zip(mid, (low, value_low, slope_low))]
        ref_high = set_high_to_middle | set_high_to_low
        max_iter_reached = (iter_num + 1) >= self.max_linesearch_steps
        presumably_failed = max_iter_reached | (too_small_int
                                                & (new_safe_stepsize > 0.0))
        return dict(
            s, count=iter_num + 1, stepsize=middle, value=value_middle,
            grad=grad_middle, slope=slope_middle, decrease_error=dec,
            curvature_error=curv, error=new_error, done=done,
            failed=presumably_failed & ~done,
            low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
            high=new_high[0], value_high=new_high[1], slope_high=new_high[2],
            cubic_ref=torch.where(ref_high, high, low),
            value_cubic_ref=torch.where(ref_high, value_high, value_low),
            safe_stepsize=new_safe_stepsize,
            safe_value=torch.where(update_safe, value_middle,
                                   s["safe_value"]),
            safe_grad=_where(update_safe, grad_middle, s["safe_grad"]))

    def _ls_step(self, s, value_and_grad):
        """One round of ``zoom_linesearch``'s ``step_fn`` for every lane:
        the interval search or the zoom, each lane at its own trial
        point, one objective evaluation for all lanes, then the safe step
        for lanes that failed."""
        larger = _INCREASE_FACTOR * s["stepsize"]
        new_stepsize = torch.where(s["count"] == 0, s["stepsize_guess"],
                                   larger)
        middle, too_small_int = self._zoom_middle(s)
        zoom = s["interval_found"]
        trial = torch.where(zoom, middle, new_stepsize)

        step = s["params"] + trial[:, None] * s["updates"]
        value, grad = value_and_grad(step)
        slope = _vdot(grad, s["updates"])
        dec = self._decrease_error(trial, value, slope, s["value_init"],
                                   s["slope_init"])
        curv = self._curvature_error(slope, s["slope_init"])

        searched = self._search_interval(s, new_stepsize, value, grad, slope,
                                         dec, curv)
        zoomed = self._zoom_into_interval(s, middle, too_small_int, value,
                                          grad, slope, dec, curv)
        new = {k: _where(zoom, zoomed[k], searched[k]) for k in s}
        # _try_safe_step for lanes whose search failed.
        take_safe = new["failed"] & ((new["safe_stepsize"] > 0.0)
                                     | torch.isinf(new["decrease_error"]))
        for k, safe_k in (("stepsize", "safe_stepsize"),
                          ("value", "safe_value"), ("grad", "safe_grad")):
            new[k] = _where(take_safe, new[safe_k], new[k])
        return new

    def _linesearch(self, updates, params, value, grad, prev_stepsize,
                    value_and_grad, active):
        s = self._ls_init(updates, params, value, grad, prev_stepsize)
        # A lane outside ``active`` keeps its state (the caller discards
        # its result), so its search is marked ended from the start.
        s["done"] = ~active
        while True:
            going = ~(s["done"] | s["failed"])
            if not bool(going.any()):
                break
            new = self._ls_step(s, value_and_grad)
            s = {k: _where(going, new[k], s[k]) for k in s}
        return s

    # -- one optimizer iteration -----------------------------------------
    def step(self, value_and_grad: Callable, params: torch.Tensor,
             state: LBFGSState, active: Optional[torch.Tensor] = None):
        """One L-BFGS iteration for the lanes in ``active`` (all if None):
        ``value_and_grad_from_state``, ``opt.update`` and
        ``apply_updates``.  Other lanes keep their params and state.
        Returns (params, state)."""
        if active is None:
            active = torch.ones_like(state.count, dtype=torch.bool)
        value, grad = self.value_and_grad_from_state(value_and_grad, params,
                                                     state)
        direction, (dpm, dum, wm) = self._lbfgs_direction(grad, state, params)
        updates = -1.0 * direction
        s = self._linesearch(updates, params, value, grad,
                             state.learning_rate, value_and_grad, active)
        learning_rate = s["stepsize"]
        new_params = params + learning_rate[:, None] * updates
        new_state = LBFGSState(
            count=state.count + 1, params=params, updates=grad,
            diff_params_memory=dpm, diff_updates_memory=dum,
            weights_memory=wm, learning_rate=learning_rate, value=s["value"],
            grad=s["grad"])
        params = _where(active, new_params, params)
        state = LBFGSState(*(_where(active, n, o)
                             for n, o in zip(new_state, state)))
        return params, state
