"""No-U-Turn Sampler (NUTS) over hyperparameter posteriors (counterpart of
``chirpgp_tpu.infer.nuts``).

Multinomial NUTS (Betancourt 2017) with iterative tree expansion: each
doubling j grows the trajectory by 2^j leapfrog steps, and the recursive
algorithm's balanced-subtree U-turn checks are reproduced exactly with an
O(max_depth) checkpoint stack -- even leaf n stores its momentum and
cumulative momentum sum at index ``popcount(n)``, odd leaf n checks the
blocks ``popcount(n) - trailing_ones(n) .. popcount(n) - 1``.  The step
size is adapted by dual averaging (Hoffman & Gelman 2014) during warmup.

Chains ride a leading axis: every leapfrog evaluates the log density and
its gradient of all chains in one call
(:func:`~chirpgp_tpu_torch.fit.lbfgs.batched_value_and_grad`), and each
chain keeps its own tree and step size.  A chain that has stopped is
masked, as in the JAX package's fixed ``2^max_depth - 1`` budget; the
rest of a subtree, or a whole doubling, is skipped once every chain has
stopped, which changes no sample (the draws are indexed by leaf).

Torch cannot replay JAX's threefry streams, so a transition runs on
:class:`NUTSDraws`: JAX splits the momentum, the direction of each
doubling, one uniform per leaf and one merge uniform per doubling
statically, so they are fixed-shape tensors, drawn from a
``torch.Generator`` or given by the caller.
"""

import math
from typing import Callable, NamedTuple, Optional

import torch

from chirpgp_tpu_torch.fit.lbfgs import batched_value_and_grad
from chirpgp_tpu_torch.parallel.mesh import (
    Mesh, all_gather, all_reduce, rank_stream, shard_keys)

__all__ = ["nuts_sample", "nuts_sample_sharded", "NUTSResult", "NUTSDraws",
           "nuts_draws"]

_DIVERGENCE_THRESHOLD = 1000.0


class NUTSResult(NamedTuple):
    """With a leading chain axis when ``init`` has one."""
    samples: torch.Tensor         # (num_samples, d)
    log_densities: torch.Tensor   # (num_samples,)
    accept_prob: torch.Tensor     # (num_samples,) mean Metropolis stat
    num_divergent: torch.Tensor   # () divergences after warmup
    step_size: torch.Tensor       # () adapted step size


class NUTSDraws(NamedTuple):
    """The random numbers of NUTS transitions, leading axes
    ``(transitions, chains)``: the momentum ``normal(k_mom)``, the
    direction ``bernoulli`` of each doubling (True: forward), the leaf
    uniforms of doubling j at ``[2^j - 1, 2^(j+1) - 1)`` and the merge
    uniform of each doubling (``fold_in(key, 12345)`` in JAX)."""
    momentum: torch.Tensor    # (..., d)
    direction: torch.Tensor   # (..., max_depth) bool
    leaf_u: torch.Tensor      # (..., 2^max_depth - 1)
    merge_u: torch.Tensor     # (..., max_depth)


def nuts_draws(generator: torch.Generator, shape, d: int, max_tree_depth: int,
               dtype=torch.float64) -> NUTSDraws:
    """:class:`NUTSDraws` of leading ``shape`` from ``generator``, on its
    device."""
    shape = tuple(shape)

    def rand(*tail):
        return torch.rand(shape + tail, generator=generator, dtype=dtype,
                          device=generator.device)

    momentum = torch.randn(shape + (d,), generator=generator, dtype=dtype,
                           device=generator.device)
    return NUTSDraws(momentum, rand(max_tree_depth) < 0.5,
                     rand(2 ** max_tree_depth - 1), rand(max_tree_depth))


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _trailing_ones(n: int) -> int:
    return _popcount(((n + 1) & -(n + 1)) - 1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _where(cond: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """``torch.where`` with a per-chain ``cond`` (C,) over (C, ...)."""
    return torch.where(cond.reshape(cond.shape + (1,) * (x.dim() - 1)), x, y)


def _leapfrog(value_and_grad, q, p, grad, eps):
    """One leapfrog step per chain from ``(q, p)`` with ``grad`` the
    gradient at ``q`` (kept from the step that reached ``q``: the JAX
    package evaluates it again, to the same value)."""
    p_half = p + 0.5 * eps[:, None] * grad
    q_new = q + eps[:, None] * p_half
    logp_new, grad_new = value_and_grad(q_new)
    p_new = p_half + 0.5 * eps[:, None] * grad_new
    return q_new, p_new, logp_new, grad_new


class _TreeState(NamedTuple):
    """The whole trajectory across doublings, per chain."""
    q_left: torch.Tensor
    p_left: torch.Tensor
    g_left: torch.Tensor
    q_right: torch.Tensor
    p_right: torch.Tensor
    g_right: torch.Tensor
    q_prop: torch.Tensor
    logw_prop: torch.Tensor      # the proposal's log density
    g_prop: torch.Tensor         # and its gradient
    log_sum_w: torch.Tensor      # logsumexp of trajectory weights (rel. H0)
    p_sum: torch.Tensor
    sum_accept: torch.Tensor
    num_steps: torch.Tensor
    terminated: torch.Tensor     # U-turn or divergence seen
    diverged: torch.Tensor


def _build_subtree(value_and_grad, tree: _TreeState, forward, eps, H0,
                   depth: int, max_depth: int, leaf_u,
                   merge_u) -> _TreeState:
    """Grow every chain's trajectory by ``2^depth`` leapfrog steps in its
    direction (``forward``: (C,) bool), with the recursive algorithm's
    internal U-turn checks, and merge.  ``leaf_u`` (C, 2^depth) and
    ``merge_u`` (C,) are the doubling's uniforms."""
    C, d = tree.q_left.shape
    q = _where(forward, tree.q_right, tree.q_left)
    p = _where(forward, tree.p_right, tree.p_left)
    grad = _where(forward, tree.g_right, tree.g_left)
    step = torch.where(forward, eps, -eps)
    neg_inf = torch.full_like(H0, -math.inf)
    false = torch.zeros(C, dtype=torch.bool, device=H0.device)
    sub_qprop, sub_logw, sub_gprop, sub_logsumw = q, neg_inf, grad, neg_inf
    sub_psum, sub_accept = torch.zeros_like(q), torch.zeros_like(H0)
    sub_turn, sub_div = false, false
    ck_p = q.new_zeros(C, max_depth + 1, d)
    ck_psum = q.new_zeros(C, max_depth + 1, d)

    for leaf in range(2 ** depth):
        stopped = sub_turn | sub_div
        if bool((stopped | tree.terminated).all()):
            break   # every chain keeps its carry from here on
        q_new, p_new, logp_new, grad_new = _leapfrog(
            value_and_grad, q, p, grad, step)
        delta = logp_new - 0.5 * _dot(p_new, p_new) - H0
        diverged = delta < -_DIVERGENCE_THRESHOLD
        accept = torch.exp(delta.clamp(max=80.0)).clamp(max=1.0)
        logw = torch.where(diverged, neg_inf, delta)
        psum_new = sub_psum + p_new

        # Progressive multinomial proposal within the subtree.
        logsumw_new = torch.logaddexp(sub_logsumw, logw)
        take_new = torch.log(leaf_u[:, leaf]) < logw - logsumw_new

        # Checkpoint store (even leaf) or U-turn checks (odd leaf).
        turning = false
        if leaf % 2 == 0:
            at = _popcount(leaf)
            keep = stopped[:, None]
            ck_p[:, at] = torch.where(keep, ck_p[:, at], p_new)
            ck_psum[:, at] = torch.where(keep, ck_psum[:, at], psum_new)
        else:
            hi = _popcount(leaf) - 1
            lo = hi - _trailing_ones(leaf) + 1
            cp, cs = ck_p[:, lo:hi + 1], ck_psum[:, lo:hi + 1]
            block_sums = psum_new[:, None] - cs + cp
            turning = ((_dot(block_sums, cp) <= 0.0)
                       | (_dot(block_sums, p_new[:, None]) <= 0.0)).any(-1)

        q = _where(stopped, q, q_new)
        p = _where(stopped, p, p_new)
        grad = _where(stopped, grad, grad_new)
        kept = stopped | ~take_new
        sub_qprop = _where(kept, sub_qprop, q_new)
        sub_logw = torch.where(kept, sub_logw, logp_new)
        sub_gprop = _where(kept, sub_gprop, grad_new)
        sub_logsumw = torch.where(stopped, sub_logsumw, logsumw_new)
        sub_psum = _where(stopped, sub_psum, psum_new)
        sub_accept = torch.where(stopped, sub_accept, sub_accept + accept)
        sub_turn = sub_turn | (~stopped & turning)
        sub_div = sub_div | (~stopped & diverged)

    # The subtree's own U-turn or divergence discards the whole extension
    # (recursive semantics); the trajectory then terminates.
    bad = sub_turn | sub_div
    usable = ~tree.terminated & ~bad
    total = torch.logaddexp(tree.log_sum_w, sub_logsumw)
    take = usable & (torch.log(merge_u) < sub_logsumw - total)
    left = usable & ~forward
    right = usable & forward
    q_left = _where(left, q, tree.q_left)
    p_left = _where(left, p, tree.p_left)
    q_right = _where(right, q, tree.q_right)
    p_right = _where(right, p, tree.p_right)
    p_sum = _where(usable, tree.p_sum + sub_psum, tree.p_sum)
    full_turn = (_dot(p_sum, p_left) <= 0.0) | (_dot(p_sum, p_right) <= 0.0)
    return _TreeState(
        q_left=q_left, p_left=p_left, g_left=_where(left, grad, tree.g_left),
        q_right=q_right, p_right=p_right,
        g_right=_where(right, grad, tree.g_right),
        q_prop=_where(take, sub_qprop, tree.q_prop),
        logw_prop=torch.where(take, sub_logw, tree.logw_prop),
        g_prop=_where(take, sub_gprop, tree.g_prop),
        log_sum_w=torch.where(usable, total, tree.log_sum_w),
        p_sum=p_sum,
        sum_accept=tree.sum_accept + torch.where(
            tree.terminated, torch.zeros_like(sub_accept), sub_accept),
        num_steps=tree.num_steps + torch.where(
            tree.terminated, 0, 2 ** depth),
        terminated=tree.terminated | bad | (usable & full_turn),
        diverged=tree.diverged | (~tree.terminated & sub_div))


def _nuts_transition(value_and_grad, q, logp, grad, eps, draws: NUTSDraws,
                     max_tree_depth: int):
    """One NUTS transition of every chain from ``q`` (C, d) with its log
    density and gradient, at step sizes ``eps`` (C,), on one transition's
    ``draws`` (leading axis C).  Returns ``(q', logp', grad', accept_stat,
    diverged)``, with ``grad'`` the gradient at ``q'``."""
    p = draws.momentum.to(q)
    H0 = logp - 0.5 * _dot(p, p)
    false = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    tree = _TreeState(
        q_left=q, p_left=p, g_left=grad, q_right=q, p_right=p, g_right=grad,
        q_prop=q, logw_prop=logp, g_prop=grad,
        log_sum_w=torch.zeros_like(logp), p_sum=p,
        sum_accept=torch.zeros_like(logp),
        num_steps=torch.zeros(q.shape[0], dtype=torch.int64, device=q.device),
        terminated=false, diverged=false)
    leaf_u = draws.leaf_u.to(device=q.device)
    forward = draws.direction.to(q.device)
    merge_u = draws.merge_u.to(device=q.device)
    for j in range(max_tree_depth):
        if bool(tree.terminated.all()):
            break   # later doublings leave every chain as it is
        tree = _build_subtree(value_and_grad, tree, forward[:, j], eps, H0,
                              j, max_tree_depth,
                              leaf_u[:, 2 ** j - 1:2 ** (j + 1) - 1],
                              merge_u[:, j])
    accept_stat = tree.sum_accept / tree.num_steps.clamp(min=1).to(logp)
    return tree.q_prop, tree.logw_prop, tree.g_prop, accept_stat, \
        tree.diverged


class _DualAveraging(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    t: torch.Tensor


def _da_init(eps0: torch.Tensor) -> _DualAveraging:
    zero = torch.zeros_like(eps0)
    return _DualAveraging(torch.log(eps0), torch.log(eps0), zero, zero)


def _da_update(state: _DualAveraging, accept_stat, target, mu,
               gamma=0.05, t0=10.0, kappa=0.75) -> _DualAveraging:
    t = state.t + 1.0
    h_avg = (1.0 - 1.0 / (t + t0)) * state.h_avg \
        + (target - accept_stat) / (t + t0)
    log_eps = mu - torch.sqrt(t) / gamma * h_avg
    w = t ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * state.log_eps_avg
    return _DualAveraging(log_eps, log_eps_avg, h_avg, t)


def _run_chains(value_and_grad, q: torch.Tensor, draw: Callable,
                num_warmup: int, num_samples: int, step_size: float,
                max_tree_depth: int, target_accept: float,
                pool: Callable) -> NUTSResult:
    """Warmup with dual averaging, then sampling, of the chains ``q`` (C,
    d), on ``draw(i)``, the draws of transition ``i``.  ``pool`` maps the
    chains' accept statistics (C,) to the one the step size adapts to, and
    fixes the step size's shape: per chain (C,), or one () for all.
    Returns the :class:`NUTSResult` with the chain axis leading."""
    C = q.shape[0]
    mu = math.log(10.0 * step_size)
    with torch.no_grad():
        logp, grad = value_and_grad(q)
        da = _da_init(torch.as_tensor(
            step_size, dtype=q.dtype, device=q.device).expand_as(
                pool(torch.zeros_like(logp))).clone())
        for i in range(num_warmup):
            q, logp, grad, accept, _ = _nuts_transition(
                value_and_grad, q, logp, grad,
                torch.exp(da.log_eps).expand(C), draw(i), max_tree_depth)
            da = _da_update(da, pool(accept), target_accept, mu)
        eps = torch.exp(da.log_eps_avg)
        out = []
        for i in range(num_warmup, num_warmup + num_samples):
            q, logp, grad, accept, diverged = _nuts_transition(
                value_and_grad, q, logp, grad, eps.expand(C), draw(i),
                max_tree_depth)
            out.append((q, logp, accept, diverged))
    qs, logps, accepts, divs = (torch.stack(x, 1) for x in zip(*out))
    return NUTSResult(samples=qs, log_densities=logps, accept_prob=accepts,
                      num_divergent=divs.sum(1), step_size=eps.expand(C))


def nuts_sample(logdensity: Callable, init: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                num_samples: int = 1000, num_warmup: int = 500,
                step_size: float = 0.1, max_tree_depth: int = 8,
                target_accept: float = 0.8,
                draws: Optional[NUTSDraws] = None) -> NUTSResult:
    """Sample from ``exp(logdensity)`` with NUTS.

    ``logdensity`` maps one point (d,) to a scalar; ``init`` is (d,) for
    one chain or (C, d) for C chains on a leading axis, all evaluated in
    one batched call per leapfrog, each with its own step size.  The
    random numbers are ``draws``
    (:class:`NUTSDraws` with leading axes ``(num_warmup + num_samples,)``,
    then C if ``init`` has chains), or else drawn from ``generator``; one
    of the two is required.  Computes in ``init``'s dtype on its device.
    Once every chain has stopped, the rest of a subtree or a doubling is
    skipped: the JAX package runs those leapfrogs masked, to the same
    samples.
    """
    if draws is None and generator is None:
        raise ValueError("nuts_sample needs a torch.Generator or draws")
    one_chain = init.dim() == 1
    q = init.detach()[None] if one_chain else init.detach()
    C, d = q.shape

    def draw(i):
        if draws is None:
            return nuts_draws(generator, (C,), d, max_tree_depth, q.dtype)
        return NUTSDraws(*(x[i][None] if one_chain else x[i] for x in draws))

    res = _run_chains(batched_value_and_grad(logdensity), q, draw,
                      num_warmup, num_samples, step_size, max_tree_depth,
                      target_accept, lambda accept: accept)
    return NUTSResult(*(x[0] for x in res)) if one_chain else res


def nuts_sample_sharded(logdensity: Callable, inits: torch.Tensor,
                        generator: Optional[torch.Generator], mesh: Mesh,
                        num_samples: int = 1000, num_warmup: int = 500,
                        step_size: float = 0.1, max_tree_depth: int = 8,
                        target_accept: float = 0.8,
                        draws: Optional[NUTSDraws] = None) -> NUTSResult:
    """Multi-chain NUTS with the chains ``inits`` (n_chains, d) split over
    ``mesh``'s ranks and one step size for all of them: at each warmup
    iteration the ranks all-reduce their chains' mean accept statistic and
    divide by the mesh size (the JAX package's ``pmean``) before the dual
    averaging update.  Every rank returns the gathered
    :class:`NUTSResult`, samples (n_chains, num_samples, d).

    ``draws`` are this rank's, leading axes ``(num_warmup + num_samples,
    n_local)``; by default they come from a stream of this rank's own,
    seeded from ``generator`` and the rank.  Computes in ``inits``' dtype
    on the mesh's device.
    """
    q = shard_keys(torch.as_tensor(inits).detach(), mesh)
    C, d = q.shape
    if draws is None:
        if generator is None:
            raise ValueError("nuts_sample_sharded needs a torch.Generator "
                             "or draws")
        draws = nuts_draws(rank_stream(generator, mesh.rank),
                           (num_warmup + num_samples, C), d, max_tree_depth,
                           q.dtype)

    def pooled(accept):
        return all_reduce(accept.mean(), mesh) / mesh.size

    res = _run_chains(batched_value_and_grad(logdensity), q,
                      lambda i: NUTSDraws(*(x[i] for x in draws)),
                      num_warmup, num_samples, step_size, max_tree_depth,
                      target_accept, pooled)
    return NUTSResult(*all_gather(tuple(res), mesh))
