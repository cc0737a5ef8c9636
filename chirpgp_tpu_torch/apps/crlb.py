"""Filter-error Monte Carlo and the posterior Cramer--Rao bound of the
chirp model, paper Fig. 5 (counterpart of ``chirpgp_tpu.apps.crlb``).

Simulate N trajectories of the chirp SDE at fixed parameters, filter every
measurement sequence, and reduce per-time-step squared errors on the
chirp component ``X2`` and on ``V``.  :func:`filter_error_mc_chunked` is
the reference-scale job (1e6 trajectories): each chunk is simulated as
one batch on the device and filtered, with the ``cf`` backend, by
``ops.chirp_filter.ghfs_chirp_filter`` -- the CUDA kernel for a tensor on
the card (it raises if the kernel cannot build or launch), its plain
version for a tensor on the host.

Torch cannot replay JAX's threefry streams.  The draws come from an
explicit ``torch.Generator`` on the data's device; every function here
also takes ``draws``, a callable ``(index, n) -> (z0 (n, 4), zx (n, T,
4), zy (n, T))`` that returns the standard normals of chunk ``index``
instead, which is how the port is held to the JAX package.
"""

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from chirpgp_tpu_torch.infer.filters import ekf, sgp_filter
from chirpgp_tpu_torch.models.chirp import disc_chirp_lcd, model_chirp
from chirpgp_tpu_torch.models.crlb import posterior_cramer_rao
from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
from chirpgp_tpu_torch.parallel.mesh import sharded_mean
from chirpgp_tpu_torch.quad.sigma_points import gauss_hermite
from chirpgp_tpu_torch.utils.sim import _simulate_batch_from_noise

__all__ = ["filter_error_mc", "filter_error_mc_chunked", "pcrlb_chirp_mc"]

Draws = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _generator_draws(generator: Optional[torch.Generator], seed: int,
                     T: int, dtype, device) -> Draws:
    """Standard normals from ``generator`` (default: a generator on
    ``device`` seeded with ``seed``), in ``dtype`` on ``device``."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    gdev = generator.device

    def draws(_index, n):
        z = [torch.randn(shape, generator=generator, dtype=dtype, device=gdev)
             for shape in ((n, 4), (n, T, 4), (n, T))]
        return tuple(x.to(device) for x in z)

    return draws


def _reference_sim_setup(lam, b, delta, ell, sigma, dt, dtype,
                         device="cpu"):
    """The reference CRLB jobs' simulation contract: sample x0 ~ N(m0,
    P0), step the LCD conditional MEAN, and add noise with the FIXED
    factor ``chol(cov(0, dt))`` (the conditional covariance evaluated once
    at x = 0), i.e. the simulator is not re-linearized per state.  Returns
    ``(trans, m0, P0, H, chol_P0, chol_Q)``, the tensors in ``dtype`` on
    ``device``."""
    _, _, m0, P0, H = model_chirp(lam, b, ell, sigma, delta)
    trans = disc_chirp_lcd(lam, b, ell, sigma)
    _, state_cov = trans(torch.zeros(4, dtype=torch.float64), dt)
    like = dict(dtype=dtype, device=device)
    return (trans, m0.to(**like), P0.to(**like), H.to(**like),
            torch.linalg.cholesky(P0).to(**like),
            torch.linalg.cholesky(state_cov).to(**like))


def _simulate(trans, m0, chol_P0, chol_Q, H, sqrt_Xi, dt, z0, zx, zy):
    """The reference simulator over a batch: ``x0 = m0 + chol_P0 z0``,
    ``x_k = mean(x_{k-1}) + chol_Q zx_k``, ``y_k = H x_k + sqrt(Xi)
    zy_k``.  Returns ``x0`` (n, 4), ``xs`` (n, T, 4) and ``ys`` (n, T)."""
    x0 = m0 + z0 @ chol_P0.T
    x, xs, ys = x0, [], []
    for k in range(zx.shape[1]):
        x = trans.mean(x, dt) + zx[:, k] @ chol_Q.T
        xs.append(x)
        ys.append(x @ H + sqrt_Xi * zy[:, k])
    return x0, torch.stack(xs, dim=1), torch.stack(ys, dim=1)


def _vmap_filter_means(method, lam, b, ell, sigma, sgps, H, Xi, m0, P0, dt,
                       ys):
    """Filter means (n, T, 4) of the per-seed covariance filter, vmapped
    over the rows of ``ys`` (n, T).  The transition's constants are made in
    the filter's dtype: under vmap a 0-dim float64 constant would promote
    the 0-dim slices of a float32 state."""
    trans = disc_chirp_lcd(*(torch.tensor(float(v), dtype=m0.dtype,
                                          device=m0.device)
                             for v in (lam, b, ell, sigma)))
    if method == "ghf":
        fn = lambda y: sgp_filter(trans, sgps, H, Xi, m0, P0, dt, y)[0]
    elif method == "ekf":
        fn = lambda y: ekf(trans, H, Xi, m0, P0, dt, y)[0]
    else:
        raise ValueError(f"Unknown method {method!r}")
    return torch.func.vmap(fn)(ys)


def filter_error_mc(lam: float, b: float, delta: float, ell: float,
                    sigma: float, Xi: float, num_mcs: int,
                    method: str = "ghf", dt: float = 0.01, T: int = 500,
                    gh_order: int = 3, generator=None, mesh=None,
                    dtype=torch.float64, device="cuda",
                    draws: Optional[Draws] = None) -> Dict[str, np.ndarray]:
    """Per-time-step mean/std of squared filter errors over ``num_mcs``
    simulated trajectories, all in one batch: ``simulate_sde``'s scheme
    (``x0 ~ N(m0, P0)``, increments through ``chol(cov(x))``) and the
    per-seed ``sgp_filter`` (``method="ghf"``) or ``ekf``, vmapped.

    The draws default to a generator seeded with 2022 on ``device``.
    With ``mesh`` the trajectories are split over its ranks, each on the
    mesh's device: rank r takes its rows of the unsharded run's draws (so
    every rank makes all ``num_mcs`` of them) and a SUM all-reduce adds
    the ranks' error sums; ``num_mcs`` must be a multiple of the mesh
    size.  Returns host arrays ``mean_err_x2``/``std_err_x2`` (chirp
    component) and ``mean_err_v``/``std_err_v`` (frequency state).
    """
    if method not in ("ghf", "ekf"):
        raise ValueError(f"Unknown method {method!r}")
    if mesh is not None:
        device = mesh.device
    if draws is None:
        draws = _generator_draws(generator, 2022, T, dtype, device)
    _, _, m0, P0, H = model_chirp(lam, b, ell, sigma, delta)
    like = dict(dtype=dtype, device=device)
    # The simulator's transition on the data's device, like the filter's.
    trans = disc_chirp_lcd(*(torch.tensor(float(v), **like)
                             for v in (lam, b, ell, sigma)))
    m0, P0, H = m0.to(**like), P0.to(**like), H.to(**like)
    z0, dws, zy = (z.to(**like) for z in draws(0, num_mcs))

    def errors(rows):
        x0 = m0 + z0[rows] @ torch.linalg.cholesky(P0).T
        traj = _simulate_batch_from_noise(trans, x0, dws[rows], dt)
        ys = traj @ H + math.sqrt(Xi) * zy[rows]           # traj (n, T, 4)
        mfs = _vmap_filter_means(method, lam, b, ell, sigma,
                                 gauss_hermite(4, gh_order), H, Xi, m0, P0,
                                 dt, ys)
        err_x2 = (mfs[..., 1] - traj[..., 1]) ** 2
        err_v = (mfs[..., 2] - traj[..., 2]) ** 2
        return dict(err_x2=err_x2, err_v=err_v, err_x2_sq=err_x2 ** 2,
                    err_v_sq=err_v ** 2)

    if mesh is not None:
        means = sharded_mean(errors, torch.arange(num_mcs), mesh)
    else:
        means = {k: e.mean(0) for k, e in errors(slice(None)).items()}
    means = {k: v.cpu().numpy() for k, v in means.items()}
    var_x2 = np.maximum(means["err_x2_sq"] - means["err_x2"] ** 2, 0.0)
    var_v = np.maximum(means["err_v_sq"] - means["err_v"] ** 2, 0.0)
    return dict(mean_err_x2=means["err_x2"], std_err_x2=np.sqrt(var_x2),
                mean_err_v=means["err_v"], std_err_v=np.sqrt(var_v))


def filter_error_mc_chunked(lam: float, b: float, delta: float, ell: float,
                            sigma: float, Xi: float, num_mcs: int,
                            method: str = "ghf", dt: float = 0.01,
                            T: int = 500, gh_order: int = 3, generator=None,
                            chunk: int = 16384, backend: str = "auto",
                            dtype=torch.float32, device="cuda",
                            draws: Optional[Draws] = None
                            ) -> Dict[str, np.ndarray]:
    """Reference-scale (1e6-trajectory) filter-error Monte Carlo with
    bounded memory: trajectories are simulated, filtered and reduced to
    per-time-step error sums in chunks of ``chunk`` seeds on ``device``;
    the sums accumulate on the host in float64.

    Simulation follows the reference job (:func:`_reference_sim_setup`),
    with independent normals for the initial state, the state increments
    and the measurement noise.  ``backend``: ``"cf"`` filters each chunk
    through ``ghfs_chirp_filter`` with ``model_chirp``'s prior mean
    ``[0, 1, 0, 0]`` (the CUDA kernel on the card, one launch per chunk;
    the plain ``sqrt_sgp_filter_batched`` on the host; sigma-point method
    only); ``"vmap"`` runs the per-seed covariance filter (``sgp_filter``
    or ``ekf``) under ``torch.func.vmap``; ``"auto"`` picks ``"cf"`` for
    ``method="ghf"`` and ``"vmap"`` for the EKF.  The draws default to a
    generator seeded with 666 on ``device``.

    Returns per-step ``mean_err_x2``/``std_err_x2`` (chirp component
    error^2) and ``mean_err_v``/``std_err_v``, float64 host arrays.
    """
    if method not in ("ghf", "ekf"):
        raise ValueError(f"Unknown method {method!r}")
    if backend == "auto":
        backend = "cf" if method == "ghf" else "vmap"
    if backend not in ("cf", "vmap"):
        raise ValueError(f"Unknown backend {backend!r}")
    if backend == "cf" and method != "ghf":
        raise ValueError("backend='cf' supports the sigma-point filter only")
    if draws is None:
        draws = _generator_draws(generator, 666, T, dtype, device)
    trans, m0, P0, H, chol_P0, chol_Q = _reference_sim_setup(
        lam, b, delta, ell, sigma, dt, dtype, device)
    sgps = gauss_hermite(4, gh_order)
    sqrt_Xi = math.sqrt(Xi)
    params = (lam, b, delta, ell, sigma, 0.0)

    def chunk_stats(z0, zx, zy):
        _, xs, ys = _simulate(trans, m0, chol_P0, chol_Q, H, sqrt_Xi, dt,
                              z0, zx, zy)
        if backend == "cf":
            mfs = ghfs_chirp_filter(params, Xi, dt, sgps, ys, m0=m0)[0]
            mfs = mfs.permute(2, 0, 1)                       # (C, T, 4)
        else:
            mfs = _vmap_filter_means(method, lam, b, ell, sigma, sgps, H,
                                     Xi, m0, P0, dt, ys)
        ex2 = (mfs[..., 1] - xs[..., 1]) ** 2                # (C, T)
        ev = (mfs[..., 2] - xs[..., 2]) ** 2
        return [s.double().cpu().numpy() for s in
                (ex2.sum(0), (ex2 ** 2).sum(0), ev.sum(0), (ev ** 2).sum(0))]

    sums = [np.zeros((T,), np.float64) for _ in range(4)]
    done = 0
    with torch.no_grad():
        while done < num_mcs:
            n = min(chunk, num_mcs - done)
            z = (x.to(dtype=dtype, device=device)
                 for x in draws(done // chunk, n))
            for acc, s in zip(sums, chunk_stats(*z)):
                acc += s
            done += n

    s_x2, s_x2_sq, s_v, s_v_sq = sums
    mean_x2 = s_x2 / num_mcs
    mean_v = s_v / num_mcs
    var_x2 = np.maximum(s_x2_sq / num_mcs - mean_x2 ** 2, 0.0)
    var_v = np.maximum(s_v_sq / num_mcs - mean_v ** 2, 0.0)
    return dict(mean_err_x2=mean_x2, std_err_x2=np.sqrt(var_x2),
                mean_err_v=mean_v, std_err_v=np.sqrt(var_v))


def pcrlb_chirp_mc(lam: float, b: float, delta: float, ell: float,
                   sigma: float, Xi: float, num_mcs: int = 100_000,
                   dt: float = 0.01, T: int = 500, generator=None,
                   dtype=torch.float32, device="cuda",
                   draws: Optional[Draws] = None) -> Dict[str, np.ndarray]:
    """Posterior Cramer--Rao bound for the chirp model on ``num_mcs``
    trajectories simulated as in :func:`filter_error_mc_chunked` (draws
    default to a generator seeded with 666 on ``device``).

    Returns per-step ``pcrlb_x2``/``pcrlb_v``: the (1,1) and (2,2)
    entries of J_k^{-1}, the bound on the mean squared filter error of
    the chirp and V components, as host arrays.
    """
    if draws is None:
        draws = _generator_draws(generator, 666, T, dtype, device)
    trans, m0, P0, H, chol_P0, chol_Q = _reference_sim_setup(
        lam, b, delta, ell, sigma, dt, dtype, device)
    sqrt_Xi = math.sqrt(Xi)
    Q_inv = torch.cholesky_inverse(chol_Q)
    z0, zx, zy = (x.to(dtype=dtype, device=device)
                  for x in draws(0, num_mcs))
    with torch.no_grad():
        x0, xs, ys = _simulate(trans, m0, chol_P0, chol_Q, H, sqrt_Xi, dt,
                               z0, zx, zy)
    xss = torch.cat([x0[:, None], xs], dim=1).transpose(0, 1)  # (T+1, N, d)
    yss = ys.T                                                  # (T, N)

    # Log-densities up to constants, which the Hessians do not see.  Under
    # vmap the model's 0-dim float64 constants meet 0-dim slices of the
    # state and promote them, hence the cast.
    def logpdf_transition(xt, xs_):
        r = xt - trans.mean(xs_, dt).to(xt.dtype)
        return -0.5 * r @ Q_inv @ r

    def logpdf_likelihood(y, x):
        return -0.5 * ((y - x @ H) / sqrt_Xi) ** 2

    js = posterior_cramer_rao(xss, yss, torch.linalg.inv(P0),
                              logpdf_transition, logpdf_likelihood)
    inv = torch.linalg.inv(js)
    return dict(pcrlb_x2=inv[:, 1, 1].cpu().numpy(),
                pcrlb_v=inv[:, 2, 2].cpu().numpy())
