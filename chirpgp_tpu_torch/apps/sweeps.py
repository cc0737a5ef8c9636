"""Monte-Carlo experiment sweeps: the Table-I RMSE jobs (counterpart of
``chirpgp_tpu.apps.sweeps``).

- **Pairing**: every method sees the same measurement realizations, from
  the same per-seed keys (:func:`generate_rnd_keys`): the JAX package's
  keys, whose records the port remakes without JAX
  (``utils/jax_keys.py``), so a key-driven sweep runs on the same records
  as the JAX package's and its columns pair with ``results/`` seed by
  seed.
- **Batched MLE**: all seeds step in lockstep through the batched L-BFGS
  (:func:`~chirpgp_tpu_torch.fit.mle.lbfgs_minimize_stepped`), each value
  and gradient one ``torch.func.vmap`` over the seeds on the measurements'
  device; then a per-lane SciPy rescue of stuck lanes and a per-lane
  float64 SciPy polish, both on that device with the lanes' evaluations
  batched, and the estimate stage, vmapped over the seeds.
- **NaN-on-divergence**: runs whose optimizer fails are recorded as NaN.
- **Mesh**: with ``mesh``, :func:`mc_mle_sweep` and :func:`mc_kpt_sweep`
  split the seeds over the mesh's ranks
  (:func:`~chirpgp_tpu_torch.parallel.mesh.sharded_seed_sweep`); each rank
  runs its seeds on its device, and every rank returns all seeds' results.
- **Results** per (method, magnitude) as ``.npz`` with ``rmse``, learnt
  params and ``success``, consumed by :func:`print_rmse_table`.

Entry points that take host data put it on ``device``, the card unless
the caller passes ``device="cpu"``.
"""

import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from chirpgp_tpu_torch.apps.kpt import (
    _kpt_init_theta, _kpt_nll, kpt_if_estimate)
from chirpgp_tpu_torch.apps.pipeline import (
    IFEstimationConfig, _filter_fns, _init_theta, _measurements, _on_data,
    make_nll_fn)
from chirpgp_tpu_torch.fit.lbfgs import batched_value_and_grad
from chirpgp_tpu_torch.fit.mle import (
    MLEResult, lbfgs_minimize, lbfgs_minimize_stepped)
from chirpgp_tpu_torch.models.bijections import g
from chirpgp_tpu_torch.parallel.mesh import sharded_seed_sweep
from chirpgp_tpu_torch.quad.expectations import gaussian_expectation_1d
from chirpgp_tpu_torch.utils.jax_keys import (
    jax_rnd_keys, jax_toymodel_measurements)
from chirpgp_tpu_torch.utils.metrics import rmse

__all__ = ["generate_rnd_keys", "toymodel_measurements", "mc_mle_sweep",
           "mc_mle_sweep_stepped", "mc_kpt_sweep",
           "mle_sweep_on_measurements", "save_results", "print_rmse_table",
           "MAGNITUDES"]


def generate_rnd_keys(num: int = 1000, seed: int = 999) -> torch.Tensor:
    """The JAX package's pregenerated keys, ``jax.random.split(
    jax.random.PRNGKey(seed), num)`` (the reference's
    ``tetralith/generate_rndkeys.py``), remade without JAX
    (:func:`~chirpgp_tpu_torch.utils.jax_keys.jax_rnd_keys`): a (num, 2)
    int64 tensor of each key's two uint32 words.  They split along the
    leading axis like any tensor (``shard_keys``, ``pad_to_multiple``)."""
    return torch.from_numpy(jax_rnd_keys(num, seed).astype(np.int64))


# The three magnitude scenarios of the paper's Table I.
MAGNITUDES = ("const", "damped", "random")


def _host_keys(keys) -> np.ndarray:
    """JAX keys, one (2,) or a batch (N, 2), of any integer tensor or array
    on any device, as the uint32 words on the host."""
    k = keys.cpu().numpy() if isinstance(keys, torch.Tensor) \
        else np.asarray(keys)
    if k.ndim not in (1, 2) or k.shape[-1] != 2:
        raise ValueError(f"JAX keys have shape (2,) or (N, 2), not "
                         f"{k.shape}")
    return k.astype(np.uint32)


def toymodel_measurements(key, mag_name: str, dt: float = 1e-3,
                          T: int = 3141, Xi: float = 0.1,
                          num_harmonics: int = 1, device="cuda"):
    """One seed's toymodel data: (ts, true_freqs, ys).

    The JAX package's record of the JAX key ``key`` (2,) (one row of
    :func:`generate_rnd_keys`): times ``dt..T*dt``, the meow IF with
    offset 8, chirp + N(0, Xi) noise, the key split once, first for the
    measurement noise, second for the OU magnitude (when used).  It is
    remade on the host in torch's default dtype, JAX's draws in that dtype
    (:func:`~chirpgp_tpu_torch.utils.jax_keys.jax_toymodel_measurements`),
    and returned on ``device``.
    """
    return jax_toymodel_measurements(
        _host_keys(key), mag_name, dt=dt, T=T, Xi=Xi,
        num_harmonics=num_harmonics, dtype=torch.get_default_dtype(),
        device=device)


def _measurement_batch(keys, mag_name, T, dt, Xi, num_harmonics, device):
    """(true_freqs, ys), each (N, T) on ``device``: the records of the JAX
    keys ``keys`` (N, 2), as :func:`toymodel_measurements` makes one."""
    _, true_freqs, ys = jax_toymodel_measurements(
        _host_keys(keys).reshape(-1, 2), mag_name, dt=dt, T=T, Xi=Xi,
        num_harmonics=num_harmonics, dtype=torch.get_default_dtype(),
        device=device)
    return true_freqs, ys


def _config_batch(cfg: IFEstimationConfig, keys, mag_name, T, device):
    nh = cfg.num_harmonics if cfg.model == "harmonic" else 1
    return _measurement_batch(keys, mag_name, T, cfg.dt, cfg.Xi, nh, device)


def _estimate_lanes(cfg: IFEstimationConfig, theta, true_freqs, ys,
                    success) -> Dict[str, np.ndarray]:
    """Filter + smooth + GH IF estimate + RMSE of every lane at its learnt
    theta, vmapped over the lanes; NaN rmse where ``success`` is False."""
    flt, smt = _filter_fns(cfg)
    v_idx = cfg.v_index()

    def estimate(theta_i, tf_i, ys_i, success_i):
        params = g(theta_i)
        pack = cfg.build(params)
        mfs, Pfs, _ = flt(pack, ys_i)
        mss, Pss = smt(pack, mfs, Pfs)
        v_mean = mss[:, v_idx]
        if cfg.form == "sqrt":
            v_std = torch.linalg.norm(Pss[:, v_idx, :], dim=-1)
        else:
            v_std = torch.sqrt(Pss[:, v_idx, v_idx].clamp_min(0.0))
        if_mean = gaussian_expectation_1d(
            v_mean, v_std, order=cfg.expectation_order) * cfg.freq_scale
        err = rmse(tf_i, if_mean)
        return dict(rmse=torch.where(success_i, err, torch.nan),
                    params=params, success=success_i)

    with torch.no_grad():
        out = torch.func.vmap(estimate)(_on_data(theta, ys), true_freqs, ys,
                                        success)
    return {k: v.cpu().numpy() for k, v in out.items()}


def mc_mle_sweep(cfg: IFEstimationConfig, keys, mag_name: str,
                 T: int = 3141, mesh=None, init_theta=None,
                 device="cuda") -> Dict[str, np.ndarray]:
    """MLE + filter + smooth + IF-RMSE for every seed in ``keys`` (JAX
    keys (N, 2), :func:`generate_rnd_keys`; the records are the JAX
    package's, :func:`toymodel_measurements`), all seeds in one batched
    :func:`lbfgs_minimize` (each stops on its own gradient-norm rule).
    Returns host arrays: rmses (N,), learnt params (N, P), success flags
    (N,).  Divergent runs contribute NaN rmse.
    With ``mesh`` the seeds are split over its ranks, each on the mesh's
    device, N a multiple of the mesh size; each rank makes its own keys'
    records."""
    if mesh is not None:
        return sharded_seed_sweep(
            lambda k: mc_mle_sweep(cfg, k, mag_name, T, None, init_theta,
                                   mesh.device), keys, mesh)
    true_freqs, ys = _config_batch(cfg, keys, mag_name, T, device)
    init_theta = _init_theta(cfg, init_theta, ys)

    def nll(theta, ys_i):
        return make_nll_fn(cfg, ys_i)(theta)

    theta0 = init_theta.expand((ys.shape[0],) + init_theta.shape).clone()
    opt = lbfgs_minimize(nll, theta0, max_iters=cfg.max_iters,
                         batch_args=(ys,))
    return _estimate_lanes(cfg, opt.params, true_freqs, ys, opt.success)


def mc_mle_sweep_stepped(cfg: IFEstimationConfig, keys, mag_name: str,
                         T: int = 3141, init_theta=None,
                         verbose: bool = False,
                         device="cuda") -> Dict[str, np.ndarray]:
    """:func:`mc_mle_sweep` through :func:`mle_sweep_on_measurements`: the
    stepped batched L-BFGS, the rescue, the float64 polish and the
    estimate.  Same per-seed math and NaN-on-divergence semantics."""
    true_freqs, ys = _config_batch(cfg, keys, mag_name, T, device)
    return mle_sweep_on_measurements(cfg, true_freqs, ys,
                                     init_theta=init_theta, verbose=verbose)


def _minimize_lanes(nll, ys, dtype, x0s, max_iters: int):
    """One SciPy L-BFGS-B per lane ``i`` of ``ys``, from ``x0s[i]``, on
    ``nll(theta, ys[i])`` in ``dtype`` on ``ys``' device; a list of the
    lanes' ``OptimizeResult``.

    Each lane's SciPy run is its own host thread; whenever every running
    lane waits on a point, those points go to the objective as one batched
    value-and-grad (:func:`~chirpgp_tpu_torch.fit.lbfgs.batched_value_and_grad`
    over the waiting lanes).  So a lane takes the steps its own SciPy run
    takes, and the device sees one call per round of evaluations in place
    of one per lane.
    """
    from scipy.optimize import minimize

    cond = threading.Condition()
    asked, answers, results = {}, {}, [None] * len(x0s)
    state = {"running": len(x0s), "error": None}

    def run_lane(i):
        def f_np(x):
            with cond:
                asked[i] = np.array(x, dtype=np.float64)
                cond.notify_all()
                while i not in answers and state["error"] is None:
                    cond.wait()
                if state["error"] is not None:
                    raise RuntimeError("lane evaluation failed")
                return answers.pop(i)

        try:
            results[i] = minimize(f_np, x0s[i], method="L-BFGS-B", jac=True,
                                  options={"maxiter": max_iters})
        except BaseException as exc:  # re-raised on the calling thread
            with cond:
                state["error"] = state["error"] or exc
        finally:
            with cond:
                state["running"] -= 1
                cond.notify_all()

    threads = [threading.Thread(target=run_lane, args=(i,), daemon=True)
               for i in range(len(x0s))]
    for t in threads:
        t.start()
    try:
        while True:
            with cond:
                while (state["error"] is None and state["running"]
                       and len(asked) < state["running"]):
                    cond.wait()
                if state["error"] is not None or not state["running"]:
                    break
                lanes = sorted(asked)
                points = np.stack([asked.pop(i) for i in lanes])
            try:
                at = torch.as_tensor(lanes, device=ys.device)
                values, grads = batched_value_and_grad(nll, (ys[at],))(
                    torch.as_tensor(points, dtype=dtype, device=ys.device))
                values = values.cpu().numpy().astype(np.float64)
                grads = grads.cpu().numpy().astype(np.float64)
            except BaseException as exc:
                with cond:
                    state["error"] = exc
                    cond.notify_all()
                break
            with cond:
                for k, i in enumerate(lanes):
                    answers[i] = (float(values[k]), grads[k])
                cond.notify_all()
    finally:
        for t in threads:
            t.join()
    if state["error"] is not None:
        raise state["error"]
    return results


def _rescue_stuck_lanes(nll, init_theta, theta0, ys, opt,
                        max_iters: int = 300, rescue_tol: float = 1e-3,
                        outlier_z: float = 8.0, verbose: bool = False):
    """Per-lane SciPy L-BFGS-B fallback, on the objective's device and in
    its dtype, for lanes the lockstep batched L-BFGS never moved off the
    init, or that landed far above the batch-typical optimum.

    A lane is "stuck" when its final NLL is not at least
    ``rescue_tol * max(1, |f_init|)`` below the init NLL, or went
    non-finite; a lane whose NLL improvement ``f_final - f_init`` lies
    more than ``outlier_z`` MAD-sigmas above the batch median is
    re-optimized too.  The rescued lane keeps whichever result is better.
    The rescued lanes run together through :func:`_minimize_lanes`.
    """
    with torch.no_grad():
        f_init = torch.func.vmap(nll)(theta0, ys).cpu().numpy()
    f_fin = opt.fun_val.cpu().numpy().astype(np.float64)
    with np.errstate(invalid="ignore"):
        stuck = (~np.isfinite(f_fin)) | (
            f_fin >= f_init - rescue_tol * np.maximum(1.0, np.abs(f_init)))
        delta = f_fin - f_init
        med = np.nanmedian(delta)
        mad = np.nanmedian(np.abs(delta - med))
        # mad == 0 (half the lanes share one improvement) would flag
        # every other lane; the stuck rule covers no-progress lanes then.
        if mad > 0:
            sigma = 1.4826 * mad
            stuck |= np.isfinite(delta) & (delta > med + outlier_z * sigma)
    idx = np.nonzero(stuck)[0]
    if idx.size == 0:
        return opt
    if verbose:
        print(f"  scipy fallback: rescuing {idx.size} stuck lanes "
              f"{idx.tolist()[:16]}{'...' if idx.size > 16 else ''}",
              flush=True)
    params_np = opt.params.cpu().numpy().copy()
    succ_np = opt.success.cpu().numpy().copy()
    iters_np = opt.num_iters.cpu().numpy().copy()
    theta_init64 = np.asarray(torch.as_tensor(init_theta).cpu(),
                              dtype=np.float64)
    results = _minimize_lanes(nll, ys[torch.as_tensor(idx, device=ys.device)],
                              theta0.dtype, [theta_init64] * idx.size,
                              max_iters)
    for i, res in zip(idx, results):
        if np.isfinite(res.fun) and (not np.isfinite(f_fin[i])
                                     or res.fun < f_fin[i]):
            params_np[i] = np.asarray(res.x, dtype=params_np.dtype)
            succ_np[i] = bool(res.success)
            f_fin[i] = res.fun
            iters_np[i] = int(res.nit)
            if verbose:
                print(f"    lane {i}: rescued nll={res.fun:.3f} "
                      f"({int(res.nit)} iters, success={res.success})",
                      flush=True)
    device = opt.params.device
    return MLEResult(
        torch.as_tensor(params_np, device=device),
        torch.as_tensor(f_fin, dtype=opt.fun_val.dtype, device=device),
        torch.as_tensor(iters_np, device=device),
        torch.as_tensor(succ_np, device=device))


def _polish_lanes_f64(nll, init_theta, opt, ys, max_iters: int = 200,
                      verbose: bool = False):
    """Per-lane float64 L-BFGS-B polish of the batched stage's solution, on
    the measurements' device, every lane's evaluations batched by
    :func:`_minimize_lanes`.  (The JAX package pins ``jax.devices("cpu")``
    at x64 for it, since its TPU has no float64; the card has.)

    The float32 NLL of this model family sits at O(1e3) nats, so float32
    resolves relative improvements only down to ~1e-4, and the stepped
    optimizer stalls on a plateau the reference's float64 SciPy run
    descends past.  Re-running the same objective in float64 from each
    lane's best iterate restores the reference's optimizer semantics.
    Lanes whose batched stage went non-finite are polished from the init
    instead.  A polished value above the incoming one (beyond 1e-3
    relative slack) is rejected; a lane without a finite incoming value
    takes its polish only when SciPy reports convergence.
    """
    params_np = opt.params.cpu().numpy().astype(np.float64)
    f_fin = opt.fun_val.cpu().numpy().astype(np.float64)
    succ_np = opt.success.cpu().numpy().copy()
    iters_np = opt.num_iters.cpu().numpy().copy()
    init64 = np.asarray(torch.as_tensor(init_theta).cpu(), dtype=np.float64)
    x0s = [x0 if np.all(np.isfinite(x0)) else init64 for x0 in params_np]
    results = _minimize_lanes(nll, ys.to(torch.float64), torch.float64, x0s,
                              max_iters)
    for i, res in enumerate(results):
        incoming_finite = np.isfinite(f_fin[i])
        slack = 1e-3 * max(1.0, abs(f_fin[i])) if incoming_finite else 0.0
        accept = np.isfinite(res.fun) and (
            (incoming_finite and res.fun <= f_fin[i] + slack)
            or (not incoming_finite and bool(res.success)))
        if accept:
            if verbose and (not incoming_finite
                            or res.fun < f_fin[i] - 1e-3):
                print(f"    f64 polish lane {i}: {f_fin[i]:.3f} -> "
                      f"{res.fun:.3f} ({int(res.nit)} iters)", flush=True)
            params_np[i] = np.asarray(res.x)
            f_fin[i] = res.fun
            # NaN-on-DIVERGENCE: a finite polished optimum is a usable
            # estimate even if SciPy stopped on maxiter.
            succ_np[i] = True
            iters_np[i] = iters_np[i] + int(res.nit)
        elif verbose:
            print(f"    f64 polish lane {i}: rejected (fun="
                  f"{res.fun:.3f} vs incoming {f_fin[i]:.3f}, success="
                  f"{res.success})", flush=True)

    device = opt.params.device
    return MLEResult(
        torch.as_tensor(params_np, dtype=opt.params.dtype, device=device),
        torch.as_tensor(f_fin, dtype=opt.fun_val.dtype, device=device),
        torch.as_tensor(iters_np, device=device),
        torch.as_tensor(succ_np, device=device))


def mle_sweep_on_measurements(cfg: IFEstimationConfig, true_freqs, ys,
                              init_theta=None, polish_f64: bool = True,
                              checkpoint_path: Optional[str] = None,
                              checkpoint_tag: str = "",
                              verbose: bool = False,
                              device="cuda") -> Dict[str, np.ndarray]:
    """Host-stepped batched MLE sweep over measurement batches ``ys (B,
    T)`` with their true IFs ``true_freqs`` ((B, T), or (T,) for all):
    :func:`lbfgs_minimize_stepped` (``tail_iters=30``), the rescue of stuck
    lanes, the float64 polish (``polish_f64``), and the estimate,
    vmapped over the lanes.  Lanes may mix scenarios (all three magnitude
    cases in one batch).  ``checkpoint_path``/``checkpoint_tag`` go to the
    stepped optimizer; the file is not deleted here.  ``verbose`` prints the
    stages' progress and each stage's seconds.  Returns host arrays
    ``rmse`` (B,), ``params`` (B, P) and ``success`` (B,)."""
    ys = _measurements(ys, device)
    true_freqs = _measurements(true_freqs, device)
    if true_freqs.dim() == 1:
        true_freqs = true_freqs.expand(ys.shape)
    init_theta = _init_theta(cfg, init_theta, ys)

    def nll(theta, ys_i):
        return make_nll_fn(cfg, ys_i)(theta)

    theta0 = init_theta.expand((ys.shape[0],) + init_theta.shape).clone()
    t_stage = time.perf_counter()

    def stage_done(name):
        """With ``verbose``, the stage's host wall time (every stage ends
        in a copy to the host, so the device's work is in it)."""
        nonlocal t_stage
        now = time.perf_counter()
        if verbose:
            print(f"  stage {name}: {now - t_stage:.3f} s", flush=True)
        t_stage = now

    opt = lbfgs_minimize_stepped(nll, theta0, batch_args=(ys,),
                                 max_iters=cfg.max_iters,
                                 ftol_rel=cfg.ftol_rel,
                                 patience=cfg.stall_patience,
                                 checkpoint_path=checkpoint_path,
                                 checkpoint_tag=checkpoint_tag,
                                 tail_iters=30, verbose=verbose)
    stage_done("stepped L-BFGS")
    opt = _rescue_stuck_lanes(nll, init_theta, theta0, ys, opt,
                              max_iters=cfg.max_iters, verbose=verbose)
    stage_done("rescue")
    if polish_f64:
        opt = _polish_lanes_f64(nll, init_theta, opt, ys,
                                max_iters=cfg.max_iters, verbose=verbose)
        stage_done("float64 polish")
    res = _estimate_lanes(cfg, opt.params, true_freqs, ys, opt.success)
    stage_done("estimate")
    return res


def _kpt_estimate_lanes(theta, true_freqs, yss, success, fs: float, Xi,
                        num_harmonics: int) -> Dict[str, np.ndarray]:
    """KPT IF estimate and RMSE of every lane at its learnt theta, vmapped
    over the lanes; NaN rmse where ``success`` is False."""

    def est(theta_i, tf_i, ys_i, success_i):
        params = g(theta_i)
        if_mean, _ = kpt_if_estimate(params, fs, Xi, ys_i,
                                     num_harmonics=num_harmonics)
        err = rmse(tf_i, if_mean)
        return dict(rmse=torch.where(success_i, err, torch.nan),
                    params=params, success=success_i)

    with torch.no_grad():
        out = torch.func.vmap(est)(_on_data(theta, yss), true_freqs, yss,
                                   success)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _kpt_sweep_on_measurements(true_freqs, yss, Xi: float = 0.1,
                               dt: float = 1e-3, num_harmonics: int = 1,
                               max_iters: int = 100, verbose: bool = False,
                               device="cuda") -> Dict[str, np.ndarray]:
    """The stepped KPT sweep over measurement batches ``yss (B, T)`` with
    their true IFs ``true_freqs`` ((B, T), or (T,) for all):
    :func:`lbfgs_minimize_stepped` over all lanes (``ftol_rel=1e-9``,
    ``patience=10``, ``tail_iters=30``), the rescue of stuck lanes, the
    float64 polish and the vmapped estimate.  Returns host arrays
    ``rmse`` (B,), ``params`` (B, 5) and ``success`` (B,)."""
    yss = _measurements(yss, device)
    true_freqs = _measurements(true_freqs, device)
    if true_freqs.dim() == 1:
        true_freqs = true_freqs.expand(yss.shape)
    fs = 1.0 / dt
    nll = _kpt_nll(fs, Xi, num_harmonics)
    init_theta = _kpt_init_theta(yss)
    theta0 = init_theta.expand((yss.shape[0],) + init_theta.shape).clone()
    opt = lbfgs_minimize_stepped(nll, theta0, batch_args=(yss,),
                                 max_iters=max_iters, ftol_rel=1e-9,
                                 patience=10, tail_iters=30, verbose=verbose)
    opt = _rescue_stuck_lanes(nll, init_theta, theta0, yss, opt,
                              max_iters=max_iters, verbose=verbose)
    opt = _polish_lanes_f64(nll, init_theta, opt, yss, max_iters=max_iters,
                            verbose=verbose)
    return _kpt_estimate_lanes(opt.params, true_freqs, yss, opt.success, fs,
                               Xi, num_harmonics)


def mc_kpt_sweep(keys, mag_name: str, Xi: float = 0.1, dt: float = 1e-3,
                 T: int = 3141, num_harmonics: int = 1, max_iters: int = 100,
                 mesh=None, stepped: bool = True, verbose: bool = False,
                 device="cuda") -> Dict[str, np.ndarray]:
    """KPT-baseline Monte-Carlo sweep on the JAX package's records of the
    JAX keys ``keys`` (N, 2): per seed, learn ``[q1, q2, p0, f0,
    a0]`` by EKF-marginal MLE, smooth with the linear RTS, estimate the
    IF and record its RMSE (NaN on divergence).

    ``stepped=True`` (default): :func:`_kpt_sweep_on_measurements`, the
    stepped batched L-BFGS with the rescue and the float64 polish.
    ``stepped=False``: one batched :func:`lbfgs_minimize` in which each
    seed stops on its own gradient-norm rule, then the estimate.  With
    ``mesh`` (``stepped=False``, as in the JAX package, whose stepped
    sweep runs unsharded) the seeds are split over its ranks, each on the
    mesh's device."""
    if mesh is not None:
        if stepped:
            raise ValueError(
                "mc_kpt_sweep: mesh splits the stepped=False sweep; the "
                "stepped sweep's rescue compares each lane with the whole "
                "batch")
        return sharded_seed_sweep(
            lambda k: mc_kpt_sweep(k, mag_name, Xi, dt, T, num_harmonics,
                                   max_iters, None, False, verbose,
                                   mesh.device), keys, mesh)
    true_freqs, yss = _measurement_batch(keys, mag_name, T, dt, Xi,
                                         num_harmonics, device)
    if stepped:
        return _kpt_sweep_on_measurements(
            true_freqs, yss, Xi=Xi, dt=dt, num_harmonics=num_harmonics,
            max_iters=max_iters, verbose=verbose)
    fs = 1.0 / dt
    init_theta = _kpt_init_theta(yss)
    theta0 = init_theta.expand((yss.shape[0],) + init_theta.shape).clone()
    opt = lbfgs_minimize(_kpt_nll(fs, Xi, num_harmonics), theta0,
                         max_iters=max_iters, batch_args=(yss,))
    return _kpt_estimate_lanes(opt.params, true_freqs, yss, opt.success, fs,
                               Xi, num_harmonics)


def save_results(results: Dict[str, np.ndarray], method: str,
                 mag_name: str, out_dir: str = "./results") -> str:
    """Write the reference-compatible result file ``{method}_{mag}.npz``."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{method}_{mag_name}.npz")
    np.savez(path, **results)
    return path


def print_rmse_table(results_by_method: Dict[str, Dict[str, np.ndarray]],
                     scale: float = 10.0) -> str:
    """Aggregate per-method RMSE statistics like the reference table
    printer: scaled mean +- std / median / min and the NaN (divergence)
    count.  Prints the table and returns it."""
    lines = [f"{'method':24s} {'mag':8s} {'mean+-std':>20s} "
             f"{'median':>9s} {'min':>9s} {'#nan':>5s}"]
    for method, by_mag in results_by_method.items():
        for mag_name, res in by_mag.items():
            r = np.asarray(res["rmse"]) * scale
            nan_count = int(np.sum(np.isnan(r)))
            ok = r[~np.isnan(r)]
            if ok.size:
                lines.append(
                    f"{method:24s} {mag_name:8s} "
                    f"{np.mean(ok):9.3f}+-{np.std(ok):8.3f} "
                    f"{np.median(ok):9.3f} {np.min(ok):9.3f} {nan_count:5d}")
            else:
                lines.append(f"{method:24s} {mag_name:8s} {'all-NaN':>20s} "
                             f"{'--':>9s} {'--':>9s} {nan_count:5d}")
    table = "\n".join(lines)
    print(table)
    return table
