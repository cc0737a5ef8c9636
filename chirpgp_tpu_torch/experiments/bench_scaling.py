"""Scaling harness on the PyTorch port (the JAX package's
``bench_scaling.py``): seeds per second of the sharded Monte-Carlo GHFS
sweep on rank meshes of size 1, 2, 4, ... up to the world size, and the
efficiency against one rank.

Per seed the record is the JAX script's: the meow chirp (offset 8, unit
magnitude, dt 1e-3) plus ``sqrt(0.1) * normal(key, (T,))`` for the keys
``split(PRNGKey(0), seeds)``, JAX's float32 draws remade without JAX
(``utils/jax_keys.py``; float64 with ``--x64``).  The value per seed is
the final NLL of the square-root GHFS at ``g(default_init_theta())``
(the JAX script's ``estimate_if(...)["nell"][-1]``).  Each rank computes
its seeds' values as one ``estimate_if_batched``: on the card one launch
of the CUDA filter kernel and one of the smoother kernel per rank per
sweep, both counted.  The sweep runs through
``parallel/mesh.py::sharded_seed_sweep``.

Timing as the JAX script: one warm-up, then the best of three, each
ending in ``torch.cuda.synchronize()`` and a barrier on every rank of the
mesh.  The last line is the JAX script's JSON (``seeds_per_sec`` and
``efficiency_vs_1dev`` keyed by mesh size), with the card, the seeds per
rank, each kernel's launches on each rank and the largest relative gap of
each size's values to one rank's.

Ranks: under ``torchrun``, or with ``--distributed``, the process group
of ``initialize_distributed`` (``env://``); ``--ranks N`` spawns N local
ranks; otherwise one rank.  Ranks that share a card use ``gloo`` (NCCL
refuses two ranks on one device), and then the rates measure contention
on that card, not scaling.

Usage:
    python -m chirpgp_tpu_torch.experiments.bench_scaling --ranks 4
    torchrun --nproc_per_node=4 -m chirpgp_tpu_torch.experiments.bench_scaling
    python -m chirpgp_tpu_torch.experiments.bench_scaling --device cpu \\
        --ranks 2 --seeds 8 --T 32
"""

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from chirpgp_tpu_torch.experiments._common import (
    add_device_args, numpy_dtype, setup)

DT, XI = 1e-3, 0.1
JOIN_TIMEOUT_S = 3000


def records(keys, T: int, dtype=torch.float32) -> torch.Tensor:
    """The JAX script's records (B, T) of the JAX keys ``keys`` (B, 2), on
    the host in ``dtype``."""
    from chirpgp_tpu_torch.toymodels import constant_mag, gen_chirp, meow_freq
    from chirpgp_tpu_torch.utils.jax_keys import jax_linspace, jax_normal
    ts = jax_linspace(DT, DT * T, T, dtype)
    _, phase = meow_freq(offset=8.0)
    base = gen_chirp(ts, constant_mag(1.0), phase)
    keys = np.asarray(keys, np.int64).astype(np.uint32).reshape(-1, 2)
    noise = np.stack([jax_normal(k, (T,), numpy_dtype(dtype)) for k in keys])
    return base + math.sqrt(XI) * torch.from_numpy(noise)


def seed_nell(keys, T: int, device, dtype=torch.float32) -> torch.Tensor:
    """The final NLL (B,) of the sqrt GHFS at ``g(default_init_theta())``
    on each key's record, as one ``estimate_if_batched`` on ``device``."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig, estimate_if_batched
    from chirpgp_tpu_torch.models import g
    keys = keys.cpu().numpy() if isinstance(keys, torch.Tensor) else keys
    cfg = IFEstimationConfig(method="ghfs", form="sqrt")
    params = g(cfg.default_init_theta(dtype))
    with torch.no_grad():
        return estimate_if_batched(cfg, params,
                                   records(keys, T, dtype).to(device),
                                   device=device)["nell"]


def _sync(mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def scaling(seeds: int, T: int, device, dtype=torch.float32,
            reps: int = 3, say=print) -> dict:
    """Every rank of the process group (or one rank without one) times the
    sweep on meshes of size 1, 2, 4, ... up to the world size, one warm-up
    and ``reps`` timed runs each.  Returns, on rank 0, per size: the
    seeds, their rate (best of ``reps``), the filter and the smoother
    kernels' launches on each of the mesh's ranks over its ``reps + 1``
    sweeps and the gathered values;
    on the other ranks None."""
    from chirpgp_tpu_torch.apps.sweeps import generate_rnd_keys
    from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
    from chirpgp_tpu_torch.ops.chirp_smoother import ghfs_chirp_smoother
    from chirpgp_tpu_torch.parallel.mesh import (
        all_gather, make_mesh, sharded_seed_sweep)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    sizes, n = [], 1
    while n <= world:
        sizes.append(n)
        n *= 2
    out = {}
    for size in sizes:
        mesh = make_mesh(size, device=device)
        if mesh is not None:
            n_seeds = (seeds // size) * size
            keys = generate_rnd_keys(n_seeds, seed=0)

            def run():
                got = sharded_seed_sweep(
                    lambda k: seed_nell(k, T, mesh.device, dtype), keys,
                    mesh)
                _sync(mesh)
                return got

            def counts():
                return torch.tensor([[ghfs_chirp_filter.launches,
                                      ghfs_chirp_smoother.launches]])

            counts0 = counts()
            run()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                nell = run()
                times.append(time.perf_counter() - t0)
            launches = all_gather(counts() - counts0, mesh)
            best = min(times)
            if rank == 0:
                say(f"ranks={size}: {n_seeds} seeds in {best:.6f} s -> "
                    f"{n_seeds / best:,.1f} seeds/s (runs "
                    f"{', '.join(f'{t:.6f}' for t in times)} s; filter, "
                    f"smoother kernel launches per rank "
                    f"{launches.tolist()})")
                out[size] = dict(seeds=n_seeds, rate=n_seeds / best,
                                 launches=launches[:, 0].tolist(),
                                 smoother_launches=launches[:, 1].tolist(),
                                 nell=nell.cpu().numpy())
        if dist.is_initialized():
            dist.barrier()
    return out if rank == 0 else None


def card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def report(res: dict, device: torch.device, local_ranks: int) -> dict:
    """The JAX script's JSON of :func:`scaling`'s result, with the card,
    the seeds per rank, each kernel's launches on each rank and the
    largest relative gap of each size's values to one rank's."""
    base = res[1]
    rates = {s: r["rate"] for s, r in res.items()}
    gaps = {s: float(np.max(np.abs(r["nell"] - base["nell"][:r["seeds"]])
                            / np.abs(base["nell"][:r["seeds"]])))
            for s, r in res.items()}
    devices = torch.cuda.device_count() if device.type == "cuda" else 1
    return {
        "metric": "mc_sweep_seeds_per_sec_scaling",
        "seeds_per_sec": {str(s): round(v, 1) for s, v in rates.items()},
        "efficiency_vs_1dev": {str(s): round(v / (rates[1] * s), 3)
                               for s, v in rates.items()},
        "card": card() if device.type == "cuda" else "cpu",
        "label": "contention, not scaling" if local_ranks > devices
                 else "scaling",
        "seeds_per_rank": {str(s): r["seeds"] // s for s, r in res.items()},
        "kernel_launches_per_rank": {str(s): r["launches"]
                                     for s, r in res.items()},
        "smoother_launches_per_rank": {str(s): r["smoother_launches"]
                                       for s, r in res.items()},
        "nell_rel_vs_1dev": {str(s): g for s, g in gaps.items() if s > 1},
    }


def _backend(device: torch.device, local_ranks: int) -> str:
    if device.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _run(args, device, local_ranks: int):
    """This rank's part: the sweep at every mesh size, and on rank 0 the
    JSON line."""
    dtype = torch.get_default_dtype()
    if device.type == "cuda" and dist.is_initialized():
        from chirpgp_tpu_torch.parallel.mesh import rank_device
        device = rank_device()
        torch.cuda.set_device(device)
    res = scaling(args.seeds, args.T, device, dtype,
                  say=lambda line: print(line, file=sys.stderr, flush=True))
    if res is not None:
        print(json.dumps(report(res, device, local_ranks)), flush=True)


def _rank_main(rank, world, port, args):
    """One rank spawned by ``--ranks``, with its share of the host's
    cores."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = setup(args)
    dist.init_process_group(_backend(device, world),
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        _run(args, device, world)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(args, world: int) -> int:
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        print(f"bench_scaling: rank exit codes {codes}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=1024)
    ap.add_argument("--T", type=int, default=512)
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group of initialize_distributed "
                         "(env://, as torchrun sets it)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="spawn this many local ranks")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = setup(args)
    if args.ranks > 1:
        return _spawn(args, args.ranks)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.distributed or world > 1:
        from chirpgp_tpu_torch.parallel import initialize_distributed
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        initialize_distributed(backend=_backend(device, local))
        try:
            _run(args, device, local)
        finally:
            dist.destroy_process_group()
    else:
        _run(args, device, 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
