"""Rank-mesh scale-out for Monte-Carlo sweeps (counterpart of
``chirpgp_tpu.parallel.mesh``).

The JAX package runs one controller that ``shard_map``-s a sweep over a
mesh of devices.  The port runs SPMD over ``torch.distributed``: every
rank calls the same entry point with the same full host inputs, takes the
slice of the leading axis that falls to its rank, computes it on its own
device, and the ranks exchange data through the collectives of this
module.  Every rank returns the gathered global result, as a JAX caller
gets it from ``device_get`` of a sharded output.

A :class:`Mesh` is one axis of ranks.  A mesh of one rank with no process
group has identity collectives: the exact semantics of a one-device JAX
mesh.  With the ``gloo`` backend every collective stages its tensors
through host memory (``gloo`` does not take a CUDA tensor for every
collective on every torch release); the arithmetic stays on each rank's
device.  Any other backend (``nccl``) exchanges tensors on the mesh's
device.  The choice is made by the backend, once, when the mesh is made.
"""

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "shard_keys", "sharded_seed_sweep",
           "sharded_mean", "pad_to_multiple", "all_reduce", "all_gather",
           "rank_device", "rank_stream"]


class Mesh:
    """One axis of ``size`` ranks: this process's ``rank`` in it, the
    ``device`` it computes on, and the process ``group`` its collectives
    run over (None for a one-rank mesh without a group).  ``shape`` maps
    the axis name to its size, as a JAX mesh's does."""

    def __init__(self, axis_name: str, size: int, rank: int,
                 device, group=None):
        self.axis_names = (axis_name,)
        self.shape = {axis_name: size}
        self.size = size
        self.rank = rank
        self.device = torch.device(device)
        self.group = group
        self._stage = group is not None and dist.get_backend(group) == "gloo"

    def __repr__(self):
        return (f"Mesh({self.axis_names[0]!r}, size={self.size}, "
                f"rank={self.rank}, device={self.device})")


def rank_device(device=None) -> torch.device:
    """``device`` if given, else this rank's card:
    ``cuda:(LOCAL_RANK % device_count)``, the local rank being the global
    one when no launcher set ``LOCAL_RANK``."""
    if device is not None:
        return torch.device(device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def rank_stream(generator: torch.Generator, rank: int) -> torch.Generator:
    """A generator of this rank's own on ``generator``'s device, seeded
    from one draw of ``generator`` and ``rank`` (the JAX package's
    ``fold_in(key, shard)``): ranks whose ``generator`` was seeded alike
    get distinct streams."""
    dev = generator.device
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=dev))
    return torch.Generator(device=dev).manual_seed(seed + rank)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "seeds",
              device=None) -> Optional[Mesh]:
    """Mesh over the first ``n_devices`` ranks of the default process
    group (all of them by default); without a process group, a one-rank
    mesh.  Every rank of the group must call it (a smaller mesh makes a
    new group); a rank outside the first ``n_devices`` gets None.  Raises
    ``ValueError`` when asked for more ranks than the group has.
    ``device``: this rank's device, :func:`rank_device` by default."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} ranks asked for, the process "
                         f"group has {world}")
    device = rank_device(device)
    if not dist.is_initialized():
        return Mesh(axis_name, 1, 0, device)
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    return Mesh(axis_name, n, rank, device, group) if rank < n else None


def pad_to_multiple(x, m: int, axis: int = 0):
    """Pad ``x`` along ``axis`` to a multiple of ``m`` by repeating its
    last entry; returns the padded tensor and the original length."""
    x = torch.as_tensor(x)
    n = x.shape[axis]
    rem = (-n) % m
    if rem == 0:
        return x, n
    edge = x.narrow(axis, n - 1, 1)
    reps = [1] * x.dim()
    reps[axis] = rem
    return torch.cat([x, edge.repeat(reps)], dim=axis), n


def _tree_map(fn: Callable, tree):
    """``fn`` over the array leaves of a tensor, NumPy array, dict or
    (named) tuple."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        leaves = [_tree_map(fn, v) for v in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") \
            else type(tree)(leaves)
    return fn(tree)


def _local_rows(x, mesh: Mesh):
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"leading axis {n} is not a multiple of the mesh "
                         f"size {mesh.size} (see pad_to_multiple)")
    per = n // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def shard_keys(keys, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the leading (seed) axis of ``keys``, on its
    device.  The axis must divide evenly by the mesh size."""
    return _local_rows(torch.as_tensor(keys), mesh).to(mesh.device)


def _collective(x, mesh: Mesh, run: Callable):
    """``run(t)`` on a tensor version of leaf ``x`` (in host memory under
    ``gloo``, else on the mesh's device; bool as uint8), returned in
    ``x``'s kind, dtype and device."""
    is_np = isinstance(x, np.ndarray)
    t = torch.from_numpy(np.ascontiguousarray(x)) if is_np \
        else torch.as_tensor(x)
    dtype, device = t.dtype, t.device
    if dtype == torch.bool:
        t = t.to(torch.uint8)
    t = t.cpu() if mesh._stage else t.to(mesh.device)
    out = run(t.contiguous())
    if is_np:
        return out.to(dtype).cpu().numpy()
    return out.to(device=device, dtype=dtype)


def all_reduce(tree, mesh: Mesh, op: str = "sum"):
    """Elementwise ``"sum"`` or ``"max"`` of every leaf over the mesh's
    ranks; the result on every rank.  Identity on a one-rank mesh."""
    if mesh.group is None:
        return tree
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

    def run(t):
        t = t.clone()
        dist.all_reduce(t, op=red, group=mesh.group)
        return t

    return _tree_map(lambda x: _collective(x, mesh, run), tree)


def all_gather(tree, mesh: Mesh):
    """Every leaf concatenated along axis 0 over the ranks, in rank order;
    the result on every rank.  Identity on a one-rank mesh.  The list form
    of ``torch.distributed.all_gather``, which every torch release takes
    (``all_gather_into_tensor`` is deprecated in later ones)."""
    if mesh.group is None:
        return tree

    def run(t):
        parts = [torch.empty_like(t) for _ in range(mesh.size)]
        dist.all_gather(parts, t, group=mesh.group)
        return torch.cat(parts)

    return _tree_map(lambda x: _collective(x, mesh, run), tree)


def sharded_seed_sweep(fn: Callable, keys, mesh: Optional[Mesh] = None):
    """``fn`` on this rank's slice of ``keys``, then every leaf of its
    result gathered along axis 0: the result of all keys, on every rank.

    Unlike the JAX package's ``per_seed_fn`` under ``vmap``, ``fn`` takes
    a batch of keys on a leading axis and returns leaves with that axis
    leading (the port's lane idiom: its sweeps run one batched optimizer
    over all lanes).  Pass ``torch.func.vmap(f)`` for a per-seed ``f``.
    ``keys``' leading axis must divide evenly by the mesh size (see
    :func:`pad_to_multiple`).
    """
    mesh = mesh or make_mesh()
    return all_gather(fn(shard_keys(keys, mesh)), mesh)


def sharded_mean(fn: Callable, keys, mesh: Optional[Mesh] = None):
    """Mean of ``fn`` over all keys: each rank sums ``fn`` of its slice
    over axis 0, a SUM all-reduce adds the ranks' sums, and the total is
    divided by the number of keys.  ``fn`` as in
    :func:`sharded_seed_sweep`."""
    mesh = mesh or make_mesh()
    n_total = torch.as_tensor(keys).shape[0]
    local = _tree_map(lambda x: x.sum(0), fn(shard_keys(keys, mesh)))
    return _tree_map(lambda x: x / n_total, all_reduce(local, mesh))
