"""Multi-process and multi-host runtime (counterpart of
``chirpgp_tpu.parallel.multihost``).

One process per rank: :func:`initialize_distributed` brings up the
``torch.distributed`` default process group, and :func:`global_mesh`
spans all of its ranks, each on its own card.  Every sweep, NUTS and SMC
entry point of the port takes a mesh and is rank-count agnostic.  Under
``torchrun --nproc_per_node=N`` the arguments come from the environment.
"""

from typing import Optional

import torch
import torch.distributed as dist

from chirpgp_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["initialize_distributed", "global_mesh", "process_info"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Initialize the default process group (nothing for one process).

    ``coordinator_address`` (``host:port``) rendezvouses over
    ``tcp://``; without it ``env://`` reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, as ``torchrun`` sets
    them.  ``backend`` defaults to ``nccl`` where CUDA is available and
    ``gloo`` otherwise.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    init = "env://" if coordinator_address is None \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, **kwargs)


def global_mesh(axis_name: str = "seeds", device=None) -> Mesh:
    """Mesh over every rank of the default process group, each on its
    device (:func:`~chirpgp_tpu_torch.parallel.mesh.rank_device`)."""
    return make_mesh(None, axis_name, device)


def process_info():
    """(rank, world size, local CUDA device count)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), \
            torch.cuda.device_count()
    return 0, 1, torch.cuda.device_count()
