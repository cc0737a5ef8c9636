"""Rank-mesh scale-out over ``torch.distributed`` for Monte-Carlo sweeps,
time-sharded scans, SMC and NUTS."""

from chirpgp_tpu_torch.parallel.mesh import (
    make_mesh, shard_keys, sharded_seed_sweep, sharded_mean, pad_to_multiple)
from chirpgp_tpu_torch.parallel.multihost import (
    initialize_distributed, global_mesh, process_info)

__all__ = ["make_mesh", "shard_keys", "sharded_seed_sweep", "sharded_mean",
           "pad_to_multiple",
           "initialize_distributed", "global_mesh", "process_info"]
