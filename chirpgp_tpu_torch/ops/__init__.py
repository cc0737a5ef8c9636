"""Hand-written CUDA kernels (``csrc/``), built on first use, and their
wrappers.  Each wrapper sits beside its plain PyTorch version."""

from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
from chirpgp_tpu_torch.ops.chirp_smoother import ghfs_chirp_smoother

__all__ = ["ghfs_chirp_filter", "ghfs_chirp_smoother"]
