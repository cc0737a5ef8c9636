"""Hand-written CUDA kernels (``csrc/``), built on first use, and their
wrappers.  Each wrapper sits beside its plain PyTorch version."""

from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
from chirpgp_tpu_torch.ops.chirp_filter_grad import chirp_filter_nll
from chirpgp_tpu_torch.ops.chirp_fused import ghfs_chirp_filter_smoother
from chirpgp_tpu_torch.ops.chirp_smoother import (
    gaussian_expectation_g, ghfs_chirp_smoother)

__all__ = ["chirp_filter_nll", "gaussian_expectation_g", "ghfs_chirp_filter",
           "ghfs_chirp_filter_smoother", "ghfs_chirp_smoother"]
