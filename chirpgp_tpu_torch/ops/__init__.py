"""Hand-written CUDA kernels (``csrc/``), built on first use, and their
wrappers.  Each wrapper sits beside its plain PyTorch version."""
