"""chirpgp_tpu_torch: the PyTorch + CUDA port of ``chirpgp_tpu``.

Module paths and function names mirror the JAX package, so each
counterpart is easy to find (``chirpgp_tpu.infer.batched`` ->
``chirpgp_tpu_torch.infer.batched``).  Public functions keep the JAX
layouts (channels-first ``(..., d, B)``, outputs ``(T, rows, B)``), take
their device and dtype from the input tensors, and hold no global device
state.  The package never imports JAX.

Subpackages (ported so far: the batched IF-estimation path)
-----------
quad       sigma-point rules
models     chirp SDE prior, its LCD discretization, Matern-3/2, bijections
infer      channels-first batched square-root filter and smoother
ops        hand-written CUDA kernels (``ops/csrc``) and their wrappers
apps       ``IFEstimationConfig`` and ``estimate_if_batched``
utils      numerics and metrics
"""

import torch as _torch

# Full-precision float32 matmuls and convolutions.  TF32 keeps ~3 decimal
# digits; the JAX package measured reduced-precision matmuls corrupting
# the T~3e3-step filter scans (CKFS IF RMSE x10 0.92 vs 0.777 at the
# reference optimum, ``chirpgp_tpu/__init__.py``).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
