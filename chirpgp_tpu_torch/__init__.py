"""chirpgp_tpu_torch: the PyTorch + CUDA port of ``chirpgp_tpu``.

Module paths and function names mirror the JAX package, so each
counterpart is easy to find (``chirpgp_tpu.infer.batched`` ->
``chirpgp_tpu_torch.infer.batched``).  Public functions keep the JAX
layouts (channels-first ``(..., d, B)``, outputs ``(T, rows, B)``), take
their device and dtype from the input tensors, and hold no global device
state.  The package never imports JAX.

Entry points that take host data (NumPy) put it on the card unless the
caller passes ``device="cpu"``.

Subpackages (ported so far: batched IF estimation, single-record MLE and
estimation, and the Table-I Monte-Carlo sweeps, for the chirp, harmonic
chirp and La Scala models, discrete and continuous-discrete, the KPT
baseline, the classical, FHC and fastF0NLS baselines: every column of
Table I; the filter-error Monte Carlo and PCRLB of Fig. 5, the
covariance functions, TME and LTI discretizations, the real-data
pipelines, the parallel-in-time filters and smoothers, the bootstrap
particle filter and NUTS; not yet the multi-device scale-out)
-----------
quad       sigma-point rules, Gaussian expectations, RK4 moment steps
models     chirp, harmonic chirp and La Scala SDE priors, their LCD
           and TME discretizations, the KPT model, Matern-3/2, bijections,
           the PCRLB recursion, covariance functions
infer      sequential, continuous-discrete and square-root filters and
           smoothers, their channels-first batched forms, the
           associative-scan KF/RTS and iterated parallel sigma-point
           smoother, the bootstrap particle filter, NUTS
ops        hand-written CUDA kernels (``ops/csrc``) and their wrappers;
           the host C++ fast-NLS library (``ops/native``)
fit        batched L-BFGS with zoom line search, host SciPy L-BFGS-B,
           Gauss-Newton / Levenberg-Marquardt
baselines  Hilbert, spectrogram, polynomial-IF MLE, adaptive notch
           filter, FHC grid NLS, fastF0NLS
apps       ``IFEstimationConfig``, the pipeline, ``estimate_if_batched``,
           the KPT baseline (``kpt_if_estimate``, ``kpt_mle``),
           the sweeps (``mle_sweep_on_measurements``), the filter-error
           Monte Carlo and PCRLB (``apps.crlb``), the real-data
           pipelines (``apps.realdata``), hyperparameter posteriors
           (``apps.posterior``)
toymodels  synthetic chirps and magnitude/IF families
utils      numerics, metrics, SDE simulation, LTI discretization, timing
"""

import torch as _torch

# Full-precision float32 matmuls and convolutions.  TF32 keeps ~3 decimal
# digits; the JAX package measured reduced-precision matmuls corrupting
# the T~3e3-step filter scans (CKFS IF RMSE x10 0.92 vs 0.777 at the
# reference optimum, ``chirpgp_tpu/__init__.py``).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
