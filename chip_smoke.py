#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Builds the hand-written CUDA kernels (the chirp filter, the chirp
smoother's: phase A's rows, phase B's chunked scan over time as Compose,
Carry and Apply, phase E's expectation in its two input modes, and the
fused filter+smoother's two: F's forward scan, G's affine backward
recursion with a team of four threads per lane) from
``chirpgp_tpu_torch/ops/csrc`` on first use, one ``nvcc`` per source,
started together, and drives the batched IF-estimation path (one filter
and one smoother wrapper launch), the single-record MLE path, the fused
batched filter+smoother (bench.py's headline: kernels F, G and E), the
Table-I Monte-Carlo
sweep, every other column of Table I, the paper's analysis and
real-data pipelines, the parallel-in-time and posterior-inference
paths, and the scale-out layer once at full width.
Phases, one line each:

1. environment: card, ``nvidia-smi`` name and power limit, torch/CUDA
   versions, the kernels' nvcc build times and ptxas reports of every
   instance (no register spills allowed but in ``SPILLS_ALLOWED``:
   float64 instances of the smoother's phase A, F and the sweep adjoint);
2. kernel vs plain PyTorch version on the card: GH-3 and cubature at
   B=512, T=32 on 0.1 N(0, 1) measurements in float32 (atol 5e-5 on
   mfs/nll, 1e-4 on L L^T and on Lfs) and float64 (atol 1e-9), at every
   team size the kernel is built for, then GH-3 at B=4096, T=3141 on the
   benchmark's data in float64 and float32 (scaled bounds below), and
   each float32 version against the float64 kernel, the on-card oracle;
   2b. the smoother's kernels (phases A, B and E, with the GH-10
   expectation of g(V)) against the plain version on the filter kernel's
   outputs: GH-3 and cubature at B=512, T=32 on the same measurements,
   float32 at the filter's levels (atol 5e-5
   on mss, 1e-4 on L L^T and Lss, 1e-4 of scale on the IF mean) and
   float64 (1e-9), and a scratch cap that forces slabs of 32 lanes
   against one slab, bit for bit; then at B=4096, T=3141 on phase 2's
   filter outputs, float64 and float32 (scaled bounds below), each
   float32 version against the float64 kernel, and in both dtypes and on
   the first 100 lanes in float32 each kernel against its own plain
   counterpart (phase A's rows against ``smoother_rows_reference``, phase
   B in ``backward_chunks``' C chunks, Compose, Carry and Apply against
   ``smoother_compose_reference``, ``smoother_carry_reference`` and
   ``smoother_apply_reference`` on the same inputs, and phase B's outputs
   against ``smoother_backward_chunked_reference`` and the sequential
   ``smoother_backward_reference`` over the kernel's rows, factors up to
   their columns' signs; phase E against its float64 pair-form twin
   ``smoother_expect_reference``, within 1e-12 relative in float64 and 2e-6
   max(1, |E|) in float32; each launched alone through
   ``SmootherKernels``), each timed and held to the scaled bound;
3. ``estimate_if_batched`` at B=4096, T=3141, dt=1e-3, Xi=0.1, GH-3,
   float32: finite outputs, one filter and one smoother launch by the
   main path and the smoother's kernels launched exactly as its slabs
   ask (phase A and phase B's Compose, Carry and Apply once per slab, E
   once), the
   call's CUDA kernel count under ``torch.profiler`` (the
   same small count at T=64 as at T=3141), wall times of the filter
   kernel and of the plain filter (one call each, both warm from phase
   2) and of the whole estimate, and its steps/s;
   3b. the kernel's CUDA-event time (the bare launch) at every team size:
   GH-3 at B=4096, T=3141 (float32 and float64), GH-3 and cubature at the
   Table-I width (the 100 records of ``toydata_const`` at the GHFS and
   CKFS reference optima, float32), cubature at B=4096 (float32), beside
   its flop and byte counts, its bound and its share of the bound; and
   the smoother's (its kernels, with the GH-10 expectation) and each
   kernel alone (A, Compose, Carry and Apply slab by slab, phase B on its
   own slab's rows, and phase B's three together, with its chunk count),
   at
   B=4096, T=3141 (float32 and float64) and at the Table-I width
   (float32), beside its bound and each phase's, and its ratio to the
   filter's bare launch on the same records; where the cap of the
   split's first version (2 GiB) gives other slabs, the whole launch at
   that cap too;
4. accuracy gate: seed 0 of ``results/data/toydata_const.npz`` at the
   reference's learnt optimum, CKFS (cubature) and GHFS (GH-3), float32;
   then 6e (below), and the bare launches that 7a, 8b, 10a and 12b report,
   each timed here while this process has the card to itself.  Phases
   5-13 then run in the three lanes of ``LANES``, beside each other on
   the card: this process runs 8, 12, 13 and 9, one spawned process 5, 11
   and 10, another 6 (6a-6d) and 7, each lane its phases in order,
   giving its cached blocks back to the card as each phase ends, the
   parts that hold most of the card's memory (6d, 10c-10e, 13e's
   ``run_fhc``) one at a time, and the card's memory sampled throughout;
   a spawned lane's phase prints through this process as it ends, and
   every phase's lines are followed by its lane and its span of the run;
5. the MLE path on seed 0 at full T=3141: ``make_nll_fn`` (cov GHFS,
   float64) value and gradient on the card against the host CPU; the
   float32 sqrt objective against the CUDA kernel's nll; ``fit_mle``
   (SciPy L-BFGS-B, 1 iteration); ``estimate_if`` GHFS and EKFS gates;
6. the fused batched filter+smoother: at B=512, T=256, float64, the
   plain loops against the separate filter and smoother, slim output
   bit-equal to the full one, covariance form against square-root form,
   and the kernels' route (``ghfs_chirp_filter_smoother`` on the card) in
   its three modes against its plain twins (scaled 1e-9); 6d bench.py's
   headline, B=4096, T=3141, GH-3, float32, ``out_index=2``, then the
   GH-10 expectation of g(V) (``gaussian_expectation_g``): F, G and E
   launched once each (counted, and under ``torch.profiler``, with the
   same CUDA kernel count per call at T=64 as at T=3141), each kernel
   alone against its plain twin (scaled 1e-4; E against its float64
   pair-form twin ``smoother_expect_var_reference`` as in 2b), the IF mean
   against phase 3's; 6e each fused kernel's CUDA-event time alone (F in
   maps and factor mode, G slim and full with its geometry, E with its
   float32 MUFU floor, phase B on F's rows with its chunk count) at B=4096 float32 and float64 and at
   the Table-I width, beside its bound, and F beside the filter kernel's
   bare launch on the same records;
7. the Table-I sweep through the per-lane filter kernels (the per-lane
   instances of the filter kernel and its adjoint, ``ops/
   chirp_filter_grad.py``), sqrt GHFS GH-3 float32 on seeds 0-99 of each
   magnitude of ``results/data`` (B=300) at the full T=3141: 7a at one
   theta per lane (the default init spread by 0.1 normals), one vmapped
   value-and-grad of the objective, timed, one launch of each kernel
   (counted), its peak memory and device busy share; the kernels against
   their plain versions on the same lanes at the same T, both timed
   (float64 nll 1e-12 relative, adjoint 1e-9 of each lane's max
   |adjoint|; float32 no further from the float64 kernels, value and
   gradient, than twice the float32 plain versions are, plus 1e-6 and
   1e-5); the float32 value-and-grad against the float64 one under the
   same limit, and at T=785 the eager float32 route's (the Python loop
   under autograd) and the kernels' deviations from the same oracle; the
   kernels against their plain versions under the same limits at B=4096,
   T=3141 (the 300 records repeated, one theta per lane: the adjoint's
   team of 8), but for the float64 value, which is printed there; each kernel's CUDA-event time alone at B=300 float32
   and float64 and at B=4096, beside its bound and the adjoint's geometry
   (its chain design while its blocks fit the SMs at once, a team of 32
   up to 16 lanes per SM, of 8 beyond), and the adjoint's chain floor as ``PERF.md`` records it
   (``SWEEP_CHAIN_FLOOR_MS``), timed before the lanes start; 7d the ghfs
   column of Table I, the whole
   ``mle_sweep_on_measurements`` at B=300, T=3141, 200 iterations, each
   stage timed, the kernels' launches counted: per magnitude the median
   IF-RMSE x10 within 2% (const, damped) or 5% (random) of the JAX
   package's committed ``results/ghfs_*.npz``, at most 3 lanes without
   success, the float64 polish never raising a lane's NLL;
8. the model family: 8a the seed-0 gates of the harmonic CKFS/EKFS, La
   Scala GHFS/EKFS and KPT/harmonic KPT columns through ``estimate_if`` /
   ``kpt_if_estimate`` on the card at T=3141, float64 (and harmonic CKFS
   in float32), in child processes beside 8b-8e; 8b La Scala through the
   filter kernel (``estimate_if_batched`` on the 100 ``toydata_const``
   records, float32 and float64: the kernel against its plain version and
   its bare-launch time beside the bound); 8c/8d one vmapped
   value-and-grad of the harmonic CKFS (d=8, cubature) and KPT (K=1, 3)
   sweep objectives at B=300, T cut to a budget, lanes 0 and 299 against
   each lane alone, launches per step and busy share; 8e the whole
   harmonic-EKFS and KPT sweeps at B=3, T=20, 3 iterations;
9. Table I's last columns: 9a the seed-0 gates of the continuous-discrete
   ``cd_ghfs`` and ``cd_ekfs`` through ``estimate_if`` on the card at
   T=3141, float64, in child processes beside 9b-9d, against the JAX
   package's values and the reference's; 9b one vmapped value-and-grad
   of each cd sweep objective at B=300, float32 (T cut to a budget),
   lanes 0 and 299 against each lane alone, its peak memory reckoned to
   T=3141, launches per step and busy share; 9c the whole cd_ekfs sweep at
   B=3, T=40, 3 iterations; 9d the four classical columns (Hilbert,
   spectrogram, polynomial LM, ANF) on 300 records at T=3141, float64,
   timed, each against the same call on the host CPU in a child process,
   and on the reference's 100 const records (remade from toydata's keys
   by a NumPy copy of JAX's Threefry) per seed against the reference's
   and the JAX package's columns;
10. the paper's analysis and the last baselines: 10a the kernel against
    its plain version on one chunk of the Fig. 5 filter-error Monte Carlo
    (B=16384, T=500, dt=0.01, at ``model_chirp``'s prior mean through
    the wrapper's ``m0``; float64 and float32), its bare-launch time
    beside the bound; 10b ``filter_error_mc_chunked`` (GHF, ``cf``
    backend) at the reference's 1e6 trajectories through the kernel (62
    launches), float32 against the float64 kernel on the same normals and
    both against the committed ``results/crlb_ghf_lam0.1_b0.1.npz``; 10c
    the EKF (``vmap`` backend) at a cut N against the committed EKF file;
    10d ``pcrlb_chirp_mc`` at N=1e5 in float64 (positive) and float32;
    10e the FHC and harmonic-FHC columns on 300 records each on the card,
    per seed against the committed columns; 10f the fastF0NLS columns
    (host C++ built by g++, in a child process beside the rest) on a
    subset of seeds; 10g the LIGO pipeline on run_ligo.py's synthetic
    record (the IF mean at its committed params, and ``analyze_ligo``
    with the MLE capped) and the Myotis bat analog cut to a crop.  Each
    sub-phase prints its line and seconds as it ends;
11. parallel-in-time filtering and posterior inference (no Pallas kernel
    on these paths): 11a the associative-scan KF/RTS on the M32 model at
    bench.py's configuration (the f32 bytes of
    ``results/data/parallel_kf_ref.npz``, T=3141 and T=25000): the
    sequential ``kf`` + ``rts`` (T=3141), the flat scan and blocked 128 and
    512, each timed with its launches and device busy share and held to
    the float64 truth within 1% of its scale, a float64 flat scan within
    1e-8; 11b the iterated parallel sigma-point smoother on the chirp
    model (GH-3, seed 0 of ``toydata_const``, T=3141, f32): one iteration
    flat and blocked 128 against the sequential filter + smoother, ten
    iterations held to the JAX package's accuracy gate, float64 on the
    card against the host CPU; 11c the
    bootstrap particle filter against the exact KF on an M32 LGSSM, and
    ``smc_nll`` on the chirp record in both dtypes; 11d NUTS on a
    correlated 2-D Gaussian with 64 chains on the leading axis (pooled
    moments), and ``sample_hyperposterior`` (sqrt GHFS f32, 8 chains, T
    cut to a budget): every point it evaluates finite, lane 0 against
    the log posterior alone;
12. the scale-out layer (``torch.distributed``; no Pallas kernel on the
    collectives): 12a one NCCL rank in this process, every sharded entry
    point on its one-rank mesh against its unsharded function (the sharded
    seed sweep of ``estimate_if_batched`` bit for bit); 12b four ``gloo``
    ranks spawned on the one card (NCCL refuses two ranks on a device):
    the sharded seed sweep of ``estimate_if_batched`` at B=4096, T=3141,
    f32, one kernel launch per rank, the gathered IF mean against phase
    3's; the time-sharded KF/RTS at T=25000; the particle-sharded SMC, the
    chain-sharded NUTS and hyperposterior; the ``mesh`` arguments of
    ``mc_mle_sweep``, ``mc_kpt_sweep`` and ``filter_error_mc`` against
    ``mesh=None``.  A rank's failure or hang fails the run;
13. the entry points, as a user runs them: the drivers and demos of
    ``chirpgp_tpu_torch/experiments`` and ``chirpgp_tpu_torch/demos`` in
    child processes on the card (``python -m ... --device cuda``), at a
    Table-I column's width (B=300) with depth cut: 13a the Table-I driver
    with its stage times, 13b the paired table printer on its columns,
    13c the Fig. 5 driver through the kernel (launches counted in the
    child; its file against the same call in this process), 13d the
    classical columns per seed against the JAX package's, 13e the KPT,
    FHC and fastF0NLS drivers, 13f two demos and the timing script, 13g
    the paper's figures as arrays (``plots --save-arrays``: the samples
    and the conditional covariance against the host CPU, the crlb arrays
    against the committed files), 13h the scaling harness on four
    ``gloo`` ranks sharing the card (``bench_scaling``: one filter and
    one smoother kernel launch per rank per sweep, counted in the child;
    the values of four ranks against one rank's).

A device busy share is the kernel time of a call under ``torch.profiler``
(the card's activity alone) over the wall time of the same call
unprofiled (``utils/timing.py::profile_device``).

Every phase must pass; a failure ends the run with a nonzero exit code.
The line before the last is a JSON record of the kernels.  The filter's
(``ms`` and
``bound_ms`` at B=4096 float32, ``ms_b100`` at the Table-I width,
``ms_f64`` and ``bound_ms_f64`` at B=4096 float64, La Scala's path,
phase 8b: its launches, ``ms_lascala_b100`` and its bound, and the CRLB
path, phase 10: ``launches_crlb``, ``ms_crlb_chunk`` and
``bound_ms_crlb_chunk``, the sharded path, phase 12b:
``launches_sharded``, ``ms_sharded_b1024`` and its bound, and the
scaling harness, 13h: ``launches_scaling``, per mesh size the launches
of each rank over its sweeps, and ``b_per_rank_scaling``); the
smoother's, which replaces the JAX package's compiled scan
(``replaces``: ``chirpgp_tpu/infer/batched.py:152``), has the contract's
keys at B=4096 float32 (``plain_ms`` from phase 2b; ``library_ms`` null:
no single PyTorch call computes it), ``ms_b100`` and ``bound_ms_b100``,
``ms_f64`` and ``bound_ms_f64``, the ratios to the filter's bare launch,
and the launches of La Scala's path (8b), of the sharded sweep (12b) and
of the scaling harness (13h); then one entry for each of the smoother's
kernels (``smoother_rows``, phase B's ``smoother_compose``,
``smoother_carry`` and ``smoother_backward`` (Apply), ``smoother_expect``)
with the contract's keys (its launches in phase 3, its time alone, its
plain counterpart's and its deviation from it in phase 2b) and
``ms_b100`` and ``ms_f64``, phase B's with its chunk counts and its
three kernels' time together (``ms_phase_b`` beside ``bound_ms_phase_b``,
the one-pass recursion's least bytes); then one entry for each kernel of
the fused
filter+smoother's slim path (``fused_forward``, ``affine_backward``,
``smoother_expect_var``; ``replaces`` the JAX package's compiled forward
scan, ``chirpgp_tpu/infer/batched.py:297``, reverse scan, ``:383``, and
``gaussian_expectation_batched``, ``:546``): its launches and deviation
from its plain twin in 6d, its time alone and its bound in 6e at B=4096
float32 in 6d's mode, ``ms_b100``, ``ms_f64``, and F's factor mode and
G's full output beside (``ms_factors``, ``ms_full``), and G's geometry;
then one entry for each kernel of the sweep objective
(``ghfs_chirp_filter_lanes``, the filter's per-lane instances, and
``ghfs_chirp_filter_adjoint``; ``replaces`` the JAX package's
``sqrt_sgp_filter`` under ``jax.value_and_grad``,
``chirpgp_tpu/infer/sqrt.py:170``): its launches in 7d's column (and
per evaluation in 7a), its deviation from its plain version in float32
and the plain version's time, both at B=300, T=3141, its time alone and
bound there in float32, ``ms_f64`` and ``ms_b4096`` with their bounds,
the adjoint's ``geometry`` and ``geometry_b4096``, and the deviations
from the plain versions at B=4096 (``max_abs_err_b4096``,
``plain_ms_b4096``).  The smoother's ``bound_ms`` counts the
least work of the function (``ops/chirp_smoother.py::smoother_cost``:
the smoother's step in the lesser of two square-root forms); each
kernel's, its own work and bytes, its phase A's rows included
(``smoother_phase_costs``).  The last
line is ``{"ok": true, "device":
{...}}``.  Without a CUDA device, or without
the ``chirpgp_tpu_torch`` package beside this script, it exits nonzero.

It leaves no process behind: each child of phase 13 runs in a session of
its own whose process group is killed when the child ends, and the
script makes itself the subreaper of its descendants, so that a process
orphaned on the way comes back to it, and kills and reaps every one of
them (and multiprocessing's resource tracker) before it exits, whether a
phase passed or failed.
"""

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DT, XI = 1e-3, 0.1
B_FULL, T_FULL = 4096, 3141
SMALL_B, SMALL_T = 512, 32
SMALL_PARAMS = (0.1, 0.1, 0.1, 1.0, 1.0, 7.0)
# Kernel-vs-plain bounds at the full shape, B=4096 x T=3141: max deviation
# over (1 + max |plain|) for mfs and L L^T, and the relative deviation of
# nll[-1].  In float64 the two must agree to round-off.  In float32 each
# version alone deviates from the float64 kernel by up to ~8e-6 in
# nll[-1] (measured on an H100), so their difference is held to 2e-5.
FULL_BOUNDS = {"float64": (1e-9, 1e-9, 1e-12), "float32": (1e-4, 1e-4, 2e-5)}
# Phase 2b, the smoother kernel against its plain version: the small cases
# (atol on mss, L L^T, Lss, and the IF mean over 1 + max |IF|) at the
# filter's levels, and at the full shape max deviation over (1 + max
# |plain|) for mss, L L^T and the IF mean.
SMOOTHER_SMALL_TOLS = {"float32": (5e-5, 1e-4, 1e-4, 1e-4),
                       "float64": (1e-9,) * 4}
SMOOTHER_FULL_BOUNDS = {"float64": (1e-9, 1e-9, 1e-9),
                        "float32": (1e-4, 1e-4, 1e-4)}
# Phase 3: one estimate_if_batched call runs at most SLICE_MAX_KERNELS
# CUDA kernels (the two hand-written ones and a few small tensor
# operations), the same count at T=SLICE_SHORT_T as at T=3141.
SLICE_MAX_KERNELS, SLICE_SHORT_T = 32, 64
# Seed-0 gates: (IF-RMSE x10, nell) of the float64 reference.
GATES = {"ckfs": ("cubature", 0.77619, 906.6107),
         "ghfs": ("gauss_hermite", 0.78564, 906.7245)}
GATE_RMSE_ATOL, GATE_NELL_RTOL = 0.005, 1e-4
# Phase 5: the float64 nll at the GHFS optimum through the float64 batched
# path (906.72448), and the reference's seed-0 IF-RMSE x10 of GHFS and EKFS.
MLE_NLL, MLE_NLL_RTOL = 906.72448, 1e-6
MLE_GATES = {"ghfs": 0.7856412, "ekfs": 0.7327871}
# fit_mle's iterations in 5c: cut from 2 to make room for phase 8; and its
# record cut to MLE_FIT_T samples (from T=3141) to make room for phase 12.
# 5a's card-vs-host check at theta0 runs on the same crop (on the whole
# record before phase 13).
MLE_ITERS, MLE_FIT_T = 1, 785
# Phase 6d: the slim fused IF mean against estimate_if_batched's, both in
# float32, as max deviation over (1 + max |IF|).  On the host CPU the two
# plain versions differ by 9.3e-6 at B=32; the bound leaves room for the
# lane maximum at B=4096 and the filter kernel's own float32 rounding.
FUSED_IF_BOUND = 1e-4
FUSED_SMALL_B, FUSED_SMALL_T, FUSED_F64_BOUND = 512, 256, 1e-9
# 6a-d: the fused kernels (ops/chirp_fused.py) against their plain twins,
# max |d| over (1 + max |twin|): the filter kernel's scaled bounds at the
# benchmark's shape (FULL_BOUNDS).  The wrapper's three modes.
FUSED_KERNEL_BOUNDS = {"float32": 1e-4, "float64": FUSED_F64_BOUND}
FUSED_MODES = {"factors": {}, "full": dict(return_factors=False),
               "slim": dict(return_factors=False, out_index=2)}
KERNEL_SOURCE = "chirpgp_tpu_torch/ops/csrc/ghfs_chirp_filter.cu"
KERNEL_REPLACES = "chirpgp_tpu/experimental/pallas_filter.py:248"
# The smoother kernel replaces no Pallas kernel but the JAX package's
# compiled reverse scan (and the expectation after it).
SMOOTHER_SOURCE = "chirpgp_tpu_torch/ops/csrc/ghfs_chirp_smoother.cu"
SMOOTHER_REPLACES = "chirpgp_tpu/infer/batched.py:152"
# Phase E's first mode: the JAX package's gaussian_expectation_batched as
# its estimate_if_batched calls it on the smoother's output.
EXPECT_REPLACES = "chirpgp_tpu/infer/batched.py:546"
# The fused filter+smoother's kernels replace the JAX package's compiled
# scans of sqrt_sgp_filter_smoother_batched: F its forward scan, G the
# covariance branch's reverse scan; E's variance mode bench.py's
# gaussian_expectation_batched of the slim output.
FUSED_SOURCE = "chirpgp_tpu_torch/ops/csrc/ghfs_chirp_fused.cu"
FUSED_REPLACES = {"fused_forward": "chirpgp_tpu/infer/batched.py:297",
                  "affine_backward": "chirpgp_tpu/infer/batched.py:383",
                  "smoother_expect_var": EXPECT_REPLACES}
# Phase 1: the instances whose register spills are reported and allowed,
# (kernel, dtype, template integers): the float64 smoother's phase A with
# GH-3's 11 rows of 8 values per member (255 registers, 116 B of spill
# stores; faster than teams of 16 and 32 at B=4096 on an H100).  Every
# other instance must not spill.
# And the float64 fused forward kernel F with 3 or 4 groups of 3 point rows
# per team member (P=32 and P=8): its blocks of 12 warps hold 3 on a
# scheduler, which leaves 168 registers a thread, and ptxas spills the
# team's float64 rows (1928 B of spill stores at P=8 with GH-3's 4 groups,
# 732 B at P=32 with 3, on an H100); float64 is off the benchmark's path.
# And the float64 adjoint of the sweep objective: the team design's at
# 255 registers (1128 B of spill stores at 11 points a member of 8, 80 B
# at 2, 264 B at 3 of 32, on an H100) and the chain design's at 168 (its
# blocks of up to 3 lanes of 1 + K warps: 32-144 B); the sweep's float64
# is the polish's.
SPILLS_ALLOWED = {("smoother_rows", "f64", 11), ("fused_forward", "f64", 8, 4),
                  ("fused_forward", "f64", 32, 3),
                  ("adjoint_team", "f64", 8, 11),
                  ("adjoint_team", "f64", 8, 2),
                  ("adjoint_team", "f64", 32, 3),
                  ("adjoint_chain", "f64", 1, 2),
                  ("adjoint_chain", "f64", 3, 2),
                  ("adjoint_chain", "f64", 3, 3)}
# Phase 3b: CUDA-event launches after one warm-up, and the H100 SXM's
# published peaks (NVIDIA data sheet, dense, at 700 W): float32 and float64
# outside the tensor cores, and HBM3.
TIMING_REPS = 6
# Phase 3b also times the smoother's whole launch at this scratch cap (the
# cap of the split's first version), where it gives other slabs than the
# wrapper's SCRATCH_CAP: float64 at B=4096 in two slabs.
OTHER_SCRATCH_CAP = 2 << 30
SWEEP_B = (528, 1056, 2112)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12
# Hopper's special-function units (ex2, lg2, rsqrt) issue 16 operations
# per clock per SM: phase E's float32 floor beside its bound (3b, 6e).
MUFU_PER_CLOCK_SM = 16
# Phase E against its pair-form twin (2b, 6d): float64 within
# EXPECT_RTOL_F64 of |twin|; float32 within EXPECT_ATOL_F32 max(1, |twin|)
# of the float64 twin on the same inputs (its ex2 and lg2 on the
# special-function unit); NaN where the twin has NaN, the same infinities.
EXPECT_RTOL_F64, EXPECT_ATOL_F32 = 1e-12, 2e-6
# Phase 7, the Table-I sweep through the per-lane filter kernels
# (ops/chirp_filter_grad.py): seeds 0-99 of each magnitude of results/data
# (B=300), sqrt GHFS, GH-3, float32, at the full T=3141.  7a, at the
# default init plus SWEEP_THETA_SPREAD standard normals (seed 0), one
# theta per lane: one vmapped value-and-grad, one launch of each kernel;
# the kernels against their plain versions on the same lanes (float64:
# the nll within SWEEP_F64_NLL_RTOL, the adjoint within SWEEP_F64_GRAD_TOL
# of each lane's max |adjoint|; float32: against the float64 kernels, the
# on-card oracle, the value and the adjoint carried to theta no further
# over the lanes than SWEEP_F32_FACTOR times the float32 plain versions
# are, plus SWEEP_F32_VALUE_FLOOR relative and SWEEP_F32_GRAD_FLOOR of
# each lane's max |grad|); the float32 value-and-grad against the float64
# one under the same limit, and beside it the eager float32 route's
# deviation from the float64 kernels at SWEEP_EAGER_T, which the float32
# kernels' there may exceed by as much.  7d: the ghfs column of Table I,
# mle_sweep_on_measurements at the config's max_iters, each stage timed:
# per magnitude the median IF-RMSE x10 within SWEEP_MEDIAN_RTOL of the JAX
# package's committed results/ghfs_<magnitude>.npz, at most
# SWEEP_MAX_FAILED lanes without success.
MAGNITUDES = ("const", "damped", "random")
SWEEP_SEEDS, SWEEP_T = 100, 3141
# 8c/8d/9b hold lanes 0 and 299 of a vmapped value-and-grad to the lane
# alone: value SWEEP_VG_TOL relative, gradient SWEEP_GRAD_TOL of max |grad|.
SWEEP_VG_TOL, SWEEP_GRAD_TOL = 1e-5, 1e-4
SWEEP_EAGER_T, SWEEP_THETA_SPREAD = 785, 0.1
SWEEP_F64_NLL_RTOL, SWEEP_F64_GRAD_TOL = 1e-12, 1e-9
SWEEP_F32_FACTOR, SWEEP_F32_VALUE_FLOOR, SWEEP_F32_GRAD_FLOOR = 2.0, 1e-6, 1e-5
SWEEP_MEDIAN_RTOL = {"const": 0.02, "damped": 0.02, "random": 0.05}
# The adjoint's chain floor at B=300, T=3141, GH-3 float32: the carried
# chain's cycles a step in the team design of 32 (the design before the
# chain design) times T at the SM clock, by time_sweep_objective.py
# --breakdown on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).  7a prints
# it beside the shipped kernel's time.
SWEEP_CHAIN_FLOOR_MS = 2.1172
SWEEP_MAX_FAILED = 3
SWEEP_SOURCES = {"ghfs_chirp_filter_lanes": KERNEL_SOURCE,
                 "ghfs_chirp_filter_adjoint":
                     "chirpgp_tpu_torch/ops/csrc/ghfs_chirp_filter_adjoint.cu"}
SWEEP_REPLACES = "chirpgp_tpu/infer/sqrt.py:170"
# Phase 8, the model family.  8a: seed 0 of each column at its reference
# optimum, T=3141, float64 on the card: (data prefix, config or KPT
# harmonics, IF-RMSE x10, final NLL) of the JAX package's float64 run,
# within FAMILY_RMSE_ATOL and FAMILY_NLL_RTOL; harmonic_ckfs in float32
# within GATE_RMSE_ATOL.  8b: La Scala through the filter kernel on the
# 100 toydata_const records.  8c/8d: one vmapped value-and-grad of the
# harmonic CKFS and KPT sweep objectives at B=300, T cut so that it takes
# at most FAMILY_VG_BUDGET_S by a first call at FAMILY_SHORT_T (the cut
# printed).  8e: the whole harmonic-EKFS and KPT sweeps at FAMILY_SMALL =
# (seeds per magnitude, T, max_iters).
KPT_FS = 1000.0
FAMILY_GATES = {
    "harmonic_ckfs": ("h3_", dict(method="ghfs", model="harmonic",
                                  num_harmonics=3, quadrature="cubature",
                                  form="sqrt"), 0.3219522, 983.183553),
    "harmonic_ekfs": ("h3_", dict(method="ekfs", model="harmonic",
                                  num_harmonics=3, form="sqrt"),
                      0.3624330, 983.090767),
    "lascala_ghfs": ("", dict(method="ghfs", model="lascala", form="cov"),
                     0.7856603, 906.724472),
    "lascala_ekfs": ("", dict(method="ekfs", model="lascala", form="sqrt"),
                     1.2892302, 1061.432102),
    "kpt": ("", 1, 1.7120660, 928.032303),
    "harmonic_kpt": ("h3_", 3, 1.5670211, 1063.913084),
}
FAMILY_RMSE_ATOL, FAMILY_NLL_RTOL = 1e-4, 1e-6
# Phase 9a: seed 0 of toydata_const at each cd column's reference optimum,
# T=3141, float64: (IF-RMSE x10, final NLL) of the JAX package's float64
# run on the host CPU (pinned by tests/test_torch_cd.py::
# test_chip_smoke_cd_gates_are_the_jax_package_values), and the
# reference's IF-RMSE x10.  The card is held within CD_RMSE_ATOL of the
# first, CD_REF_ATOL of the last, and CD_NLL_RTOL of the NLL.
CD_GATES = {"cd_ghfs": (0.8357478849699029, 906.7019433239651, 0.835748),
            "cd_ekfs": (2.6312863662172266, 904.313261515979, 2.631286)}
CD_RMSE_ATOL, CD_REF_ATOL, CD_NLL_RTOL = 1e-7, 0.005, 1e-6
# 9b: one vmapped value-and-grad of each cd sweep objective at B=300, T cut
# to CD_VG_BUDGET_S by a first call at FAMILY_SHORT_T.  9c: the whole
# cd_ekfs sweep at CD_SMALL = (seeds per magnitude, T, max_iters).  (The
# budget was 20 s before phase 10, 15 s before phase 12, and 10 s until 2b
# held phase B's chunked kernels alone.)
CD_VG_BUDGET_S = 7.0
CD_SMALL = (1, 40, 3)
# 9d: the classical columns, float64.  The card against the host CPU on the
# same inputs, per-record IF-RMSE relative: 1e-9, but the polynomial LM's
# 2e-4 (its degree-11 least squares is ill-conditioned: the card's QR
# against the host's moved a seed by 7.6e-5 on an H100, and the port and
# the JAX package on one host CPU differ by up to 5.1e-5 per seed).
# The reference's 100 const records, per seed, relative, against
# results/reference/ (the reference) and results/ (the JAX package's
# column), with the largest deviation measured on the host CPU: Hilbert
# 2.3e-6 and the ANF 2.1e-14 from the reference; the spectrogram 1.5e-7
# from the JAX package's column and 2.0% from the reference's own
# spectrogram (paired median ratio 0.994); the polynomial LM 5.1e-5 from
# the JAX package's column (the reference's departs: ROADMAP Queue 3).
# The host CPU runs the polynomial LM on the first
# CLASSICAL_HOST_POLY_RECORDS records (all 300 before phase 13: 97 s of
# host time, phase 9's longest path).
POLY_ITERS = 100
CLASSICAL_ENV_SEED, CLASSICAL_HOST_THREADS = 9, 4
CLASSICAL_HOST_POLY_RECORDS = 100
CLASSICAL_HOST_RTOL = {"hilbert": 1e-9, "spectrogram": 1e-9, "poly": 2e-4,
                       "anf": 1e-9}
CLASSICAL_REF_RTOL = (("hilbert", "reference", 1e-5),
                      ("spectrogram", "reference", 0.025),
                      ("spectrogram", "JAX package", 1e-6),
                      ("poly", "JAX package", 1e-4),
                      ("anf", "reference", 1e-9))
# (FAMILY_VG_BUDGET_S was 75 s, then 45 s and 30 s, before phase 9, and 20 s
# before phase 10, 15 s before phase 12, and 10 s until 2b held phase B's
# chunked kernels alone.)
FAMILY_SHORT_T, FAMILY_VG_BUDGET_S = 64, 7.0
FAMILY_PROFILE_T = 16
# (8e ran T=40 before phase 13.)
FAMILY_SMALL = (1, 20, 3)
# Phase 10, the paper's analysis and the last baselines.  The Fig. 5
# grid point (lam, b, delta, ell, sigma, Xi) of results/crlb_*_lam0.1_b0.1
# at dt=0.01, T=500, float32, in chunks of 16384 trajectories (the JAX
# package's defaults): 1e6 trajectories make CRLB_LAUNCHES chunks.
CRLB_ARGS = (0.1, 0.1, 0.1, 1.0, 1.0, 0.1)
CRLB_DT, CRLB_T, CRLB_CHUNK, CRLB_N = 0.01, 500, 16384, 1_000_000
CRLB_LAUNCHES = -(-CRLB_N // CRLB_CHUNK)
# 10a: on one chunk, the kernel against its plain version: in float64
# within FULL_BOUNDS["float64"]; in float32 the per-step error sums of x2
# and V (what the Monte Carlo reduces) within CRLB_SUM_RTOL relative,
# beside FULL_BOUNDS' float32 ones, which hold each lane at the
# benchmark's data (here, dt=0.01, a lane's float32 mean moves 3.3e-3 of
# its scale and the sums 5.7e-5; the float32 kernel's sums sit 1.6e-5
# from the float64 kernel's, the plain version's 4.1e-5, on an H100).
CRLB_SUM_RTOL = 1e-4
# 10b: float32 against the float64 kernel on the same normals (drawn in
# float64 per chunk from CRLB_SEED + chunk), the mean error per step
# within CRLB_F32_RTOL relative (4.8e-6 on an H100); then each against the
# committed results/crlb_ghf_lam0.1_b0.1.npz: the time-averaged mean
# error of each component within CRLB_GHF_REF's relative bound, and per
# step |z| = |d mean| / sqrt(std_a^2/N_a + std_b^2/N_b) within its bound.
# The committed file sits 1.5% (x2) and 4.0% (V) below the float64
# filter on the card, |z| 10.9 and 16.0 at 1e6 against 1e6 (ROADMAP
# Queue 3); the JAX package on the host CPU at N=16384 already gave 1.5%
# and 3.2%.  10c: the EKF (vmap backend) at CRLB_EKF_N trajectories, a cut
# of the reference's 1e6, per step |z| <= CRLB_Z_MAX against
# crlb_ekf_lam0.1_b0.1.npz (3.1 and 2.4 on an H100).
CRLB_SEED, CRLB_F32_RTOL = 666, 1e-4
CRLB_GHF_REF = {"x2": (0.02, 15.0), "v": (0.05, 20.0)}
CRLB_Z_MAX, CRLB_EKF_N = 6.0, 65536
# 10d: the PCRLB at PCRLB_N trajectories, float64 and float32 on the same
# float64 draws: float64 positive at every step, float32 within
# PCRLB_F32_RTOL of float64 per step.  Float32 loses digits to the
# recursion's cancellation (J + D11 is dominated by the near-singular
# Matern block of Q^-1): 3.7% on x2 and 23% on V at N=1e5 on an H100.
PCRLB_N, PCRLB_F32_RTOL = 100_000, 0.3
# 10e: the FHC columns (K=1 on toydata_*, K=3 on toydata_h3_*), float32 on
# the card, run_fhc.py's window protocol (300 samples, hop 5, median
# kernel force_odd(round(300 / 10))), per seed against the committed
# columns: the FHC_QUANTILE quantile of the relative gap within
# FHC_SEED_RTOL, the median ratio within FHC_MEDIAN_RTOL of 1.  A
# near-tie grid argmax moves a window by one grid step, and the
# committed columns were not made on this port's host: on an H100 the
# 0.95 quantiles are 1.6% (K=1) and 2.6% (K=3), the largest gaps 62.6%
# (const seed 74: 0.1648 against 0.1014, float64 alike) and 7.5%.
FHC_SEEDS, FHC_QUANTILE = 100, 0.95
FHC_SEED_RTOL, FHC_MEDIAN_RTOL = 0.05, 0.01
# 10f: the fastF0NLS columns (host C++) on NLS_SEEDS seeds per magnitude,
# run_fastnls.py's protocol (hop 1, median kernel force_odd(round(300 /
# 2)), method 1), against the committed float32 columns within NLS_RTOL
# (6.5e-7 on the H100's host).
NLS_SEEDS, NLS_RTOL = 3, 2e-6
# 10g: run_ligo.py's synthetic H record (NumPy Threefry of PRNGKey(0)'s
# first split), estimate_if at results/ligo_synthetic.npz's H_synth_params
# in float64: the IF mean within LIGO_IF_RTOL of max |IF| of the committed
# one (1.2e-15 on an H100); analyze_ligo with fit_mle capped at
# LIGO_MLE_ITERS iterations.  The Myotis analog of
# tests/test_bats_longrecord.py (25334 samples at 250 kHz) cut to the
# samples MYOTIS_CROP (the envelope core from sample 6702 on), cov f32 IF
# RMS in the core under MYOTIS_RMS_HZ.  Whether the filter locks on
# depends on round-off, and so on the crop, the dtype, the device and the
# package (ROADMAP Queue 3; myotis_analog.py runs any crop): this crop
# locks on an H100 (1.81 Hz).
LIGO_IF_RTOL, LIGO_MLE_ITERS = 1e-9, 2
MYOTIS_FULL, MYOTIS_CROP, MYOTIS_RMS_HZ = 25334, (4000, 8000), 50.0
# Phase 11, parallel-in-time filtering and posterior inference (no Pallas
# kernel on these paths: batched PyTorch).  11a: the M32 KF/RTS (ell =
# sigma = 1, dt=1e-3, Xi=0.1, float32) on the float32 measurement bytes of
# results/data/parallel_kf_ref.npz at each T of PKF_T, sequential (the
# first T only), flat associative scan and blocked PKF_BLOCKS; smoothed
# means within PKF_TOL of max |truth| of the float64 truth (bench.py:485-
# 503), a float64 flat scan within PKF_F64_ATOL.  11b: the iterated
# parallel sigma-point smoother on the chirp model, GH-3, SMALL_PARAMS,
# seed 0 of toydata_const at T=3141, float32: one iteration flat and
# blocked PSGP_BLOCK against the sequential sgp_filter + sgp_smoother
# (17-28 s on an H100); PSGP_ITERS iterations held to
# tests/test_parallel_sgp.py:109-139 (IF RMSE below 1.5 x the sequential
# one + 0.2, V means within 0.3); a
# float64 call (PSGP_F64_ITERS iterations) on the card equal to the host
# CPU's within PSGP_F64_RTOL of scale.  11c: the bootstrap particle filter
# on the M32 LGSSM of tests/test_nuts_smc.py:95-115 (ell = sigma = 1,
# dt=0.01, T=100, Xi=0.1) at SMC_LGSSM_N particles: log-ML within 2% of
# -kf's NLL, mean filter error below 0.05, ESS above 1; smc_nll on the
# chirp model at seed 0, T=3141, SMC_CHIRP_N particles, float32 and
# float64, finite.  11d: NUTS on tests/test_nuts_smc.py:22-37's Gaussian
# with NUTS_CHAINS chains at depth NUTS_DEPTH (pooled moments: mean atol
# 0.15, cov atol 0.35, accept above 0.6, no divergence); then
# sample_hyperposterior, sqrt GHFS float32, HYPER_CHAINS chains at depth
# HYPER_DEPTH, HYPER_TRANSITIONS (warmup, samples), T cut to
# HYPER_BUDGET_S (not below HYPER_MIN_T) by a first call at HYPER_SHORT_T
# (one batched value-and-grad of 8 chains took 27 ms per step on an
# H100, so the cut leaves T of a few tens): every point evaluated, warmup
# included, with a finite log density and gradient, finite samples, mean
# accept above 0, lane 0's log density = make_logposterior on the lane
# alone (HYPER_LANE_RTOL).
PKF_T, PKF_BLOCKS, PKF_TOL, PKF_F64_ATOL = (3141, 25000), (128, 512), \
    0.01, 1e-8
PKF_PROFILE_T = 300
PSGP_BLOCK, PSGP_ITERS, PSGP_F64_ITERS, PSGP_F64_RTOL = 128, 10, 2, 1e-9
SMC_LGSSM_N, SMC_CHIRP_N = 4000, 4096
# (11d's Gaussian ran 100 + 100 transitions before phase 13.)
NUTS_CHAINS, NUTS_DEPTH, NUTS_TRANSITIONS = 64, 6, (60, 60)
NUTS_COV = ((1.0, 0.7), (0.7, 2.0))
HYPER_CHAINS, HYPER_DEPTH, HYPER_TRANSITIONS = 8, 3, (2, 2)
# The initial step size of the hyperposterior chains.  From nuts_sample's
# 0.1, dual averaging's first step is ~1.4, and a trajectory reached a
# point where the float32 objective is not finite; a NaN log density is
# no divergence in either package, so the accept statistic went NaN on an
# H100 (ROADMAP Queue 3).  The gate on every evaluated point still fails
# the run if the smaller step meets one.
HYPER_STEP = 0.01
# (HYPER_BUDGET_S was 30 s before phase 12.)
HYPER_SHORT_T, HYPER_MIN_T, HYPER_BUDGET_S = 32, 16, 15.0
HYPER_LANE_RTOL = 1e-5
# Phase 12, the scale-out layer (torch.distributed; the exchanges are
# collectives, no Pallas kernel): 12a one NCCL rank in this process at
# SHARD_ONE_RANK's sizes, each sharded entry point against its unsharded
# function; 12b SHARD_RANKS gloo ranks on the one card (NCCL refuses two
# ranks on one device), spawned, at SHARD_RANKS_SIZES: the sharded seed
# sweep of estimate_if_batched at the benchmark's B=4096, T=3141, f32 on
# phase 3's data (B / SHARD_RANKS lanes and one kernel launch per rank),
# the gathered IF mean within SHARD_IF_BOUND of phase 3's as max |d| over
# (1 + max |IF|) (phase 2's float32 bound on the means: launch_geometry
# may pick another team at the smaller B); the time-sharded KF/RTS on 11a's
# M32 configuration, flat and blocked PKF_BLOCKS[0], within PKF_TOL of the
# float64 truth, a float64 flat call within SHARD_KF_F64_RTOL of scale of
# the unsharded flat scan; bootstrap_filter_sharded on 11c's LGSSM, log-ML
# within 2% of -kf's NLL, and in float64 on the unsharded run's draws
# within SHARD_SMC_F64_RTOL of bootstrap_filter's; nuts_sample_sharded on
# 11d's Gaussian (11d's bounds and transitions, one step size), and a
# float64 run on equal draws (SHARD_NUTS_EQUAL: chains, transitions, depth)
# within SHARD_NUTS_F64_RTOL of a one-rank mesh; sample_hyperposterior_sharded,
# sqrt GHFS f32, at T=SHARD_HYPER_T, SHARD_HYPER_TRANSITIONS, every
# evaluated point finite; mc_mle_sweep (EKFS) and mc_kpt_sweep
# (stepped=False) at the sizes' sweep (B, T, max_iters) against
# mesh=None (rtol 1e-6, atol 1e-8: the JAX package's shard-invariance
# tolerance); filter_error_mc (GHF, f64) at the crlb point with N
# trajectories against mesh=None on equal draws within SHARD_CRLB_RTOL
# of scale.  The ranks are joined within SHARD_JOIN_S; a rank's failure
# or hang fails the run.
SHARD_RANKS, SHARD_JOIN_S, SHARD_PG_TIMEOUT_S = 4, 600, 300
SHARD_IF_BOUND = FULL_BOUNDS["float32"][0]
SHARD_KF_F64_RTOL, SHARD_SMC_F64_RTOL = 1e-10, 1e-9
SHARD_NUTS_F64_RTOL, SHARD_CRLB_RTOL = 1e-9, 1e-10
SHARD_NUTS_EQUAL = (8, (10, 10), 4)
SHARD_HYPER_T, SHARD_HYPER_TRANSITIONS = HYPER_MIN_T, (1, 1)
SHARD_SWEEP_RTOL, SHARD_SWEEP_ATOL = 1e-6, 1e-8
SHARD_RANKS_SIZES = dict(B=B_FULL, T=T_FULL, kf_T=PKF_T[-1],
                         smc_N=SMC_LGSSM_N, nuts=(NUTS_CHAINS, (60, 60)),
                         hyper_chains=HYPER_CHAINS, sweep=(8, 40, 2),
                         crlb_N=65536)
SHARD_ONE_RANK = dict(B=256, T=500, kf_T=PKF_T[0], smc_N=1000,
                      nuts=(16, (30, 30)), hyper_chains=2, sweep=(2, 40, 2),
                      crlb_N=4096)
# Phase 13, the entry points: the port's drivers and demos as a user runs
# them, ``python -m chirpgp_tpu_torch.{experiments,demos}.<name> --device
# cuda ...``, each in a child process (the card machine has no JAX), at
# most ENTRY_PARALLEL at once; a nonzero exit, a hang past
# ENTRY_TIMEOUT_S or a failed check fails the run.  Table-I width:
# ENTRY_SEEDS = 100 seeds of each magnitude, B=300, for every column
# driver, the two sweeps (13a, 13e's KPT) included: their rescue and
# float64 polish run each lane's SciPy L-BFGS-B with the lanes'
# evaluations batched on the card (``apps/sweeps.py::_minimize_lanes``).
# Depth cut
# (each cut printed): 13a the Table-I driver (sqrt GHFS, the stepped sweep
# with its rescue, float64 polish and estimate) on the committed
# toydata_* cropped to ENTRY_T samples, ENTRY_ITERS iterations; 13b
# print_table --paired on 13a's
# columns; 13c run_crlb at ENTRY_CRLB_N trajectories, float32, cf backend:
# ENTRY_CRLB_N / CRLB_CHUNK kernel launches, counted in the child, its
# file equal to an in-process filter_error_mc_chunked on the same draws
# within ENTRY_CRLB_RTOL; 13d run_classical (Hilbert, spectrogram, ANF) at
# the full T=3141 on JAX's records of its keys, per seed against the JAX
# package's committed results/{method}_{mag}.npz within
# ENTRY_CLASSICAL_RTOL (the host CPU: Hilbert 1.1e-6, spectrogram 2.1e-7,
# ANF 8.5e-11), the random records' Hilbert within ENTRY_HILBERT_RANDOM_RTOL
# (1.25e-5 on the host CPU: the OU magnitude crosses zero, where the
# analytic signal's angle amplifies round-off); 13e run_kpt at ENTRY_T and
# ENTRY_ITERS, run_fhc (K=3) on ENTRY_FHC_SEEDS seeds (10e's bounds
# against the committed columns) and run_fastnls on ENTRY_NLS_SEEDS seed
# against the committed columns within ENTRY_NLS_RTOL (1.6e-6 on the host
# CPU: the float32 records remade from JAX's keys part from XLA's by
# float32 round-off of the chirp); 13f the classical_methods demo, the
# ghfs_mle demo at ENTRY_DEMO (T, max_iters) and print_time at
# ENTRY_PRINT_TIME_T.
ENTRY_PARALLEL, ENTRY_TIMEOUT_S = 4, 400
# (13f's ghfs_mle ran T=50 with 3 iterations and print_time T=785 in the
# first card run: phase 13 took 140 s.)
ENTRY_SEEDS, ENTRY_T, ENTRY_ITERS = 100, 100, 2
ENTRY_CRLB_N, ENTRY_CRLB_RTOL = 65536, 1e-12
ENTRY_CLASSICAL_RTOL = {"hilbert": 1e-5, "spectrogram": 1e-6, "anf": 1e-9}
ENTRY_HILBERT_RANDOM_RTOL = 5e-5
ENTRY_FHC_SEEDS, ENTRY_NLS_SEEDS, ENTRY_NLS_RTOL = 10, 1, 1e-5
ENTRY_DEMO, ENTRY_PRINT_TIME_T = (30, 2), 200
# 13g the paper's figures, ``plots --save-arrays`` with all nine: the
# samples, the covariance surface and the conditional covariance at the
# JAX script's sizes, the two estimation records cut from T=3141 to
# ENTRY_PLOTS_T; every array finite and of the script's shape, the
# samples and the conditional covariance against the same ``_arrays``
# call on the host CPU in this process (float32, ENTRY_PLOTS_RTOL of each
# array's largest magnitude), the crlb arrays equal to the committed
# files.  13h the scaling harness, ``bench_scaling --ranks 4 --seeds
# 1024`` with T cut from 512 to ENTRY_SCALING["T"] (four gloo ranks on the
# one card): mesh sizes 1, 2 and 4 reported, one filter and one smoother
# kernel launch per rank per sweep (SCALING_SWEEPS: a warm-up and three
# timed), counted in the child, and each size's values within ENTRY_SCALING_RTOL of one rank's.
ENTRY_PLOTS_T, ENTRY_PLOTS_RTOL = 785, 1e-4
ENTRY_SCALING = dict(ranks=4, seeds=1024, T=64)
ENTRY_SCALING_RTOL, SCALING_SWEEPS = 1e-5, 4

# Phases 5-13 run in LANES once the timed phases (1-4, 6e and the bare
# launches that 8b, 10a and 12b report) are done: the main process runs
# the first lane, a spawned process each other one, beside each other on
# the one card.  Each lane runs its phases in order; every phase that
# runs there has no CUDA-event time, so only its host-clock times (6d's
# plain twins' among them) and busy shares are taken with the card and
# the host shared.  A lane's phases print
# through this process, each phase's lines together as it ends.  The
# phases that print from a child of their own (12b's rank 0) and the
# entry points' children (the subreaper) stay in the main process.  Each
# lane empties its allocator's cache as a phase ends: the lanes' phases
# share the card's memory (13e's run_fhc ran out of it while another lane
# held 6d's cached blocks through 10e's harmonic FHC).
# (All of phases 5-13 ran in turn, one after another, before the run
# reached the 1200 s limit on a slower host.)
LANES = (("family", "sharded", "entry_points", "table_one"),
         ("mle", "parallel_posterior", "analysis"),
         ("fused", "sweep"))
LANE_JOIN_S = 900
# The card's memory, all processes together, is sampled every
# MEMORY_WATCH_S seconds while the lanes run and reported by phase span
# and in bins of MEMORY_BIN_S seconds (``CardMemoryWatch``).  The parts
# of the lanes that hold most of it take turns (``memory_turn``): 6d
# (25 GiB reserved), 10c-10e (phase 10 reached 40 GiB reserved before
# each of its parts gave its blocks back as it ended) and 13e's run_fhc
# child, each giving its blocks back to the card before the next begins;
# a turn not had within MEMORY_TURN_WAIT_S fails the run.  Without turns
# the lanes met at 58 GiB of 79 in one run, and another run ran out of the
# card's memory.
MEMORY_WATCH_S, MEMORY_BIN_S, MEMORY_TURN_WAIT_S = 0.2, 10, 600
# The lanes' lock of memory turns (set as the lanes start, in each of
# their processes) and the seconds this process has waited for it.
MEMORY_TURN = dict(lock=None, wait_s=0.0)


class SmokeFailure(RuntimeError):
    pass


@contextlib.contextmanager
def memory_turn(device):
    """The block runs alone among the lanes' memory-heavy blocks: it waits
    for the lanes' lock (MEMORY_TURN; none outside the lanes) and gives
    this process's cached blocks back to the card before it lets the next
    one in."""
    lock = MEMORY_TURN["lock"]
    if lock is None:
        yield
        return
    t0 = time.monotonic()
    check(lock.acquire(timeout=MEMORY_TURN_WAIT_S),
          f"no memory turn within {MEMORY_TURN_WAIT_S} s")
    MEMORY_TURN["wait_s"] += time.monotonic() - t0
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        lock.release()


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def sm_clock_mhz() -> float:
    """The card's largest SM clock, MHz (``nvidia-smi``'s clocks.max.sm)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return float(proc.stdout.strip().splitlines()[0])


def mufu_floor(elements, per_element, device):
    """Phase E's float32 floor: ``elements`` x ``per_element`` MUFU
    operations at MUFU_PER_CLOCK_SM per clock on each SM of ``device`` at
    its largest clock.  Returns (ms, a note of the count and rates)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = sm_clock_mhz()
    ms = 1e-3 * elements * per_element / (MUFU_PER_CLOCK_SM * sms * mhz)
    return ms, (f"MUFU {per_element} per element, floor {ms!r} ms at "
                f"{MUFU_PER_CLOCK_SM}/clock/SM x {sms} SMs x {mhz:g} MHz")


def expect_within(got, twin):
    """Phase E's kernel output ``got`` against its pair-form twin ``twin``
    (float64, same inputs): the largest |d| over its allowance (float64
    EXPECT_RTOL_F64 |twin|, float32 EXPECT_ATOL_F32 max(1, |twin|)), at
    most 1 to pass; inf where a NaN or an infinity differs."""
    g, w = got.double(), twin.double()
    inf = torch.isinf(w)
    if not (torch.equal(torch.isnan(g), torch.isnan(w))
            and torch.equal(g[inf], w[inf])):
        return math.inf
    fin = torch.isfinite(w)
    if not bool(fin.any()):
        return 0.0
    allow = (EXPECT_RTOL_F64 * w[fin].abs() if got.dtype == torch.float64
             else EXPECT_ATOL_F32 * w[fin].abs().clamp_min(1.0))
    return float(((g[fin] - w[fin]).abs()
                  / allow.clamp_min(torch.finfo(torch.float64).tiny)).max())


def measurements(B, T, seed, dtype, device):
    """gen_chirp(meow_freq(offset=8)) + sqrt(Xi) N(0, 1), noise from a
    seeded NumPy generator -- the benchmark's data."""
    from chirpgp_tpu_torch.toymodels import gen_chirp, constant_mag, meow_freq
    ts = torch.linspace(DT, DT * T, T, dtype=dtype, device=device)
    _, phase = meow_freq(offset=8.0)
    base = gen_chirp(ts, constant_mag(1.0), phase)
    noise = np.random.default_rng(seed).standard_normal((B, T))
    return base[None] + math.sqrt(XI) * torch.as_tensor(
        noise, dtype=dtype, device=device)


def deviations(kern, plain):
    """max |d mfs|, max |d L L^T|, max |d Lfs|, max |d nll|, the largest
    relative deviation of nll[-1], and the scales max |mfs|, max |L L^T|
    of the plain version."""
    (mk, lk, nk), (mp, lp, np_) = [[x.double() for x in out]
                                   for out in (kern, plain)]
    Pk = torch.einsum("tikb,tjkb->tijb", lk, lk)
    Pp = torch.einsum("tikb,tjkb->tijb", lp, lp)
    return dict(
        mfs=float((mk - mp).abs().max()), LLT=float((Pk - Pp).abs().max()),
        Lfs=float((lk - lp).abs().max()), nll=float((nk - np_).abs().max()),
        nll_last_rel=float(((nk[-1] - np_[-1]).abs() / np_[-1].abs()).max()),
        scale_mfs=float(mp.abs().max()), scale_LLT=float(Pp.abs().max()))


# Phase 1: the names of each kernel's template integers in ptxas's report.
TEMPLATE_NAMES = {"ghfs_chirp_filter": ("P", "rows", "per_lane"),
                  "adjoint_team": ("P", "rows"),
                  "adjoint_chain": ("rows", "producers"),
                  "smoother_rows": ("rows",),
                  "fused_forward": ("P", "groups"),
                  "affine_backward": ("slim",)}


def phase_environment(device):
    import concurrent.futures
    from chirpgp_tpu_torch.ops.chirp_filter import load_kernel
    from chirpgp_tpu_torch.ops.chirp_filter_grad import load_adjoint_kernel
    from chirpgp_tpu_torch.ops.chirp_fused import load_fused_kernel
    from chirpgp_tpu_torch.ops.chirp_smoother import load_smoother_kernel
    from chirpgp_tpu_torch.ops._build import find_nvcc
    smi = nvidia_smi()
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    # One nvcc per source, started together.
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        built = dict(zip(("filter", "smoother", "fused", "adjoint"), pool.map(
            lambda load: load(),
            (load_kernel, load_smoother_kernel, load_fused_kernel,
             load_adjoint_kernel))))
    t_build = time.perf_counter() - t0
    # ptxas -v: each kernel instance (kernel, dtype, and its template
    # integers: the team size and rows per member, G's slim flag) with its
    # registers, stack frame and spills.
    ptxas, spills = [], []
    for name, lib in built.items():
        inst = None
        for ln in lib.log.splitlines():
            found = re.search(r"entry function '\S*?([a-z_]+)_kernelI([fd])"
                              r"((?:L[ib]\d+E)*)", ln)
            if found:
                ints = tuple(int(x) for x in re.findall(r"\d+", found[3]))
                inst = (found[1], dict(f="f32", d="f64")[found[2]], *ints)
                ptxas.append(" ".join(inst[:2]) + "".join(
                    f" {k}={v}" for k, v in zip(
                        TEMPLATE_NAMES.get(found[1], ()), ints)) + ":")
            elif "registers" in ln or "spill" in ln:
                ptxas.append(ln.split("ptxas info    :")[-1].strip())
                if ("spill" in ln and inst not in SPILLS_ALLOWED and
                        "0 bytes spill stores, 0 bytes spill loads" not in ln):
                    spills.append((inst, ln.strip()))
    print(f"phase 1 environment: device={torch.cuda.get_device_name(device)}"
          f" | nvidia-smi: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {nvcc[-1] if nvcc else 'nvcc ?'} | "
          f"kernel builds, in parallel: {t_build:.2f} s (filter "
          f"{built['filter'].build_seconds:.2f} s, smoother "
          f"{built['smoother'].build_seconds:.2f} s, fused "
          f"{built['fused'].build_seconds:.2f} s, adjoint "
          f"{built['adjoint'].build_seconds:.2f} s) | ptxas (fused_forward, "
          f"adjoint_chain: one count for both roles of their warps): "
          f"{' '.join(ptxas)}")
    print(smi)
    check(not spills, f"ptxas reports register spills: {spills}")
    return smi


def phase_kernel_vs_plain(device):
    from chirpgp_tpu_torch.ops.chirp_filter import (
        TEAMS, ghfs_chirp_filter, ghfs_chirp_filter_kernel,
        ghfs_chirp_filter_reference)
    from chirpgp_tpu_torch.quad import cubature, gauss_hermite
    rules = {"gh3": gauss_hermite(4, 3), "cubature": cubature(4)}
    parts = []
    # The small cases take tests/test_pallas_filter.py's inputs,
    # 0.1 N(0, 1), at which its absolute tolerances were set; every team
    # size the kernel is built for is held to them.
    small = 0.1 * np.random.default_rng(0).standard_normal((SMALL_B, SMALL_T))
    for dtype, tols in ((torch.float32, (5e-5, 1e-4, 1e-4, 5e-5)),
                        (torch.float64, (1e-9,) * 4)):
        yss = torch.as_tensor(small, dtype=dtype, device=device)
        for name, rule in rules.items():
            args = (SMALL_PARAMS, XI, DT, rule, yss)
            plain = ghfs_chirp_filter_reference(*args)
            for team in TEAMS:
                dev = deviations(ghfs_chirp_filter_kernel(*args, team=team),
                                 plain)
                tag = f"{name}/{str(dtype)[6:]}/P={team}"
                for key, tol in zip(("mfs", "LLT", "Lfs", "nll"), tols):
                    check(dev[key] <= tol,
                          f"{tag}: max |d {key}| = {dev[key]} > {tol}")
                parts.append(f"{tag} mfs {dev['mfs']:.3g} LLT "
                             f"{dev['LLT']:.3g} Lfs {dev['Lfs']:.3g} nll "
                             f"{dev['nll']:.3g}")

    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.models import g
    cfg = IFEstimationConfig()
    params = g(cfg.default_init_theta()).to(torch.float32)
    y64 = measurements(B_FULL, T_FULL, 999, torch.float64, device)
    kern, plain = {}, {}
    for yss in (y64, y64.float()):
        args = (params, XI, DT, cfg.sigma_points(), yss)
        tag = str(yss.dtype)[6:]
        kern[tag] = ghfs_chirp_filter(*args)
        plain[tag] = ghfs_chirp_filter_reference(*args)
        dev = deviations(kern[tag], plain[tag])
        scaled = (dev["mfs"] / (1.0 + dev["scale_mfs"]),
                  dev["LLT"] / (1.0 + dev["scale_LLT"]), dev["nll_last_rel"])
        for key, val, bound in zip(("mfs", "LLT", "nll[-1]"), scaled,
                                   FULL_BOUNDS[tag]):
            check(val <= bound, f"full {tag}: scaled |d {key}| {val} > {bound}")
        parts.append(
            f"full gh3/{tag} B={B_FULL} T={T_FULL}: max|d mfs| {dev['mfs']!r}"
            f" (max|mfs| {dev['scale_mfs']!r}), max|d LLT| {dev['LLT']!r} "
            f"(max|LLT| {dev['scale_LLT']!r}), max|d Lfs| {dev['Lfs']!r}, "
            f"max rel|d nll[-1]| {dev['nll_last_rel']!r}")
    del plain["float64"]
    # Each float32 version against the float64 kernel, the on-card oracle.
    for name, out in (("kernel", kern["float32"]), ("plain", plain["float32"])):
        dev = deviations(out, kern["float64"])
        parts.append(f"float32 {name} vs float64 kernel: max|d mfs| "
                     f"{dev['mfs']!r}, max|d LLT| {dev['LLT']!r}, max rel|d "
                     f"nll[-1]| {dev['nll_last_rel']!r}")
    dev = deviations(kern["float32"], plain["float32"])
    print("phase 2 kernel vs plain: " + "; ".join(parts))
    return max(dev["mfs"], dev["Lfs"], dev["nll"]), kern


def signs_of(L, like):
    """The lower factors L (T, 4, 4, B) with each column's sign made that
    of ``like``'s: two lower factors of one Gram differ by column signs
    only, which the Householder pivots pick (phase B's chunks pick other
    pivots than the plain recursion), so a factor is compared entry by
    entry once they agree (sign of the diagonals; 0 counts as +)."""
    d = torch.where(torch.diagonal(L, dim1=1, dim2=2) >= 0, 1.0, -1.0)
    w = torch.where(torch.diagonal(like, dim1=1, dim2=2) >= 0, 1.0, -1.0)
    return L * (d * w).transpose(1, 2)[:, None].to(L.dtype)


def smoother_deviations(kern, plain):
    """max |d mss|, |d Ls Ls^T|, |d Lss| (up to its columns' signs, as
    ``signs_of`` aligns them), |d if_mean|, and the scales max |mss|, max
    |Ls Ls^T|, max |if_mean| of the plain version."""
    (mk, lk, ik), (mp, lp, ip) = [[x.double() for x in out]
                                  for out in (kern, plain)]
    lk = signs_of(lk, lp)
    Pk = torch.einsum("tikb,tjkb->tijb", lk, lk)
    Pp = torch.einsum("tikb,tjkb->tijb", lp, lp)
    return dict(
        mss=float((mk - mp).abs().max()), LLT=float((Pk - Pp).abs().max()),
        Lss=float((lk - lp).abs().max()), if_mean=float((ik - ip).abs().max()),
        scale_mss=float(mp.abs().max()), scale_LLT=float(Pp.abs().max()),
        scale_if=float(ip.abs().max()))


def upper_gram(words):
    """R22^T R22 of the (..., 10, B) upper-triangle words of R22 (phase A's
    rows): a row of R22 may change sign with the rounding of a near-zero
    diagonal, and phase B reads only the Gram."""
    iu = torch.triu_indices(4, 4)
    up = words.new_zeros(words.shape[:-2] + (4, 4, words.shape[-1]))
    up[..., iu[0], iu[1], :] = words
    return torch.einsum("...kib,...kjb->...ijb", up, up)


def lower_words(words):
    """The (n, 4, 4, B) lower factors of (n, 10, B) words of their lower
    triangles, row by row (phase B's carries)."""
    il = torch.tril_indices(4, 4)
    L = words.new_zeros(words.shape[:-2] + (4, 4, words.shape[-1]))
    L[..., il[0], il[1], :] = words
    return L


def smoother_phase_deviations(args, outputs):
    """Each smoother kernel against its own plain counterpart on the same
    inputs, all lanes as one slab, its deviation over (1 + max |plain|)
    held to SMOOTHER_FULL_BOUNDS: phase A's rows against
    ``smoother_rows_reference`` (m_p and X, and R22 by its Gram); phase B
    in ``backward_chunks``' C chunks, Compose's aggregates against
    ``smoother_compose_reference`` (c, x_ref and A^T, and S^T by its
    Gram), Carry's carries against ``smoother_carry_reference`` on
    Compose's aggregates (ms, and Ls up to its columns' signs) and Apply's
    mss and Lss against ``smoother_apply_reference`` on Carry's carries;
    then phase B's outputs against the whole chunked twin and the
    sequential recursion ``smoother_backward_reference`` over the
    kernel's own rows; phase E's IF mean against
    its pair-form twin ``smoother_expect_reference`` in float64 on the
    wrapper's mss and Lss (``outputs``), within ``expect_within``'s
    allowance.  Returns ({kernel: (max |d|, plain seconds)}, C, {twin:
    scaled |d| of phase B's outputs})."""
    from chirpgp_tpu_torch.ops.chirp_smoother import (
        ROW_WORDS, SmootherKernels, smoother_apply_reference,
        smoother_backward_chunked_reference, smoother_backward_reference,
        smoother_carry_reference, smoother_compose_reference,
        smoother_expect_reference, smoother_rows_reference)
    from chirpgp_tpu_torch.utils.timing import timed
    params, dt, rule, mfs, Lfs, order = args
    T, _, B = mfs.shape
    tag = f"{str(mfs.dtype)[6:]} B={B}"
    bound = SMOOTHER_FULL_BOUNDS[str(mfs.dtype)[6:]][0]
    kernels = SmootherKernels(params, dt, rule, order, mfs.dtype, mfs.device)
    rows = mfs.new_empty((T - 1, ROW_WORDS, B))
    kernels.rows(mfs, Lfs, rows)
    want, t_rows = timed(smoother_rows_reference, params, dt, rule, mfs, Lfs)
    gram, gram_p = (upper_gram(x[:, 20:].double()) for x in (rows, want))
    devs = {"smoother_rows": [(rows[:, :20], want[:, :20]), (gram, gram_p)]}
    times = {"smoother_rows": t_rows}
    del want, gram, gram_p
    back = kernels.back
    C = back.chunks(T, B)
    agg, bounds = back.scratch(B, C)
    back.compose(mfs, rows, agg, C)
    want, times["smoother_compose"] = timed(smoother_compose_reference, mfs,
                                            rows, C)
    devs["smoother_compose"] = [
        (agg[:, :24], want[:, :24]),
        tuple(upper_gram(x[:, 24:].double()) for x in (agg, want))]
    back.carry(mfs, Lfs, agg, bounds, C)
    want, times["smoother_carry"] = timed(smoother_carry_reference, mfs, Lfs,
                                          agg, C)
    Lb = lower_words(want[:, 4:])
    devs["smoother_carry"] = [(bounds[:, :4], want[:, :4]),
                              (signs_of(lower_words(bounds[:, 4:]), Lb), Lb)]
    mss = torch.empty_like(mfs)
    lss = mfs.new_empty((T, 16, B))
    back.apply(mfs, Lfs, rows, bounds, mss, lss, C)
    (ms_p, Ls_p), times["smoother_backward"] = timed(
        smoother_apply_reference, mfs, Lfs, rows, bounds, C)
    Lss = lss.view(T, 4, 4, B)
    devs["smoother_backward"] = [(mss, ms_p), (signs_of(Lss, Ls_p), Ls_p)]
    del agg, bounds, ms_p, Ls_p, want, Lb
    whole = {}
    for twin, fn in (("chunked twin", lambda: smoother_backward_chunked_reference(
            mfs, Lfs, rows, C)), ("sequential twin", lambda:
                                  smoother_backward_reference(mfs, Lfs,
                                                              rows))):
        ms_w, Ls_w = fn()
        whole[twin] = max(scaled_dev(mss, ms_w),
                          scaled_dev(signs_of(Lss, Ls_w), Ls_w))
        check(whole[twin] <= bound, f"2b {tag}: phase B (C={C}) vs the "
                                    f"{twin}: scaled |d| {whole[twin]} > "
                                    f"{bound}")
        del ms_w, Ls_w
    del rows, mss, lss, Lss
    if_mean = mfs.new_empty((T, B))
    kernels.expect(outputs[0], outputs[1].view(T, 16, B), if_mean)
    if_p, times["smoother_expect"] = timed(
        smoother_expect_reference, outputs[0].double(), outputs[1].double(),
        order)
    within = expect_within(if_mean, if_p)
    check(within <= 1.0, f"2b {tag} smoother_expect vs its float64 pair-form "
                         f"twin: |d| at {within} of its allowance")
    devs["smoother_expect"] = [(if_mean, if_p)]
    out = {}
    for kernel, pairs in devs.items():
        d = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
        scaled = max(scaled_dev(a, b) for a, b in pairs)
        check(scaled <= bound, f"2b {tag} {kernel} vs its plain counterpart:"
                               f" scaled |d| {scaled} > {bound}")
        out[kernel] = (d, times[kernel])
    return out, C, whole


@contextlib.contextmanager
def scratch_cap(cap):
    """The smoother wrapper with ``SCRATCH_CAP`` = ``cap`` bytes for the
    launchers built inside."""
    from chirpgp_tpu_torch.ops import chirp_smoother
    saved, chirp_smoother.SCRATCH_CAP = chirp_smoother.SCRATCH_CAP, cap
    try:
        yield
    finally:
        chirp_smoother.SCRATCH_CAP = saved


def phase_smoother_vs_plain(device, filtered):
    """2b: the smoother's kernels (phases A, B and E) against the plain
    version on the filter kernel's outputs: the small cases, a scratch cap
    that forces slabs of lanes against one
    slab (bit for bit), then the benchmark's B=4096 x T=3141 (phase 2's
    filter outputs ``filtered``) in float64 and float32, each float32
    version against the float64 kernel, and in float32 each kernel
    against its own plain counterpart.  Returns the float32 kernels'
    largest deviation, the plain version's time at the benchmark's shape,
    float32, and {kernel: (max |d|, plain ms)}."""
    from chirpgp_tpu_torch.utils.timing import timed
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
    from chirpgp_tpu_torch.ops.chirp_smoother import (
        ROW_WORDS, ghfs_chirp_smoother, ghfs_chirp_smoother_kernel,
        ghfs_chirp_smoother_reference, smoother_kernel_launcher)
    from chirpgp_tpu_torch.quad import cubature, gauss_hermite
    cfg = IFEstimationConfig()
    order = cfg.expectation_order
    rules = {"gh3": gauss_hermite(4, 3), "cubature": cubature(4)}
    parts = []
    t_phase = time.perf_counter()
    small = 0.1 * np.random.default_rng(0).standard_normal((SMALL_B, SMALL_T))
    for dtype, tols in ((torch.float32, SMOOTHER_SMALL_TOLS["float32"]),
                        (torch.float64, SMOOTHER_SMALL_TOLS["float64"])):
        yss = torch.as_tensor(small, dtype=dtype, device=device)
        for name, rule in rules.items():
            mfs, Lfs, _ = ghfs_chirp_filter(SMALL_PARAMS, XI, DT, rule, yss)
            args = (SMALL_PARAMS, DT, rule, mfs, Lfs, order)
            plain = ghfs_chirp_smoother_reference(*args)
            kern = ghfs_chirp_smoother_kernel(*args)
            dev = smoother_deviations(kern, plain)
            dev["if_scaled"] = dev["if_mean"] / (1.0 + dev["scale_if"])
            tag = f"{name}/{str(dtype)[6:]}"
            for key, tol in zip(("mss", "LLT", "Lss", "if_scaled"), tols):
                check(dev[key] <= tol,
                      f"2b {tag}: max |d {key}| = {dev[key]} > {tol}")
            parts.append(f"{tag} mss {dev['mss']:.3g} LLT {dev['LLT']:.3g} "
                         f"Lss {dev['Lss']:.3g} if_mean {dev['if_mean']:.3g}")
            # Slabs of 32 lanes: the bits of one slab.
            cap = 32 * (SMALL_T - 1) * ROW_WORDS * mfs.element_size()
            before = ghfs_chirp_smoother.kernel_launches["smoother_rows"]
            with scratch_cap(cap):
                launch, slabbed = smoother_kernel_launcher(*args)
            launch()
            slabs = (ghfs_chirp_smoother.kernel_launches["smoother_rows"]
                     - before)
            check(slabs == SMALL_B // 32 and all(
                torch.equal(a, b) for a, b in zip(slabbed, kern)),
                  f"2b {tag}: {slabs} slabs differ from one")

    params = g(cfg.default_init_theta()).to(torch.float32)
    kern, plain_ms, phases = {}, None, {}
    for tag in ("float64", "float32"):
        mfs, Lfs, _ = filtered[tag]
        args = (params, DT, cfg.sigma_points(), mfs, Lfs, order)
        kern[tag] = ghfs_chirp_smoother_kernel(*args)
        plain, t_plain = timed(ghfs_chirp_smoother_reference, *args)
        dev = smoother_deviations(kern[tag], plain)
        scaled = (dev["mss"] / (1.0 + dev["scale_mss"]),
                  dev["LLT"] / (1.0 + dev["scale_LLT"]),
                  dev["if_mean"] / (1.0 + dev["scale_if"]))
        for key, val, bound in zip(("mss", "LLT", "if_mean"), scaled,
                                   SMOOTHER_FULL_BOUNDS[tag]):
            check(val <= bound,
                  f"2b full {tag}: scaled |d {key}| {val} > {bound}")
        parts.append(
            f"full gh3/{tag} B={B_FULL} T={T_FULL}: max|d mss| {dev['mss']!r}"
            f" (max|mss| {dev['scale_mss']!r}), max|d LLT| {dev['LLT']!r} "
            f"(max|LLT| {dev['scale_LLT']!r}), max|d Lss| {dev['Lss']!r}, "
            f"max|d if_mean| {dev['if_mean']!r} (max|if_mean| "
            f"{dev['scale_if']!r}); plain smoother {t_plain:.3f} s")
        if tag == "float32":
            plain_ms, plain32 = 1e3 * t_plain, plain
            max_err = max(dev["mss"], dev["Lss"], dev["if_mean"])
        del plain
        # Each kernel against its own plain counterpart, at B=4096 in both
        # dtypes and on the first 100 lanes in float32.
        cases = [(tag, args, kern[tag])]
        if tag == "float32":
            cases.append(("float32 B=100", args[:3] + tuple(
                x[..., :100].contiguous() for x in args[3:5]) + args[5:],
                tuple(x[..., :100].contiguous() for x in kern[tag])))
        for what, a, outputs in cases:
            each, C, whole = smoother_phase_deviations(a, outputs)
            each = {k: (err, 1e3 * t) for k, (err, t) in each.items()}
            if what == "float32":
                phases = each
            parts.append(
                f"{what} each kernel vs its plain counterpart (phase B in C="
                f"{C} chunks): " + ", ".join(
                    f"{k} max|d| {err!r}, plain {t:.3f} ms"
                    for k, (err, t) in each.items())
                + "; phase B's outputs vs " + ", ".join(
                    f"the {twin} scaled {d:.3g}" for twin, d in whole.items()))
    # Each float32 version against the float64 kernel, the on-card oracle.
    for name, out in (("kernel", kern["float32"]), ("plain", plain32)):
        dev = smoother_deviations(out, kern["float64"])
        parts.append(f"float32 {name} vs float64 kernel: max|d mss| "
                     f"{dev['mss']!r}, max|d LLT| {dev['LLT']!r}, max|d "
                     f"if_mean| {dev['if_mean']!r}")
    print(f"phase 2b smoother kernels vs plain "
          f"({time.perf_counter() - t_phase:.3f} s): " + "; ".join(parts))
    return max_err, plain_ms, phases


def phase_slice(device):
    from chirpgp_tpu_torch.utils.timing import profile_device, timed
    from chirpgp_tpu_torch.apps import IFEstimationConfig, estimate_if_batched
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter import (
        ghfs_chirp_filter, ghfs_chirp_filter_reference)
    from chirpgp_tpu_torch.ops.chirp_smoother import (
        KERNELS, backward_chunks, ghfs_chirp_smoother, smoother_slabs)
    cfg = IFEstimationConfig()
    params = g(cfg.default_init_theta()).to(torch.float32).to(device)
    yss = measurements(B_FULL, T_FULL, 999, torch.float32, device)
    rule = cfg.sigma_points()
    args = (params, cfg.Xi, cfg.dt, rule, yss)
    # One call of each, both warm from phase 2 (the plain version's second
    # call, once in turns, was cut to make room for later phases).
    times = {"plain": [], "kernel": []}
    for which in ("kernel", "plain"):
        fn = ghfs_chirp_filter if which == "kernel" else ghfs_chirp_filter_reference
        times[which].append(timed(fn, *args)[1])

    ghfs_chirp_filter.launches = ghfs_chirp_smoother.launches = 0
    ghfs_chirp_smoother.kernel_launches = dict.fromkeys(KERNELS, 0)
    est, t_est = timed(estimate_if_batched, cfg, params, yss)
    launches = (ghfs_chirp_filter.launches, ghfs_chirp_smoother.launches)
    kernel_launches = dict(ghfs_chirp_smoother.kernel_launches)
    check(launches == (1, 1), f"estimate_if_batched launched the filter and "
                              f"the smoother {launches} times, not once each")
    slabs = len(smoother_slabs(T_FULL, B_FULL, yss.element_size()))
    chunks = backward_chunks(T_FULL, B_FULL, torch.cuda.get_device_properties(
        device).multi_processor_count)
    chained = slabs if chunks > 1 else 0
    want = dict(zip(KERNELS, (slabs, chained, chained, slabs, 1)))
    check(kernel_launches == want,
          f"estimate_if_batched launched the smoother's kernels "
          f"{kernel_launches}, not {want} (phase A and phase B's Compose, "
          f"Carry (C = {chunks} > 1) and Apply once per slab)")
    for key in ("if_mean", "nell", "mss", "Lss"):
        check(bool(torch.isfinite(est[key]).all()), f"non-finite {key}")
    check(tuple(est["if_mean"].shape) == (B_FULL, T_FULL), "if_mean shape")
    check(tuple(est["nell"].shape) == (B_FULL,), "nell shape")
    # The CUDA kernels of one call, at the full T and at SLICE_SHORT_T: the
    # same small count, whatever T.
    profs = {T: profile_device(lambda: estimate_if_batched(
        cfg, params, yss[:, :T])) for T in (T_FULL, SLICE_SHORT_T)}
    counts = {T: prof.launches for T, prof in profs.items()}
    check(len(set(counts.values())) == 1
          and counts[T_FULL] <= SLICE_MAX_KERNELS,
          f"estimate_if_batched ran {counts} CUDA kernels at T = "
          f"{list(counts)}, not one count of at most {SLICE_MAX_KERNELS}")
    prof = profs[T_FULL]
    ms_p = 1e3 * times["plain"][0]
    print(f"phase 3 slice: estimate_if_batched B={B_FULL} T={T_FULL} GH-3 "
          f"float32: finite, filter and smoother launches {launches}, the "
          f"smoother's kernels {kernel_launches} (phase B in C={chunks} "
          f"chunks); "
          f"{counts[T_FULL]} CUDA kernels per call at T={T_FULL} and "
          f"{counts[SLICE_SHORT_T]} at T={SLICE_SHORT_T} (torch.profiler), "
          f"device busy {100 * prof.busy:.2f}% of {1e3 * prof.wall_s:.3f} ms;"
          f" filter kernel {[round(1e3 * t, 3) for t in times['kernel']]} ms,"
          f" plain filter {[round(1e3 * t, 3) for t in times['plain']]} ms "
          f"(one call each, warm from phase 2); whole estimate "
          f"{1e3 * t_est:.3f} ms = {B_FULL * T_FULL / t_est:.1f} steps/s")
    return launches, kernel_launches, ms_p, est["if_mean"], t_est


def event_ms(fn, reps=TIMING_REPS):
    """Mean CUDA-event time of ``fn()`` over ``reps`` calls after one
    warm-up call, in ms."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(S, T, B, dtype, cost=None):
    """The least time the card could take for one filter call (one call of
    the kernel whose work ``cost`` counts, ``filter_cost``'s signature):
    the larger of flop over the peak rate of ``dtype`` and bytes over the
    memory rate.  Returns (flop, bytes, ms, what bounds it)."""
    from chirpgp_tpu_torch.ops.chirp_filter import filter_cost
    work = (cost or filter_cost)(S, T, B, dtype)
    t_ops = work.flop / PEAK_FLOPS[dtype]
    t_bytes = work.bytes / PEAK_BYTES
    return (work.flop, work.bytes, 1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernel_timing(device, smi):
    """CUDA-event times of the bare kernel launch at every team size: GH-3
    at the benchmark's B=4096 x T=3141 (float32 and float64), GH-3 and
    cubature at the Table-I width (the 100 records of toydata_const at the
    reference's GHFS and CKFS optima, float32), and cubature at B=4096
    float32, beside the bound.  Each team's nll[-1] is held to the default
    geometry's."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.convert import params_from_jax
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter import (
        TEAMS, kernel_launcher, launch_geometry)
    from chirpgp_tpu_torch.quad import cubature
    cfg = IFEstimationConfig()
    gh3, cub = cfg.sigma_points(), cubature(4)
    num_sms = torch.cuda.get_device_properties(device).multi_processor_count
    bench = measurements(B_FULL, T_FULL, 999, torch.float64, device)
    p_bench = g(cfg.default_init_theta())
    y100 = torch.as_tensor(
        np.load(ROOT / "results/data/toydata_const.npz")["ys"],
        dtype=torch.float32, device=device)
    opt = {name: params_from_jax(np.load(
        ROOT / f"results/reference/{name}_const.npz")["params"][0])
        for name in ("ghfs", "ckfs")}
    cases = {
        "gh3/B=4096/f32": (p_bench, gh3, bench.float()),
        "gh3/B=4096/f64": (p_bench, gh3, bench),
        "gh3/B=100/f32": (opt["ghfs"], gh3, y100),
        "cubature/B=4096/f32": (p_bench, cub, bench.float()),
        "cubature/B=100/f32": (opt["ckfs"], cub, y100),
    }

    def team_times(args):
        """{team: (ms, nll[-1])} of the bare launch at each team size."""
        out = {}
        for team in TEAMS:
            launch, (_, _, nll) = kernel_launcher(*args, team=team)
            out[team] = (event_ms(launch), nll[-1].double())
        return out

    out, parts = {}, []
    for tag, (params, rule, yss) in cases.items():
        B, T = yss.shape
        default = launch_geometry(B, rule.n_points, num_sms)
        times = team_times((params.to(torch.float64).cpu(), XI, DT, rule,
                            yss))
        nll_ref = times[default.team][1]
        rtol = FULL_BOUNDS[str(yss.dtype)[6:]][2]
        for team, (_, nll) in times.items():
            rel = float(((nll - nll_ref).abs() / nll_ref.abs()).max())
            check(bool(torch.isfinite(nll).all()) and rel <= rtol,
                  f"timing {tag} P={team}: rel d nll[-1] vs default {rel}")
        flop, nbytes, bound, bound_by = bound_ms(rule.n_points, T, B,
                                                 yss.dtype)
        ms = times[default.team][0]
        out[tag] = dict(ms=ms, bound_ms=bound, bound_by=bound_by,
                        team=default.team)
        parts.append(
            f"{tag} T={T}: " + ", ".join(f"P={p} {t!r} ms" for p, (t, _) in
                                         times.items())
            + f"; default P={default.team} rows={default.rows} "
            f"({default.lanes_per_block} lanes x {default.blocks} blocks) "
            f"{ms!r} ms; {flop} flop, {nbytes} B, bound {bound!r} ms "
            f"({bound_by}), share {bound / ms:.4f}")
    # The widths between, on the benchmark's first B records: where the
    # fastest team changes (launch_geometry's threshold).
    for B in SWEEP_B:
        times = team_times((p_bench, XI, DT, gh3, bench[:B].float()))
        parts.append(f"gh3/B={B}/f32: " + ", ".join(
            f"P={p} {t!r} ms" for p, (t, _) in times.items()) + f"; default "
            f"P={launch_geometry(B, gh3.n_points, num_sms).team}")
    print(f"phase 3b kernel timing (CUDA events around the bare launch, 1 "
          f"warm-up + {TIMING_REPS} launches; {smi}; peaks 67/34 TFLOP/s "
          f"f32/f64, 3.35 TB/s): " + "; ".join(parts))
    return out


def phase_smoother_timing(device, smi, filtered, filter_timing):
    """3b, the smoother: CUDA-event times of the whole bare launch (phases
    A, B and E) and of each phase alone, GH-3 with the GH-10 expectation,
    at the benchmark's B=4096 x T=3141 (phase 2's filter outputs
    ``filtered``, float32 and float64) and at the Table-I width (the 100
    records of toydata_const at the reference's GHFS optimum, float32),
    beside the bounds and the ratio to the filter's bare launch on the same
    records in this run (``filter_timing``, phase 3b's).  Phases A and B
    are timed slab by slab (``smoother_slabs``), B on its own slab's rows;
    where ``OTHER_SCRATCH_CAP`` gives other slabs, the whole launch is
    timed at that cap too.  The IF mean of the timed launches is held to
    that of a launch of the wrapper, and to the bits of the phases alone
    and of the other slabs."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.convert import params_from_jax
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
    from chirpgp_tpu_torch.ops.chirp_smoother import (
        KERNELS, ROW_WORDS, SmootherKernels, expect_mufu, ghfs_chirp_smoother,
        rows_per_member, smoother_cost, smoother_kernel_launcher,
        smoother_phase_costs, smoother_slabs)
    cfg = IFEstimationConfig()
    rule, order = cfg.sigma_points(), cfg.expectation_order
    p_bench = g(cfg.default_init_theta())
    opt = params_from_jax(np.load(
        ROOT / "results/reference/ghfs_const.npz")["params"][0])
    y100 = torch.as_tensor(
        np.load(ROOT / "results/data/toydata_const.npz")["ys"],
        dtype=torch.float32, device=device)
    cases = {"gh3/B=4096/f32": (p_bench, filtered["float32"][:2]),
             "gh3/B=4096/f64": (p_bench, filtered["float64"][:2]),
             "gh3/B=100/f32": (opt, ghfs_chirp_filter(opt, XI, DT, rule,
                                                      y100)[:2])}
    out, parts = {}, []
    for tag, (params, (mfs, Lfs)) in cases.items():
        T, _, B = mfs.shape
        if_ref = ghfs_chirp_smoother(params, DT, rule, mfs, Lfs, order)[2]
        launch, outputs = smoother_kernel_launcher(params, DT, rule, mfs,
                                                   Lfs, order)
        if_mean = outputs[2]
        ms = event_ms(launch)
        del launch, outputs   # one launcher's outputs and scratch at a time
        dev = scaled_dev(if_mean, if_ref)
        bound = SMOOTHER_FULL_BOUNDS[str(mfs.dtype)[6:]][2]
        check(bool(torch.isfinite(if_mean).all()) and dev <= bound,
              f"3b smoother {tag}: IF mean of the timed launches {dev}")
        # Each kernel alone: phase A and phase B's Compose, Carry and Apply
        # slab by slab, on the rows phase A has just written for its own
        # slab, in the chunks of the whole B; and phase B's three together.
        kernels = SmootherKernels(params, DT, rule, order, mfs.dtype, device)
        back = kernels.back
        chunks = back.chunks(T, B)
        slabs = smoother_slabs(T, B, mfs.element_size())
        mss, lss = torch.empty_like(mfs), mfs.new_empty((T, 16, B))
        slab_ms = {k: [] for k in KERNELS[:-1] + ("phase_b",)}
        for b0, nb in slabs:
            rows = mfs.new_empty((T - 1, ROW_WORDS, nb))
            agg, bounds = back.scratch(nb, chunks)
            slab_ms["smoother_rows"].append(event_ms(
                lambda: kernels.rows(mfs, Lfs, rows, b0)))
            if chunks > 1:
                slab_ms["smoother_compose"].append(event_ms(
                    lambda: back.compose(mfs, rows, agg, chunks, b0)))
                slab_ms["smoother_carry"].append(event_ms(
                    lambda: back.carry(mfs, Lfs, agg, bounds, chunks, b0)))
            slab_ms["smoother_backward"].append(event_ms(
                lambda: back.apply(mfs, Lfs, rows, bounds, mss, lss, chunks,
                                   b0)))
            slab_ms["phase_b"].append(event_ms(
                lambda: kernels.backward(mfs, Lfs, rows, mss, lss, b0, chunks,
                                         (agg, bounds))))
            del rows, agg, bounds
        if_e = torch.empty_like(if_mean)
        slab_ms["smoother_expect"] = [event_ms(
            lambda: kernels.expect(mss, lss, if_e))]
        check(torch.equal(if_e, if_mean),
              f"3b smoother {tag}: the kernels alone differ from the launch")
        del kernels, back, mss, lss, if_e
        phases = {}
        for kernel in KERNELS + ("phase_b",):
            # Phase B's three together against the least work and bytes of
            # the recursion (the one-pass phase B, inputs read once).
            _, _, pbound, pby = bound_ms(
                rule.n_points, T, B, mfs.dtype,
                lambda *a, _k=kernel: smoother_phase_costs(
                    *a, order, chunks if _k != "phase_b" else 1)[
                    "smoother_backward" if _k == "phase_b" else _k])
            phases[kernel] = dict(ms=sum(slab_ms[kernel]), bound_ms=pbound,
                                  bound_by=pby, slab_ms=slab_ms[kernel])
            if kernel == "smoother_expect" and mfs.dtype == torch.float32:
                phases[kernel]["mufu_ms"], phases[kernel]["mufu"] = \
                    mufu_floor(T * B, expect_mufu(order), device)
        # The whole launch at the other cap, where it gives other slabs.
        other = smoother_slabs(T, B, mfs.element_size(), OTHER_SCRATCH_CAP)
        ms_other = None
        if other != slabs:
            with scratch_cap(OTHER_SCRATCH_CAP):
                launch_o, (_, _, if_o) = smoother_kernel_launcher(
                    params, DT, rule, mfs, Lfs, order)
            ms_other = event_ms(launch_o)
            check(torch.equal(if_o, if_mean),
                  f"3b smoother {tag}: {len(other)} slabs differ from "
                  f"{len(slabs)}")
            del launch_o, if_o
        flop, nbytes, bound, bound_by = bound_ms(rule.n_points, T, B,
                                                 mfs.dtype, smoother_cost)
        ratio = ms / filter_timing[tag]["ms"]
        out[tag] = dict(ms=ms, bound_ms=bound, bound_by=bound_by,
                        ratio=ratio, phases=phases, slabs=len(slabs),
                        chunks=chunks)
        parts.append(
            f"{tag} T={T}: rows={rows_per_member(rule.n_points)} "
            f"({len(slabs)} slab(s)), phase B in C={chunks} chunks (Compose "
            f"{chunks - 1} x {-(-B // 32)} warps, Apply {chunks} x "
            f"{-(-B // 32)}) {ms!r} ms; {flop} flop, {nbytes} "
            f"B, bound {bound!r} ms ({bound_by}), share {bound / ms:.4f}; "
            f"filter {filter_timing[tag]['ms']!r} ms, smoother/filter "
            f"{ratio:.3f}; phases alone: " + ", ".join(
                f"{k} {v['ms']!r} ms (bound {v['bound_ms']!r} ms, "
                f"{v['bound_by']}, share {v['bound_ms'] / v['ms']:.4f}"
                + (f"; {v['mufu']}" if "mufu" in v else "")
                + (f"; slabs {v['slab_ms']!r} ms" if len(slabs) > 1 else "")
                + ")" for k, v in phases.items() if v["slab_ms"])
            + ("" if ms_other is None else
               f"; the whole launch at a {OTHER_SCRATCH_CAP} B cap, "
               f"{len(other)} slabs: {ms_other!r} ms"))
    print(f"phase 3b smoother timing (CUDA events around the bare launches, "
          f"1 warm-up + {TIMING_REPS} launches; {smi}; peaks 67/34 TFLOP/s "
          f"f32/f64, 3.35 TB/s): " + "; ".join(parts) + "; this process's "
          f"peak reserved memory so far "
          f"{torch.cuda.max_memory_reserved(device) / 2 ** 30:.2f} GiB")
    return out


def phase_accuracy(device):
    from chirpgp_tpu_torch.apps import IFEstimationConfig, estimate_if_batched
    from chirpgp_tpu_torch.convert import params_from_jax
    from chirpgp_tpu_torch.utils import rmse
    data = np.load(ROOT / "results/data/toydata_const.npz")
    ys = torch.as_tensor(data["ys"][:1], dtype=torch.float32, device=device)
    tf = torch.as_tensor(data["true_freqs"], dtype=torch.float32, device=device)
    parts = []
    for name, (quad, ref_rmse, ref_nell) in GATES.items():
        params = params_from_jax(
            np.load(ROOT / f"results/reference/{name}_const.npz")["params"][0],
            torch.float32, device)
        est = estimate_if_batched(IFEstimationConfig(quadrature=quad), params, ys)
        r10 = 10.0 * float(rmse(tf, est["if_mean"][0]))
        nell = float(est["nell"][0])
        check(abs(r10 - ref_rmse) <= GATE_RMSE_ATOL,
              f"{name}: IF-RMSE x10 {r10} not within {GATE_RMSE_ATOL} of {ref_rmse}")
        check(abs(nell - ref_nell) <= GATE_NELL_RTOL * ref_nell,
              f"{name}: nell {nell} not within {GATE_NELL_RTOL} rel of {ref_nell}")
        parts.append(f"{name} IF-RMSE x10 {r10!r} (ref {ref_rmse}), "
                     f"nell {nell!r} (ref {ref_nell})")
    print("phase 4 accuracy: " + "; ".join(parts))


def scaled_dev(a, b):
    """max |a - b| over (1 + max |b|)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (1.0 + b.abs().max()))


def value_and_grad(fn, theta, device):
    """The objective's value and gradient at ``theta`` on ``device``, as
    float64 host tensors, and the wall time of the call."""
    th = theta.to(device).requires_grad_(True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = fn(th)
    grad, = torch.autograd.grad(value, th)
    value, grad = value.detach().cpu(), grad.cpu()
    return float(value), grad, time.perf_counter() - t0


def phase_mle(device):
    from chirpgp_tpu_torch.utils.timing import timed
    from unittest import mock
    import chirpgp_tpu_torch.apps.pipeline as pipeline
    from chirpgp_tpu_torch.apps import IFEstimationConfig, estimate_if
    from chirpgp_tpu_torch.convert import params_from_jax
    from chirpgp_tpu_torch.models import g, g_inv
    from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
    from chirpgp_tpu_torch.utils import rmse
    data = np.load(ROOT / "results/data/toydata_const.npz")
    y_host = torch.as_tensor(data["ys"][0], dtype=torch.float64)
    ys = y_host.to(device)
    tf = torch.as_tensor(data["true_freqs"], dtype=torch.float64, device=device)
    ref = {name: np.load(ROOT / f"results/reference/{name}_const.npz")
           for name in MLE_GATES}
    theta_star = g_inv(params_from_jax(ref["ghfs"]["params"][0]))
    theta0 = g_inv(torch.tensor(SMALL_PARAMS, dtype=torch.float64))
    cfg = IFEstimationConfig()
    cpu = torch.device("cpu")
    parts = []
    t_phase = time.perf_counter()

    ghfs_chirp_filter.launches = 0
    # a. float64 cov GHFS objective: card against host CPU, at theta* on
    # the whole record and at theta0 on its first MLE_FIT_T samples.  The
    # gradient nearly vanishes at the optimum, so there its deviation is
    # held to the gradient's scale at theta0.
    card_nll = pipeline.make_nll_fn(cfg, ys)
    host_nll = pipeline.make_nll_fn(cfg, y_host)
    v_star, g_star, t_star = value_and_grad(card_nll, theta_star, device)
    v0, g0, t0 = value_and_grad(pipeline.make_nll_fn(cfg, ys[:MLE_FIT_T]),
                                theta0, device)
    v_host, g_host, t_host = value_and_grad(host_nll, theta_star, cpu)
    v0_host, g0_host, _ = value_and_grad(
        pipeline.make_nll_fn(cfg, y_host[:MLE_FIT_T]), theta0, cpu)
    check(abs(v_star - MLE_NLL) <= MLE_NLL_RTOL * MLE_NLL,
          f"nll at theta* {v_star!r} not within {MLE_NLL_RTOL} of {MLE_NLL}")
    scale = float(g0_host.abs().max())
    devs = {}
    for at, (vc, gc, vh, gh) in (("theta*", (v_star, g_star, v_host, g_host)),
                                 ("theta0", (v0, g0, v0_host, g0_host))):
        check(np.isfinite(vc) and abs(vc - vh) <= 1e-9 * abs(vh),
              f"nll at {at}: card {vc!r} vs host {vh!r}")
        devs[at] = float((gc - gh).abs().max()) / scale
        check(devs[at] <= 1e-7, f"grad at {at}: card vs host {devs[at]} of "
                                f"max|grad(theta0)|")
    parts.append(
        f"5a cov GHFS f64 T={ys.shape[0]}: nll(theta*) card {v_star!r}, "
        f"host {v_host!r}; nll(theta0) at T={MLE_FIT_T} (cut from {T_FULL} "
        f"for phase 13) card {v0!r}, host {v0_host!r}; max|d "
        f"grad| card vs host over max|grad(theta0)| {devs['theta*']:.3g} at "
        f"theta*, {devs['theta0']:.3g} at theta0; |grad(theta*)| "
        f"{float(g_star.norm())!r}, |grad(theta0)| {float(g0.norm())!r}; "
        f"value-and-grad card {t_star:.3f} s, {t0:.3f} s (T={MLE_FIT_T}), "
        f"host CPU {t_host:.3f} s")

    # c. fit_mle from theta0 on the record's first MLE_FIT_T samples,
    # counting the objective's calls and keeping their values.
    calls = []
    make_nll = pipeline.make_nll_fn

    def counted_make_nll_fn(_cfg, _ys):
        fn = make_nll(_cfg, _ys)

        def nll(theta):
            out = fn(theta)
            calls.append(float(out.detach()))
            return out
        return nll

    with mock.patch.object(pipeline, "make_nll_fn", counted_make_nll_fn):
        opt, t_fit = timed(pipeline.fit_mle,
                           dataclasses.replace(cfg, max_iters=MLE_ITERS),
                           ys[:MLE_FIT_T], theta0)
    f_fit = float(opt.fun_val)
    check(np.isfinite(f_fit) and f_fit < calls[0],
          f"fit_mle: final nll {f_fit!r} not finite and below {calls[0]!r}")
    parts.append(
        f"5c fit_mle scipy {int(opt.num_iters)} iters (cut from 2 to make "
        f"room for phase 8) at T={MLE_FIT_T} (cut from {T_FULL} for phase "
        f"12), {len(calls)} "
        f"objective calls, nll {calls[0]!r} -> {f_fit!r}, success "
        f"{bool(opt.success)}; {t_fit:.3f} s = {t_fit / len(calls):.3f} s "
        f"per value-and-grad on the card (host CPU {t_host:.3f} s, once)")

    # d. estimate_if gates, float64.
    for name, want in MLE_GATES.items():
        params = params_from_jax(ref[name]["params"][0], device=device)
        est, t_est = timed(estimate_if, IFEstimationConfig(method=name),
                           params, ys)
        check(bool(torch.isfinite(est["if_mean"]).all()),
              f"{name}: non-finite if_mean")
        r10 = 10.0 * float(rmse(tf, est["if_mean"]))
        check(abs(r10 - want) <= GATE_RMSE_ATOL,
              f"{name}: IF-RMSE x10 {r10!r} not within {GATE_RMSE_ATOL} of {want}")
        parts.append(f"5d estimate_if {name} f64 IF-RMSE x10 {r10!r} (ref "
                     f"{want}), nell {float(est['nell'][-1])!r}, "
                     f"{t_est:.3f} s")
    path_launches = ghfs_chirp_filter.launches

    # b. float32 sqrt objective at theta* against the kernel's nll[-1].
    th32 = theta_star.to(device, torch.float32)
    with torch.no_grad():
        v32, t32 = timed(pipeline.make_nll_fn(IFEstimationConfig(form="sqrt"),
                                              ys.float()), th32)
        _, _, nll_k = ghfs_chirp_filter(g(th32), XI, DT, cfg.sigma_points(),
                                        ys.float()[None])
    check(v32.dtype == torch.float32, f"sqrt objective dtype {v32.dtype}")
    rel = abs(float(v32) - float(nll_k[-1, 0])) / abs(float(nll_k[-1, 0]))
    check(rel <= FULL_BOUNDS["float32"][2],
          f"sqrt f32 objective {float(v32)!r} vs kernel nll "
          f"{float(nll_k[-1, 0])!r}: rel {rel}")
    parts.insert(1, f"5b sqrt GHFS f32 nll(theta*) {float(v32)!r} ({t32:.3f} "
                    f"s) vs CUDA kernel {float(nll_k[-1, 0])!r}: rel {rel:.3g}")
    print(f"phase 5 MLE path ({time.perf_counter() - t_phase:.3f} s; kernel "
          f"launches in 5a/5c/5d: {path_launches}): " + "; ".join(parts))


def fused_headline(ys):
    """bench.py's slim headline on ``ys`` (B, T), the call of 6d: the fused
    filter+smoother at the default parameters, GH-3, ``out_index=2`` (F
    and G), then the GH-10 expectation of g(V) (E).  Returns ``(if_mean
    (T, B), nll (T, B))``."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_fused import ghfs_chirp_filter_smoother
    from chirpgp_tpu_torch.ops.chirp_smoother import gaussian_expectation_g
    cfg = IFEstimationConfig()
    v_mean, v_var, nll = ghfs_chirp_filter_smoother(
        g(cfg.default_init_theta()), XI, DT, cfg.sigma_points(), ys,
        return_factors=False, out_index=2)
    return gaussian_expectation_g(v_mean, v_var, cfg.expectation_order), nll


def fused_headline_profiles(device, Ts):
    """``torch.profiler`` over 6d's call on the first T steps of its
    measurements, for each T of ``Ts``, each after one unprofiled warm-up
    call: {T: DeviceProfile}.  6d runs it in a process of its own: in the
    smoke run's own process, after phases 1-5, the profiled call of
    T=3141 recorded no CUDA activity at all on an H100 while the call of
    T=64 recorded its kernels, and a fresh process records both."""
    from chirpgp_tpu_torch.utils.timing import profile_device
    device = torch.device(device)
    yss = measurements(B_FULL, T_FULL, 999, torch.float32, device)
    out = {}
    for T in Ts:
        fused_headline(yss[:, :T])
        out[T] = profile_device(lambda: fused_headline(yss[:, :T]))
    return out


def phase_fused(device, if_ref, t_ref):
    """6a-c: the plain fused filter+smoother in float64 against the separate
    filter and smoother and the covariance form, slim against full, and the
    kernels' route (``ghfs_chirp_filter_smoother`` on the card) against its
    plain twins in its three modes; 6d: bench.py's headline through F, G
    and E, each kernel against its plain twin, the IF mean against phase
    3's, the kernels per call under ``torch.profiler``.  Returns {kernel:
    (launches, max |d| from its twin, twin ms)}."""
    import concurrent.futures
    import multiprocessing
    from chirpgp_tpu_torch.utils.timing import timed
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.infer.batched import (
        cov_sgp_filter_smoother_batched, sqrt_sgp_filter_batched,
        sqrt_sgp_filter_smoother_batched, sqrt_sgp_smoother_batched)
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
    from chirpgp_tpu_torch.ops.chirp_fused import (
        KERNELS, ROW_WORDS, FusedKernels, affine_backward_reference,
        fused_forward_reference, ghfs_chirp_filter_smoother,
        ghfs_chirp_filter_smoother_reference)
    from chirpgp_tpu_torch.ops.chirp_smoother import (
        gaussian_expectation_g, smoother_expect_var_reference)
    cfg = IFEstimationConfig()
    rule, order = cfg.sigma_points(), cfg.expectation_order
    parts = []
    t_phase = time.perf_counter()

    def args(dtype, yss):
        pack = cfg.build(g(cfg.default_init_theta()).to(device, dtype))
        return (pack.m_and_cov, rule, pack.H, XI, pack.m0, pack.P0, DT, yss)

    ghfs_chirp_filter.launches = 0
    yss = measurements(FUSED_SMALL_B, FUSED_SMALL_T, 7, torch.float64, device)
    a = args(torch.float64, yss)
    mfs, Lfs, nll = sqrt_sgp_filter_batched(*a)
    mss, Lss = sqrt_sgp_smoother_batched(a[0], rule, mfs, Lfs, DT)
    Pss = torch.einsum("tikb,tjkb->tijb", Lss, Lss)
    ms_f, Ls_f, nll_f = sqrt_sgp_filter_smoother_batched(*a)
    Ps_f = torch.einsum("tikb,tjkb->tijb", Ls_f, Ls_f)
    ms_c, Ps_c, nll_c = sqrt_sgp_filter_smoother_batched(
        *a, return_factors=False)
    vm, vv, nll_s = sqrt_sgp_filter_smoother_batched(
        *a, return_factors=False, out_index=2)
    ms_k, Ps_k, nll_k = cov_sgp_filter_smoother_batched(*a)
    devs = {"fused vs separate": (scaled_dev(ms_f, mss), scaled_dev(Ps_f, Pss),
                                  scaled_dev(nll_f, nll)),
            "cov form vs sqrt fused": (scaled_dev(ms_k, ms_c),
                                       scaled_dev(Ps_k, Ps_c),
                                       scaled_dev(nll_k, nll_c))}
    # The kernels' route in its three modes against its plain twins (the
    # factors by their Gram: a row may change sign at a near-zero pivot).
    params = g(cfg.default_init_theta())
    for mode, kwargs in FUSED_MODES.items():
        kern = ghfs_chirp_filter_smoother(params, XI, DT, rule, yss, **kwargs)
        twin = ghfs_chirp_filter_smoother_reference(params, XI, DT, rule, yss,
                                                    **kwargs)
        if mode == "factors":
            kern, twin = ([x[0], torch.einsum("tikb,tjkb->tijb", x[1], x[1]),
                           x[2]] for x in (kern, twin))
        devs[f"kernels vs twins, {mode}"] = tuple(
            scaled_dev(k, t) for k, t in zip(kern, twin))
    for what, vals in devs.items():
        for key, val in zip(("mss", "Pss", "nll"), vals):
            check(val <= FUSED_F64_BOUND, f"6: {what} {key} {val} > "
                                          f"{FUSED_F64_BOUND}")
        parts.append(f"{what} (scaled mss, Pss, nll) "
                     f"{', '.join(f'{v:.3g}' for v in vals)}")
    slim_equal = (torch.equal(vm, ms_c[:, 2]) and torch.equal(vv, Ps_c[:, 2, 2])
                  and torch.equal(nll_s, nll_c))
    check(slim_equal, "6b: slim output is not bit-equal to the full slices")
    parts.insert(0, f"6a-c B={FUSED_SMALL_B} T={FUSED_SMALL_T} f64; slim == "
                    f"full slices: {slim_equal}")
    del mfs, Lfs, mss, Lss, Pss, ms_f, Ls_f, Ps_f, ms_c, Ps_c, ms_k, Ps_k

    # 6d holds 25 GiB of the card at its peak: in a memory turn.
    with memory_turn(device):
        # 6d: bench.py's headline, B=4096, T=3141, GH-3, f32, out_index=2, then
        # the GH-10 expectation of g(V): F, G and E once each.
        yss = measurements(B_FULL, T_FULL, 999, torch.float32, device)
        ghfs_chirp_filter_smoother.launches = gaussian_expectation_g.launches = 0
        ghfs_chirp_filter_smoother.kernel_launches = dict.fromkeys(KERNELS, 0)
        (if_mean, nll), t_call = timed(fused_headline, yss)
        launches = {**ghfs_chirp_filter_smoother.kernel_launches,
                    "smoother_expect_var": gaussian_expectation_g.launches}
        want = dict(fused_forward=1, affine_backward=1, smoother_compose=0,
                    smoother_carry=0, smoother_backward=0, smoother_expect_var=1)
        check(ghfs_chirp_filter_smoother.launches == 1 and launches == want,
              f"6d: the call launched {launches}, not {want}")
        for name, x in (("if_mean", if_mean), ("nll", nll)):
            check(bool(torch.isfinite(x).all()), f"6d: non-finite {name}")
        dev_if = scaled_dev(if_mean.T, if_ref)
        check(dev_if <= FUSED_IF_BOUND,
              f"6d: fused IF mean vs estimate_if_batched {dev_if} > "
              f"{FUSED_IF_BOUND}")
        # Each kernel alone against its plain twin on the same inputs.
        bound = FUSED_KERNEL_BOUNDS["float32"]
        like = dict(dtype=yss.dtype, device=device)
        kernels = FusedKernels(params, XI, DT, rule, yss.dtype, device)
        rows = torch.empty((T_FULL - 1, ROW_WORDS, B_FULL), **like)
        mf = torch.empty((1, 4, B_FULL), **like)
        lf = torch.empty((1, 16, B_FULL), **like)
        nll_k = torch.empty((T_FULL, B_FULL), **like)
        kernels.forward(yss.T.contiguous(), rows, mf, lf, nll_k, False)
        twin, t_f = timed(fused_forward_reference, params, XI, DT, rule, yss)
        # The on-card oracle: F in float64 on the same measurements, in factor
        # mode, its maps derived (G = X^T, u = mf_{t-1} - G m_p, D = R22^T R22).
        oracle = fused_oracle_maps(params, rule, yss.double())
        # u = mf_{t-1} - G m_p cancels: its float32 rounding is on the scale of
        # the filtered means, which the f32 twin shows against the oracle too.
        u_scale = oracle["mf_scale"]
        pairs = {"fused_forward": [(rows[:, 4:20], twin.rows[:, 4:20]),
                                   (rows[:, 20:], twin.rows[:, 20:]),
                                   (mf, twin.mfs), (nll_k, twin.nll),
                                   (*(torch.einsum("tikb,tjkb->tijb", x, x) for x
                                      in (lf.view(1, 4, 4, B_FULL), twin.Lfs)),)]}
        u_dev = {name: float((x[:, :4].double() - oracle["rows"][:, :4]).abs()
                             .max()) for name, x in (("kernel", rows),
                                                     ("twin", twin.rows))}
        u_dev["kernel vs twin"] = float((rows[:, :4].double()
                                         - twin.rows[:, :4]).abs().max())
        oracle_dev = {name: max(scaled_dev(x[:, 4:], oracle["rows"][:, 4:]),
                                scaled_dev(n, oracle["nll"]))
                      for name, x, n in (("kernel", rows, nll_k),
                                         ("twin", twin.rows, twin.nll))}
        del twin, oracle
        check(u_dev["kernel vs twin"] / u_scale <= bound,
              f"6d fused_forward u vs its plain twin: |d| "
              f"{u_dev['kernel vs twin']} over the means' scale {u_scale} > "
              f"{bound}")
        vm = torch.empty((T_FULL, B_FULL), **like)
        vv = torch.empty((T_FULL, B_FULL), **like)
        kernels.backward(rows, mf, lf, vm, vv, 2)
        twin, t_g = timed(affine_backward_reference, rows, mf[0],
                          lf[0].view(4, 4, B_FULL), 2)
        pairs["affine_backward"] = list(zip((vm, vv), twin))
        ie = gaussian_expectation_g(vm, vv, order)
        twin, t_e = timed(smoother_expect_var_reference, vm.double(), vv.double(),
                          order)
        within = expect_within(ie, twin)
        check(within <= 1.0, f"6d smoother_expect_var vs its float64 pair-form "
                             f"twin: |d| at {within} of its allowance")
        pairs["smoother_expect_var"] = [(ie, twin)]
        out, kparts = {}, []
        for kernel, t in zip(pairs, (t_f, t_g, t_e)):
            err = max(float((a.double() - b.double()).abs().max())
                      for a, b in pairs[kernel])
            scaled = max(scaled_dev(a, b) for a, b in pairs[kernel])
            check(scaled <= bound, f"6d {kernel} vs its plain twin: scaled |d| "
                                   f"{scaled} > {bound}")
            if kernel == "fused_forward":
                err = max(err, u_dev["kernel vs twin"])
            out[kernel] = (launches[kernel], err, 1e3 * t)
            kparts.append(f"{kernel} max|d| {err!r} (scaled {scaled:.3g}), twin "
                          f"{t:.3f} s")
        kparts.insert(1, f"F's u: max|d| kernel vs twin "
                         f"{u_dev['kernel vs twin']!r}, each from the float64 "
                         f"oracle: kernel {u_dev['kernel']!r}, twin "
                         f"{u_dev['twin']!r} (the means' scale {u_scale!r}); F's "
                         f"G, D and nll scaled from the oracle: kernel "
                         f"{oracle_dev['kernel']:.3g}, twin "
                         f"{oracle_dev['twin']:.3g}")
        del pairs, twin, rows, kernels
        # The CUDA kernels of one call (the host-to-device copies of the rule's
        # tables apart: the profiler records a varying number of them), at the
        # full T and at SLICE_SHORT_T, in a child process on the same card.
        with concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
            profs = pool.submit(fused_headline_profiles, str(device),
                                (T_FULL, SLICE_SHORT_T)).result()
    counts = {T: sum(not n.startswith(("Memcpy", "Memset"))
                     for n in prof.names) for T, prof in profs.items()}
    hand = {k: sum(f"{k}_kernel" in n for n in profs[T_FULL].names)
            for k in ("fused_forward", "affine_backward",
                      "smoother_expect_var")}
    check(len(set(counts.values())) == 1 and set(hand.values()) == {1},
          f"6d: {counts} CUDA kernels per call at T = {list(counts)}, the "
          f"hand kernels {hand} times each (not once)")
    prof = profs[T_FULL]
    parts.append(
        f"6d bench.py's slim GH-3 headline + GH-10 E[g(V)], B={B_FULL} "
        f"T={T_FULL} f32: {1e3 * t_call:.3f} ms = "
        f"{B_FULL * T_FULL / t_call:.1f} steps/s (estimate_if_batched, phase "
        f"3: {1e3 * t_ref:.3f} ms); launches {launches}; {counts[T_FULL]} "
        f"CUDA kernels per call at T={T_FULL} and {counts[SLICE_SHORT_T]} at "
        f"T={SLICE_SHORT_T} (torch.profiler in a child process; with the "
        f"copies {prof.launches} and {profs[SLICE_SHORT_T].launches} "
        f"events), the hand kernels {hand}, device "
        f"busy {100 * prof.busy:.2f}% of {1e3 * prof.wall_s:.3f} ms; IF mean "
        f"vs phase 3's: scaled {dev_if:.3g} (bound {FUSED_IF_BOUND}); each "
        f"kernel vs its plain twin: " + ", ".join(kparts))
    print(f"phase 6 fused filter+smoother ({time.perf_counter() - t_phase:.3f}"
          f" s; filter kernel launches: {ghfs_chirp_filter.launches}): "
          + "; ".join(parts))
    return out


def fused_oracle_maps(params, rule, y64):
    """F in float64 on the card in factor mode on ``y64``, with the maps of
    its rows (``u = mf_{t-1} - X^T m_p``, ``G = X^T``, D's upper triangle):
    {"rows": (T-1, 30, B) maps, "nll": (T, B), "mf_scale": 1 + max |mf|}."""
    from chirpgp_tpu_torch.ops.chirp_fused import ROW_WORDS, FusedKernels
    B, T = y64.shape
    like = dict(dtype=y64.dtype, device=y64.device)
    rows = torch.empty((T - 1, ROW_WORDS, B), **like)
    mfs, lfs = (torch.empty((T, n, B), **like) for n in (4, 16))
    nll = torch.empty((T, B), **like)
    FusedKernels(params, XI, DT, rule, y64.dtype, y64.device).forward(
        y64.T.contiguous(), rows, mfs, lfs, nll, True)
    del lfs
    X = rows[:, 4:20].reshape(T - 1, 4, 4, B)
    G = X.transpose(1, 2)
    u = mfs[:-1] - torch.einsum("tijb,tjb->tib", G, rows[:, :4])
    iu = torch.triu_indices(4, 4)
    up = rows.new_zeros((T - 1, 4, 4, B))
    up[:, iu[0], iu[1]] = rows[:, 20:]
    D = torch.einsum("tkib,tkjb->tijb", up, up)[:, iu[0], iu[1]]
    return {"rows": torch.cat([u, G.reshape(T - 1, 16, B), D], dim=1),
            "nll": nll, "mf_scale": 1.0 + float(mfs.abs().max())}


def fused_entry(timing, kernel):
    """The ``kernels`` line's times of a fused kernel from 6e's ``timing``:
    ``ms``, ``bound_ms`` and ``bound_by`` at B=4096 f32 in the mode of
    6d's call (F maps, G slim), ``ms_b100``, ``ms_f64`` and its bound, and
    F's factor mode and G's full output beside, and E's float32 MUFU
    floor (``mufu_ms``)."""
    key = {"affine_backward": "affine_backward_slim"}.get(kernel, kernel)
    f32, f64, b100 = (timing[t] for t in ("B=4096/f32", "B=4096/f64",
                                          "B=100/f32"))
    entry = dict(ms=f32[key]["ms"], bound_ms=f32[key]["bound_ms"],
                 bound_by=f32[key]["bound_by"], ms_b100=b100[key]["ms"],
                 ms_f64=f64[key]["ms"], bound_ms_f64=f64[key]["bound_ms"])
    other = {"fused_forward": ("fused_forward_factors", "factors"),
             "affine_backward": ("affine_backward", "full")}.get(kernel)
    if other:
        entry.update({f"ms_{other[1]}": f32[other[0]]["ms"],
                      f"bound_ms_{other[1]}": f32[other[0]]["bound_ms"],
                      f"ms_{other[1]}_f64": f64[other[0]]["ms"]})
    if kernel == "affine_backward":
        entry.update(ms_full_b100=b100["affine_backward"]["ms"],
                     geometry=f32["geometry"], geometry_b100=b100["geometry"])
    if "mufu_ms" in f32[key]:
        entry.update(mufu_ms=f32[key]["mufu_ms"])
    return entry


def phase_fused_timing(device, smi):
    """6e: CUDA-event times of each fused kernel alone, after one warm-up:
    F in maps and factor mode, G full and slim, E in its variance mode,
    and the smoother's phase B on F's factor rows, GH-3 at B=4096 x
    T=3141 (float32 and float64) and at the Table-I width (the 100 records
    of toydata_const at the reference's GHFS optimum, float32), beside each
    kernel's bound (``fused_cost``, ``expectation_g_cost``,
    ``smoother_phase_costs``), and F beside the filter kernel's bare
    launch on the same measurements in the same run."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.convert import params_from_jax
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter import kernel_launcher
    from chirpgp_tpu_torch.ops.chirp_fused import (
        BACK_STAGES, ROW_WORDS, FusedKernels, affine_geometry, fused_cost)
    from chirpgp_tpu_torch.ops.chirp_smoother import (
        expect_mufu, expectation_g_cost, expectation_launcher,
        smoother_phase_costs)
    cfg = IFEstimationConfig()
    rule, order = cfg.sigma_points(), cfg.expectation_order
    S = rule.n_points
    t_phase = time.perf_counter()
    y100 = torch.as_tensor(
        np.load(ROOT / "results/data/toydata_const.npz")["ys"],
        dtype=torch.float32, device=device)
    opt = params_from_jax(np.load(
        ROOT / "results/reference/ghfs_const.npz")["params"][0])
    bench = measurements(B_FULL, T_FULL, 999, torch.float64, device)
    cases = {"B=4096/f32": (g(cfg.default_init_theta()), bench.float()),
             "B=4096/f64": (g(cfg.default_init_theta()), bench),
             "B=100/f32": (opt, y100)}
    out, parts, geos = {}, [], {}
    for tag, (params, yss) in cases.items():
        B, T = yss.shape
        like = dict(dtype=yss.dtype, device=device)
        kernels = FusedKernels(params, XI, DT, rule, yss.dtype, device)
        ys_t = yss.T.contiguous()
        rows = torch.empty((T - 1, ROW_WORDS, B), **like)
        nll = torch.empty((T, B), **like)
        mf, lf = (torch.empty((1, n, B), **like) for n in (4, 16))
        ms = {"fused_forward": event_ms(
            lambda: kernels.forward(ys_t, rows, mf, lf, nll, False))}
        vm, vv = (torch.empty((T, B), **like) for _ in range(2))
        ms["affine_backward_slim"] = event_ms(
            lambda: kernels.backward(rows, mf, lf, vm, vv, 2))
        om, op = torch.empty((T, 4, B), **like), torch.empty((T, 16, B),
                                                             **like)
        ms["affine_backward"] = event_ms(
            lambda: kernels.backward(rows, mf, lf, om, op))
        check(torch.equal(om[:, 2], vm) and torch.equal(op[:, 10], vv),
              f"6e {tag}: G's slim output differs from its full one")
        geo = affine_geometry(B, kernels.num_sms)
        geos[tag] = (f"G team {geo.team}, {geo.lanes_per_block} lanes x "
                     f"{geo.blocks} blocks, ring of {BACK_STAGES} steps")
        del om, op
        launch, if_mean = expectation_launcher(vm, vv, order)
        ms["smoother_expect_var"] = event_ms(launch)
        check(all(bool(torch.isfinite(x).all()) for x in (nll, if_mean)),
              f"6e {tag}: non-finite outputs")
        del launch, if_mean
        mfs, lfs = (torch.empty((T, n, B), **like) for n in (4, 16))
        ms["fused_forward_factors"] = event_ms(
            lambda: kernels.forward(ys_t, rows, mfs, lfs, nll, True))
        mss, lss = torch.empty_like(mfs), torch.empty_like(lfs)
        chain = kernels.back.scratch(B, kernels.back.chunks(T, B))
        ms["phase_b"] = event_ms(
            lambda: kernels.rows_backward(mfs, lfs, rows, mss, lss, chain))
        check(bool(torch.isfinite(mss).all()), f"6e {tag}: non-finite mss")
        geos[tag] += f"; phase B in C={kernels.back.chunks(T, B)} chunks"
        del chain
        del mfs, lfs, mss, lss, rows, kernels
        launch, _ = kernel_launcher(params.to(torch.float64).cpu(), XI, DT,
                                    rule, yss)
        filter_ms = event_ms(launch)
        del launch
        costs = {**fused_cost(S, T, B, yss.dtype),
                 "smoother_expect_var": expectation_g_cost(T, B, yss.dtype,
                                                           order),
                 "phase_b": smoother_phase_costs(
                     S, T, B, yss.dtype)["smoother_backward"]}
        out[tag] = {"geometry": geos[tag]}
        for k, t in ms.items():
            _, _, bound, by = bound_ms(S, T, B, yss.dtype,
                                       lambda *a, _c=costs[k]: _c)
            out[tag][k] = dict(ms=t, bound_ms=bound, bound_by=by)
        if yss.dtype == torch.float32:
            e = out[tag]["smoother_expect_var"]
            e["mufu_ms"], e["mufu"] = mufu_floor(T * B, expect_mufu(order),
                                                 device)
        parts.append(f"{tag} T={T} ({geos[tag]}): " + ", ".join(
            f"{k} {v['ms']!r} ms (bound {v['bound_ms']!r} ms, {v['bound_by']},"
            f" share {v['bound_ms'] / v['ms']:.4f}"
            + (f"; {v['mufu']}" if "mufu" in v else "") + ")"
            for k, v in out[tag].items() if k != "geometry")
            + f"; the filter kernel "
            f"{filter_ms!r} ms: F maps / filter "
            f"{ms['fused_forward'] / filter_ms:.3f}")
        torch.cuda.empty_cache()
    print(f"phase 6e fused kernels alone ({time.perf_counter() - t_phase:.3f}"
          f" s; CUDA events, 1 warm-up + {TIMING_REPS} launches; {smi}; peaks "
          f"67/34 TFLOP/s f32/f64, 3.35 TB/s): " + "; ".join(parts))
    return out


def sweep_data(device, seeds, T, prefix=""):
    """Seeds ``seeds`` of each magnitude of results/data (of
    ``toydata_h3_*`` with ``prefix="h3_"``), (3 len(seeds), T) float32 on
    ``device``, and the true IF (T,)."""
    files = {m: np.load(ROOT / f"results/data/toydata_{prefix}{m}.npz")
             for m in MAGNITUDES}
    ys = np.concatenate([files[m]["ys"][seeds, :T] for m in MAGNITUDES])
    tf = files["const"]["true_freqs"][:T]
    return (torch.as_tensor(ys, dtype=torch.float32, device=device),
            torch.as_tensor(tf, dtype=torch.float32, device=device))


def sweep_lane_constants(theta):
    """Phase 7's per-lane model constants (B, 43) at the thetas ``theta``
    (B, 6) of the sweep's configuration, through ``chirp_lane_constants``
    (differentiable)."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter_grad import chirp_lane_constants
    cfg = IFEstimationConfig(method="ghfs", form="sqrt")
    return torch.func.vmap(lambda p: chirp_lane_constants(
        p, cfg.Xi, cfg.dt))(g(theta))


def sweep_thetas(B, device):
    """7a's thetas (B, 6), float64: the sweep's default init plus
    SWEEP_THETA_SPREAD standard normals (NumPy seed 0), one per lane."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    theta = IFEstimationConfig(method="ghfs", form="sqrt").default_init_theta(
        torch.float64) + SWEEP_THETA_SPREAD * torch.as_tensor(
            np.random.default_rng(0).standard_normal((B, 6)))
    return theta.to(device)


def sweep_bare_launches(device, smi):
    """7a's CUDA-event times of the per-lane forward kernel and the adjoint
    kernel, each launched alone, timed before the lanes start while this
    process has the card to itself: at the Table-I column (B=300, T=3141)
    in float32 and float64 and at bench.py's B=4096 in float32, GH-3, at
    the default init theta, beside each its bound and the adjoint's
    geometry, and at B=300 float32 the adjoint's chain floor as recorded
    (``SWEEP_CHAIN_FLOOR_MS``).  Returns {kernel: {case: dict(ms,
    bound_ms, bound_by[, geometry])}}."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.ops.chirp_filter_grad import (
        adjoint_cost, adjoint_geometry, adjoint_launcher, forward_cost,
        forward_launcher)
    cfg = IFEstimationConfig(method="ghfs", form="sqrt")
    rule = cfg.sigma_points()
    S = rule.n_points
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    t_phase = time.perf_counter()
    out = {name: {} for name in SWEEP_SOURCES}
    parts = []
    for case, dtype in (("B=300/f32", torch.float32),
                        ("B=300/f64", torch.float64),
                        ("B=4096/f32", torch.float32)):
        if case.startswith("B=300"):
            ys = sweep_data(device, slice(0, SWEEP_SEEDS), SWEEP_T)[0].to(dtype)
        else:
            ys = measurements(B_FULL, T_FULL, 999, dtype, device)
        B, T = ys.shape
        consts = sweep_lane_constants(
            cfg.default_init_theta(dtype).to(device).expand(B, -1))
        launch, (mfs, lfs, nll) = forward_launcher(consts, rule, ys)
        fwd = event_ms(launch)
        gbar = torch.ones(B, dtype=dtype, device=device)
        adj_launch, dconsts = adjoint_launcher(consts, rule, ys, mfs, lfs,
                                               gbar)
        adj = event_ms(adj_launch)
        check(bool(torch.isfinite(nll).all() and torch.isfinite(dconsts).all()),
              f"7a bare launches {case}: non-finite nll or adjoint")
        for name, ms, cost in (
                ("ghfs_chirp_filter_lanes", fwd, forward_cost),
                ("ghfs_chirp_filter_adjoint", adj, adjoint_cost)):
            flop, nbytes, b_ms, by = bound_ms(S, T, B, dtype, cost)
            out[name][case] = dict(ms=ms, bound_ms=b_ms, bound_by=by)
            geo = ""
            if name == "ghfs_chirp_filter_adjoint":
                g = adjoint_geometry(B, S, sms, dtype)
                out[name][case]["geometry"] = g._asdict()
                geo = (f", {g.design} design: team {g.team}, rows {g.rows}"
                       f", producers {g.producers}, ring {g.ring}, "
                       f"{g.lanes_per_block} lanes x {g.blocks} blocks")
            parts.append(f"{name} {case}: {ms!r} ms, bound {b_ms:.4f} ms "
                         f"({by}; {flop / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} "
                         f"MB), {100 * b_ms / ms:.2f}% of it{geo}")
        if case == "B=300/f32":
            parts.append(
                f"the adjoint's chain floor {case} as recorded "
                f"(SWEEP_CHAIN_FLOOR_MS, time_sweep_objective.py "
                f"--breakdown): {SWEEP_CHAIN_FLOOR_MS} ms, "
                f"{100 * SWEEP_CHAIN_FLOOR_MS / adj:.1f}% of this launch")
        del mfs, lfs, dconsts
    torch.cuda.empty_cache()
    print(f"phase 7a bare launches ({time.perf_counter() - t_phase:.3f} s; "
          f"CUDA events, 1 warm-up + {TIMING_REPS} launches; {smi}; T="
          f"{SWEEP_T}, GH-3, default init): " + "; ".join(parts),
          flush=True)
    return out


def sweep_deviation(grads, oracle):
    """The largest over lanes of max |grad - oracle| over the lane's max
    |oracle|."""
    g, o = grads.double().cpu(), oracle.double().cpu()
    return float(((g - o).abs().amax(1) / o.abs().amax(1)).max())


def value_deviation(values, oracle):
    """The largest over lanes of |value - oracle| / |oracle|."""
    v, o = values.double().cpu(), oracle.double().cpu()
    return float(((v - o) / o).abs().max())


def sweep_kernels_vs_plain(device, ys, theta, parts, gate_f64_value=True):
    """7a's kernels, launched directly (not counted on the path), against
    their plain versions on the same inputs: ``ys`` (B, T), one theta per
    lane (``theta`` (B, 6), float64), the constants built from it in each
    dtype as the path builds them, the upstream gradient 1, GH-3; float64
    and float32, each plain version timed on the host clock.  Without
    ``gate_f64_value`` the float64 value's deviation is printed, not
    held.  Returns {dtype: readings}, the float32 ones with the value's
    and the theta gradient's deviation from the float64 kernels, of the
    kernels and of the plain versions."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.ops.chirp_filter_grad import (
        adjoint_geometry, adjoint_launcher, filter_nll_adjoint_reference,
        filter_nll_reference, forward_launcher)
    from chirpgp_tpu_torch.utils.timing import timed
    rule = IFEstimationConfig(method="ghfs", form="sqrt").sigma_points()
    B = ys.shape[0]
    geo = adjoint_geometry(
        B, rule.n_points,
        torch.cuda.get_device_properties(device).multi_processor_count)
    th = theta.clone().requires_grad_(True)
    consts64 = sweep_lane_constants(th)

    def to_theta(dconsts):
        grad, = torch.autograd.grad(consts64, th, dconsts.double(),
                                    retain_graph=True)
        return grad

    out = {}
    for dtype in (torch.float64, torch.float32):
        y = ys.to(dtype)
        with torch.no_grad():
            consts = sweep_lane_constants(theta.to(dtype))
        gbar = torch.ones(B, dtype=dtype, device=device)
        launch, (mfs, lfs, nll_k) = forward_launcher(consts, rule, y)
        launch()
        adj_launch, d_k = adjoint_launcher(consts, rule, y, mfs, lfs, gbar)
        adj_launch()
        (pm, pl, nll_p), fwd_s = timed(filter_nll_reference, consts, rule, y)
        d_p, adj_s = timed(filter_nll_adjoint_reference, consts, rule, y, pm,
                           pl, gbar)
        check(bool(torch.isfinite(nll_k).all() and torch.isfinite(d_k).all()),
              f"7a: non-finite kernel nll or adjoint ({dtype})")
        out[dtype] = dict(
            nll_abs=float((nll_k - nll_p).abs().max()),
            adjoint_abs=float((d_k - d_p).abs().max()),
            nll_rel=value_deviation(nll_k, nll_p),
            adjoint_rel=sweep_deviation(d_k, d_p), plain_fwd_s=fwd_s,
            plain_adj_s=adj_s, nll=(nll_k, nll_p), grad=(to_theta(d_k),
                                                       to_theta(d_p)))
        del mfs, lfs, pm, pl
    # The plain versions' blocks back to the card before 7d: the lanes
    # share its memory.
    torch.cuda.empty_cache()
    r64, r32 = out[torch.float64], out[torch.float32]
    check((r64["nll_rel"] <= SWEEP_F64_NLL_RTOL or not gate_f64_value)
          and r64["adjoint_rel"] <= SWEEP_F64_GRAD_TOL,
          f"7a: float64 kernels vs plain at B={B}, T={ys.shape[1]}: nll rel "
          f"{r64['nll_rel']}, adjoint {r64['adjoint_rel']}")
    n64, g64 = r64["nll"][0], r64["grad"][0]
    r32.update(
        value_kernel=value_deviation(r32["nll"][0], n64),
        value_plain=value_deviation(r32["nll"][1], n64),
        grad_kernel=sweep_deviation(r32["grad"][0], g64),
        grad_plain=sweep_deviation(r32["grad"][1], g64))
    check(r32["value_kernel"] <= SWEEP_F32_FACTOR * r32["value_plain"]
          + SWEEP_F32_VALUE_FLOOR
          and r32["grad_kernel"] <= SWEEP_F32_FACTOR * r32["grad_plain"]
          + SWEEP_F32_GRAD_FLOOR,
          f"7a: float32 kernels vs the float64 kernels at B={B}, "
          f"T={ys.shape[1]}: "
          f"value rel {r32['value_kernel']}, grad {r32['grad_kernel']}; the "
          f"float32 plain versions {r32['value_plain']}, {r32['grad_plain']}")
    parts.append(
        f"kernels vs plain at B={B}, T={ys.shape[1]}, one theta per lane "
        f"(the adjoint's {geo.design} design, team {geo.team}): "
        f"f64 nll rel {r64['nll_rel']:.3g}"
        f"{'' if gate_f64_value else ' (printed, not held)'}, adjoint "
        f"{r64['adjoint_rel']:.3g} "
        f"of each lane's max; f32 nll rel {r32['nll_rel']:.3g}, adjoint "
        f"{r32['adjoint_rel']:.3g}; f32 against the f64 kernels: the kernels "
        f"value rel {r32['value_kernel']:.3g}, grad {r32['grad_kernel']:.3g} "
        f"of each lane's max |grad|, the plain versions "
        f"{r32['value_plain']:.3g}, {r32['grad_plain']:.3g}; the plain "
        f"versions (host clock): f32 forward {r32['plain_fwd_s']:.3f} s, "
        f"adjoint {r32['plain_adj_s']:.3f} s, f64 {r64['plain_fwd_s']:.3f}, "
        f"{r64['plain_adj_s']:.3f} s")
    return out


def phase_sweep_objective(device, ys, parts):
    """7a: one vmapped value-and-grad of the sweep objective at the
    Table-I width and full T through the two kernels, one theta per lane,
    against the float64 kernels, the plain versions and the eager route.
    Returns (launches per evaluation, (sweep_kernels_vs_plain's readings
    at B, at B_FULL))."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig, make_nll_fn
    from chirpgp_tpu_torch.apps.pipeline import _filter_fns, _on_data
    from chirpgp_tpu_torch.fit import batched_value_and_grad
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter_grad import ChirpFilterNLL
    from chirpgp_tpu_torch.utils.timing import profile_device, timed
    cfg = IFEstimationConfig(method="ghfs", form="sqrt")
    B = ys.shape[0]

    def nll(theta, ys_i):
        return make_nll_fn(cfg, ys_i)(theta)

    flt, _ = _filter_fns(cfg)

    def eager_nll(theta, ys_i):
        return flt(cfg.build(g(_on_data(theta, ys_i))), ys_i)[2][-1]

    theta64 = sweep_thetas(B, device)
    theta = theta64.float()
    # One value-and-grad of all lanes through the kernels, timed, with its
    # launches and peak memory; then the same in float64, the oracle.
    ChirpFilterNLL.reset_launches()
    torch.cuda.reset_peak_memory_stats(device)
    (values, grads), t_vg = timed(batched_value_and_grad(nll, (ys,)), theta)
    peak = torch.cuda.max_memory_allocated(device)
    per_eval = dict(ChirpFilterNLL.launches)
    check(per_eval == {"forward": 1, "adjoint": 1},
          f"7a: launches per evaluation {per_eval}, not one of each kernel")
    check(bool(torch.isfinite(values).all() and torch.isfinite(grads).all()),
          "7a: non-finite value or gradient")
    (v64, g64), t_vg64 = timed(batched_value_and_grad(nll, (ys.double(),)),
                               theta64)
    dv, dg = value_deviation(values, v64), sweep_deviation(grads, g64)
    # The eager float32 route (the Python loop under autograd, the route
    # before the kernels) against the float64 kernels at SWEEP_EAGER_T,
    # beside the float32 kernels at the same T.
    yT = ys[:, :SWEEP_EAGER_T].contiguous()
    (ve32, ge32), t_eager = timed(batched_value_and_grad(eager_nll, (yT,)),
                                  theta)
    vk32, gk32 = batched_value_and_grad(nll, (yT,))(theta)
    vk64, gk64 = batched_value_and_grad(nll, (yT.double(),))(theta64)
    dg_eager, dg_k785 = sweep_deviation(ge32, gk64), sweep_deviation(gk32,
                                                                    gk64)
    dv_eager, dv_k785 = value_deviation(ve32, vk64), value_deviation(vk32,
                                                                     vk64)
    check(dg_k785 <= SWEEP_F32_FACTOR * dg_eager + SWEEP_F32_GRAD_FLOOR,
          f"7a: float32 kernels {dg_k785} vs the eager float32 route "
          f"{dg_eager} from the float64 kernels at T={SWEEP_EAGER_T}")
    readings = sweep_kernels_vs_plain(device, ys, theta64, parts)
    r32 = readings[torch.float32]
    check(dv <= SWEEP_F32_FACTOR * r32["value_plain"] + SWEEP_F32_VALUE_FLOOR
          and dg <= SWEEP_F32_FACTOR * r32["grad_plain"]
          + SWEEP_F32_GRAD_FLOOR,
          f"7a: float32 value-and-grad vs the float64 one at T={SWEEP_T}: "
          f"value rel {dv}, grad {dg}; the float32 plain versions "
          f"{r32['value_plain']}, {r32['grad_plain']}")
    # The bare launches' width, B=4096 (the adjoint's team of 8): the
    # records repeated, one theta per lane, the same limits but for the
    # float64 value's, which the main path's width holds (its relative
    # round-off over 4096 lanes reached 1.07e-12 on an H100).
    wide = sweep_kernels_vs_plain(
        device, ys.repeat(-(-B_FULL // B), 1)[:B_FULL],
        sweep_thetas(B_FULL, device), parts, gate_f64_value=False)
    prof = profile_device(lambda: batched_value_and_grad(nll, (ys,))(theta))
    parts.insert(0,
        f"7a value-and-grad B={B} T={SWEEP_T} f32 through the kernels, one "
        f"theta per lane: {t_vg:.3f} s = {1e3 * t_vg / SWEEP_T:.4f} ms per "
        f"step, launches per evaluation {per_eval}, peak memory "
        f"{peak / 2 ** 30:.3f} GiB, device busy {100 * prof.busy:.2f}% of "
        f"{prof.wall_s:.4f} s ({prof.launches} CUDA kernels per call under "
        f"the profiler); f64 {t_vg64:.3f} s; f32 vs the f64 kernels: value "
        f"rel {dv:.3g}, grad {dg:.3g} of each lane's max |grad|; at "
        f"T={SWEEP_EAGER_T}: the eager f32 route value rel {dv_eager:.3g}, "
        f"grad {dg_eager:.3g} ({t_eager:.3f} s), the f32 kernels "
        f"{dv_k785:.3g}, {dg_k785:.3g}")
    return per_eval, (readings, wide)


def phase_sweep(device, smi, bare):
    """7a (``phase_sweep_objective``) and 7d the ghfs column of Table I.
    Returns the kernels' entries of the ``kernels`` line."""
    from unittest import mock
    import chirpgp_tpu_torch.apps.sweeps as sweeps
    from chirpgp_tpu_torch.apps import (
        IFEstimationConfig, make_nll_fn, mle_sweep_on_measurements,
        print_rmse_table)
    from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
    from chirpgp_tpu_torch.ops.chirp_filter_grad import ChirpFilterNLL
    from chirpgp_tpu_torch.utils.timing import timed
    cfg = IFEstimationConfig(method="ghfs", form="sqrt")
    ys, tf = sweep_data(device, slice(0, SWEEP_SEEDS), SWEEP_T)
    B = ys.shape[0]

    def nll(theta, ys_i):
        return make_nll_fn(cfg, ys_i)(theta)

    parts = []
    t_phase = time.perf_counter()
    ghfs_chirp_filter.launches = 0
    per_eval, readings = phase_sweep_objective(device, ys, parts)

    # 7d: the ghfs column of Table I, each stage timed.
    stages = {}

    def staged(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages[name] = (time.perf_counter() - t0, args, out)
            return out
        return run

    ChirpFilterNLL.reset_launches()
    with mock.patch.object(sweeps, "lbfgs_minimize_stepped",
                           staged("stepped", sweeps.lbfgs_minimize_stepped)), \
            mock.patch.object(sweeps, "_rescue_stuck_lanes",
                              staged("rescue", sweeps._rescue_stuck_lanes)), \
            mock.patch.object(sweeps, "_polish_lanes_f64",
                              staged("polish", sweeps._polish_lanes_f64)):
        res, t_sweep = timed(mle_sweep_on_measurements, cfg, tf, ys)
    launches = dict(ChirpFilterNLL.launches)
    check(min(launches.values()) > 0,
          f"7d: a kernel of the path was never launched: {launches}")
    # The polish never worse: the float64 NLL at its output against that
    # at its input, through the float64 kernels.
    _, polish_args, polished = stages["polish"]
    with torch.no_grad():
        y64 = ys.double()
        f_in = torch.func.vmap(nll)(polish_args[2].params.double(), y64)
        f_out = torch.func.vmap(nll)(polished.params.double(), y64)
    ok = torch.isfinite(f_in)
    worse = int((f_out[ok] > f_in[ok] + 1e-6 * f_in[ok].abs()).sum())
    check(worse == 0, f"7d: the polish raised {worse} lanes' float64 NLL")
    rows = []
    for k, mag in enumerate(MAGNITUDES):
        lanes = slice(k * SWEEP_SEEDS, (k + 1) * SWEEP_SEEDS)
        ref = np.load(ROOT / f"results/ghfs_{mag}.npz")
        med = 10.0 * float(np.nanmedian(res["rmse"][lanes]))
        want = 10.0 * float(np.nanmedian(ref["rmse"]))
        failed = int((~res["success"][lanes]).sum())
        rel = abs(med - want) / want
        rows.append(f"{mag} median IF-RMSE x10 {med:.4f} (JAX package "
                    f"{want:.4f}, rel {rel:.4f}), {failed} lanes without "
                    f"success (JAX package {int((~ref['success']).sum())})")
        check(rel <= SWEEP_MEDIAN_RTOL[mag] and failed <= SWEEP_MAX_FAILED,
              f"7d {mag}: median IF-RMSE x10 {med} vs {want} (rel {rel}), "
              f"{failed} lanes without success")
    print_rmse_table({"ghfs (sqrt, f32, card)": {
        m: {"rmse": res["rmse"][k * SWEEP_SEEDS:(k + 1) * SWEEP_SEEDS]}
        for k, m in enumerate(MAGNITUDES)}})
    stage_s = ", ".join(f"{k} {v[0]:.3f} s" for k, v in stages.items())
    parts.append(
        f"7d ghfs column, mle_sweep_on_measurements B={B} T={SWEEP_T} "
        f"max_iters={cfg.max_iters}: {t_sweep:.3f} s ({stage_s}, estimate "
        f"the rest); kernel launches {launches}; polish never worse; "
        + "; ".join(rows))
    print(f"phase 7 sweep ({time.perf_counter() - t_phase:.3f} s; {smi}; "
          f"one-theta filter kernel launches {ghfs_chirp_filter.launches}: "
          f"not on the sweep path): " + "; ".join(parts), flush=True)
    r32, wide32 = (r[torch.float32] for r in readings)
    return {name: dict({
        "name": name, "route": "cuda", "source": SWEEP_SOURCES[name],
        "replaces": SWEEP_REPLACES, "launches": launches[key],
        "max_abs_err": r32["nll_abs" if key == "forward" else "adjoint_abs"],
        "ms": bare[name]["B=300/f32"]["ms"],
        "plain_ms": 1e3 * r32["plain_fwd_s" if key == "forward"
                              else "plain_adj_s"],
        "bound_ms": bare[name]["B=300/f32"]["bound_ms"],
        "bound_by": bare[name]["B=300/f32"]["bound_by"],
        "library_ms": None, "launches_per_evaluation": per_eval[key],
        "ms_f64": bare[name]["B=300/f64"]["ms"],
        "bound_ms_f64": bare[name]["B=300/f64"]["bound_ms"],
        "ms_b4096": bare[name]["B=4096/f32"]["ms"],
        "bound_ms_b4096": bare[name]["B=4096/f32"]["bound_ms"],
        "max_abs_err_b4096": wide32["nll_abs" if key == "forward"
                                    else "adjoint_abs"],
        "plain_ms_b4096": 1e3 * wide32["plain_fwd_s" if key == "forward"
                                       else "plain_adj_s"],
        **({"geometry": bare[name]["B=300/f32"]["geometry"],
            "geometry_b4096": bare[name]["B=4096/f32"]["geometry"]}
           if key == "adjoint" else {})})
        for name, key in (("ghfs_chirp_filter_lanes", "forward"),
                          ("ghfs_chirp_filter_adjoint", "adjoint"))}


def family_gate(name, dtype_name, device):
    """Seed 0 of column ``name`` at its reference optimum, T=3141, in
    ``dtype_name`` on ``device``, through ``estimate_if`` (the KPT columns
    through ``kpt_if_estimate``): (IF-RMSE x10, final NLL, all finite,
    seconds).  Phase 8a runs it in child processes."""
    from chirpgp_tpu_torch.apps import (
        IFEstimationConfig, estimate_if, kpt_if_estimate)
    from chirpgp_tpu_torch.convert import params_from_jax
    from chirpgp_tpu_torch.utils import rmse
    prefix, cfg, _, _ = FAMILY_GATES[name]
    dtype = getattr(torch, dtype_name)
    data = np.load(ROOT / f"results/data/toydata_{prefix}const.npz")
    ys = torch.as_tensor(data["ys"][0], dtype=dtype, device=device)
    tf = torch.as_tensor(data["true_freqs"], dtype=torch.float64,
                         device=device)
    params = params_from_jax(np.load(
        ROOT / f"results/reference/{name}_const.npz")["params"][0], dtype,
        device)
    t0 = time.perf_counter()
    if isinstance(cfg, dict):
        est = estimate_if(IFEstimationConfig(**cfg), params, ys)
        if_mean, nell = est["if_mean"], est["nell"]
    else:
        if_mean, nell = kpt_if_estimate(params, KPT_FS, XI, ys,
                                        num_harmonics=cfg)
    finite = bool(torch.isfinite(if_mean).all() and torch.isfinite(nell).all())
    r10 = 10.0 * float(rmse(tf, if_mean.double()))
    return r10, float(nell[-1]), finite, time.perf_counter() - t0


def family_objective(kind):
    """A family sweep's per-lane objective ``(theta, ys_i) -> NLL`` and its
    float32 init theta: ``"harmonic_ckfs"`` (K=3, cubature, sqrt),
    ``"kpt1"``/``"kpt3"`` (the KPT EKF with K=1/3 harmonics), or
    ``"cd_ghfs"``/``"cd_ekfs"`` (the chirp model, cov form, GH-3)."""
    from chirpgp_tpu_torch.apps import (
        IFEstimationConfig, KPT_INIT_PARAMS, kpt_filter, make_nll_fn)
    from chirpgp_tpu_torch.models import g, g_inv
    if kind in ("harmonic_ckfs", "cd_ghfs", "cd_ekfs"):
        cfg = IFEstimationConfig(**FAMILY_GATES[kind][1]) \
            if kind == "harmonic_ckfs" else IFEstimationConfig(method=kind)
        return (lambda th, y: make_nll_fn(cfg, y)(th),
                cfg.default_init_theta(torch.float32))
    K = int(kind[-1])
    return (lambda th, y: kpt_filter(g(th), KPT_FS, XI, y,
                                     num_harmonics=K)[2][-1],
            g_inv(torch.tensor(KPT_INIT_PARAMS, dtype=torch.float32)))


def family_lane_alone(kind, ys_lane, theta, device):
    """Value, gradient and wall time of a family sweep objective on one
    lane alone, float32 on ``device``: what phases 8c and 8d hold each
    vmapped lane to, in child processes."""
    fn, _ = family_objective(kind)
    th = torch.tensor(theta, device=device).requires_grad_(True)
    t0 = time.perf_counter()
    value = fn(th, torch.tensor(ys_lane, device=device))
    grad, = torch.autograd.grad(value, th)
    return float(value.detach()), grad.cpu().numpy(), time.perf_counter() - t0


def family_value_and_grad(kind, ys, device, pool,
                          budget_s=FAMILY_VG_BUDGET_S):
    """8c/8d/9b: one vmapped value-and-grad of a sweep objective on all
    lanes of ``ys`` (B, T_full), float32.  A first call at FAMILY_SHORT_T
    prices a step; T is cut so that the call takes at most ``budget_s``.
    Lanes 0 and B-1 run alone in ``pool`` meanwhile.  Returns the record
    of the call and the lanes' futures."""
    from chirpgp_tpu_torch.utils.timing import profile_device, timed
    from chirpgp_tpu_torch.fit import batched_value_and_grad
    fn, theta = family_objective(kind)
    B, t_full = ys.shape
    theta0 = theta.to(device).expand(B, -1).clone()
    _, t_short = timed(batched_value_and_grad(
        fn, (ys[:, :FAMILY_SHORT_T].contiguous(),)), theta0)
    T = min(t_full, max(FAMILY_SHORT_T, int(budget_s * FAMILY_SHORT_T
                                            / t_short)))
    yT = ys[:, :T].contiguous()
    lanes = (0, B - 1)
    alone = [pool.submit(family_lane_alone, kind, yT[i].cpu().numpy(),
                         theta0[i].cpu().numpy(), str(device)) for i in lanes]
    torch.cuda.reset_peak_memory_stats(device)
    (values, grads), t_vg = timed(batched_value_and_grad(fn, (yT,)), theta0)
    peak = torch.cuda.max_memory_allocated(device)
    check(bool(torch.isfinite(values).all() and torch.isfinite(grads).all()),
          f"8 {kind}: non-finite value or gradient")
    prof = profile_device(
        lambda: batched_value_and_grad(fn, (ys[:, :FAMILY_PROFILE_T],))(
            theta0))
    return dict(kind=kind, B=B, T=T, t_full=t_full, t_short=t_short, t=t_vg,
                peak=peak, values=values, grads=grads, lanes=lanes,
                per_step=prof.launches / FAMILY_PROFILE_T, prof=prof,
                budget=budget_s), alone


def family_vg_report(rec, alone):
    """Check the lanes alone against the vmapped call; its report line."""
    devs = []
    for lane, fut in zip(rec["lanes"], alone):
        v, gr, t_lane = fut.result()
        dv = abs(v - float(rec["values"][lane])) / abs(v)
        dg = float(np.abs(gr - rec["grads"][lane].cpu().numpy()).max()
                   / np.abs(gr).max())
        check(dv <= SWEEP_VG_TOL and dg <= SWEEP_GRAD_TOL,
              f"8 {rec['kind']} lane {lane}: vmapped vs alone, value rel "
              f"{dv}, grad {dg}")
        devs.append(f"lane {lane}: value rel {dv:.3g}, grad {dg:.3g} "
                    f"({t_lane:.3f} s alone)")
    cut = "" if rec["T"] == rec["t_full"] else (
        f" (T cut from {rec['t_full']} to {rec['T']}: T={FAMILY_SHORT_T} "
        f"took {rec['t_short']:.3f} s, budget {rec['budget']:.0f} s)")
    prof = rec["prof"]
    prof = (f"profiler at T={FAMILY_PROFILE_T}: {rec['per_step']:.1f} "
            f"kernel launches per step, device busy {100 * prof.busy:.2f}% "
            f"of {prof.wall_s:.3f} s (profiled: {prof.profiled_wall_s:.3f} s)")
    return (f"{rec['kind']} value-and-grad B={rec['B']} T={rec['T']}{cut} "
            f"f32: {rec['t']:.3f} s = {1e3 * rec['t'] / rec['T']:.3f} ms per "
            f"step, peak memory {rec['peak'] / 2 ** 30:.3f} GiB (x "
            f"{rec['t_full']}/{rec['T']}: {rec['peak'] * rec['t_full'] / rec['T'] / 2 ** 30:.2f} "
            f"GiB at T={rec['t_full']}); {'; '.join(devs)}; {prof}")


def lascala_inputs(device):
    """8b's La Scala parameters, rule and records: the Table-I width, the
    100 records of ``toydata_const`` in float64, and their true IFs."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.convert import params_from_jax
    cfg = IFEstimationConfig(model="lascala")
    data = np.load(ROOT / "results/data/toydata_const.npz")
    y64 = torch.as_tensor(data["ys"], dtype=torch.float64, device=device)
    tf = torch.as_tensor(data["true_freqs"], dtype=torch.float64,
                         device=device)
    las = params_from_jax(np.load(
        ROOT / "results/reference/lascala_ghfs_const.npz")["params"][0])
    return cfg, las, y64, tf


def lascala_bare_launches(device):
    """8b's bare launches of La Scala's filter at the Table-I width,
    {dtype name: CUDA-event ms}, timed before the lanes start, while this
    process has the card to itself."""
    from chirpgp_tpu_torch.ops.chirp_filter import (
        kernel_launcher, lascala_chirp_params)
    cfg, las, y64, _ = lascala_inputs(device)
    out = {}
    for yss in (y64.float(), y64):
        launch, _ = kernel_launcher(lascala_chirp_params(las.to(yss.dtype)),
                                    XI, DT, cfg.sigma_points(), yss)
        out[str(yss.dtype)[6:]] = event_ms(launch)
    return out


def phase_family(device, smi, bare_ms):
    """8a seed-0 gates of the six columns (child processes, beside the
    rest), 8b La Scala through the filter kernel (its bare launches
    ``bare_ms`` timed by ``lascala_bare_launches``), 8c/8d the harmonic
    CKFS and KPT sweep objectives at B=300, 8e the whole harmonic-EKFS and
    KPT sweeps at a small depth."""
    from chirpgp_tpu_torch.utils.timing import timed
    import concurrent.futures
    import multiprocessing
    from unittest import mock
    import chirpgp_tpu_torch.apps.sweeps as sweeps
    from chirpgp_tpu_torch.apps import (
        IFEstimationConfig, estimate_if_batched, make_nll_fn,
        mle_sweep_on_measurements)
    from chirpgp_tpu_torch.ops.chirp_filter import (
        ghfs_chirp_filter, ghfs_chirp_filter_reference, kernel_launcher,
        lascala_chirp_params)
    from chirpgp_tpu_torch.ops.chirp_smoother import ghfs_chirp_smoother
    from chirpgp_tpu_torch.utils import rmse
    spawn = multiprocessing.get_context("spawn")
    parts, out = [], {}
    t_phase = time.perf_counter()

    # 8b: the kernel's outputs on La Scala's records (its bare launches
    # were timed before the lanes, with the card to itself).
    cfg, las, y64, tf = lascala_inputs(device)
    rule = cfg.sigma_points()
    kern = {}
    for yss in (y64.float(), y64):
        tag = str(yss.dtype)[6:]
        launch, kern[tag] = kernel_launcher(
            lascala_chirp_params(las.to(yss.dtype)), XI, DT, rule, yss)
        launch()  # writes kern[tag]
        out[tag] = dict(ms=bare_ms[tag])

    gate_jobs = [(name, "float64") for name in FAMILY_GATES] + [
        ("harmonic_ckfs", "float32")]
    with concurrent.futures.ProcessPoolExecutor(3, mp_context=spawn) as gates, \
            concurrent.futures.ProcessPoolExecutor(2, mp_context=spawn) as lanes:
        gate_futs = [gates.submit(family_gate, n, dt, str(device))
                     for n, dt in gate_jobs]

        # 8b: estimate_if_batched(lascala) launches the kernel; the kernel
        # against its plain version.
        _, _, want_r10, want_nll = FAMILY_GATES["lascala_ghfs"]
        for yss in (y64.float(), y64):
            tag = str(yss.dtype)[6:]
            params = las.to(device, yss.dtype)
            ghfs_chirp_filter.launches = ghfs_chirp_smoother.launches = 0
            est, t_est = timed(estimate_if_batched, cfg, params, yss)
            launches = ghfs_chirp_filter.launches
            smoother_launches = ghfs_chirp_smoother.launches
            check(launches == 1 and smoother_launches == 1,
                  f"8b {tag}: estimate_if_batched(lascala) launched the "
                  f"filter {launches} and the smoother {smoother_launches} "
                  f"times, not once each")
            for key in ("if_mean", "nell", "mss", "Lss"):
                check(bool(torch.isfinite(est[key]).all()),
                      f"8b {tag}: non-finite {key}")
            r10 = 10.0 * float(rmse(tf, est["if_mean"][0].double()))
            nll0 = float(est["nell"][0])
            r_tol, n_tol = ((FAMILY_RMSE_ATOL, FAMILY_NLL_RTOL) if tag ==
                            "float64" else (GATE_RMSE_ATOL, GATE_NELL_RTOL))
            check(abs(r10 - want_r10) <= r_tol and
                  abs(nll0 - want_nll) <= n_tol * want_nll,
                  f"8b {tag}: record 0 IF-RMSE x10 {r10!r}, nll {nll0!r}")
            chirp = lascala_chirp_params(params)
            plain, t_plain = timed(ghfs_chirp_filter_reference, chirp, XI, DT,
                                   rule, yss)
            dev = deviations(kern[tag], plain)
            scaled = (dev["mfs"] / (1.0 + dev["scale_mfs"]),
                      dev["LLT"] / (1.0 + dev["scale_LLT"]),
                      dev["nll_last_rel"])
            for key, val, bound in zip(("mfs", "LLT", "nll[-1]"), scaled,
                                       FULL_BOUNDS[tag]):
                check(val <= bound, f"8b {tag}: kernel vs plain scaled |d "
                                    f"{key}| {val} > {bound}")
            B, T = yss.shape
            flop, nbytes, bound, bound_by = bound_ms(rule.n_points, T, B,
                                                     yss.dtype)
            ms = out[tag]["ms"]
            out[tag].update(launches=launches,
                            smoother_launches=smoother_launches, bound_ms=bound,
                            bound_by=bound_by, plain_ms=1e3 * t_plain)
            parts.append(
                f"8b lascala estimate_if_batched B={B} T={T} GH-3 {tag}: "
                f"{t_est:.3f} s, filter and smoother kernel launches "
                f"{launches}, {smoother_launches}; record 0 IF-RMSE "
                f"x10 {r10!r}, nll {nll0!r}; kernel vs plain: max|d mfs| "
                f"{dev['mfs']!r}, max|d LLT| {dev['LLT']!r}, max rel|d "
                f"nll[-1]| {dev['nll_last_rel']!r}; bare launch {ms!r} ms "
                f"(CUDA events, before the lanes), plain filter "
                f"{1e3 * t_plain:.3f} ms; {flop} flop, {nbytes} B, bound "
                f"{bound!r} ms ({bound_by}), share {bound / ms:.4f}")
        del kern

        # 8c/8d: the harmonic CKFS and KPT sweep objectives at B=300.
        ys_h3, _ = sweep_data(device, slice(0, SWEEP_SEEDS), SWEEP_T, "h3_")
        ys_1, _ = sweep_data(device, slice(0, SWEEP_SEEDS), SWEEP_T)
        for tag, kind, ys in (("8c", "harmonic_ckfs", ys_h3),
                              ("8d", "kpt1", ys_1), ("8d", "kpt3", ys_h3)):
            rec, alone = family_value_and_grad(kind, ys, device, lanes)
            parts.append(f"{tag} " + family_vg_report(rec, alone))
        del ys_h3, ys_1

        # 8e: the whole sweeps at a small depth, the polish batched on the card.
        n, t_e, iters = FAMILY_SMALL
        stages = {}
        polish = sweeps._polish_lanes_f64

        def captured(*args, **kwargs):
            res = polish(*args, **kwargs)
            stages["polish"] = (args, res)
            return res

        cfg_e = IFEstimationConfig(max_iters=iters,
                                   **FAMILY_GATES["harmonic_ekfs"][1])
        kpt_nll, _ = family_objective("kpt1")
        runs = (("harmonic_ekfs", "h3_", lambda tf_, ys_: (
                    mle_sweep_on_measurements(cfg_e, tf_, ys_)),
                 lambda y: make_nll_fn(cfg_e, y)),
                ("kpt", "", lambda tf_, ys_: sweeps._kpt_sweep_on_measurements(
                    tf_, ys_, max_iters=iters),
                 lambda y: (lambda th: kpt_nll(th, y))))
        for name, prefix, run, host_nll in runs:
            ys_e, tf_e = sweep_data(device, slice(0, n), t_e, prefix)
            with mock.patch.object(sweeps, "_polish_lanes_f64", captured):
                res, t_run = timed(run, tf_e, ys_e)
            check(bool(np.all(np.isfinite(res["rmse"]))
                       and np.all(res["success"])),
                  f"8e {name}: lanes not finite with success: "
                  f"{res['success']}")
            (_, _, incoming, _), polished = stages["polish"][0], \
                stages["polish"][1]
            gaps = []
            with torch.no_grad():
                for i in range(ys_e.shape[0]):
                    f = host_nll(ys_e[i].cpu().double())
                    f_in = float(f(incoming.params[i].cpu().double()))
                    f_out = float(f(polished.params[i].cpu().double()))
                    gaps.append(f_out - f_in)
                    check(f_out <= f_in + 1e-6 * abs(f_in),
                          f"8e {name}: polish of lane {i} raised the f64 NLL "
                          f"{f_in} -> {f_out}")
            parts.append(
                f"8e {name} sweep B={ys_e.shape[0]} T={t_e} (cut from 40) "
                f"max_iters={iters}:"
                f" {t_run:.3f} s; all lanes finite with success; f64 NLL "
                f"change by the polish {min(gaps):.4g} to {max(gaps):.4g}; "
                f"rmse x10 {[round(10 * float(r), 4) for r in res['rmse']]}")

        # 8a: the seed-0 gates, run in the child processes meanwhile.
        gate_parts = []
        for (name, dtype_name), fut in zip(gate_jobs, gate_futs):
            r10, nll, finite, secs = fut.result()
            _, _, want_r10, want_nll = FAMILY_GATES[name]
            r_tol = FAMILY_RMSE_ATOL if dtype_name == "float64" \
                else GATE_RMSE_ATOL
            check(finite and abs(r10 - want_r10) <= r_tol,
                  f"8a {name} {dtype_name}: IF-RMSE x10 {r10!r} not within "
                  f"{r_tol} of {want_r10} (finite {finite})")
            if dtype_name == "float64":
                check(abs(nll - want_nll) <= FAMILY_NLL_RTOL * want_nll,
                      f"8a {name}: nll {nll!r} not within {FAMILY_NLL_RTOL} "
                      f"rel of {want_nll}")
            gate_parts.append(f"{name} f{dtype_name[5:]} IF-RMSE x10 {r10!r} "
                              f"(ref {want_r10}), nll {nll!r} (ref "
                              f"{want_nll}), {secs:.3f} s")
        parts.insert(0, f"8a seed-0 gates T={SWEEP_T} on the card: "
                        + "; ".join(gate_parts))
    print(f"phase 8 model family ({time.perf_counter() - t_phase:.3f} s; "
          f"{smi}): " + "; ".join(parts), flush=True)
    return out


def cd_gate(method, device):
    """Seed 0 of toydata_const at the cd column's reference optimum, T=3141,
    float64, through ``estimate_if`` on ``device``: (IF-RMSE x10, final
    NLL, all finite, seconds).  Phase 9a runs it in child processes."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig, estimate_if
    from chirpgp_tpu_torch.convert import params_from_jax
    from chirpgp_tpu_torch.utils import rmse
    data = np.load(ROOT / "results/data/toydata_const.npz")
    ys = torch.as_tensor(data["ys"][0], dtype=torch.float64, device=device)
    tf = torch.as_tensor(data["true_freqs"], dtype=torch.float64,
                         device=device)
    params = params_from_jax(np.load(
        ROOT / f"results/reference/{method}_const.npz")["params"][0],
        device=device)
    t0 = time.perf_counter()
    est = estimate_if(IFEstimationConfig(method=method), params, ys)
    finite = bool(torch.isfinite(est["if_mean"]).all()
                  and torch.isfinite(est["nell"]).all())
    r10 = 10.0 * float(rmse(tf, est["if_mean"]))
    return r10, float(est["nell"][-1]), finite, time.perf_counter() - t0


def classical_inputs(seeds, T):
    """Phase 9d's float64 host inputs: the times and true IF; the 300
    records of toydata_* and 300 complex envelopes made with NumPy (the
    Table-I width); the 100 const records and envelopes of the reference's
    classical columns, remade from toydata_const's keys (float64 draws,
    where toydata holds float32 draws of the same keys); the polynomial
    init, numpy's degree-11 fit of the true IF."""
    from chirpgp_tpu_torch.toymodels import (
        constant_mag, gen_chirp, gen_chirp_envelope, meow_freq)
    from chirpgp_tpu_torch.utils.jax_keys import jax_normal, split
    ts = torch.linspace(DT, DT * T, T, dtype=torch.float64)
    freq, phase = meow_freq(offset=8.0)
    tf = freq(ts)
    ys = np.concatenate([np.load(ROOT / f"results/data/toydata_{m}.npz")["ys"]
                         [:seeds, :T] for m in MAGNITUDES]).astype(np.float64)
    env = gen_chirp_envelope(ts, constant_mag(1.0), phase)
    noise = np.random.default_rng(CLASSICAL_ENV_SEED).standard_normal(
        (3 * seeds, T))
    env300 = (env + math.sqrt(XI) * torch.as_tensor(noise)).numpy()
    keys = np.load(ROOT / "results/data/toydata_const.npz")["keys"][:seeds]
    noise = torch.as_tensor(np.stack([jax_normal(split(k)[0], T)
                                      for k in keys]))
    ys_ref = gen_chirp(ts, constant_mag(1.0), phase) + math.sqrt(XI) * noise
    env_ref = env + math.sqrt(XI) * noise
    fit = np.polynomial.Polynomial.fit(ts.numpy(), tf.numpy(), 11)
    init = np.concatenate([[1.0], fit.convert().coef])
    return dict(ts=ts.numpy(), tf=tf.numpy(), ys=ys, env=env300,
                ys_ref=ys_ref.numpy(), env_ref=env_ref.numpy(), init=init)


def classical_columns(ts, tf, ys, env, init, device, iters, threads=0,
                      poly_records=None):
    """The four classical columns on ``device`` (records ``ys`` (B, T) and
    envelopes ``env`` (B, T), NumPy float64), 100 records per call, as the
    JAX package's Table-I driver runs them (the polynomial LM for at most
    ``iters`` iterations, on the first ``poly_records`` records): per-record
    IF-RMSE of each method and its seconds.  Phase 9d runs it on the card
    and, in a child process with ``threads`` threads, on the host CPU."""
    from chirpgp_tpu_torch.baselines import (
        adaptive_notch_filter, butter_lowpass, hilbert_method,
        mean_power_spectrum, mle_polynomial_batched)
    from chirpgp_tpu_torch.toymodels import meow_freq
    if threads:
        torch.set_num_threads(threads)
    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    freq, _ = meow_freq(offset=8.0)
    ts, tf = (torch.as_tensor(x, device=device) for x in (ts, tf))
    mu = 0.015
    anf_args = (0.0, float(freq(ts[:1])[0]), 1.0 + 0.0j, mu, mu ** 3 / 8,
                mu ** 2 / 2)
    powers = ts[:, None] ** torch.arange(len(init) - 1, dtype=ts.dtype,
                                         device=device)

    def rmse_rows(est, truth):
        return torch.sqrt(((est - truth) ** 2).mean(-1))

    def hilbert(y):
        return rmse_rows(hilbert_method(ts, butter_lowpass(y, 18.0, 1e3)),
                         tf[1:])

    def spectrogram(y):
        new_ts, est = mean_power_spectrum(ts, butter_lowpass(y, 18.0, 1e3),
                                          nperseg=450, noverlap=449,
                                          window="cosine")
        return rmse_rows(est, freq(new_ts))

    def poly(y):
        res = mle_polynomial_batched(
            ts, y, XI, torch.as_tensor(init, device=device).expand(
                y.shape[0], -1), max_iters=iters)
        return rmse_rows(res.params[:, 1:] @ powers.T, tf)

    def anf(e):
        return rmse_rows(adaptive_notch_filter(ts, e, *anf_args)[0], tf)

    out, secs = {}, {}
    for name, fn, data in (("hilbert", hilbert, ys),
                           ("spectrogram", spectrogram, ys),
                           ("poly", poly, ys[:poly_records]),
                           ("anf", anf, env)):
        sync()
        t0 = time.perf_counter()
        rows = [fn(torch.as_tensor(data[i:i + 100], device=device))
                for i in range(0, data.shape[0], 100)]
        sync()
        secs[name] = time.perf_counter() - t0
        out[name] = torch.cat(rows).cpu().numpy()
    return out, secs


def phase_table_one(device, smi):
    """9a the cd seed-0 gates (child processes, beside the rest), 9b the cd
    sweep objectives at B=300, 9c the whole cd_ekfs sweep at a small
    depth, 9d the four classical columns at the Table-I width."""
    from chirpgp_tpu_torch.utils.timing import timed
    import concurrent.futures
    import multiprocessing
    from unittest import mock
    import chirpgp_tpu_torch.apps.sweeps as sweeps
    from chirpgp_tpu_torch.apps import (
        IFEstimationConfig, make_nll_fn, mle_sweep_on_measurements)
    spawn = multiprocessing.get_context("spawn")
    parts = []
    t_phase = time.perf_counter()
    inputs = classical_inputs(SWEEP_SEEDS, SWEEP_T)
    cols = ("ts", "tf", "ys", "env", "init")
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=spawn) as gates, \
            concurrent.futures.ProcessPoolExecutor(
                1, mp_context=spawn) as lanes, \
            concurrent.futures.ProcessPoolExecutor(
                1, mp_context=spawn) as host:
        gate_futs = {m: gates.submit(cd_gate, m, str(device))
                     for m in CD_GATES}
        host_fut = host.submit(classical_columns,
                               *(inputs[k] for k in cols), "cpu",
                               POLY_ITERS, CLASSICAL_HOST_THREADS,
                               CLASSICAL_HOST_POLY_RECORDS)

        # 9b: the cd sweep objectives at B=300, float32.
        ys_1, _ = sweep_data(device, slice(0, SWEEP_SEEDS), SWEEP_T)
        for kind in CD_GATES:
            rec, alone = family_value_and_grad(kind, ys_1, device, lanes,
                                               CD_VG_BUDGET_S)
            parts.append("9b " + family_vg_report(rec, alone))
        del ys_1

        # 9c: the whole cd_ekfs sweep at a small depth, the polish batched
        # on the card.
        n, t_c, iters = CD_SMALL
        captured = {}
        polish = sweeps._polish_lanes_f64

        def capture(*args, **kwargs):
            captured["args"] = args
            captured["res"] = polish(*args, **kwargs)
            return captured["res"]

        cfg_c = IFEstimationConfig(method="cd_ekfs", max_iters=iters)
        ys_c, tf_c = sweep_data(device, slice(0, n), t_c)
        with mock.patch.object(sweeps, "_polish_lanes_f64", capture):
            res, t_run = timed(mle_sweep_on_measurements, cfg_c, tf_c, ys_c)
        check(bool(np.all(np.isfinite(res["rmse"])) and np.all(res["success"])),
              f"9c cd_ekfs: lanes not finite with success: {res['success']}")
        incoming, polished = captured["args"][2], captured["res"]
        gaps = []
        with torch.no_grad():
            for i in range(ys_c.shape[0]):
                f = make_nll_fn(cfg_c, ys_c[i].cpu().double())
                f_in = float(f(incoming.params[i].cpu().double()))
                f_out = float(f(polished.params[i].cpu().double()))
                gaps.append(f_out - f_in)
                check(f_out <= f_in + 1e-6 * abs(f_in),
                      f"9c cd_ekfs: polish of lane {i} raised the f64 NLL "
                      f"{f_in} -> {f_out}")
        parts.append(
            f"9c cd_ekfs sweep B={ys_c.shape[0]} T={t_c} max_iters={iters}: "
            f"{t_run:.3f} s; all lanes finite with success; f64 NLL change "
            f"by the polish {min(gaps):.4g} to {max(gaps):.4g}; rmse x10 "
            f"{[round(10 * float(r), 4) for r in res['rmse']]}")

        # 9d: the classical columns on the card; the same inputs on the
        # host CPU in the child process; the reference's const records.
        card, card_s = classical_columns(*(inputs[k] for k in cols), device,
                                         POLY_ITERS)
        ref, _ = classical_columns(inputs["ts"], inputs["tf"],
                                   inputs["ys_ref"], inputs["env_ref"],
                                   inputs["init"], device, POLY_ITERS)
        host_rmse, host_s = host_fut.result()
        col = []
        for name in card:
            c, h = card[name], host_rmse[name]
            check(bool(np.all(np.isfinite(c))), f"9d {name}: non-finite")
            c = c[:h.shape[0]]
            rel = float(np.max(np.abs(c - h) / np.abs(h)))
            tol = CLASSICAL_HOST_RTOL[name]
            check(rel <= tol, f"9d {name}: card vs host CPU rel {rel} > {tol}")
            col.append(f"{name} card {card_s[name]:.3f} s, host CPU "
                       f"({CLASSICAL_HOST_THREADS} threads, {h.shape[0]} "
                       f"records) {host_s[name]:.3f} s, max rel |card - host| "
                       f"{rel:.3g}, median rmse x10 "
                       f"{10 * float(np.median(card[name])):.4f}")
        parts.append(f"9d classical columns B={inputs['ys'].shape[0]} "
                     f"T={SWEEP_T} f64 (toydata_* records, NumPy envelopes): "
                     + "; ".join(col))
        held = []
        for name, which, rtol in CLASSICAL_REF_RTOL:
            want = np.load(ROOT / (f"results/reference/{name}_const.npz"
                                   if which == "reference" else
                                   f"results/{name}_const.npz"))["rmse"][
                                       :SWEEP_SEEDS]
            rel = float(np.max(np.abs(ref[name] - want) / want))
            check(rel <= rtol, f"9d {name}: per-seed rmse vs the {which} "
                               f"column rel {rel} > {rtol}")
            held.append(f"{name} vs the {which} column: seed 0 "
                        f"{float(ref[name][0])!r} ({float(want[0])!r}), max "
                        f"rel {rel:.3g} (bound {rtol})")
        parts.append(f"9d the {SWEEP_SEEDS} const records of the reference "
                     f"(float64 draws of toydata's keys), per seed: "
                     + "; ".join(held))

        # 9a: the seed-0 gates, run in the child processes meanwhile.
        gate_parts = []
        for method, fut in gate_futs.items():
            r10, nll, finite, secs = fut.result()
            want_r10, want_nll, ref_r10 = CD_GATES[method]
            check(finite and abs(r10 - want_r10) <= CD_RMSE_ATOL
                  and abs(r10 - ref_r10) <= CD_REF_ATOL,
                  f"9a {method}: IF-RMSE x10 {r10!r} not within "
                  f"{CD_RMSE_ATOL} of {want_r10} and {CD_REF_ATOL} of "
                  f"{ref_r10} (finite {finite})")
            check(abs(nll - want_nll) <= CD_NLL_RTOL * abs(want_nll),
                  f"9a {method}: nll {nll!r} not within {CD_NLL_RTOL} rel "
                  f"of {want_nll}")
            gate_parts.append(f"{method} f64 IF-RMSE x10 {r10!r} (JAX "
                              f"{want_r10}, ref {ref_r10}), nll {nll!r} "
                              f"(JAX {want_nll}), {secs:.3f} s")
        parts.insert(0, f"9a seed-0 gates T={T_FULL} on the card, in child "
                        f"processes: " + "; ".join(gate_parts))
    print(f"phase 9 Table I's last columns ({time.perf_counter() - t_phase:.3f}"
          f" s; {smi}): " + "; ".join(parts), flush=True)


def crlb_vs_reference(res, path, n):
    """The time-averaged relative gap of each component's mean error and
    the largest per-step |z| against the committed file at ``path``."""
    ref = np.load(path)
    n_ref = float(ref["num_mcs"])
    out = {}
    for comp in ("x2", "v"):
        a, b = res[f"mean_err_{comp}"], ref[f"mean_err_{comp}"]
        sa, sb = res[f"std_err_{comp}"], ref[f"std_err_{comp}"]
        z = (a - b) / np.sqrt(sa ** 2 / n + sb ** 2 / n_ref)
        out[comp] = (float(abs(a.mean() - b.mean()) / b.mean()),
                     float(np.abs(z).max()))
    return out


def crlb_draws(seed, device):
    """Phase 10b's normals: chunk ``index`` from a generator on ``device``
    seeded with ``seed + index``, in float64, so that a float32 and a
    float64 run see the same samples."""
    def draws(index, n):
        gen = torch.Generator(device=device).manual_seed(seed + index)
        return tuple(torch.randn(shape, generator=gen, dtype=torch.float64,
                                 device=device)
                     for shape in ((n, 4), (n, CRLB_T, 4), (n, CRLB_T)))
    return draws


def fastnls_columns(seeds):
    """Phase 10f, on the host in a child process: the fastF0NLS and
    harmonic-fastF0NLS columns on ``seeds`` seeds per magnitude with
    run_fastnls.py's protocol.  Returns ({column: (rmse, committed)},
    {K: seconds per record}, build seconds)."""
    from chirpgp_tpu_torch.baselines.fastnls import (
        force_odd, median_smooth, pitch_track)
    from chirpgp_tpu_torch.ops.native import load_fast_nls
    from chirpgp_tpu_torch.toymodels import meow_freq
    t0 = time.perf_counter()
    load_fast_nls()
    build = time.perf_counter() - t0
    freq, _ = meow_freq(offset=8.0)
    out, per_record = {}, {}
    for K, prefix, col in ((1, "", "fastf0nls"),
                           (3, "h3_", "harmonic_fastf0nls")):
        t0 = time.perf_counter()
        for mag in MAGNITUDES:
            ys = np.load(ROOT / f"results/data/toydata_{prefix}{mag}.npz")[
                "ys"][:seeds].astype(np.float64)
            rm = []
            for y in ys:
                times, f0 = pitch_track(y, 1.0 / DT, K, window_length=300,
                                        window_overlap=299, method=1)
                tf = freq(torch.as_tensor(times)).numpy()
                sm = median_smooth(f0, force_odd(round(300 / 2)))
                rm.append(float(np.sqrt(np.mean((sm - tf) ** 2))))
            out[f"{col}_{mag}"] = (np.array(rm), np.load(
                ROOT / f"results/{col}_{mag}.npz")["rmse"][:seeds])
        per_record[K] = (time.perf_counter() - t0) / (seeds * len(MAGNITUDES))
    return out, per_record, build


def ligo_synthetic_h():
    """run_ligo's synthetic H record (``synth_gw150914``: chirp mass 30
    Msun, 35 -> 300 Hz at 4096 Hz, noise 0.55 N(0, 1) from the first half
    of JAX's split of PRNGKey(0), float64): (ts, ys) host arrays."""
    from chirpgp_tpu_torch.experiments.run_ligo import synth_gw150914
    ts, ys, _, _ = synth_gw150914()[0]
    return ts.numpy(), ys.numpy()


def myotis_analog():
    """tests/test_bats_longrecord.py's synthetic Myotis call: 4 harmonics
    sweeping 60 -> 25 kHz over 25334 samples at 250 kHz under a Gaussian
    envelope, plus 0.01 N(0, 1) from default_rng(0).  Returns (fs, ys,
    true IF, envelope)."""
    fs = 250000.0
    ts = np.arange(MYOTIS_FULL) / fs
    dur = MYOTIS_FULL / fs
    freq = 60e3 + (25e3 - 60e3) * ts / dur
    phase = np.cumsum(freq) / fs
    env = np.exp(-0.5 * ((ts - dur / 2) / (dur / 5)) ** 2)
    sig = sum((0.6 ** (k - 1)) * np.sin(2 * np.pi * k * phase)
              for k in range(1, 5))
    ys = env * sig + 0.01 * np.random.default_rng(0).standard_normal(
        MYOTIS_FULL)
    return fs, ys, freq, env


def ligo_check(device):
    """Phase 10g in a child process: ``estimate_if`` at the committed
    H_synth_params on run_ligo.py's synthetic H record, float64, against
    the committed IF mean, then ``analyze_ligo`` with ``fit_mle`` capped.
    Returns the sub-phase's text; raises SmokeFailure on a failed gate."""
    from chirpgp_tpu_torch.utils.timing import timed
    from chirpgp_tpu_torch.apps import (
        analyze_ligo, estimate_if, ligo_config, standardize)
    device = torch.device(device)
    t0 = time.perf_counter()
    ligo = np.load(ROOT / "results/ligo_synthetic.npz")
    ts_h, ys_h = ligo_synthetic_h()
    ys_t = torch.as_tensor(ys_h, device=device)
    cfg, _ = ligo_config(float(ts_h[1] - ts_h[0]))
    est = estimate_if(cfg, torch.as_tensor(ligo["H_synth_params"],
                                           device=device), standardize(ys_t))
    ifm = est["if_mean"].cpu().numpy()
    ref_if = ligo["H_synth_if_mean"]
    if_rel = float(np.max(np.abs(ifm - ref_if)) / np.max(np.abs(ref_if)))
    check(if_rel <= LIGO_IF_RTOL, f"10g LIGO: IF mean vs H_synth_if_mean "
                                  f"rel {if_rel}")
    t_if = time.perf_counter() - t0
    (opt, params, est), t_mle = timed(
        analyze_ligo, torch.as_tensor(ts_h, device=device), ys_t,
        max_iters=LIGO_MLE_ITERS)
    check(bool(torch.isfinite(est["if_mean"]).all()),
          "10g analyze_ligo: non-finite IF")
    return (f"LIGO synthetic H T={len(ys_h)} f64: estimate_if at "
            f"H_synth_params, IF mean vs committed rel {if_rel:.3g} (bound "
            f"{LIGO_IF_RTOL}), {t_if:.3f} s; analyze_ligo fit_mle capped at "
            f"{LIGO_MLE_ITERS} iterations: {int(opt.num_iters)} iterations, "
            f"nll {float(opt.fun_val):.6f}, params "
            f"{np.round(params.detach().cpu().numpy(), 4).tolist()}, "
            f"{t_mle:.3f} s")


def myotis_check(device):
    """Phase 10g in a child process: the Myotis analog's crop MYOTIS_CROP
    through ``analyze_bat_call`` (cov, cubature, d=10, float32) on the
    card, its IF RMS in the envelope core and its time per step.  Returns
    the sub-phase's text; raises SmokeFailure on a failed gate."""
    from chirpgp_tpu_torch.utils.timing import timed
    from chirpgp_tpu_torch.apps import MYOTIS, analyze_bat_call
    device = torch.device(device)
    fs, ys, freq, env = myotis_analog()
    lo, hi = MYOTIS_CROP
    yc = ys[lo:hi]
    yc = (yc - yc.mean()) / yc.std()
    core = env[lo:hi] > 0.5
    (bat, _), wall = timed(analyze_bat_call,
                           torch.as_tensor(yc, dtype=torch.float32,
                                           device=device),
                           fs, MYOTIS, form="cov")
    ifb = bat["if_mean"].double().cpu().numpy()
    rms = float(np.sqrt(np.mean((ifb[core] - freq[lo:hi][core]) ** 2)))
    check(bool(np.all(np.isfinite(ifb))) and rms < MYOTIS_RMS_HZ,
          f"10g Myotis cov f32: IF RMS {rms} Hz in the core")
    step_ms = 1e3 * wall / (hi - lo)
    return (f"Myotis analog cov f32 samples {lo}:{hi} (cut from "
            f"{MYOTIS_FULL}; core {int(core.sum())} samples): IF RMS "
            f"{rms:.4f} Hz (bound {MYOTIS_RMS_HZ}), filter+smoother "
            f"{wall:.3f} s = {step_ms:.4f} ms per step with the card "
            f"shared, reckoned {step_ms * MYOTIS_FULL / 1e3:.1f} s for the "
            f"{MYOTIS_FULL}-sample record")


def crlb_chunk(device):
    """10a's simulated CRLB chunk, float32: (params, Xi, m0, rule, ys, xs)."""
    from chirpgp_tpu_torch.apps.crlb import _reference_sim_setup, _simulate
    from chirpgp_tpu_torch.quad import gauss_hermite
    lam, b, delta, ell, sigma, Xi = CRLB_ARGS
    trans, m0, P0, H, chol_P0, chol_Q = _reference_sim_setup(
        lam, b, delta, ell, sigma, CRLB_DT, torch.float32, device)
    gen = torch.Generator(device=device).manual_seed(10)
    z = [torch.randn(shape, generator=gen, device=device)
         for shape in ((CRLB_CHUNK, 4), (CRLB_CHUNK, CRLB_T, 4),
                       (CRLB_CHUNK, CRLB_T))]
    with torch.no_grad():
        _, xs, ys = _simulate(trans, m0, chol_P0, chol_Q, H, math.sqrt(Xi),
                              CRLB_DT, *z)
    return (lam, b, delta, ell, sigma, 0.0), Xi, m0, gauss_hermite(4, 3), ys, xs


def crlb_bare_launches(device):
    """10a's bare launches of the kernel on the CRLB chunk and on the last,
    shorter chunk, {lanes: CUDA-event ms}, timed before the lanes start."""
    from chirpgp_tpu_torch.ops.chirp_filter import kernel_launcher
    params, Xi, m0, gh3, ys, _ = crlb_chunk(device)
    n_last = CRLB_N - (CRLB_LAUNCHES - 1) * CRLB_CHUNK
    ms = {}
    for n in (CRLB_CHUNK, n_last):
        launch, _ = kernel_launcher(params, Xi, CRLB_DT, gh3, ys[:n], m0=m0)
        ms[n] = event_ms(launch)
    return ms


def phase_analysis(device, smi, crlb_ms):
    """10a the kernel against its plain version on one CRLB chunk (its bare
    launches ``crlb_ms`` timed by ``crlb_bare_launches``), 10b the
    1e6-trajectory filter-error Monte Carlo through the kernel, 10c the
    EKF's, 10d the PCRLB, 10e the FHC columns, 10f the fastF0NLS columns
    (host, child process), 10g the real-data pipelines on synthetic
    records (two child processes on the card, from the end of 10a)."""
    from chirpgp_tpu_torch.utils.timing import timed
    import concurrent.futures
    import multiprocessing
    from chirpgp_tpu_torch.apps import (
        filter_error_mc_chunked, pcrlb_chirp_mc)
    from chirpgp_tpu_torch.baselines import (
        fhc_pitch_track_batch, force_odd, median_smooth)
    from chirpgp_tpu_torch.ops.chirp_filter import (
        ghfs_chirp_filter, ghfs_chirp_filter_reference)
    from chirpgp_tpu_torch.toymodels import meow_freq
    spawn = multiprocessing.get_context("spawn")
    out = {}
    t_phase = t_sub = time.perf_counter()

    def say(line):
        """Print a sub-phase's line with its seconds and this process's
        peak of reserved card memory, as it ends, and give its cached
        blocks back to the card."""
        nonlocal t_sub
        now = time.perf_counter()
        print(f"phase {line} ({now - t_sub:.3f} s; peak reserved "
              f"{torch.cuda.max_memory_reserved(device) / 2 ** 30:.2f} GiB)"
              if device.type == "cuda" else
              f"phase {line} ({now - t_sub:.3f} s)", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        t_sub = now

    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=spawn) as host, \
            concurrent.futures.ProcessPoolExecutor(
                2, mp_context=spawn) as real:
        nls_fut = host.submit(fastnls_columns, NLS_SEEDS)

        # 10a: one simulated CRLB chunk, the kernel against plain.
        params, Xi, m0, gh3, ys, xs = crlb_chunk(device)
        kern, plain, sums, plain_s = {}, {}, {}, {}
        for y in (ys.double(), ys):
            tag = str(y.dtype)[6:]
            args = (params, Xi, CRLB_DT, gh3, y)
            kern[tag] = ghfs_chirp_filter(*args, m0=m0)
            plain[tag], plain_s[tag] = timed(ghfs_chirp_filter_reference,
                                             *args, m0=m0)
            for name, out_ in (("kernel", kern[tag]), ("plain", plain[tag])):
                mfs = out_[0].permute(2, 0, 1).double()
                sums[name, tag] = torch.stack(
                    [((mfs[..., i] - xs[..., i].double()) ** 2).sum(0)
                     for i in (1, 2)])
        a_parts = []
        for tag in ("float64", "float32"):
            dev = deviations(kern[tag], plain[tag])
            scaled = (dev["mfs"] / (1.0 + dev["scale_mfs"]),
                      dev["LLT"] / (1.0 + dev["scale_LLT"]),
                      dev["nll_last_rel"])
            if tag == "float64":
                for key, val, bound in zip(("mfs", "LLT", "nll[-1]"), scaled,
                                           FULL_BOUNDS[tag]):
                    check(val <= bound, f"10a f64: scaled |d {key}| {val} > "
                                        f"{bound}")
            a_parts.append(f"{tag} kernel vs plain: scaled |d mfs| "
                           f"{scaled[0]:.3g}, |d LLT| {scaled[1]:.3g}, rel|d "
                           f"nll[-1]| {scaled[2]:.3g}")
        rel = {}
        for name in ("kernel", "plain"):
            rel[name] = float(((sums[name, "float32"] - sums["kernel",
                                                              "float64"])
                               .abs() / sums["kernel", "float64"]).max())
        sum_rel = float(((sums["kernel", "float32"] - sums["plain",
                                                           "float32"]).abs()
                         / sums["plain", "float32"]).max())
        check(sum_rel <= CRLB_SUM_RTOL,
              f"10a: per-step error sums kernel vs plain rel {sum_rel} > "
              f"{CRLB_SUM_RTOL}")
        n_last = CRLB_N - (CRLB_LAUNCHES - 1) * CRLB_CHUNK
        ms = crlb_ms
        flop, nbytes, bound, bound_by = bound_ms(gh3.n_points, CRLB_T,
                                                 CRLB_CHUNK, torch.float32)
        out.update(ms_crlb_chunk=ms[CRLB_CHUNK], bound_ms_crlb_chunk=bound)
        del kern, plain, xs, ys
        say(
            f"10a CRLB chunk B={CRLB_CHUNK} T={CRLB_T} GH-3 m0=[0,1,0,0]: "
            + "; ".join(a_parts) + f" (f64 bounds {FULL_BOUNDS['float64']});"
            f" f32 per-step error sums (x2, V) kernel vs plain rel "
            f"{sum_rel:.3g} (bound {CRLB_SUM_RTOL}), kernel / plain vs the "
            f"f64 kernel {rel['kernel']:.3g} / {rel['plain']:.3g}; bare "
            f"launch f32 (CUDA events, before the lanes) "
            f"{ms[CRLB_CHUNK]!r} ms (B={n_last}: {ms[n_last]!r} ms), {flop} "
            f"flop, {nbytes} B, bound {bound!r} ms ({bound_by}), share "
            f"{bound / ms[CRLB_CHUNK]:.4f}; plain version f32 "
            f"{1e3 * plain_s['float32']:.1f} ms, f64 "
            f"{1e3 * plain_s['float64']:.1f} ms (host clock)")

        # 10g runs in two child processes on the card from here on, beside
        # 10b-10e.
        ligo_fut = real.submit(ligo_check, str(device))
        myotis_fut = real.submit(myotis_check, str(device))

        # 10b: the paper's 1e6 trajectories through the kernel, float32, and
        # the float64 kernel on the same normals, the oracle.
        draws = crlb_draws(CRLB_SEED, device)
        ghfs_chirp_filter.launches = 0
        res_ghf, t_ghf = timed(filter_error_mc_chunked, *CRLB_ARGS, CRLB_N,
                               method="ghf", dt=CRLB_DT, T=CRLB_T,
                               chunk=CRLB_CHUNK, device=device, draws=draws)
        launches = ghfs_chirp_filter.launches
        check(launches == CRLB_LAUNCHES,
              f"10b: {launches} kernel launches, want {CRLB_LAUNCHES}")
        out["launches_crlb"] = launches
        res_64, t_64 = timed(filter_error_mc_chunked, *CRLB_ARGS, CRLB_N,
                             method="ghf", dt=CRLB_DT, T=CRLB_T,
                             chunk=CRLB_CHUNK, dtype=torch.float64,
                             device=device, draws=draws)
        kernel_s = 1e-3 * ((CRLB_LAUNCHES - 1) * ms[CRLB_CHUNK] + ms[n_last])
        b_parts = []
        for comp in ("x2", "v"):
            a, o = res_ghf[f"mean_err_{comp}"], res_64[f"mean_err_{comp}"]
            step_rel = float(np.max(np.abs(a - o) / o))
            check(step_rel <= CRLB_F32_RTOL,
                  f"10b {comp}: float32 vs float64 mean error per step rel "
                  f"{step_rel} > {CRLB_F32_RTOL}")
            b_parts.append(f"{comp} f32 vs f64 same normals: max rel per "
                           f"step {step_rel:.3g}")
        ref_path = ROOT / "results/crlb_ghf_lam0.1_b0.1.npz"
        for tag, res in (("f32", res_ghf), ("f64", res_64)):
            held = crlb_vs_reference(res, ref_path, CRLB_N)
            for comp, (rel, zmax) in held.items():
                rel_max, z_max = CRLB_GHF_REF[comp]
                check(rel <= rel_max and zmax <= z_max,
                      f"10b {tag} {comp}: time-averaged mean error rel {rel} "
                      f"(bound {rel_max}), max |z| {zmax} (bound {z_max}) "
                      f"against the committed file")
                b_parts.append(f"{tag} {comp} vs committed: time-averaged "
                               f"rel {rel:.4g}, max|z| {zmax:.3f}")
        say(
            f"10b filter_error_mc_chunked ghf N={CRLB_N} T={CRLB_T} through "
            f"the kernel: f32 {t_ghf:.3f} s = {CRLB_N * CRLB_T / t_ghf:.1f} "
            f"filter steps/s, kernel launches {launches}, kernel share "
            f"{kernel_s / t_ghf:.4f} (bare-launch times of 10a); f64 "
            f"{t_64:.3f} s; " + "; ".join(b_parts)
            + f"; time-averaged mean error x2 {float(res_ghf['mean_err_x2'].mean())!r}"
            f", v {float(res_ghf['mean_err_v'].mean())!r} (committed "
            f"{float(np.load(ref_path)['mean_err_x2'].mean())!r}, "
            f"{float(np.load(ref_path)['mean_err_v'].mean())!r})")

        # 10c, 10d and 10e hold most of this phase's card memory: in
        # one memory turn.
        with memory_turn(device):
            # 10c: the EKF through the vmap backend, N cut.
            res_ekf, t_ekf = timed(filter_error_mc_chunked, *CRLB_ARGS,
                                   CRLB_EKF_N, method="ekf", dt=CRLB_DT,
                                   T=CRLB_T, chunk=CRLB_CHUNK, device=device)
            held = crlb_vs_reference(res_ekf, ROOT / "results/crlb_ekf_lam0.1_"
                                     "b0.1.npz", CRLB_EKF_N)
            for comp, (rel, zmax) in held.items():
                check(zmax <= CRLB_Z_MAX, f"10c {comp}: max |z| {zmax} > "
                                          f"{CRLB_Z_MAX}")
            say(
                f"10c filter_error_mc_chunked ekf (vmap) N={CRLB_EKF_N} (cut from "
                f"{CRLB_N}): {t_ekf:.3f} s; vs crlb_ekf_lam0.1_b0.1.npz: "
                + ", ".join(f"{c} mean rel {r:.4g} max|z| {zm:.3f}"
                            for c, (r, zm) in held.items()))

            # 10d: the PCRLB, float64 and float32 on the same draws.
            t0 = time.perf_counter()
            gen = torch.Generator(device=device).manual_seed(666)
            z = tuple(torch.randn(shape, generator=gen, dtype=torch.float64,
                                  device=device)
                      for shape in ((PCRLB_N, 4), (PCRLB_N, CRLB_T, 4),
                                    (PCRLB_N, CRLB_T)))
            pc, pc_s = {}, {}
            for dtype in (torch.float64, torch.float32):
                pc[dtype], pc_s[dtype] = timed(
                    pcrlb_chirp_mc, *CRLB_ARGS, num_mcs=PCRLB_N, dt=CRLB_DT,
                    T=CRLB_T, dtype=dtype, device=device,
                    draws=lambda _i, _n: z)
            del z
            committed = np.load(ROOT / "results/crlb_ghf_lam0.1_b0.1.npz")
            d_parts = []
            for comp in ("x2", "v"):
                p64, p32 = pc[torch.float64][f"pcrlb_{comp}"], \
                    pc[torch.float32][f"pcrlb_{comp}"]
                check(bool(np.all(p64 > 0)), f"10d: float64 pcrlb_{comp} not "
                                             f"positive at every step")
                rel = float(np.max(np.abs(p32 - p64) / p64))
                check(rel <= PCRLB_F32_RTOL, f"10d: float32 pcrlb_{comp} vs "
                                             f"float64 rel {rel}")
                above = float(np.mean(res_ghf[f"mean_err_{comp}"] > p64))
                d_parts.append(
                    f"{comp}: f64 min {p64.min():.6g}, step 0 {p64[0]:.6g}, "
                    f"f32 vs f64 max rel {rel:.4g}, 10b's mean error above the "
                    f"f64 bound at {above:.4f} of the steps, committed overlay "
                    f"negative at {int(np.sum(committed[f'pcrlb_{comp}'] < 0))} "
                    f"of {CRLB_T} steps")
            say(f"10d pcrlb_chirp_mc N={PCRLB_N} T={CRLB_T}: f64 "
                         f"{pc_s[torch.float64]:.3f} s, f32 "
                         f"{pc_s[torch.float32]:.3f} s; " + "; ".join(d_parts))

            # 10e: the FHC columns on the card.
            freq, _ = meow_freq(offset=8.0)
            e_parts = []
            for K, prefix, col in ((1, "", "fhc"), (3, "h3_", "harmonic_fhc")):
                ys, _ = sweep_data(device, slice(0, FHC_SEEDS), SWEEP_T, prefix)
                torch.cuda.reset_peak_memory_stats(device)
                (times, f0), secs = timed(fhc_pitch_track_batch, ys, 1.0 / DT, K,
                                          window_length=300, window_overlap=295)
                peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
                tf = freq(torch.as_tensor(times)).numpy()
                rm = np.array([np.sqrt(np.mean((median_smooth(
                    f, force_odd(round(300 / 10))) - tf) ** 2)) for f in f0])
                want = np.concatenate([np.load(ROOT / f"results/{col}_{m}.npz")[
                    "rmse"][:FHC_SEEDS] for m in MAGNITUDES])
                rel = np.abs(rm / want - 1.0)
                med = float(np.median(rm / want))
                q = float(np.quantile(rel, FHC_QUANTILE))
                check(bool(np.all(np.isfinite(rm))) and q <= FHC_SEED_RTOL
                      and abs(med - 1.0) <= FHC_MEDIAN_RTOL,
                      f"10e {col}: per-seed rel {FHC_QUANTILE} quantile {q} "
                      f"(bound {FHC_SEED_RTOL}), median ratio {med} (bound "
                      f"{FHC_MEDIAN_RTOL})")
                worst = np.argsort(-rel)[:3]
                e_parts.append(
                    f"{col} B={ys.shape[0]} T={SWEEP_T}: {secs:.3f} s, peak "
                    f"{peak:.2f} GiB, per-seed rel vs committed median "
                    f"{np.median(rel):.4g}, {FHC_QUANTILE} quantile {q:.4g}, "
                    f"max {rel.max():.4g}, worst seeds (record, rmse, committed) "
                    + ", ".join(f"({int(i)}, {rm[i]:.4f}, {want[i]:.4f})"
                                for i in worst)
                    + f"; median ratio {med:.5f}, median rmse {np.median(rm):.5f}")
                del ys
            say("10e FHC columns on the card, f32: " + "; ".join(e_parts))

        # 10g: the real-data pipelines, from the child processes.
        ligo_line = ligo_fut.result()
        myotis_line = myotis_fut.result()
        say(f"10g real data on synthetic stand-ins, in two child processes "
            f"on the card beside 10b-10e: {ligo_line}; {myotis_line}")

        # 10f: the fastF0NLS columns from the child process.
        nls, per_rec, build = nls_fut.result()
        f_parts = []
        for col, (rm, want) in nls.items():
            rel = float(np.max(np.abs(rm / want - 1.0)))
            check(rel <= NLS_RTOL, f"10f {col}: rel {rel} > {NLS_RTOL}")
            f_parts.append(f"{col} rel {rel:.3g}")
        say(f"10f fastF0NLS columns on the host CPU, a child process (g++ "
            f"build {build:.2f} s; its time runs beside 10a-10g), "
            f"{NLS_SEEDS} seeds per magnitude: " + ", ".join(
                f"K={K} {s:.3f} s per record, reckoned {300 * s:.1f} s per "
                f"300-record column" for K, s in per_rec.items())
            + f"; vs the committed columns (bound {NLS_RTOL}): "
            + ", ".join(f_parts))
    print(f"phase 10 the paper's analysis and the last baselines: "
          f"{time.perf_counter() - t_phase:.3f} s; {smi}", flush=True)
    return out


def chirp_record(dtype, device):
    """Phase 11b's model and record: the chirp model at SMALL_PARAMS and
    seed 0 of toydata_const at T=3141, in ``dtype`` on ``device``."""
    from chirpgp_tpu_torch.models import build_chirp_model
    pack = build_chirp_model(torch.tensor(SMALL_PARAMS, dtype=dtype,
                                          device=device))
    ys = np.load(ROOT / "results/data/toydata_const.npz")["ys"][0, :T_FULL]
    return pack, torch.as_tensor(ys, dtype=dtype, device=device)


def m32_model(dt, dtype, device):
    """The M32 model of phases 11 and 12 (ell = sigma = 1): F, Sigma, H,
    m0, P0 in ``dtype`` on ``device``."""
    from chirpgp_tpu_torch.models import m32_solution, stationary_cov_m32
    F, Sigma = m32_solution(1.0, 1.0, dt)
    return [torch.as_tensor(x, dtype=dtype, device=device) for x in (
        F, Sigma, [1.0, 0.0], [0.0, 0.0], stationary_cov_m32(1.0, 1.0))]


def lgssm_record(device, T=100):
    """11c's LGSSM: the M32 model at dt=0.01, float64, and T measurements
    (Xi=0.1) of a path simulated from ``default_rng(7)``."""
    F, Sigma, H, m0, P0 = m32_model(0.01, torch.float64, device)
    rng = np.random.default_rng(7)
    Lq = np.linalg.cholesky(Sigma.cpu().numpy())
    x, xs = np.zeros(2), []
    for _ in range(T):
        x = F.cpu().numpy() @ x + Lq @ rng.standard_normal(2)
        xs.append(x[0])
    ys = torch.as_tensor(np.array(xs) + math.sqrt(XI)
                         * rng.standard_normal(T), device=device)
    return (F, Sigma, H, m0, P0), ys


def sequential_chirp_smoother(device):
    """11b's baseline, the sequential sgp_filter + sgp_smoother on the chirp
    record (f32, GH-3) on ``device``, for a child process: the smoothed V
    means (host NumPy), the final NLL and the seconds."""
    from chirpgp_tpu_torch.infer import sgp_filter, sgp_smoother
    from chirpgp_tpu_torch.quad import gauss_hermite
    from chirpgp_tpu_torch.utils.timing import timed
    rule = gauss_hermite(4, 3)
    pack, ys = chirp_record(torch.float32, torch.device(device))

    def seq():
        mfs, Pfs, nll = sgp_filter(pack.m_and_cov, rule, pack.H, XI, pack.m0,
                                   pack.P0, DT, ys)
        return sgp_smoother(pack.m_and_cov, rule, mfs, Pfs, DT)[0], nll

    (mss, nll), t_seq = timed(seq)
    return mss[:, 2].double().cpu().numpy(), float(nll[-1]), t_seq


def phase_parallel_posterior(device, smi):
    """11a the associative-scan KF/RTS, 11b the iterated parallel
    sigma-point smoother, 11c the bootstrap particle filter, 11d NUTS and
    the hyperparameter posterior."""
    import concurrent.futures
    import multiprocessing
    from unittest import mock
    import chirpgp_tpu_torch.infer.nuts as nuts_module
    from chirpgp_tpu_torch.apps import (
        IFEstimationConfig, make_logposterior, sample_hyperposterior, smc_nll)
    from chirpgp_tpu_torch.fit import batched_value_and_grad
    from chirpgp_tpu_torch.infer import (
        bootstrap_filter, kf, kf_rts_parallel, nuts_sample,
        psgp_filter_smoother, rts)
    from chirpgp_tpu_torch.models import disc_m32, g
    from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
    from chirpgp_tpu_torch.quad import gauss_hermite
    from chirpgp_tpu_torch.utils import rmse
    from chirpgp_tpu_torch.utils.timing import profile_device, timed
    t_phase = t_sub = time.perf_counter()
    ghfs_chirp_filter.launches = 0
    # 11b's sequential baseline runs in a child process on the same card
    # beside 11a (inline it took 16-29 s; cut for phase 12).
    baseline = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    seq_future = baseline.submit(sequential_chirp_smoother, str(device))

    def say(line):
        nonlocal t_sub
        now = time.perf_counter()
        print(f"phase {line} ({now - t_sub:.3f} s; {smi})", flush=True)
        t_sub = now

    def m32(dt, dtype):
        return m32_model(dt, dtype, device)

    def profiled(fn, T):
        """Launches per call and the device's busy share, two more calls."""
        prof = profile_device(fn)
        return (f"{prof.launches} launches ({prof.launches / T:.2f} per "
                f"step), device busy {100 * prof.busy:.1f}% of "
                f"{1e3 * prof.wall_s:.1f} ms (profiled: "
                f"{1e3 * prof.profiled_wall_s:.1f} ms)")

    # 11a: the parallel KF/RTS at bench.py's configuration.
    ref = np.load(ROOT / "results/data/parallel_kf_ref.npz")
    F, Sigma, H, m0, P0 = m32(DT, torch.float32)
    parts = []
    for T in PKF_T:
        ys = torch.as_tensor(ref[f"ys_T{T}"], device=device)
        truth = ref[f"mss_T{T}"]
        scale = float(np.abs(truth).max())
        paths = {"flat": None, **{f"blocked{b}": b for b in PKF_BLOCKS}}
        if T == PKF_T[0]:
            def seq(ys_):
                mfs, Pfs, _ = kf(F, Sigma, H, XI, m0, P0, ys_)
                return rts(F, Sigma, mfs, Pfs)
            mss, t_seq = timed(seq, ys)
            err = float(np.abs(mss[0].double().cpu().numpy() - truth).max())
            check(err <= PKF_TOL * scale,
                  f"11a seq T={T}: max |mss - truth| {err} > {PKF_TOL} x "
                  f"{scale}")
            prof = profiled(lambda: seq(ys[:PKF_PROFILE_T]), PKF_PROFILE_T)
            parts.append(f"T={T} sequential kf+rts {t_seq:.3f} s = "
                         f"{T / t_seq:.1f} steps/s, err {err:.3g} ({prof} "
                         f"at T={PKF_PROFILE_T})")
        for name, bs in paths.items():
            def par(ys_, bs=bs):
                return kf_rts_parallel(F, Sigma, H, XI, m0, P0, ys_,
                                       block_size=bs)
            par(ys)
            out, t_par = timed(par, ys)
            err = float(np.abs(out[3].double().cpu().numpy() - truth).max())
            check(bool(all(torch.isfinite(x).all() for x in out))
                  and err <= PKF_TOL * scale,
                  f"11a {name} T={T}: max |mss - truth| {err} > {PKF_TOL} x "
                  f"{scale}")
            parts.append(f"T={T} {name} {1e3 * t_par:.3f} ms = "
                         f"{T / t_par:.1f} steps/s, err {err:.3g} "
                         f"({profiled(lambda: par(ys), T)})")
    ys = torch.as_tensor(ref["ys_T3141"], dtype=torch.float64, device=device)
    out64, t64 = timed(kf_rts_parallel, *m32(DT, torch.float64)[:3], XI,
                       *m32(DT, torch.float64)[3:], ys)
    err64 = float(np.abs(out64[3].cpu().numpy() - ref["mss_T3141"]).max())
    check(err64 <= PKF_F64_ATOL, f"11a flat float64: max |mss - truth| "
                                 f"{err64} > {PKF_F64_ATOL}")
    say(f"11a parallel KF/RTS, M32 f32, max |truth| {scale:.4g} at "
        f"T={PKF_T[-1]} (gate {PKF_TOL} x scale): " + "; ".join(parts)
        + f"; flat float64 T=3141 {1e3 * t64:.3f} ms, err {err64:.3g} "
        f"(gate {PKF_F64_ATOL})")

    # 11b: the iterated parallel sigma-point smoother on the chirp model.
    data = np.load(ROOT / "results/data/toydata_const.npz")
    tf = torch.as_tensor(data["true_freqs"][:T_FULL], dtype=torch.float64)
    rule = gauss_hermite(4, 3)
    pack, ys = chirp_record(torch.float32, device)

    def psgp(iters, bs=None, pack=pack, ys=ys):
        return psgp_filter_smoother(pack.m_and_cov, rule, pack.H, XI, pack.m0,
                                    pack.P0, DT, ys, num_iters=iters,
                                    block_size=bs)

    psgp(1)
    _, t_flat = timed(psgp, 1)
    _, t_blk = timed(psgp, 1, PSGP_BLOCK)
    out, t_it = timed(psgp, PSGP_ITERS)
    v_par = out[3][:, 2].double().cpu()

    v_seq, nll_seq, t_seq = seq_future.result()
    baseline.shutdown()
    v_seq = torch.as_tensor(v_seq)
    err_seq = float(rmse(tf, g(v_seq)))
    err_par = float(rmse(tf, g(v_par)))
    dv = float((v_par - v_seq).abs().max())
    check(np.isfinite(err_par) and err_par < 1.5 * err_seq + 0.2 and dv <= 0.3,
          f"11b psgp x{PSGP_ITERS}: IF RMSE {err_par} vs sequential "
          f"{err_seq}, max |dV| {dv}")
    prof = profiled(lambda: psgp(1), T_FULL)
    pack64, ys64 = chirp_record(torch.float64, device)
    card, t64 = timed(psgp, PSGP_F64_ITERS, None, pack64, ys64)
    host = psgp(PSGP_F64_ITERS, None, *chirp_record(torch.float64, "cpu"))
    dev64 = max(float((a.cpu() - b).abs().max() / b.abs().max())
                for a, b in zip(card, host))
    check(dev64 <= PSGP_F64_RTOL, f"11b psgp float64 card vs host CPU: "
                                  f"{dev64} of scale > {PSGP_F64_RTOL}")
    say(f"11b iterated parallel sigma-point smoother, chirp GH-3 f32, seed "
        f"0, T={T_FULL}: sequential sgp_filter + sgp_smoother {t_seq:.3f} s "
        f"= {T_FULL / t_seq:.1f} steps/s (in a child process beside 11a); "
        f"one iteration flat {1e3 * t_flat:.3f} ms ({T_FULL / t_flat:.1f} "
        f"steps/s; {prof}), "
        f"blocked {PSGP_BLOCK} {1e3 * t_blk:.3f} ms; {PSGP_ITERS} "
        f"iterations {t_it:.3f} s: IF RMSE {err_par:.5f} vs sequential "
        f"{err_seq:.5f} (gate < 1.5 x + 0.2), max |dV| {dv:.4f} (gate 0.3); "
        f"float64 x{PSGP_F64_ITERS} on the card {t64:.3f} s vs the host CPU "
        f"{dev64:.3g} of scale (gate {PSGP_F64_RTOL})")

    # 11c: the bootstrap particle filter.
    (F64, Sig64, H64, m064, P064), ys = lgssm_record(device)
    T = ys.shape[0]
    mfs, _, nll = kf(F64, Sig64, H64, XI, m064, P064, ys)
    gen = torch.Generator(device=device).manual_seed(8)
    res, t_lg = timed(bootstrap_filter, disc_m32(1.0, 1.0), H64, XI, m064,
                      P064, 0.01, ys, gen, num_particles=SMC_LGSSM_N)
    dml = abs(float(res.log_ml[-1]) + float(nll[-1])) / abs(float(nll[-1]))
    merr = float((res.means[:, 0] - mfs[:, 0]).abs().mean())
    ess = float(res.ess.min())
    check(dml <= 0.02 and merr < 0.05 and ess > 1.0,
          f"11c LGSSM: log-ML rel {dml}, mean error {merr}, min ESS {ess}")
    chirp_parts = []
    cfg = IFEstimationConfig()
    for dtype in (torch.float32, torch.float64):
        _, ys_c = chirp_record(dtype, device)
        gen = torch.Generator(device=device).manual_seed(0)
        (snll, sres), t_c = timed(smc_nll, cfg, torch.tensor(
            SMALL_PARAMS, dtype=dtype, device=device), ys_c, gen,
            num_particles=SMC_CHIRP_N)
        check(bool(torch.isfinite(snll)) and bool(
            torch.isfinite(sres.means).all()),
            f"11c smc_nll {dtype}: {float(snll)}")
        chirp_parts.append(f"{str(dtype)[6:]} {float(snll):.4f} in "
                           f"{t_c:.3f} s (min ESS {float(sres.ess.min()):.1f})")
    ys_p = chirp_record(torch.float32, device)[1][:PKF_PROFILE_T]
    prof = profiled(lambda: smc_nll(
        cfg, torch.tensor(SMALL_PARAMS, dtype=torch.float32, device=device),
        ys_p, torch.Generator(device=device).manual_seed(1),
        num_particles=SMC_CHIRP_N), PKF_PROFILE_T)
    say(f"11c bootstrap particle filter: M32 LGSSM T={T}, N={SMC_LGSSM_N}, "
        f"f64 {t_lg:.3f} s: log-ML {float(res.log_ml[-1]):.4f} vs -kf NLL "
        f"{-float(nll[-1]):.4f} (rel {dml:.3g}, gate 0.02), mean error "
        f"{merr:.4f} (gate 0.05), min ESS {ess:.1f}; smc_nll chirp seed 0 "
        f"T={T_FULL} N={SMC_CHIRP_N}: {', '.join(chirp_parts)}; the cov "
        f"GHFS f32 NLL at the same params {nll_seq:.4f} (11b); "
        f"{prof} at T={PKF_PROFILE_T}")

    # 11d: NUTS on the correlated Gaussian, then the hyperposterior.
    cov = torch.tensor(NUTS_COV, dtype=torch.float64, device=device)
    prec = torch.linalg.inv(cov)
    n_w, n_s = NUTS_TRANSITIONS
    gen = torch.Generator(device=device).manual_seed(0)
    res, t_g = timed(nuts_sample, lambda q: -0.5 * q @ prec @ q,
                     torch.zeros(NUTS_CHAINS, 2, dtype=torch.float64,
                                 device=device), gen, num_samples=n_s,
                     num_warmup=n_w, step_size=0.5, max_tree_depth=NUTS_DEPTH)
    pooled = res.samples.reshape(-1, 2).cpu().numpy()
    dmean = float(np.abs(pooled.mean(0)).max())
    dcov = float(np.abs(np.cov(pooled.T) - np.array(NUTS_COV)).max())
    acc = float(res.accept_prob.mean())
    ndiv = int(res.num_divergent.sum())
    check(dmean <= 0.15 and dcov <= 0.35 and acc > 0.6 and ndiv == 0,
          f"11d Gaussian: mean {dmean}, cov {dcov}, accept {acc}, "
          f"divergences {ndiv}")
    gauss = (f"Gaussian, {NUTS_CHAINS} chains, depth {NUTS_DEPTH}, {n_w} + "
             f"{n_s} transitions (cut from 100 + 100): {t_g:.3f} s = "
             f"{1e3 * t_g / (n_w + n_s):.2f} ms per transition of all "
             f"chains; pooled mean {dmean:.4f} (gate 0.15), cov {dcov:.4f} "
             f"(0.35), accept {acc:.3f} (0.6), {ndiv} divergences")

    hcfg = IFEstimationConfig(method="ghfs", form="sqrt")
    ys_all = torch.as_tensor(data["ys"][0], dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    init = hcfg.default_init_theta(torch.float32).to(device) \
        + 0.1 * torch.randn(HYPER_CHAINS, 6, generator=gen, device=device)
    vg = batched_value_and_grad(
        make_logposterior(hcfg, ys_all[:HYPER_SHORT_T]))
    vg(init)
    _, t_short = timed(vg, init)
    n_w, n_s = HYPER_TRANSITIONS
    evals = 1 + (n_w + n_s) * (2 ** HYPER_DEPTH - 1)
    T_h = int(min(T_FULL, max(HYPER_MIN_T, HYPER_SHORT_T * HYPER_BUDGET_S
                              / (evals * t_short))))
    ys_h = ys_all[:T_h]
    seen = []

    def watched(logdensity):
        """nuts_sample's batched value-and-grad, keeping every point it
        evaluates (warmup included) with its value and gradient."""
        vg_ = batched_value_and_grad(logdensity)

        def run(q):
            logp, grad = vg_(q)
            seen.append((q, logp, grad))
            return logp, grad
        return run

    with mock.patch.object(nuts_module, "batched_value_and_grad", watched):
        res, t_h = timed(sample_hyperposterior, hcfg, ys_h, gen,
                         init_theta=init, num_samples=n_s, num_warmup=n_w,
                         step_size=HYPER_STEP, max_tree_depth=HYPER_DEPTH)
    qs, logps, grads = (torch.cat(x) for x in zip(*seen))
    bad = ~(torch.isfinite(logps) & torch.isfinite(grads).all(-1))
    check(not bool(bad.any()),
          f"11d hyperposterior: {int(bad.sum())} of {len(logps)} evaluated "
          f"points have a non-finite log density or gradient, the first at "
          f"theta {qs[bad][:1].tolist()}")
    acc = float(res.accept_prob.mean())
    finite = bool(torch.isfinite(res.samples).all())
    check(finite and acc > 0.0,
          f"11d hyperposterior: finite {finite}, accept "
          f"{res.accept_prob.tolist()}, step sizes {res.step_size.tolist()}")
    logpost = make_logposterior(hcfg, ys_h)
    lane = max(abs(float(logpost(res.samples[0, k])) - float(
        res.log_densities[0, k])) / abs(float(res.log_densities[0, k]))
        for k in range(n_s))
    check(lane <= HYPER_LANE_RTOL, f"11d lane 0 vs make_logposterior alone: "
                                   f"{lane} > {HYPER_LANE_RTOL}")
    say(f"11d NUTS: {gauss}; sample_hyperposterior sqrt GHFS f32, "
        f"{HYPER_CHAINS} chains, depth {HYPER_DEPTH}, {n_w} + {n_s} "
        f"transitions, T={T_h} (cut from {T_FULL} to fit {HYPER_BUDGET_S:.0f}"
        f" s: one batched value-and-grad at T={HYPER_SHORT_T} took "
        f"{1e3 * t_short:.1f} ms, at most {evals} per run): {t_h:.3f} s, "
        f"{len(logps)} points evaluated, all finite, "
        f"accept {acc:.3f}, step sizes "
        f"{[round(float(e), 4) for e in res.step_size]}, lane 0 vs alone "
        f"{lane:.3g} (gate {HYPER_LANE_RTOL})")
    print(f"phase 11 parallel-in-time filtering and posterior inference: "
          f"{time.perf_counter() - t_phase:.3f} s; filter kernel launches "
          f"{ghfs_chirp_filter.launches} (no Pallas kernel on these paths); "
          f"{smi}", flush=True)

def shard_checks(mesh, sizes, smi, say):
    """Phase 12's checks on ``mesh`` (every rank runs them; the unsharded
    references run on rank 0).  Returns rank 0's report (and the gathered
    IF mean) with every rank's kernel launches of the sharded sweep."""
    from unittest import mock
    import chirpgp_tpu_torch.infer.nuts as nuts_module
    from chirpgp_tpu_torch.apps import (
        IFEstimationConfig, estimate_if_batched, filter_error_mc,
        generate_rnd_keys, mc_kpt_sweep, mc_mle_sweep,
        sample_hyperposterior_sharded)
    from chirpgp_tpu_torch.fit import batched_value_and_grad
    from chirpgp_tpu_torch.infer import (
        bootstrap_filter, bootstrap_filter_sharded, kf, kf_rts_parallel,
        kf_parallel_time_sharded, nuts_sample_sharded,
        rts_parallel_time_sharded)
    from chirpgp_tpu_torch.infer.nuts import NUTSDraws, nuts_draws
    from chirpgp_tpu_torch.infer.smc import SMCDraws, smc_draws
    from chirpgp_tpu_torch.models import disc_m32, g
    from chirpgp_tpu_torch.ops.chirp_filter import ghfs_chirp_filter
    from chirpgp_tpu_torch.ops.chirp_smoother import ghfs_chirp_smoother
    from chirpgp_tpu_torch.parallel.mesh import Mesh, all_reduce
    from chirpgp_tpu_torch.parallel import sharded_seed_sweep
    from chirpgp_tpu_torch.utils.timing import timed
    dev, lead = mesh.device, mesh.rank == 0
    rep = {}

    def rows(x, axis=0):
        n = x.shape[axis] // mesh.size
        return x.narrow(axis, mesh.rank * n, n)

    def barrier():
        all_reduce(torch.zeros(1, device=dev), mesh)

    def rel(a, b):
        a, b = (torch.as_tensor(x).double().cpu() for x in (a, b))
        return float((a - b).abs().max() / b.abs().max())

    # The sharded seed sweep of estimate_if_batched: the main path.
    cfg = IFEstimationConfig()
    params = g(cfg.default_init_theta()).to(torch.float32).to(dev)
    B, T = sizes["B"], sizes["T"]
    yss = measurements(B, T, 999, torch.float32, dev)
    ghfs_chirp_filter.launches = ghfs_chirp_smoother.launches = 0
    est, t_est = timed(sharded_seed_sweep, lambda y: {
        "if_mean": estimate_if_batched(cfg, params, y)["if_mean"]}, yss, mesh)
    launches = ghfs_chirp_filter.launches
    smoother_launches = ghfs_chirp_smoother.launches
    if_mean = est["if_mean"]
    check(launches == 1 and smoother_launches == 1,
          f"12 sharded sweep: rank {mesh.rank} launched the filter "
          f"{launches} and the smoother {smoother_launches} times, not once "
          f"each")
    check(tuple(if_mean.shape) == (B, T)
          and bool(torch.isfinite(if_mean).all()),
          f"12 sharded sweep: IF mean {tuple(if_mean.shape)}, not finite")
    rep["launches"], rep["smoother_launches"] = all_reduce(
        torch.tensor([launches, smoother_launches]), mesh).tolist()
    if lead:
        rep["if_mean"] = if_mean.cpu().numpy()
    say(f"sharded seed sweep of estimate_if_batched, B={B} "
        f"({B // mesh.size} lanes per rank), T={T}, GH-3 f32: "
        f"{t_est:.3f} s, filter and smoother kernel launches "
        f"{rep['launches']}, {rep['smoother_launches']} (one each per rank)")

    # The time-sharded KF/RTS on 11a's configuration.
    ref = np.load(ROOT / "results/data/parallel_kf_ref.npz")
    T = sizes["kf_T"]
    F, Sigma, H, m0, P0 = m32_model(DT, torch.float32, dev)
    ys = torch.as_tensor(ref[f"ys_T{T}"], device=dev)
    truth = ref[f"mss_T{T}"]
    scale = float(np.abs(truth).max())
    parts = []
    for name, bs in (("flat", None), (f"blocked{PKF_BLOCKS[0]}",
                                      PKF_BLOCKS[0])):
        def run(bs=bs):
            mfs, Pfs, _ = kf_parallel_time_sharded(
                F, Sigma, H, XI, m0, P0, ys, mesh, block_size=bs)
            return rts_parallel_time_sharded(F, Sigma, mfs, Pfs, mesh,
                                             block_size=bs)
        (mss, _), t_kf = timed(run)
        err = float(np.abs(mss.double().cpu().numpy() - truth).max())
        check(err <= PKF_TOL * scale, f"12 time-sharded {name} T={T}: "
                                      f"max |mss - truth| {err} > {PKF_TOL}"
                                      f" x {scale}")
        parts.append(f"{name} {1e3 * t_kf:.3f} ms, err {err:.3g}")
    m64 = m32_model(DT, torch.float64, dev)
    y64 = ys.double()
    mfs, Pfs, nll = kf_parallel_time_sharded(*m64[:3], XI, *m64[3:], y64,
                                             mesh)
    got = (mfs, Pfs, nll) + rts_parallel_time_sharded(m64[0], m64[1], mfs,
                                                      Pfs, mesh)
    want = kf_rts_parallel(*m64[:3], XI, *m64[3:], y64)
    dev64 = max(rel(a, b) for a, b in zip(got, want))
    check(dev64 <= SHARD_KF_F64_RTOL, f"12 time-sharded f64 vs unsharded: "
                                      f"{dev64} > {SHARD_KF_F64_RTOL}")
    say(f"time-sharded KF/RTS, M32 f32, T={T} ({T // mesh.size} steps per "
        f"rank; gate {PKF_TOL} x {scale:.4g}): " + "; ".join(parts)
        + f"; float64 flat vs unsharded {dev64:.3g} of scale (gate "
          f"{SHARD_KF_F64_RTOL})")

    # The particle-sharded bootstrap filter on 11c's LGSSM.
    (F, Sigma, H, m0, P0), ys = lgssm_record(dev)
    _, _, nll = kf(F, Sigma, H, XI, m0, P0, ys)
    N = sizes["smc_N"]
    args = (disc_m32(1.0, 1.0), H, XI, m0, P0, 0.01, ys)
    res, t_smc = timed(bootstrap_filter_sharded, *args,
                       torch.Generator(device=dev).manual_seed(8), mesh,
                       num_particles=N)
    dml = abs(float(res.log_ml[-1]) + float(nll[-1])) / abs(float(nll[-1]))
    check(dml <= 0.02 and bool(torch.isfinite(res.means).all()),
          f"12 bootstrap_filter_sharded: log-ML rel {dml}")
    full = smc_draws(torch.Generator(device=dev).manual_seed(9),
                     ys.shape[0], N, 2)
    mine = SMCDraws(rows(full.z0), rows(full.z, 1), full.u)
    res = bootstrap_filter_sharded(*args, None, mesh, num_particles=N,
                                   draws=mine)
    smc_dev = 0.0
    if lead:
        want = bootstrap_filter(*args, num_particles=N, draws=full)
        smc_dev = rel(res.log_ml, want.log_ml)
        check(smc_dev <= SHARD_SMC_F64_RTOL and bool(
            (want.ess < 0.5 * N).any()),
            f"12 bootstrap_filter_sharded on equal draws: log-ML "
            f"{smc_dev} > {SHARD_SMC_F64_RTOL} (or no resampling)")
    say(f"bootstrap_filter_sharded, LGSSM T={ys.shape[0]}, N={N} "
        f"({N // mesh.size} per rank), f64: {t_smc:.3f} s, log-ML rel "
        f"{dml:.3g} of -kf's (gate 0.02); on bootstrap_filter's draws "
        f"{smc_dev:.3g} (gate {SHARD_SMC_F64_RTOL})")

    # Chain-sharded NUTS on 11d's Gaussian.
    prec = torch.linalg.inv(torch.tensor(NUTS_COV, dtype=torch.float64,
                                         device=dev))

    def gauss(q):
        return -0.5 * q @ prec @ q

    C, (n_w, n_s) = sizes["nuts"]
    res, t_nuts = timed(nuts_sample_sharded, gauss,
                        torch.zeros(C, 2, dtype=torch.float64, device=dev),
                        torch.Generator(device=dev).manual_seed(0), mesh,
                        num_samples=n_s, num_warmup=n_w, step_size=0.5,
                        max_tree_depth=NUTS_DEPTH)
    pooled = res.samples.reshape(-1, 2).cpu().numpy()
    dmean = float(np.abs(pooled.mean(0)).max())
    dcov = float(np.abs(np.cov(pooled.T) - np.array(NUTS_COV)).max())
    acc = float(res.accept_prob.mean())
    ndiv = int(res.num_divergent.sum())
    one_eps = bool((res.step_size == res.step_size[0]).all())
    check(dmean <= 0.15 and dcov <= 0.35 and acc > 0.6 and ndiv == 0
          and one_eps and tuple(res.samples.shape) == (C, n_s, 2),
          f"12 nuts_sample_sharded: mean {dmean}, cov {dcov}, accept {acc},"
          f" divergences {ndiv}, one step size {one_eps}")
    c_eq, (w_eq, s_eq), depth = SHARD_NUTS_EQUAL
    inits = torch.linspace(-1.0, 1.0, 2 * c_eq, dtype=torch.float64,
                           device=dev).reshape(c_eq, 2)
    full = nuts_draws(torch.Generator(device=dev).manual_seed(1),
                      (w_eq + s_eq, c_eq), 2, depth)
    kw = dict(num_samples=s_eq, num_warmup=w_eq, step_size=0.5,
              max_tree_depth=depth)
    got = nuts_sample_sharded(gauss, inits, None, mesh, **kw,
                              draws=NUTSDraws(*(rows(x, 1) for x in full)))
    nuts_dev = 0.0
    if lead:
        want = nuts_sample_sharded(gauss, inits, None, Mesh("seeds", 1, 0,
                                                            dev),
                                   **kw, draws=full)
        nuts_dev = max(rel(a, b) for a, b in zip(
            (got.samples, got.step_size), (want.samples, want.step_size)))
        check(nuts_dev <= SHARD_NUTS_F64_RTOL,
              f"12 nuts_sample_sharded vs one rank: {nuts_dev} > "
              f"{SHARD_NUTS_F64_RTOL}")
    say(f"nuts_sample_sharded, Gaussian, {C} chains ({C // mesh.size} per "
        f"rank), depth {NUTS_DEPTH}, {n_w} + {n_s} transitions: "
        f"{t_nuts:.3f} s; pooled mean {dmean:.4f} (gate 0.15), cov "
        f"{dcov:.4f} (0.35), accept {acc:.3f} (0.6), {ndiv} divergences, "
        f"one step size {float(res.step_size[0]):.4f}; f64 {c_eq} chains "
        f"on equal draws vs a one-rank mesh {nuts_dev:.3g} (gate "
        f"{SHARD_NUTS_F64_RTOL})")

    # The chain-sharded hyperposterior.
    chains, T_h = sizes["hyper_chains"], SHARD_HYPER_T
    h_w, h_s = SHARD_HYPER_TRANSITIONS
    hcfg = IFEstimationConfig(method="ghfs", form="sqrt")
    ys_h = torch.as_tensor(np.load(ROOT / "results/data/toydata_const.npz")
                           ["ys"][0, :T_h], dtype=torch.float32, device=dev)
    seen = []

    def watched(logdensity):
        vg_ = batched_value_and_grad(logdensity)

        def run(q):
            logp, grad = vg_(q)
            seen.append((logp, grad))
            return logp, grad
        return run

    with mock.patch.object(nuts_module, "batched_value_and_grad", watched):
        res, t_h = timed(sample_hyperposterior_sharded, hcfg, ys_h,
                         torch.Generator(device=dev).manual_seed(3), mesh,
                         chains, num_samples=h_s, num_warmup=h_w,
                         step_size=HYPER_STEP, max_tree_depth=HYPER_DEPTH)
    logps, grads = (torch.cat(x) for x in zip(*seen))
    bad = int((~(torch.isfinite(logps) & torch.isfinite(grads).all(-1)))
              .sum())
    check(bad == 0 and bool(torch.isfinite(res.samples).all())
          and tuple(res.samples.shape) == (chains, h_s, 6),
          f"12 sample_hyperposterior_sharded: {bad} of {len(logps)} "
          f"evaluated points not finite")
    say(f"sample_hyperposterior_sharded, sqrt GHFS f32, {chains} chains, "
        f"T={T_h} (cut from {T_FULL}), depth {HYPER_DEPTH}, {h_w} + {h_s} "
        f"transitions: {t_h:.3f} s, {len(logps)} points evaluated on this "
        f"rank, all finite")

    # The mesh arguments of the sweeps and of the filter-error Monte Carlo.
    b_sw, t_sw, it_sw = sizes["sweep"]
    keys = generate_rnd_keys(b_sw)
    scfg = IFEstimationConfig(method="ekfs", max_iters=it_sw)
    calls = {
        "mc_mle_sweep": lambda m, d: mc_mle_sweep(
            scfg, keys, "random", T=t_sw, mesh=m, device=d),
        "mc_kpt_sweep": lambda m, d: mc_kpt_sweep(
            keys, "damped", T=t_sw, max_iters=it_sw, mesh=m, stepped=False,
            device=d)}
    parts = []
    for name, call in calls.items():
        got, t_sh = timed(call, mesh, dev)
        if lead:
            want, t_un = timed(call, None, dev)
            ok = bool((got["success"] == want["success"]).all()) and all(
                np.allclose(got[k], want[k], rtol=SHARD_SWEEP_RTOL,
                            atol=SHARD_SWEEP_ATOL, equal_nan=True)
                for k in ("rmse", "params"))
            check(ok, f"12 {name}(mesh) vs mesh=None: {got} vs {want}")
            parts.append(f"{name} {t_sh:.3f} s sharded, {t_un:.3f} s "
                         f"unsharded, equal")
    N = sizes["crlb_N"]
    crlb = dict(method="ghf", dt=CRLB_DT, T=CRLB_T)
    got, t_sh = timed(filter_error_mc, *CRLB_ARGS, N, mesh=mesh, **crlb)
    if lead:
        want, t_un = timed(filter_error_mc, *CRLB_ARGS, N, device=dev,
                           **crlb)
        crlb_dev = max(rel(got[k], want[k]) for k in want)
        check(crlb_dev <= SHARD_CRLB_RTOL,
              f"12 filter_error_mc(mesh) vs mesh=None: {crlb_dev} > "
              f"{SHARD_CRLB_RTOL}")
        parts.append(f"filter_error_mc GHF f64 N={N}, T={CRLB_T}: "
                     f"{t_sh:.3f} s sharded, {t_un:.3f} s unsharded, "
                     f"{crlb_dev:.3g} of scale (gate {SHARD_CRLB_RTOL})")
    barrier()
    say(f"mesh arguments, B={b_sw}, T={t_sw}, {it_sw} iterations "
        f"(rtol {SHARD_SWEEP_RTOL}, atol {SHARD_SWEEP_ATOL}): "
        + "; ".join(parts))
    return rep


def _shard_rank(rank, port, device, sizes, smi, queue):
    """One spawned rank of 12b: the gloo process group, phase 12's checks
    on the mesh of all ranks, rank 0's report to ``queue``."""
    import datetime
    import torch.distributed as dist
    from chirpgp_tpu_torch.parallel import make_mesh
    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}",
        world_size=SHARD_RANKS, rank=rank,
        timeout=datetime.timedelta(seconds=SHARD_PG_TIMEOUT_S))
    try:
        mesh = make_mesh(SHARD_RANKS, device=device)
        t_sub = time.perf_counter()

        def say(line):
            nonlocal t_sub
            now = time.perf_counter()
            if rank == 0:
                print(f"phase 12b {line} ({now - t_sub:.3f} s; {smi})",
                      flush=True)
            t_sub = now

        queue.put((rank, shard_checks(mesh, sizes, smi, say)))
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def shard_bare_launch(device):
    """12b's bare launch of the kernel on rank 0's share of the sharded
    sweep (its first B / SHARD_RANKS records), timed before the lanes
    start: (CUDA-event ms, bound ms, bound by)."""
    from chirpgp_tpu_torch.apps import IFEstimationConfig
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.ops.chirp_filter import kernel_launcher
    cfg = IFEstimationConfig()
    B, T = SHARD_RANKS_SIZES["B"], SHARD_RANKS_SIZES["T"]
    local = measurements(B, T, 999, torch.float32, device)[:B // SHARD_RANKS]
    launch, _ = kernel_launcher(
        g(cfg.default_init_theta()).to(torch.float32).double(), XI, DT,
        cfg.sigma_points(), local)
    return (event_ms(launch),) + bound_ms(
        cfg.sigma_points().n_points, T, local.shape[0], torch.float32)[2:]


def phase_sharded(device, smi, if_ref, bare, backend="nccl"):
    """12a the sharded entry points on one ``backend`` rank in this
    process, 12b on SHARD_RANKS spawned gloo ranks sharing ``device``
    (the bare launch on rank 0's share, ``bare``, timed by
    ``shard_bare_launch``)."""
    import datetime
    import multiprocessing
    import queue as queue_module
    import torch.distributed as dist
    from chirpgp_tpu_torch.apps import IFEstimationConfig, estimate_if_batched
    from chirpgp_tpu_torch.models import g
    from chirpgp_tpu_torch.parallel import make_mesh
    t_phase = t_sub = time.perf_counter()

    def say(line):
        nonlocal t_sub
        now = time.perf_counter()
        print(f"phase 12a {line} ({now - t_sub:.3f} s; {smi})", flush=True)
        t_sub = now

    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=SHARD_PG_TIMEOUT_S))
    try:
        mesh = make_mesh(device=device)
        check(mesh.group is not None and mesh.size == 1,
              f"12a: {mesh} has no {backend} group")
        one = shard_checks(mesh, SHARD_ONE_RANK, smi, say)
        cfg = IFEstimationConfig()
        want = estimate_if_batched(
            cfg, g(cfg.default_init_theta()).to(torch.float32).to(device),
            measurements(SHARD_ONE_RANK["B"], SHARD_ONE_RANK["T"], 999,
                         torch.float32, device))["if_mean"]
        dev = float(np.abs(one["if_mean"] - want.cpu().numpy()).max())
        check(dev == 0.0, f"12a one-rank sweep vs estimate_if_batched: {dev}")
    finally:
        dist.destroy_process_group()
    print(f"phase 12a one {backend} rank: {time.perf_counter() - t_phase:.3f}"
          f" s, the one-rank sweep equal to estimate_if_batched bit for bit",
          flush=True)

    t_b = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_shard_rank, args=(
        r, port, str(device), SHARD_RANKS_SIZES, smi, queue))
        for r in range(SHARD_RANKS)]
    for p in procs:
        p.start()
    reports = {}
    deadline = time.monotonic() + SHARD_JOIN_S
    try:
        while len(reports) < SHARD_RANKS and time.monotonic() < deadline:
            try:
                rank, rep = queue.get(timeout=5.0)
                reports[rank] = rep
            except queue_module.Empty:
                failed = [p.exitcode for p in procs
                          if p.exitcode not in (None, 0)]
                check(not failed, f"12b: a rank exited with {failed}")
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        alive = [i for i, p in enumerate(procs) if p.is_alive()]
        for i in alive:
            procs[i].kill()
    check(not alive, f"12b: ranks {alive} hung past {SHARD_JOIN_S} s")
    codes = [p.exitcode for p in procs]
    check(codes == [0] * SHARD_RANKS and len(reports) == SHARD_RANKS,
          f"12b: exit codes {codes}, {len(reports)} reports")
    rep = reports[0]
    launches, smoother_launches = rep["launches"], rep["smoother_launches"]
    dev_if = float(np.abs(rep["if_mean"] - if_ref.cpu().numpy()).max()
                   / (1.0 + np.abs(rep["if_mean"]).max()))
    check(launches == SHARD_RANKS == smoother_launches
          and dev_if <= SHARD_IF_BOUND,
          f"12b: {launches} filter and {smoother_launches} smoother kernel "
          f"launches; gathered IF mean vs phase 3's "
          f"{dev_if} > {SHARD_IF_BOUND}")
    print(f"phase 12b {SHARD_RANKS} gloo ranks on {device}: "
          f"{time.perf_counter() - t_b:.3f} s; gathered IF mean at B="
          f"{SHARD_RANKS_SIZES['B']} vs phase 3's {dev_if:.3g} (gate "
          f"{SHARD_IF_BOUND}); filter and smoother kernel launches "
          f"{launches}, {smoother_launches}, one each per rank; the "
          f"bare launch on rank 0's share, B="
          f"{SHARD_RANKS_SIZES['B'] // SHARD_RANKS}, {bare[0]!r} ms (CUDA "
          f"events, alone before the lanes), bound {bare[1]!r} ms "
          f"({bare[2]})", flush=True)
    print(f"phase 12 scale-out: {time.perf_counter() - t_phase:.3f} s; {smi}",
          flush=True)
    return {"launches_sharded": launches,
            "smoother_launches_sharded": smoother_launches,
            "ms_sharded_b1024": bare[0], "bound_ms_sharded_b1024": bare[1]}


def kill_group(pgid: int):
    """SIGKILL every process left in the process group ``pgid``."""
    try:
        os.killpg(pgid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def run_entry(module: str, args, cwd, on_card: bool = True) -> tuple:
    """``python -m chirpgp_tpu_torch.<module> --device cuda <args>`` in a
    child process from the repository root (without ``--device`` when not
    ``on_card``: the NumPy table printer), in a session of its own whose
    process group is killed when the child ends: (stdout, seconds).  A
    nonzero exit or a hang past ENTRY_TIMEOUT_S raises SmokeFailure."""
    cmd = [sys.executable, "-m", f"chirpgp_tpu_torch.{module}",
           *(("--device", "cuda") if on_card else ()), *map(str, args)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=ENTRY_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        kill_group(proc.pid)
        stdout, _ = proc.communicate()
        raise SmokeFailure(f"13 {module}: no exit within {ENTRY_TIMEOUT_S} "
                           f"s; its output ended: {stdout[-1500:]}")
    finally:
        kill_group(proc.pid)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"13 {module} exited {proc.returncode}: {stderr[-2000:]}")
    return stdout, secs


def entry_columns(out_dir, prefix, n):
    """The three magnitude files ``{prefix}_{mag}.npz`` of a driver's run,
    each with ``n`` lanes and a finite ``rmse`` wherever ``success``."""
    cols = {}
    for mag in MAGNITUDES:
        res = np.load(Path(out_dir) / f"{prefix}_{mag}.npz")
        rmse = res["rmse"]
        ok = res["success"] if "success" in res.files else \
            np.ones_like(rmse, bool)
        check(rmse.shape == (n,) and bool(np.all(np.isfinite(rmse[ok]))),
              f"13 {prefix}_{mag}: rmse {rmse.shape}, not finite where "
              f"success")
        cols[mag] = res
    return cols


def plots_shapes(T_est):
    """The arrays of each computed figure of ``plots`` and their shapes at
    the JAX script's sizes, the estimation records at ``T_est``."""
    est = {k: (T_est,) for k in ("ts", "true_if", "if_mean", "if_lower",
                                 "if_upper")}
    return {"samples": {"ts": (3000,), "x2": (4, 3000), "if": (4, 3000)},
            "cov": {"ts": (80,), "surf": (80, 80, 2, 2)},
            "cond_cov": {"ts": (100,), "vs": (100, 2),
                         "surf": (100, 100, 2, 2)},
            "estimation": est, "estimation_harmonic": est}


def check_plots(out_dir):
    """13g's files: each figure's arrays finite and of the script's
    shapes; ``samples`` and ``cond_cov`` against the same calls on the host
    CPU here, float32; the crlb arrays equal to the committed files.
    Returns the largest deviation of each host-checked figure."""
    from chirpgp_tpu_torch.experiments import plots
    for name, shapes in plots_shapes(ENTRY_PLOTS_T).items():
        got = np.load(Path(out_dir) / f"{name}.npz")
        check(sorted(got.files) == sorted(shapes) and all(
            got[k].shape == v and bool(np.all(np.isfinite(got[k])))
            for k, v in shapes.items()),
            f"13g {name}: {[(k, got[k].shape) for k in got.files]}, want "
            f"{shapes}, finite")
    devs = {}
    for name, host in (("samples", plots.samples_arrays(device="cpu")),
                       ("cond_cov", plots.cond_cov_arrays(device="cpu"))):
        got = np.load(Path(out_dir) / f"{name}.npz")
        devs[name] = max(
            float(np.max(np.abs(got[k] - v)) / np.max(np.abs(v)))
            for k, v in host.items())
        check(devs[name] <= ENTRY_PLOTS_RTOL,
              f"13g {name}: card vs host CPU {devs[name]} > "
              f"{ENTRY_PLOTS_RTOL} of scale")
    for name, methods in (("crlb", ("ekf",)), ("crlb_ghf", ("ghf",)),
                          ("crlb_ekf", ("ekf",)),
                          ("crlb_both", ("ghf", "ekf"))):
        got = np.load(Path(out_dir) / f"{name}.npz")
        cells = 0
        for method in methods:
            for path in sorted((ROOT / "results").glob(
                    f"crlb_{method}_lam*_b*.npz")):
                want = np.load(path)
                cell = f"{method}_{path.stem.split('_', 2)[2]}"
                for k in ("mean_err_v", "pcrlb_v"):
                    if k in want.files:
                        check(np.array_equal(got[f"{cell}_{k}"], want[k]),
                              f"13g {name}: {cell}_{k} is not {path.name}'s")
                cells += 1
        check(cells == 16 * len(methods), f"13g {name}: {cells} cells")
    return devs


def check_scaling(out):
    """13h's JSON line: sizes 1, 2 and 4, one filter and one smoother
    kernel launch per rank per sweep, each size's values within
    ENTRY_SCALING_RTOL of one rank's."""
    line = json.loads(out.strip().splitlines()[-1])
    sizes = ["1", "2", "4"]
    check(line["metric"] == "mc_sweep_seeds_per_sec_scaling"
          and list(line["seeds_per_sec"]) == sizes
          and list(line["efficiency_vs_1dev"]) == sizes,
          f"13h bench_scaling: sizes {line}")
    want = {s: [SCALING_SWEEPS] * int(s) for s in sizes}
    for key in ("kernel_launches_per_rank", "smoother_launches_per_rank"):
        check(line[key] == want,
              f"13h bench_scaling: {key} {line[key]}, want {want}")
    rel = line["nell_rel_vs_1dev"]
    check(all(0.0 <= rel[s] <= ENTRY_SCALING_RTOL for s in sizes[1:]),
          f"13h bench_scaling: values vs one rank {rel} > "
          f"{ENTRY_SCALING_RTOL}")
    check(line["label"] == "contention, not scaling",
          f"13h bench_scaling: label {line['label']}")
    return line


def phase_entry_points(device, smi):
    """13a-13h: the drivers of ``chirpgp_tpu_torch/experiments`` and the
    demos of ``chirpgp_tpu_torch/demos`` in child processes on the card,
    up to ENTRY_PARALLEL at once, each checked as it ends.  Returns the
    scaling harness's kernel launches per rank and seeds per rank."""
    import concurrent.futures
    import re
    import tempfile
    from chirpgp_tpu_torch.apps import filter_error_mc_chunked
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_entry_")
    work = Path(tmp.name)
    data = work / "data"
    data.mkdir()
    for mag in MAGNITUDES:
        d = np.load(ROOT / f"results/data/toydata_{mag}.npz")
        np.savez(data / f"toydata_{mag}.npz", ys=d["ys"][:, :ENTRY_T],
                 true_freqs=d["true_freqs"][:ENTRY_T], ts=d["ts"][:ENTRY_T],
                 keys=d["keys"])
    exp, demos = "experiments.", "demos."
    sweep = ("--seeds", ENTRY_SEEDS, "--max-iters", ENTRY_ITERS)

    def table_one():
        out_a, secs_a = run_entry(exp + "run_rmse_table", (
            "--methods", "ghfs", *sweep, "--data-dir", data, "--out",
            work / "a"), ROOT)
        out_b, secs_b = run_entry(exp + "print_table", (
            "--paired", "--results", work / "a", "--reference",
            ROOT / "results/reference"), ROOT, on_card=False)
        return out_a, secs_a, out_b, secs_b

    def fhc():
        # K=3 FHC takes much of the card's memory: in a memory turn.
        with memory_turn(device):
            return run_entry(exp + "run_fhc", (
                "--seeds", ENTRY_FHC_SEEDS, "--out", work / "e"), ROOT)

    n_demo_t, n_demo_iters = ENTRY_DEMO
    # Longest first: the pool takes them in this order.
    jobs = {
        "13a": table_one,
        "13g": lambda: run_entry(exp + "plots", (
            "--save-arrays", work / "g", "--T", ENTRY_PLOTS_T), ROOT),
        "13h": lambda: run_entry(exp + "bench_scaling", (
            "--ranks", ENTRY_SCALING["ranks"], "--seeds",
            ENTRY_SCALING["seeds"], "--T", ENTRY_SCALING["T"]), ROOT),
        "13f classical_methods": lambda: run_entry(
            demos + "classical_methods", (), ROOT),
        "13d": lambda: run_entry(exp + "run_classical", (
            "--methods", "hilbert", "spectrogram", "anf", "--seeds",
            ENTRY_SEEDS, "--out", work / "d"), ROOT),
        "13e kpt": lambda: run_entry(exp + "run_kpt", (
            *sweep, "--T", ENTRY_T, "--out", work / "e"), ROOT),
        "13e fhc": fhc,
        "13e fastnls": lambda: run_entry(exp + "run_fastnls", (
            "--seeds", ENTRY_NLS_SEEDS, "--out", work / "e"), ROOT),
        "13f print_time": lambda: run_entry(exp + "print_time", (
            "--T", ENTRY_PRINT_TIME_T, "--methods", "ghfs", "ekfs"), ROOT),
        "13f ghfs_mle": lambda: run_entry(demos + "ghfs_mle", (
            "--T", n_demo_t, "--max-iters", n_demo_iters), ROOT),
        "13c": lambda: run_entry(exp + "run_crlb", (
            "-method", "ghf", "-num_mcs", ENTRY_CRLB_N, "-lam", 0.1, "-b",
            0.1, "--backend", "cf", "-out", work / "c"), ROOT),
    }
    with concurrent.futures.ThreadPoolExecutor(ENTRY_PARALLEL) as pool:
        futs = {name: pool.submit(job) for name, job in jobs.items()}
        concurrent.futures.wait(futs.values())
    failed = {name: fut.exception() for name, fut in futs.items()
              if fut.exception() is not None}
    if failed:
        print("phase 13 children: " + "; ".join(
            f"{name} {fut.result()[-1]:.3f} s" if name not in failed
            else f"{name} FAILED" for name, fut in futs.items()), flush=True)
        raise SmokeFailure("; ".join(f"{k}: {v}" for k, v in failed.items()))
    done = {name: fut.result() for name, fut in futs.items()}
    parts = []

    # 13a: three columns of 100 lanes; the sweep's stage times.
    out_a, secs_a, out_b, secs_b = done["13a"]
    entry_columns(work / "a", "ghfs", ENTRY_SEEDS)
    stages = re.findall(r"stage (.+?): ([0-9.]+) s", out_a)
    check(len(stages) == 4, f"13a: stage times {stages}")
    parts.append(
        f"13a run_rmse_table --methods ghfs B={3 * ENTRY_SEEDS}, T cut to "
        f"{ENTRY_T} on toydata_* cropped, --max-iters "
        f"{ENTRY_ITERS}: {secs_a:.3f} s; " + ", ".join(
            f"{k} {v} s" for k, v in stages))
    rows = [ln.strip() for ln in out_b.splitlines()
            if ln.startswith("ghfs ")]
    check(len(rows) == 3, f"13b print_table --paired: ghfs rows {rows}")
    parts.append(f"13b print_table --paired {secs_b:.3f} s: "
                 + "; ".join(" ".join(r.split()) for r in rows))

    # 13c: 4 launches in the child; its file against the same call here.
    out_c, secs_c = done["13c"]
    launches = re.findall(r"filter kernel launches (\d+)", out_c)
    want_launches = -(-ENTRY_CRLB_N // CRLB_CHUNK)
    check(launches == [str(want_launches)],
          f"13c run_crlb: kernel launches {launches}, want {want_launches}")
    got = np.load(work / "c" / "crlb_ghf_lam0.1_b0.1.npz")
    want = filter_error_mc_chunked(*CRLB_ARGS, ENTRY_CRLB_N, device=device)
    rel = max(float(np.max(np.abs(got[k] - v)) / float(np.max(np.abs(v))))
              for k, v in want.items())
    check(rel <= ENTRY_CRLB_RTOL, f"13c run_crlb vs in-process rel {rel}")
    parts.append(
        f"13c run_crlb N={ENTRY_CRLB_N} f32 cf {secs_c:.3f} s (its wall_s "
        f"{float(got['wall_s']):.3f} s): {launches[0]} kernel launches in the "
        f"child, its statistics vs filter_error_mc_chunked here max rel "
        f"{rel:.3g}")

    # 13d: every seed against the JAX package's committed columns.
    _, secs_d = done["13d"]
    held = []
    for name, rtol in ENTRY_CLASSICAL_RTOL.items():
        worst = 0.0
        for mag in MAGNITUDES:
            got = np.load(work / "d" / f"{name}_{mag}.npz")["rmse"]
            want = np.load(ROOT / f"results/{name}_{mag}.npz")["rmse"][
                :ENTRY_SEEDS]
            bound = ENTRY_HILBERT_RANDOM_RTOL \
                if (name, mag) == ("hilbert", "random") else rtol
            rel = float(np.max(np.abs(got - want) / want))
            check(got.shape == (ENTRY_SEEDS,) and rel <= bound,
                  f"13d {name}_{mag}: per-seed rel {rel} > {bound}")
            worst = max(worst, rel)
        held.append(f"{name} max rel {worst:.3g}")
    parts.append(f"13d run_classical B={3 * ENTRY_SEEDS} T={T_FULL} f64 on "
                 f"JAX's records {secs_d:.3f} s, per seed vs results/: "
                 + ", ".join(held))

    # 13e: the KPT, FHC and fastF0NLS drivers.
    _, secs_k = done["13e kpt"]
    entry_columns(work / "e", "kpt", ENTRY_SEEDS)
    _, secs_f = done["13e fhc"]
    gaps = []
    for mag in MAGNITUDES:
        got = np.load(work / "e" / f"harmonic_fhc_{mag}.npz")["rmse"]
        want = np.load(ROOT / f"results/harmonic_fhc_{mag}.npz")["rmse"][
            :ENTRY_FHC_SEEDS]
        gaps.append(got / want)
    gaps = np.concatenate(gaps)
    q = float(np.quantile(np.abs(gaps - 1.0), FHC_QUANTILE))
    med = float(np.median(gaps))
    check(q <= FHC_SEED_RTOL and abs(med - 1.0) <= FHC_MEDIAN_RTOL,
          f"13e run_fhc: {FHC_QUANTILE} quantile {q}, median ratio {med}")
    _, secs_n = done["13e fastnls"]
    nls = max(float(np.max(np.abs(
        np.load(work / "e" / f"fastf0nls_{mag}.npz")["rmse"]
        - np.load(ROOT / f"results/fastf0nls_{mag}.npz")["rmse"][
            :ENTRY_NLS_SEEDS]) / np.load(ROOT / f"results/fastf0nls_{mag}"
                                         f".npz")["rmse"][:ENTRY_NLS_SEEDS]))
        for mag in MAGNITUDES)
    check(nls <= ENTRY_NLS_RTOL, f"13e run_fastnls vs committed rel {nls}")
    parts.append(
        f"13e run_kpt B={3 * ENTRY_SEEDS}, T cut to "
        f"{ENTRY_T}, --max-iters {ENTRY_ITERS} {secs_k:.3f} s; run_fhc K=3 "
        f"{3 * ENTRY_FHC_SEEDS} records {secs_f:.3f} s, per seed vs committed {FHC_QUANTILE} "
        f"quantile {q:.3g}, median ratio {med:.4f}; run_fastnls "
        f"{3 * ENTRY_NLS_SEEDS} records {secs_n:.3f} s, vs committed max rel "
        f"{nls:.3g}")

    # 13f: the demos and the timing script, their numbers finite.
    demo_parts = []
    for name, pattern, n in (
            ("13f classical_methods", r"IF RMSE[^:]*: (\S+)", 4),
            ("13f ghfs_mle", r"IF RMSE: (\S+)", 3),
            ("13f print_time", r"T=\d+: best ([0-9.]+) ms", 2)):
        out, secs = done[name]
        vals = [float(v) for v in re.findall(pattern, out)]
        check(len(vals) == n and all(math.isfinite(v) for v in vals),
              f"{name}: {vals} from {out[-1000:]}")
        demo_parts.append(f"{name.split()[1]} {secs:.3f} s {vals}")
    parts.append(f"13f demos: classical_methods (T={T_FULL}); ghfs_mle (T "
                 f"cut to {n_demo_t}, --max-iters {n_demo_iters}: IF RMSE of "
                 f"const, damped, random_ou); print_time (T cut from 785 to "
                 f"{ENTRY_PRINT_TIME_T}, best ms of ghfs, ekfs): "
                 + "; ".join(demo_parts))

    # 13g: the figures' arrays; 13h: the scaling harness's JSON line.
    _, secs_g = done["13g"]
    devs = check_plots(work / "g")
    parts.append(
        f"13g plots --save-arrays, nine figures, the estimation records' T "
        f"cut from {T_FULL} to {ENTRY_PLOTS_T}: {secs_g:.3f} s; samples and "
        f"cond_cov vs the host CPU, f32, max " + ", ".join(
            f"{k} {v:.3g}" for k, v in devs.items())
        + " of scale; crlb arrays equal to results/")
    out_h, secs_h = done["13h"]
    line = check_scaling(out_h)
    parts.append(
        f"13h bench_scaling --ranks {ENTRY_SCALING['ranks']} --seeds "
        f"{ENTRY_SCALING['seeds']}, T cut from 512 to {ENTRY_SCALING['T']}: "
        f"{secs_h:.3f} s; seeds/s {line['seeds_per_sec']}, efficiency "
        f"{line['efficiency_vs_1dev']} ({line['label']}); filter kernel "
        f"launches per rank {line['kernel_launches_per_rank']}, smoother "
        f"{line['smoother_launches_per_rank']}, over {SCALING_SWEEPS} "
        f"sweeps; values vs one rank "
        f"{line['nell_rel_vs_1dev']}")
    tmp.cleanup()
    print(f"phase 13 entry points ({time.perf_counter() - t_phase:.3f} s; "
          f"{smi}; {len(jobs)} child processes, {ENTRY_PARALLEL} at once): "
          + "; ".join(parts), flush=True)
    return {"launches_scaling": line["kernel_launches_per_rank"],
            "smoother_launches_scaling": line["smoother_launches_per_rank"],
            "b_per_rank_scaling": line["seeds_per_rank"]}


PR_SET_CHILD_SUBREAPER = 36


def become_subreaper():
    """Make this process the subreaper of its descendants (Linux), so that
    a process orphaned below it is re-parented to it, not to init."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        print(f"chip_smoke: prctl(PR_SET_CHILD_SUBREAPER) failed: errno "
              f"{ctypes.get_errno()}", file=sys.stderr)


def child_pids() -> dict:
    """{pid: command line} of this process's children, from /proc."""
    me, kids = os.getpid(), {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid == me:
                with open(f"/proc/{entry}/cmdline", "rb") as f:
                    kids[int(entry)] = f.read().replace(b"\0", b" ").decode(
                        errors="replace").strip()[:120]
        except (OSError, IndexError, ValueError):
            pass
    return kids


def reap_descendants(grace_s: float = 5.0) -> list:
    """Wait up to ``grace_s`` for the children left (orphans come back as
    children of a subreaper) to exit, SIGKILL and reap the rest, then the
    same for multiprocessing's resource tracker once its pipe is closed.
    Returns the command lines of the processes it killed."""
    from multiprocessing import resource_tracker
    tracker = getattr(resource_tracker, "_resource_tracker", None)
    killed = reap_children(grace_s, keep=getattr(tracker, "_pid", None))
    if getattr(tracker, "_fd", None) is not None:
        os.close(tracker._fd)  # its end of file stops the tracker
        tracker._fd = tracker._pid = None
    return killed + reap_children(grace_s)


def reap_children(grace_s: float, keep=None) -> list:
    """Reap this process's children but ``keep`` until none is left,
    killing those still running after ``grace_s``; gives up on what
    outlives three rounds of SIGKILL."""
    def reap():
        for pid in child_pids():
            if pid != keep:
                try:
                    os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    pass

    killed, deadline, rounds = [], time.monotonic() + grace_s, 0
    while rounds < 3:
        reap()
        kids = {pid: cmd for pid, cmd in child_pids().items()
                if pid != keep and not _is_zombie(pid)}
        if not kids:
            reap()  # what exited since the last pass
            return killed
        if time.monotonic() < deadline:
            time.sleep(0.1)
            continue
        for pid, cmd in kids.items():
            try:
                os.kill(pid, signal.SIGKILL)
                killed.append(cmd)
            except ProcessLookupError:
                pass
        deadline, rounds = time.monotonic() + grace_s, rounds + 1
    return killed


def _is_zombie(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except (OSError, IndexError):
        return True


# Each phase of a lane, called with the lane's context: the device, the
# nvidia-smi line, phase 3's IF mean and time, the hoisted bare launches.
LANE_PHASES = {
    "mle": lambda c: phase_mle(c["device"]),
    "fused": lambda c: phase_fused(
        c["device"], c["if_ref"].to(c["device"]), c["t_ref"]),
    "sweep": lambda c: phase_sweep(c["device"], c["smi"], c["sweep_ms"]),
    "family": lambda c: phase_family(c["device"], c["smi"],
                                     c["lascala_ms"]),
    "table_one": lambda c: phase_table_one(c["device"], c["smi"]),
    "analysis": lambda c: phase_analysis(c["device"], c["smi"],
                                         c["crlb_ms"]),
    "parallel_posterior": lambda c: phase_parallel_posterior(c["device"],
                                                             c["smi"]),
    "sharded": lambda c: phase_sharded(
        c["device"], c["smi"], c["if_ref"].to(c["device"]), c["shard_ms"]),
    "entry_points": lambda c: phase_entry_points(c["device"], c["smi"]),
}


def lane_stamp(lane: int, name: str, t0: float, t_run: float, device,
               wait0: float) -> tuple:
    """The line that follows a lane's phase, with this process's peak of
    reserved card memory in the phase (since the phase's last reset of the
    peak; its CUDA context and its child processes not included) and the
    seconds it waited for memory turns (since ``wait0``), and the phase's
    span (name, start, end) in seconds of the run."""
    now = time.time()
    peak = (f"; this process's peak reserved memory "
            f"{torch.cuda.max_memory_reserved(device) / 2 ** 30:.2f} GiB"
            if device.type == "cuda" else "")
    waited = MEMORY_TURN["wait_s"] - wait0
    return (f"lane {lane}: {name} ran from {t0 - t_run:.1f} s to "
            f"{now - t_run:.1f} s of the run ({now - t0:.1f} s{peak}; "
            f"{waited:.1f} s waiting for memory turns)\n",
            (name, t0 - t_run, now - t_run))


class CardMemoryWatch:
    """The card's used memory, all processes together (``cudaMemGetInfo``:
    total less free), sampled every MEMORY_WATCH_S seconds on a thread of
    this process while the lanes run, so that a run that comes near the
    card's capacity says when, and beside which phases."""

    def __init__(self, device, t_run: float):
        import threading
        self.device, self.t_run = device, t_run
        self.samples, self.stop_event = [], threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="chip_smoke memory watch")
        self.total = torch.cuda.mem_get_info(device)[1]
        self.thread.start()

    def _run(self):
        while not self.stop_event.wait(MEMORY_WATCH_S):
            free, total = torch.cuda.mem_get_info(self.device)
            self.samples.append((time.time() - self.t_run, total - free))

    def report(self, spans) -> str:
        """The peak, the phases whose spans held it, the most each phase's
        span saw, and the most in each MEMORY_BIN_S of the run."""
        self.stop_event.set()
        self.thread.join()
        if not self.samples:
            return "card memory: no sample"
        gib = 2 ** 30
        t_peak, peak = max(self.samples, key=lambda s: s[1])
        during = [n for n, a, b in spans if a <= t_peak <= b]
        most = {n: max((u for t, u in self.samples if a <= t <= b),
                       default=0) for n, a, b in spans}
        bins = {}
        for t, used in self.samples:
            k = int(t // MEMORY_BIN_S)
            bins[k] = max(bins.get(k, 0), used)
        return (f"card memory while the lanes ran (all processes, sampled "
                f"every {MEMORY_WATCH_S} s): peak {peak / gib:.2f} GiB of "
                f"{self.total / gib:.2f} at {t_peak:.1f} s of the run, during "
                f"{', '.join(during) or 'no phase'}; the most in each "
                f"phase's span: " + ", ".join(
                    f"{n} {u / gib:.1f}" for n, u in most.items())
                + f" GiB; the most in each {MEMORY_BIN_S} s from "
                f"{min(bins) * MEMORY_BIN_S} s: " + " ".join(
                    f"{bins.get(k, 0) / gib:.0f}"
                    for k in range(min(bins), max(bins) + 1)) + " GiB")


def run_lane(lane: int, ctx: dict, t_run: float, queue):
    """Lane ``lane``'s phases in a spawned process, in order; each phase's
    printed lines, its result or its traceback, and its span go to
    ``queue``."""
    import io
    import traceback
    device = torch.device(ctx["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    ctx = dict(ctx, device=device)
    MEMORY_TURN["lock"] = ctx["memory_turn"]
    for name in LANES[lane]:
        t0, buf = time.time(), io.StringIO()
        wait0 = MEMORY_TURN["wait_s"]
        try:
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            with contextlib.redirect_stdout(buf):
                result = LANE_PHASES[name](ctx)
            stamp, span = lane_stamp(lane, name, t0, t_run, device, wait0)
            if device.type == "cuda":
                torch.cuda.empty_cache()
        except BaseException:
            queue.put((lane, name, buf.getvalue(), None,
                       traceback.format_exc(), None))
            raise
        queue.put((lane, name, buf.getvalue() + stamp, result, None, span))


def start_lanes(ctx: dict, t_run: float):
    """Spawn lanes 1.. of LANES on ``ctx`` (tensors on the host), with the
    lanes' lock of memory turns, which this process takes too."""
    import multiprocessing
    spawn = multiprocessing.get_context("spawn")
    queue = spawn.Queue()
    MEMORY_TURN["lock"] = spawn.Lock()
    ctx = dict(ctx, memory_turn=MEMORY_TURN["lock"])
    procs = [spawn.Process(target=run_lane, args=(lane, ctx, t_run, queue),
                           name=f"chip_smoke lane {lane}")
             for lane in range(1, len(LANES))]
    for proc in procs:
        proc.start()
    return queue, procs, {}, []


def drain_lanes(lanes, wait: bool = False) -> dict:
    """Print what the spawned lanes' phases have reported, fail on a
    phase that failed; with ``wait``, until every phase has reported and
    the lanes have exited.  Returns {phase: result} so far; the phases'
    spans go to the lanes' list of spans."""
    import queue as queue_module
    queue, procs, results, spans = lanes
    want = sum(len(names) for names in LANES[1:])
    deadline = time.monotonic() + LANE_JOIN_S
    while len(results) < want:
        try:
            lane, name, text, result, error, span = queue.get(
                timeout=5.0 if wait else 0.01)
        except queue_module.Empty:
            if not wait:
                break
            dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            check(not dead, f"a lane exited with {dead} before its phases "
                            f"reported")
            check(time.monotonic() < deadline,
                  f"the lanes reported {sorted(results)} of their phases in "
                  f"{LANE_JOIN_S} s")
            continue
        sys.stdout.write(text)
        sys.stdout.flush()
        check(error is None, f"lane {lane}, phase {name} failed:\n{error}")
        results[name] = result
        spans.append(span)
    if wait:
        for proc in procs:
            proc.join(max(1.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
        check(codes == [0] * len(procs), f"the lanes exited with {codes}")
    return results


def main() -> int:
    become_subreaper()
    try:
        return run()
    finally:
        # The lanes' lock goes first: its finalizer unlinks its semaphore,
        # which the resource tracker would otherwise unlink as it stops.
        MEMORY_TURN["lock"] = None
        killed = reap_descendants()
        if killed:
            print(f"chip_smoke: killed {len(killed)} processes left "
                  f"running: {killed}", file=sys.stderr, flush=True)


def run() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import chirpgp_tpu_torch
    except ImportError as exc:
        print(f"chip_smoke: cannot import chirpgp_tpu_torch beside this "
              f"script ({exc})", file=sys.stderr)
        return 2
    if ROOT not in Path(chirpgp_tpu_torch.__file__).resolve().parents:
        print(f"chip_smoke: chirpgp_tpu_torch was imported from "
              f"{chirpgp_tpu_torch.__file__}, not from beside this script",
              file=sys.stderr)
        return 2
    t_run = time.time()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = phase_environment(device)
    max_err, filtered = phase_kernel_vs_plain(device)
    smoother_err, smoother_plain_ms, smoother_phases = phase_smoother_vs_plain(
        device, filtered)
    launches, smoother_kernels, ms_p, if_ref, t_ref = phase_slice(device)
    timing = phase_kernel_timing(device, smi)
    smoother = phase_smoother_timing(device, smi, filtered, timing)
    del filtered
    # 2b and 3b hold the benchmark's filter and smoother outputs in both
    # dtypes at once; give their cached blocks back to the card, which the
    # later phases' child processes and ranks share.
    torch.cuda.empty_cache()
    phase_accuracy(device)
    fused_ms = phase_fused_timing(device, smi)
    # The later phases' CUDA-event times, while this process has the card
    # to itself; then the lanes.
    ctx = dict(device=str(device), smi=smi, if_ref=if_ref.cpu(), t_ref=t_ref,
               lascala_ms=lascala_bare_launches(device),
               crlb_ms=crlb_bare_launches(device),
               shard_ms=shard_bare_launch(device),
               sweep_ms=sweep_bare_launches(device, smi))
    torch.cuda.empty_cache()
    print(f"phases 5-13 in {len(LANES)} lanes from {time.time() - t_run:.1f}"
          f" s of the run: " + "; ".join(
              f"lane {i} ({'this process' if i == 0 else 'spawned'}) "
              + ", ".join(names) for i, names in enumerate(LANES)),
          flush=True)
    watch = CardMemoryWatch(device, t_run)
    lanes = start_lanes(ctx, t_run)
    spans = lanes[3]
    ctx = dict(ctx, device=device)
    results = {}
    try:
        for name in LANES[0]:
            t0, wait0 = time.time(), MEMORY_TURN["wait_s"]
            torch.cuda.reset_peak_memory_stats(device)
            results[name] = LANE_PHASES[name](ctx)
            stamp, span = lane_stamp(0, name, t0, t_run, device, wait0)
            spans.append(span)
            torch.cuda.empty_cache()
            print(stamp, end="", flush=True)
            drain_lanes(lanes)
        results.update(drain_lanes(lanes, wait=True))
    except BaseException:
        # What the other lanes have reported, and the card's memory, before
        # this failure ends the run (on standard error, which a failed
        # run's reader sees first).
        with contextlib.suppress(BaseException):
            drain_lanes(lanes)
        print(watch.report(spans), file=sys.stderr, flush=True)
        raise
    print(watch.report(spans), flush=True)
    print(f"phases 5-13 ended at {time.time() - t_run:.1f} s of the run",
          flush=True)
    fused, family, analysis, sharded, scaling, sweep = (
        results[name] for name in ("fused", "family", "analysis", "sharded",
                                   "entry_points", "sweep"))
    from chirpgp_tpu_torch.ops.chirp_smoother import BACKWARD_KERNELS
    full = timing["gh3/B=4096/f32"]
    smoother_sharded = sharded.pop("smoother_launches_sharded")
    smoother_scaling = scaling.pop("smoother_launches_scaling")
    print(json.dumps({"kernels": [{
        "name": "ghfs_chirp_filter", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches[0],
        "max_abs_err": max_err, "ms": full["ms"], "plain_ms": ms_p,
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": None, "ms_b100": timing["gh3/B=100/f32"]["ms"],
        "ms_f64": timing["gh3/B=4096/f64"]["ms"],
        "bound_ms_f64": timing["gh3/B=4096/f64"]["bound_ms"],
        "launches_lascala": family["float32"]["launches"],
        "ms_lascala_b100": family["float32"]["ms"],
        "bound_ms_lascala_b100": family["float32"]["bound_ms"],
        "plain_ms_lascala_b100": family["float32"]["plain_ms"],
        "ms_lascala_b100_f64": family["float64"]["ms"], **analysis,
        **sharded, **scaling}, {
        "name": "ghfs_chirp_smoother", "route": "cuda",
        "source": SMOOTHER_SOURCE, "replaces": SMOOTHER_REPLACES,
        "launches": launches[1], "max_abs_err": smoother_err,
        "ms": smoother["gh3/B=4096/f32"]["ms"],
        "plain_ms": smoother_plain_ms,
        "bound_ms": smoother["gh3/B=4096/f32"]["bound_ms"],
        "bound_by": smoother["gh3/B=4096/f32"]["bound_by"],
        "library_ms": None, "ms_b100": smoother["gh3/B=100/f32"]["ms"],
        "bound_ms_b100": smoother["gh3/B=100/f32"]["bound_ms"],
        "ms_f64": smoother["gh3/B=4096/f64"]["ms"],
        "bound_ms_f64": smoother["gh3/B=4096/f64"]["bound_ms"],
        "ratio_to_filter": smoother["gh3/B=4096/f32"]["ratio"],
        "ratio_to_filter_b100": smoother["gh3/B=100/f32"]["ratio"],
        "ratio_to_filter_f64": smoother["gh3/B=4096/f64"]["ratio"],
        "launches_lascala": family["float32"]["smoother_launches"],
        "launches_sharded": smoother_sharded,
        "launches_scaling": smoother_scaling}] + [{
        # Each CUDA kernel of the smoother's launch, alone.
        "name": kernel, "route": "cuda", "source": SMOOTHER_SOURCE,
        "replaces": EXPECT_REPLACES if kernel == "smoother_expect"
        else SMOOTHER_REPLACES, "launches": smoother_kernels[kernel],
        "max_abs_err": smoother_phases[kernel][0],
        "ms": smoother["gh3/B=4096/f32"]["phases"][kernel]["ms"],
        "plain_ms": smoother_phases[kernel][1],
        "bound_ms": smoother["gh3/B=4096/f32"]["phases"][kernel]["bound_ms"],
        "bound_by": smoother["gh3/B=4096/f32"]["phases"][kernel]["bound_by"],
        "library_ms": None,
        "ms_b100": smoother["gh3/B=100/f32"]["phases"][kernel]["ms"],
        "ms_f64": smoother["gh3/B=4096/f64"]["phases"][kernel]["ms"],
        **({"mufu_ms": smoother["gh3/B=4096/f32"]["phases"][kernel]["mufu_ms"]}
           if kernel == "smoother_expect" else {}),
        **({"chunks": smoother["gh3/B=4096/f32"]["chunks"],
            "chunks_b100": smoother["gh3/B=100/f32"]["chunks"],
            "ms_phase_b": smoother["gh3/B=4096/f32"]["phases"]["phase_b"]["ms"],
            "bound_ms_phase_b":
                smoother["gh3/B=4096/f32"]["phases"]["phase_b"]["bound_ms"],
            "ms_phase_b_b100":
                smoother["gh3/B=100/f32"]["phases"]["phase_b"]["ms"],
            "ms_phase_b_f64":
                smoother["gh3/B=4096/f64"]["phases"]["phase_b"]["ms"]}
           if kernel in BACKWARD_KERNELS else {})}
        for kernel in smoother_kernels] + [dict({
        # The fused filter+smoother's kernels on bench.py's slim headline
        # (6d), each timed alone (6e): F in maps mode, G slim, E.
        "name": kernel, "route": "cuda",
        "source": SMOOTHER_SOURCE if kernel == "smoother_expect_var"
        else FUSED_SOURCE, "replaces": FUSED_REPLACES[kernel],
        "launches": launches_, "max_abs_err": err, "plain_ms": plain_ms,
        "library_ms": None}, **fused_entry(fused_ms, kernel))
        for kernel, (launches_, err, plain_ms) in fused.items()]
        + list(sweep.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
