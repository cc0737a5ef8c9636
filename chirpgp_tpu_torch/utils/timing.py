"""Timing and profiling utilities (counterpart of
``chirpgp_tpu.utils.timing``): warm-up, device synchronization, repeats
with best/median statistics, and ``torch.profiler`` hooks.

PyTorch returns before the card finishes, so every timed call ends in
``torch.cuda.synchronize()`` once CUDA is in use; a run that never touched
CUDA is timed on the host clock alone.
"""

import contextlib
import os
import statistics
import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = ["TimingResult", "time_jitted", "timed", "wall_timer",
           "profile_trace", "DeviceProfile", "profile_device"]


class TimingResult(NamedTuple):
    best: float
    median: float
    times: Sequence[float]
    compile_time: float   # the warm-up call (no compile in eager PyTorch)

    def __str__(self):
        return (f"best {self.best * 1e3:.2f} ms, "
                f"median {self.median * 1e3:.2f} ms over "
                f"{len(self.times)} runs (warm-up {self.compile_time:.2f} s)")


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, **kwargs):
    """``(fn(*args, **kwargs), seconds)``, the call between two device
    synchronizations."""
    _sync()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync()
    return out, time.perf_counter() - t0


def time_jitted(fn: Callable, *args, repeats: int = 5,
                **kwargs) -> TimingResult:
    """Time ``fn(*args, **kwargs)``: one warm-up call, then ``repeats``
    timed calls, each between two device synchronizations."""
    compile_time = timed(fn, *args, **kwargs)[1]
    times = [timed(fn, *args, **kwargs)[1] for _ in range(repeats)]
    return TimingResult(best=min(times), median=statistics.median(times),
                        times=times, compile_time=compile_time)


@contextlib.contextmanager
def wall_timer(label: str = "", printer: Callable = print):
    """Context manager printing the wall time of its block (device work
    included)."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    printer(f"[{label or 'timer'}] {time.perf_counter() - t0:.4f} s")


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None, activities=None):
    """``torch.profiler`` around a block; yields the profiler, whose
    ``key_averages()`` sum the time by kernel.  ``activities`` defaults to
    the host's and, where CUDA is available, the card's; with ``logdir``
    the trace goes to ``logdir/trace.json`` for Perfetto or
    ``chrome://tracing``."""
    from torch.profiler import ProfilerActivity, profile
    if activities is None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class DeviceProfile(NamedTuple):
    launches: int          # kernels the call ran on the card
    kernel_s: float        # their summed durations
    wall_s: float          # the call's wall time, not profiled
    profiled_wall_s: float
    names: Tuple[str, ...] = ()   # the kernels' names, in launch order

    @property
    def busy(self) -> float:
        """The card's busy share of the unprofiled call's wall time."""
        return self.kernel_s / self.wall_s


def profile_device(fn: Callable) -> DeviceProfile:
    """Kernels and busy share of ``fn()`` on the card: one timed call, then
    one under ``torch.profiler`` recording the card's activity alone.  The
    profiler slows the host's launches, so the busy share divides the
    profiled kernel time by the unprofiled call's wall time.  Call ``fn``
    once before, for the warm-up."""
    from torch.profiler import ProfilerActivity
    if not torch.cuda.is_available():
        raise RuntimeError("profile_device needs a CUDA device")
    wall = timed(fn)[1]
    with profile_trace(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        profiled = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return DeviceProfile(len(kernels),
                         sum(e.time_range.elapsed_us() for e in kernels)
                         * 1e-6, wall, profiled,
                         tuple(e.name for e in kernels))
