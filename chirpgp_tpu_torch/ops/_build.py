"""Build the hand-written CUDA kernels of ``ops/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface.  ``nvcc`` compiles it into
``ops/_build/<name>-<hash>.so`` (a directory git ignores), keyed by a hash
of every source in ``csrc`` and of the flags, so the first use after a
change builds and later uses load.  The library is opened with
``ctypes``; nothing is built or loaded when this module is imported.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

__all__ = ["NVCC_FLAGS", "BuiltLibrary", "find_nvcc", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# sm_90a: Hopper with its architecture-specific features.  No
# --use_fast_math: the filter needs the accurate sin/cos/log.
# -Xptxas -v reports registers, shared memory and local-memory spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuiltLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an existing build was loaded
    log: str               # nvcc / ptxas output of the build


def find_nvcc() -> str:
    """The ``nvcc`` of ``$CUDA_HOME``, of ``PATH``, or of ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built on first use")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> BuiltLibrary:
    """Build ``csrc/<name>.cu`` if no build of the current sources exists,
    and load it.  Raises ``RuntimeError`` with nvcc's output if the build
    fails."""
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(src)
    out = BUILD_DIR / f"{name}-{_source_hash()}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src.name}:\n"
                f"{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    log = log_path.read_text() if log_path.is_file() else ""
    return BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)
