"""Host C++ ops: the fast harmonic-NLS pitch estimator.

``fast_nls.cpp`` is this package's own copy of the JAX package's source
(a test holds the two byte-equal).  It is host code, not a GPU kernel:
``g++`` builds it on first use, with the JAX package's flags, into
``ops/_build/libfast_nls-<hash>.so`` (a directory git ignores), keyed by
a hash of the source and the flags, and ``ctypes`` loads it.  Nothing is
built or loaded when this module is imported.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

__all__ = ["GXX_FLAGS", "SOURCE", "build_fast_nls", "load_fast_nls"]

SOURCE = Path(__file__).resolve().parent / "fast_nls.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def build_fast_nls() -> Path:
    """Build the library if no build of the current source exists; returns
    its path.  Raises ``RuntimeError`` with g++'s output if the build
    fails."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libfast_nls-{h.hexdigest()[:16]}.so"
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_fast_nls() -> ctypes.CDLL:
    """Load (building if necessary) and type the library's C ABI:
    ``single_pitch_new / est / est_fast / model_order / del``."""
    lib = ctypes.CDLL(str(build_fast_nls()))
    c_void_p, c_double, c_int = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
    lib.single_pitch_new.argtypes = [c_int, c_int, c_int, c_void_p]
    lib.single_pitch_new.restype = c_void_p
    lib.single_pitch_est.argtypes = [c_void_p, c_void_p, c_double, c_double]
    lib.single_pitch_est.restype = c_double
    lib.single_pitch_est_fast.argtypes = [c_void_p, c_void_p, c_double,
                                          c_double]
    lib.single_pitch_est_fast.restype = c_double
    lib.single_pitch_model_order.argtypes = [c_void_p]
    lib.single_pitch_model_order.restype = c_int
    lib.single_pitch_del.argtypes = [c_void_p]
    lib.single_pitch_del.restype = None
    return lib
