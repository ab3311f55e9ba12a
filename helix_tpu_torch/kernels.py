"""Build and load the hand-written CUDA kernels under ``csrc/``.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface and loaded with :mod:`ctypes`,
at first use and never at import (the CPU test suite imports every
module and has no ``nvcc``).  The library lands in ``_build/`` next to
this file, named by a hash of the sources and the compile command, so an
edited ``.cu`` rebuilds and concurrent cold builds never share a file.

No ``--use_fast_math``: it flushes denormals in every float operation,
and the bucket-scores kernel reproduces the reference's denormal rule
explicitly instead (see ``csrc/bucket_scores.cu``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "bucket_scores.cu",)
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise KernelBuildError("nvcc not found (PATH or CUDA_HOME)")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhxcuda-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them already exists;
    returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"kernel build failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        lib.hx_bucket_scores.restype = ctypes.c_int
        lib.hx_bucket_scores.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        _LIB = lib
        return lib
