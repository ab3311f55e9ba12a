"""Build and load the hand-written CUDA kernels under ``csrc/``.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface and loaded with :mod:`ctypes`,
at first use and never at import (the CPU test suite imports every
module and has no ``nvcc``).  Each source compiles in its own ``nvcc``
process, all started together, and one more links them.  The library
lands in ``_build/`` next to this file, named by a hash of the sources,
the shared header and the compile command, so an edited ``.cu`` or
``.cuh`` rebuilds and concurrent cold builds never share a file.

No ``--use_fast_math``: it flushes denormals in every float operation,
and the bucket-scores kernel reproduces the reference's denormal rule
explicitly instead (see ``csrc/bucket_scores.cu``).  ``-Xptxas -v``
makes ``ptxas`` report each kernel's registers, shared memory and
spills (and any ``C75xx`` note that ``wgmma`` was serialized); a build
keeps that report in :data:`BUILD_LOG`.  The kernels use no CUTLASS
header: ``csrc/hopper.cuh``, which all three include, writes their TMA,
``mbarrier`` and ``wgmma`` instructions as inline PTX and includes only
the toolkit's ``cuda.h`` (for the tensor-map type; libcuda's encoder is
fetched with ``cudaGetDriverEntryPoint``, not linked).
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
SOURCES = (
    _HERE / "csrc" / "bucket_scores.cu",
    _HERE / "csrc" / "i8_bucket_scores.cu",
    _HERE / "csrc" / "i4_bucket_scores.cu",
)
HEADERS = (_HERE / "csrc" / "hopper.cuh",)
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# source name -> the compiler's output of the last build in this process
BUILD_LOG: dict[str, str] = {}


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
    for src in SOURCES + HEADERS:
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
    nvcc = _nvcc()
    tag = f"tmp{os.getpid()}"
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in SOURCES]
    tmp = out.with_suffix(f".{tag}.so")
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        for src, obj in zip(SOURCES, objs)
    ]
    try:
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for cmd in compiles
        ]
        outputs = [proc.communicate()[0] for proc in procs]
        for src, cmd, proc, text in zip(SOURCES, compiles, procs, outputs):
            BUILD_LOG[src.name] = text
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"kernel build failed: {' '.join(cmd)}\n{text}"
                )
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                *[str(o) for o in objs]]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"kernel link failed: {' '.join(link)}\n{proc.stdout}"
                f"{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
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
        lib.hx_i8_bucket_scores.restype = ctypes.c_int
        lib.hx_i8_bucket_scores.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        for plan in (lib.hx_i8_bucket_scores_plan,
                     lib.hx_i4_bucket_scores_plan):
            plan.restype = ctypes.c_int
            plan.argtypes = [ctypes.c_int, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int)]
        lib.hx_i4_bucket_scores.restype = ctypes.c_int
        lib.hx_i4_bucket_scores.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        _LIB = lib
        return lib
