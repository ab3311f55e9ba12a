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
fetched with ``cudaGetDriverEntryPoint``, not linked).  The serving
library also holds the row-wise top-k selection ``csrc/select_topk.cu``
(``ops/topk.py``), which takes only the header's shared-memory opt-in,
and the l2 exact rung's score step ``csrc/l2_scores.cu``
(``ops/distance.py:l2_scores``), kernel 1's pipeline with a TMA-store
epilogue.

Every wrapper checks its operands with :func:`check_operands` and
calls its C entry through :func:`launch`, the one caller of a launch
entry: it passes the device's current stream, counts the launch (or the
node it became on a stream capturing a CUDA graph, which every entry
reports as :data:`CAPTURED`) and raises on a refused launch.

The kernel sweeps' sources (``SWEEP_SOURCES``: kernels 4 and 5, the
ports of ``benchmarks/onepass_sweep.py`` and ``benchmarks/i8_sweep.py``)
build the same way into a second library, ``libhxsweep-<hash>.so``, at
the first use of a sweep kernel (:func:`load_sweep`).  Its hash covers
the sweep sources and every header they include; the serving library's
name, sources and build are the three kernels' alone, so an engine or a
server never compiles the sweeps' instantiations.
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
    _HERE / "csrc" / "select_topk.cu",
    _HERE / "csrc" / "l2_scores.cu",
)
HEADERS = (_HERE / "csrc" / "hopper.cuh",)
SWEEP_SOURCES = (
    _HERE / "csrc" / "sweep_bucket_scores.cu",
    _HERE / "csrc" / "i8_sweep_bf16.cu",
    _HERE / "csrc" / "i8_sweep_packed.cu",
    _HERE / "csrc" / "i8_sweep_probe.cu",
)
SWEEP_HEADERS = (_HERE / "csrc" / "sweep.cuh",)
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_SWEEP_LOCK = threading.Lock()
_SWEEP_LIB: ctypes.CDLL | None = None
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


def _library_path(stem: str, sources: tuple, headers: tuple) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + headers:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    """Where the serving library for the current sources lives (built or
    not)."""
    return _library_path("libhxcuda", SOURCES, HEADERS)


def sweep_library_path() -> Path:
    """Where the sweep library for the current sources lives (built or
    not): its sources, their own header and the shared one."""
    return _library_path("libhxsweep", SWEEP_SOURCES,
                         HEADERS + SWEEP_HEADERS)


def build(out: Path | None = None, sources: tuple | None = None) -> Path:
    """Compile ``sources`` (default: the serving library's) into ``out``
    (default: :func:`library_path`) unless it already exists, one
    ``nvcc`` per source, all started together, then a link; returns the
    path."""
    out = library_path() if out is None else out
    sources = SOURCES if sources is None else sources
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"tmp{os.getpid()}"
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in sources]
    tmp = out.with_suffix(f".{tag}.so")
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        for src, obj in zip(sources, objs)
    ]
    try:
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for cmd in compiles
        ]
        outputs = [proc.communicate()[0] for proc in procs]
        for src, cmd, proc, text in zip(sources, compiles, procs, outputs):
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
        for plan in (lib.hx_bucket_scores_plan,
                     lib.hx_i8_bucket_scores_plan,
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
        lib.hx_select_topk.restype = ctypes.c_int
        lib.hx_select_topk.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p,
        ]
        lib.hx_l2_scores.restype = ctypes.c_int
        lib.hx_l2_scores.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.hx_select_topk_plan.restype = ctypes.c_int
        lib.hx_select_topk_plan.argtypes = [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong),
        ]
        _LIB = lib
        return lib


# A C launch entry's code for a launch into a stream capturing a CUDA
# graph (csrc/hopper.cuh: HX_CAPTURED).
CAPTURED = 1 << 30
_LAUNCH_LOCK = threading.Lock()


def check_operands(name: str, operands: dict, dtypes: dict) -> None:
    """Raise unless every operand is a contiguous, 16-byte aligned CUDA
    tensor of its dtype, all on one device."""
    device = next(iter(operands.values())).device
    for key, t in operands.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(
                f"{name} needs every operand on one CUDA device, got {key} "
                f"on {t.device}"
            )
        if t.dtype != dtypes[key]:
            raise TypeError(f"{name}: {key} must be {dtypes[key]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def launch(wrapper, entry, device: int, *args) -> bool:
    """Call the C launch entry ``entry`` with ``args`` and the current
    stream of CUDA device ``device`` (made the current device first where
    it is not), and count the call in ``wrapper.launches``; where the
    entry returns :data:`CAPTURED` the stream was capturing a CUDA graph,
    nothing launched and the kernel became a node of the graph (which
    launches at each replay), counted in ``wrapper.captured``.  Any other
    code but 0 raises.  Returns whether the stream was capturing."""
    import torch

    if device == torch._C._cuda_getDevice():
        rc = entry(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            rc = entry(*args, torch._C._cuda_getCurrentRawStream(device))
    captured = rc == CAPTURED
    if rc and not captured:
        raise RuntimeError(
            f"{entry.__name__} kernel launch failed: code {rc} (a CUDA "
            "error; -1: no cuTensorMapEncodeTiled, -2: tensor map refused, "
            "-3: shape refused)"
        )
    with _LAUNCH_LOCK:  # searches may run on several threads
        if captured:
            wrapper.captured += 1
        else:
            wrapper.launches += 1
    return captured


# The sweep kernels' C entries (csrc/sweep.cuh: HX_SWEEP_ENTRY): kernel 4
# in sweep_bucket_scores.cu, kernel 5 in i8_sweep_*.cu.
SWEEP_ENTRIES = (
    "hx_sweep_shipped", "hx_sweep_onepass", "hx_sweep_lastmask",
    "hx_i8_sweep_bf16dot", "hx_i8_sweep_bf16dot_tail", "hx_i8_sweep_dot_bf16",
    "hx_i8_sweep_i32pack", "hx_i8_sweep_scale2d", "hx_i8_sweep_gscale",
    "hx_i8_sweep_ep_pack", "hx_i8_sweep_full_t",
    "hx_i8_sweep_dot_i8", "hx_i8_sweep_ep_astype", "hx_i8_sweep_ep_scale",
    "hx_i8_sweep_ep_mask", "hx_i8_sweep_amk",
)


def load_sweep() -> ctypes.CDLL:
    """Build (if needed) and load the sweep library, once per process."""
    global _SWEEP_LIB
    with _SWEEP_LOCK:
        if _SWEEP_LIB is not None:
            return _SWEEP_LIB
        lib = ctypes.CDLL(str(build(sweep_library_path(), SWEEP_SOURCES)))
        for name in SWEEP_ENTRIES:
            entry = getattr(lib, name)
            entry.restype = ctypes.c_int
            entry.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
        lib.hx_sweep_plan.restype = ctypes.c_int
        lib.hx_sweep_plan.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        _SWEEP_LIB = lib
        return lib
