"""Native host components (C++), loaded via ctypes.

Port copy of ``helix_tpu/native/__init__.py`` with the C++ sources of
the functions the port calls: ``rerank.cpp`` (the exact re-rank of the
int8, int4 and host-IVF rungs) and ``bfs.cpp`` (the native traversal
sweep).  ``hxjson.cpp`` and its headers ``fastdouble.h`` and
``fastdouble_pow5.h`` are here for ``helix_tpu_torch.fastjson``.  The
write-ahead log (``wal.cpp``) waits for the persistence slice, and the
HTTP gateway and HA proxy (``gateway.cpp``, ``haproxy.cpp``) wait for
the serving slice, so the library's source list and argtypes are cut
to the two sources.  The library is compiled on first use with g++ into
this directory (``libhxnative.so``, ignored by git), keyed on the source
contents.  ``tests/test_torch_engine_copy.py`` holds the code equal to
the reference's except for the functions listed here, and the C++
sources byte for byte.

Differs from the reference in:

- ``_build_library``: compiles ``rerank.cpp`` and ``bfs.cpp`` only.
- ``load``: declares the argtypes of ``hx_rerank`` and ``hx_bfs_khop``
  only.
- ``Wal``: dropped with ``wal.cpp``.
- ``replay``: dropped with ``wal.cpp``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    pass


def source_key(paths: list[Path], cmd_tag: str) -> str:
    """sha256 over the source contents + the compile command shape.

    Binaries are never committed (``.gitignore`` covers ``*.so``); the
    cache key is content-addressed so fresh clones — whose mtimes say
    nothing — always build from the checked-out sources, and any source
    edit invalidates regardless of clock games."""
    import hashlib

    h = hashlib.sha256(cmd_tag.encode())
    for p in sorted(paths):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _cached(out: Path, key: str) -> bool:
    keyfile = out.with_suffix(out.suffix + ".key")
    return out.exists() and keyfile.exists() and keyfile.read_text() == key


def _build_library(out: Path | None = None) -> Path:
    sources = [_HERE / "rerank.cpp", _HERE / "bfs.cpp"]
    out = out or _HERE / "libhxnative.so"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", "-o", "", *[str(s) for s in sources],
    ]
    key = source_key(sources, " ".join(cmd))
    if _cached(out, key):
        return out
    # temp + rename: never truncate a .so another process has mapped,
    # and concurrent cold builds cannot interleave writes
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd[cmd.index("")] = str(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"native build failed: {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    out.with_suffix(out.suffix + ".key").write_text(key)
    return out


def load() -> ctypes.CDLL:
    """Build (if stale) and load the native library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(_build_library()))
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.hx_rerank.restype = None
        lib.hx_rerank.argtypes = [
            f32p, f32p, ctypes.c_int64, ctypes.c_int64,
            f32p, ctypes.c_int64,
            i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int,
            i64p, f32p,
        ]
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.hx_bfs_khop.restype = ctypes.c_int64
        lib.hx_bfs_khop.argtypes = [
            i64p, i32p, i32p, ctypes.c_int64,
            u8p, u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        _LIB = lib
        return lib


def rerank(
    data: "np.ndarray",
    sq_norms: "np.ndarray",
    queries: "np.ndarray",
    candidates: "np.ndarray",
    k: int,
    metric: str = "cosine",
) -> tuple["np.ndarray", "np.ndarray"]:
    """Exact float32 re-rank of per-query candidate rows (C++).

    data [n,d] f32 C-contiguous, queries [b,d] f32, candidates [b,kc]
    int64 (pad with -1).  Returns (dists [b,k] ascending, idx [b,k],
    -1-padded when fewer than k valid candidates).
    """
    lib = load()
    data = np.ascontiguousarray(data, np.float32)
    sq_norms = np.ascontiguousarray(sq_norms, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    candidates = np.ascontiguousarray(candidates, np.int64)
    b, kc = candidates.shape
    n, d = data.shape
    out_idx = np.empty((b, k), np.int64)
    out_dist = np.empty((b, k), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.hx_rerank(
        data.ctypes.data_as(f32p), sq_norms.ctypes.data_as(f32p),
        n, d,
        queries.ctypes.data_as(f32p), b,
        candidates.ctypes.data_as(i64p), kc,
        k, 1 if metric == "l2" else 0,
        out_idx.ctypes.data_as(i64p), out_dist.ctypes.data_as(f32p),
    )
    return out_dist, out_idx


def bfs_khop(
    indptr: np.ndarray,      # [n+1] int64
    targets: np.ndarray,     # [m]   int32 (node slots)
    labels: np.ndarray,      # [m]   int32 (edge label codes)
    start_mask: np.ndarray,  # [n]   bool/uint8
    label_code: int,
    hops: int,
    n_threads: int = 0,
) -> tuple[np.ndarray, int]:
    """k-hop BFS frontier on the host (see bfs.cpp).  Returns
    ``(mask uint8 [n], frontier count)``; semantics match
    ops/csr.py khop_mask."""
    import ctypes as _ct
    import os

    lib = load()
    n = int(indptr.shape[0] - 1)
    mask = np.ascontiguousarray(start_mask, dtype=np.uint8).copy()
    scratch = np.zeros(n, np.uint8)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    targets = np.ascontiguousarray(targets, dtype=np.int32)
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    count = lib.hx_bfs_khop(
        indptr.ctypes.data_as(_ct.POINTER(_ct.c_int64)),
        targets.ctypes.data_as(_ct.POINTER(_ct.c_int32)),
        labels.ctypes.data_as(_ct.POINTER(_ct.c_int32)),
        n,
        mask.ctypes.data_as(_ct.POINTER(_ct.c_uint8)),
        scratch.ctypes.data_as(_ct.POINTER(_ct.c_uint8)),
        int(label_code), int(hops), int(n_threads),
    )
    return mask, int(count)
