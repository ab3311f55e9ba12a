"""Native runtime components (C++), loaded via ctypes.

Port copy of ``helix_tpu/native/__init__.py`` with every C++ source of
the reference: the write-ahead log (``wal.cpp``), the exact re-rank of
the int8, int4 and host-IVF rungs (``rerank.cpp``), the native traversal
sweep (``bfs.cpp``), the HTTP gateway (``gateway.cpp``) and the HA
front's proxy (``haproxy.cpp``).  ``hxjson.cpp`` and its headers
``fastdouble.h`` and ``fastdouble_pow5.h`` are here for
``helix_tpu_torch.fastjson`` (the gateway includes the headers too).
The library is compiled on first use with g++ into this directory
(``libhxnative.so``, ignored by git), keyed on the source contents.
``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's, and the C++ sources byte for byte.

Differs from the reference in:
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
    sources = [
        _HERE / "wal.cpp", _HERE / "rerank.cpp", _HERE / "bfs.cpp",
        _HERE / "gateway.cpp", _HERE / "haproxy.cpp",
    ]
    headers = [_HERE / "fastdouble.h", _HERE / "fastdouble_pow5.h"]
    out = out or _HERE / "libhxnative.so"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", "-o", "", *[str(s) for s in sources],
    ]
    key = source_key(sources + headers, " ".join(cmd))
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
        lib.hxwal_open.restype = ctypes.c_void_p
        lib.hxwal_open.argtypes = [ctypes.c_char_p]
        lib.hxwal_append.restype = ctypes.c_int
        lib.hxwal_append.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int,
        ]
        lib.hxwal_flush.restype = ctypes.c_int
        lib.hxwal_flush.argtypes = [ctypes.c_void_p]
        lib.hxwal_reset.restype = ctypes.c_int
        lib.hxwal_reset.argtypes = [ctypes.c_void_p]
        lib.hxwal_close.restype = None
        lib.hxwal_close.argtypes = [ctypes.c_void_p]
        lib.hxwal_reader_open.restype = ctypes.c_void_p
        lib.hxwal_reader_open.argtypes = [ctypes.c_char_p]
        lib.hxwal_reader_next.restype = ctypes.c_long
        lib.hxwal_reader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.hxwal_reader_close.restype = None
        lib.hxwal_reader_close.argtypes = [ctypes.c_void_p]
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
        # -- gateway ---------------------------------------------------
        u64p = ctypes.POINTER(ctypes.c_uint64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.hxgw_create.restype = ctypes.c_void_p
        lib.hxgw_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p]
        lib.hxgw_port.restype = ctypes.c_int
        lib.hxgw_port.argtypes = [ctypes.c_void_p]
        lib.hxgw_start.restype = ctypes.c_int
        lib.hxgw_start.argtypes = [ctypes.c_void_p]
        lib.hxgw_stop.restype = None
        lib.hxgw_stop.argtypes = [ctypes.c_void_p]
        lib.hxgw_destroy.restype = None
        lib.hxgw_destroy.argtypes = [ctypes.c_void_p]
        lib.hxgw_parked_count.restype = ctypes.c_longlong
        lib.hxgw_parked_count.argtypes = [ctypes.c_void_p]
        lib.hxgw_fast_route.restype = ctypes.c_int
        lib.hxgw_fast_route.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ]
        lib.hxgw_clear_fast_routes.restype = None
        lib.hxgw_clear_fast_routes.argtypes = [ctypes.c_void_p]
        lib.hxgw_next_vbatch.restype = ctypes.c_int
        lib.hxgw_next_vbatch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), f32p, i32p, i32p,
            ctypes.c_char_p,
        ]
        lib.hxgw_respond_vbatch.restype = ctypes.c_int
        lib.hxgw_respond_vbatch.argtypes = [
            ctypes.c_void_p, u64p, i32p, ctypes.c_int, ctypes.c_int,
            u64p, f64p, i32p,
        ]
        lib.hxgw_next_general.restype = ctypes.c_longlong
        lib.hxgw_next_general.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ]
        lib.hxgw_next_general_zc.restype = ctypes.c_longlong
        lib.hxgw_next_general_zc.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ]
        lib.hxgw_release_body.restype = None
        lib.hxgw_release_body.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.hxgw_respond.restype = ctypes.c_int
        lib.hxgw_respond.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
        ]
        lib.hxgw_respond_stream_start.restype = ctypes.c_int
        lib.hxgw_respond_stream_start.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_char_p,
        ]
        lib.hxgw_stream_write.restype = ctypes.c_int
        lib.hxgw_stream_write.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_longlong,
        ]
        lib.hxgw_stream_end.restype = ctypes.c_int
        lib.hxgw_stream_end.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.hxgw_request_alive.restype = ctypes.c_int
        lib.hxgw_request_alive.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.hxgw_stats.restype = None
        lib.hxgw_stats.argtypes = [ctypes.c_void_p, u64p, u64p, u64p]
        # dynamic fast routes + blob cache (round 4)
        lib.hxgw_skeleton.restype = ctypes.c_longlong
        lib.hxgw_skeleton.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char_p,
            ctypes.c_longlong,
        ]
        lib.hxgw_dyn_vec_route.restype = ctypes.c_longlong
        lib.hxgw_dyn_vec_route.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p,
        ]
        lib.hxgw_dyn_lookup_route.restype = ctypes.c_longlong
        lib.hxgw_dyn_lookup_route.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ]
        lib.hxgw_clear_dyn_routes.restype = None
        lib.hxgw_clear_dyn_routes.argtypes = [ctypes.c_void_p]
        lib.hxgw_blob_epoch.restype = None
        lib.hxgw_blob_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.hxgw_blob_put.restype = ctypes.c_int
        lib.hxgw_blob_put.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_longlong,
        ]
        lib.hxgw_dyn_stats.restype = None
        lib.hxgw_dyn_stats.argtypes = [ctypes.c_void_p, u64p, u64p, u64p]
        # -- HA proxy --------------------------------------------------
        lib.hxha_create.restype = ctypes.c_void_p
        lib.hxha_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.hxha_port.restype = ctypes.c_int
        lib.hxha_port.argtypes = [ctypes.c_void_p]
        lib.hxha_set_backends.restype = None
        lib.hxha_set_backends.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.hxha_start.restype = ctypes.c_int
        lib.hxha_start.argtypes = [ctypes.c_void_p]
        lib.hxha_stop.restype = None
        lib.hxha_stop.argtypes = [ctypes.c_void_p]
        lib.hxha_destroy.restype = None
        lib.hxha_destroy.argtypes = [ctypes.c_void_p]
        lib.hxha_next_control.restype = ctypes.c_longlong
        lib.hxha_next_control.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.hxha_respond.restype = ctypes.c_int
        lib.hxha_respond.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
        ]
        lib.hxha_write_routes.restype = ctypes.c_longlong
        lib.hxha_write_routes.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
        ]
        lib.hxha_add_write_route.restype = None
        lib.hxha_add_write_route.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.hxha_stats.restype = None
        lib.hxha_stats.argtypes = [ctypes.c_void_p, u64p, u64p, u64p]
        _LIB = lib
        return lib


class Wal:
    """Append handle over the native WAL."""

    def __init__(self, path: str | Path):
        self._lib = load()
        self._handle = self._lib.hxwal_open(str(path).encode())
        if not self._handle:
            raise OSError(f"cannot open WAL at {path}")

    def append(self, payload: bytes, sync: bool = True) -> None:
        rc = self._lib.hxwal_append(
            self._handle, payload, len(payload), 1 if sync else 0
        )
        if rc != 0:
            raise OSError("WAL append failed")

    def flush(self) -> None:
        if self._lib.hxwal_flush(self._handle) != 0:
            raise OSError("WAL flush failed")

    def reset(self) -> None:
        if self._lib.hxwal_reset(self._handle) != 0:
            raise OSError("WAL reset failed")

    def close(self) -> None:
        if self._handle:
            self._lib.hxwal_close(self._handle)
            self._handle = None


def replay(path: str | Path):
    """Yield every intact record payload from a WAL file."""
    lib = load()
    handle = lib.hxwal_reader_open(str(path).encode())
    if not handle:
        return
    try:
        out = ctypes.c_void_p()
        while True:
            n = lib.hxwal_reader_next(handle, ctypes.byref(out))
            if n < 0:
                break
            yield ctypes.string_at(out, n) if n else b""
    finally:
        lib.hxwal_reader_close(handle)


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
