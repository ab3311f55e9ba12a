"""Fast JSON codec facade.

Loads the ``hxjson`` C extension (``native/hxjson.cpp``, built with g++
on first use like the rest of :mod:`helix_tpu_torch.native`), exposing
``loads``/``dumps``/``dumpb`` with stdlib-compatible semantics, and
falls back to stdlib ``json`` when the toolchain is unavailable.  The
replication follower parses its records with ``loads(...,
fast_arrays=True)``.

Port copy of ``helix_tpu/fastjson.py``.  ``tests/test_torch_engine_copy.py``
holds the code equal to the reference's.

Differs from the reference in: nothing.
"""

from __future__ import annotations

import json as _json
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Any

_HERE = Path(__file__).resolve().parent / "native"
_LOCK = threading.Lock()
_IMPL: Any = None


def _build_extension(out: Path | None = None) -> Path:
    from .native import _cached, source_key

    src = _HERE / "hxjson.cpp"
    deps = [src, _HERE / "fastdouble.h", _HERE / "fastdouble_pow5.h"]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = out or _HERE / f"hxjson{suffix}"
    include = sysconfig.get_paths()["include"]
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        f"-I{include}", "-o", "", str(src),
    ]
    key = source_key(deps, " ".join(cmd))
    if _cached(out, key):
        return out
    # build to a per-pid temp and rename: a direct -o <path> truncates
    # the mapped file under any process that already dlopen'd it, and
    # two cold processes building concurrently would interleave writes
    tmp = out.with_suffix(out.suffix + f".tmp{os.getpid()}")
    cmd[cmd.index("")] = str(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"hxjson build failed:\n{proc.stderr}")
    os.replace(tmp, out)
    out.with_suffix(out.suffix + ".key").write_text(key)
    return out


def _load():
    global _IMPL
    if _IMPL is not None:
        return _IMPL
    with _LOCK:
        if _IMPL is not None:
            return _IMPL
        try:
            path = _build_extension()
            import importlib.util

            spec = importlib.util.spec_from_file_location("hxjson", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)  # type: ignore[union-attr]
            _IMPL = mod
        except Exception:
            _IMPL = False
        return _IMPL


def native_available() -> bool:
    return bool(_load())


def loads(data: str | bytes | bytearray, fast_arrays: bool = False) -> Any:
    """Parse JSON.  ``fast_arrays=True`` (native only) parses numeric
    arrays of >=32 elements with a float member into ``array.array('d')``
    — zero per-element boxing, the bulk-ingest hot path.  The stdlib
    fallback ignores the flag (plain lists; identical values)."""
    impl = _load()
    if impl:
        return impl.loads(data, fast_arrays=fast_arrays)
    if isinstance(data, memoryview):  # stdlib json cannot take a view
        data = data.tobytes()
    return _json.loads(data)


def _plain_default(obj: Any):
    """stdlib-fallback encoder hook for buffer-backed numeric arrays."""
    tolist = getattr(obj, "tolist", None)
    if tolist is not None:
        return tolist()
    raise TypeError(
        f"Object of type {type(obj).__name__} is not JSON serializable"
    )


def _sanitize_nonfinite(value: Any) -> Any:
    """Replace non-finite floats with None, recursively (stdlib fallback
    for ``nan_null``; only reached when a non-finite is present)."""
    if isinstance(value, float):
        return value if value == value and abs(value) != float("inf") else None
    if isinstance(value, dict):
        return {k: _sanitize_nonfinite(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_sanitize_nonfinite(v) for v in value]
    tolist = getattr(value, "tolist", None)
    if tolist is not None:
        return _sanitize_nonfinite(tolist())
    return value


def dumps(value: Any, compact: bool = False, nan_null: bool = False) -> str:
    """Serialize.  ``nan_null=True`` encodes non-finite floats as JSON
    ``null`` (strict wire responses — bare NaN/Infinity tokens are not
    JSON; reference serde/sonic-rs never emit them).  Default keeps the
    stdlib-compatible literals for lossless internal round-trips (WAL)."""
    impl = _load()
    if impl:
        try:
            return impl.dumps(value, compact=compact, nan_null=nan_null)
        except TypeError:
            pass  # non-plain types: stdlib error text for consistency
    seps = (",", ":") if compact else None
    if nan_null:
        try:
            return _json.dumps(value, ensure_ascii=False, separators=seps,
                               default=_plain_default, allow_nan=False)
        except ValueError:
            value = _sanitize_nonfinite(value)
    return _json.dumps(value, ensure_ascii=False, separators=seps,
                       default=_plain_default)


def dumpb(value: Any, compact: bool = False, nan_null: bool = False) -> bytes:
    impl = _load()
    if impl:
        try:
            return impl.dumpb(value, compact=compact, nan_null=nan_null)
        except TypeError:
            pass
    return dumps(value, compact=compact, nan_null=nan_null).encode("utf-8")
