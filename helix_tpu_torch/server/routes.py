"""Transport-independent route dispatch.

Both HTTP front doors — the native epoll gateway (``native_gateway.py``)
and the pure-Python fallback server (``http_server.py``) — funnel
requests through :func:`dispatch`, so wire semantics (routes, headers,
error envelopes; reference contract ``sdks/rust/src/lib.rs:160-173``,
``:274-298``, ``:380-381``) are defined once.

Results:
- :class:`JsonResult` — status + JSON-able payload
- :class:`BytesResult` — status + raw bytes + content type (replica seed)
- :class:`EventStream` — marker: serve the telemetry SSE stream

Port copy of ``helix_tpu/server/routes.py`` for ``helix_tpu_torch``.
``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Any
from urllib.parse import parse_qs, urlparse

from .. import fastjson
from ..engine import EngineError
from ..engine.errors import QueryError


@dataclass
class JsonResult:
    status: int
    payload: Any


@dataclass
class BytesResult:
    status: int
    body: bytes
    content_type: str = "application/octet-stream"


@dataclass
class EventStream:
    after: int


@dataclass
class FileResult:
    """A large response streamed from a temp file (replica seeds can be
    GBs; neither server buffers them in memory).  The transport deletes
    ``path`` after sending."""

    status: int
    path: str
    content_type: str = "application/octet-stream"


def decode_body(raw: bytes, fast_arrays: bool = False) -> Any:
    if not raw:
        return {}
    try:
        return fastjson.loads(raw, fast_arrays=fast_arrays)
    except ValueError as exc:
        raise QueryError(f"invalid JSON body: {exc}") from exc


def dispatch(
    server: Any,
    method: str,
    path: str,
    raw_body: bytes,
    *,
    warm: bool = False,
    await_durable: bool = True,
    trace: bool = False,
) -> JsonResult | BytesResult | EventStream | FileResult:
    """Handle one authorized request. ``server`` carries ``engine``,
    ``replica_of`` and ``mcp_enabled``."""
    engine = server.engine
    try:
        if method == "GET":
            if path.startswith("/v1/replication"):
                query = parse_qs(urlparse(path).query)
                try:
                    after = int(query.get("after", ["-1"])[0])
                except ValueError as exc:
                    raise QueryError(f"bad after value: {exc}") from exc
                records, reseed = engine.replication.since(after)
                return JsonResult(200, {
                    "records": records,
                    "reseed_required": reseed,
                    "head_seq": engine.replication.head_seq(),
                    "epoch": engine.replication.epoch,
                })
            if path.startswith("/v1/events"):
                query = parse_qs(urlparse(path).query)
                return EventStream(int(query.get("after", ["-1"])[0]))
            if path == "/v1/source":
                return JsonResult(200, engine.source_snapshot)
            if path == "/v1/snapshot":
                # Replica seed: consistent snapshot + replication
                # watermark.  Pickled to a temp file and streamed in
                # chunks (followers decode through a restricted,
                # streaming unpickler) — O(chunk) memory on both sides.
                import tempfile

                fd, tmp = tempfile.mkstemp(prefix="hxseed-", suffix=".pkl")
                try:
                    with open(fd, "wb") as fh:
                        pickle.dump(
                            engine.export_replica_seed(), fh, protocol=5
                        )
                except Exception:
                    import os as _os

                    _os.unlink(tmp)  # don't litter /tmp on export failure
                    raise
                return FileResult(200, tmp)
            if path == "/v1/health":
                health = {
                    "status": "ok",
                    "nodes": engine.store.node_count(),
                    "edges": engine.store.edge_count(),
                    "epoch": engine.store.epoch,
                    "routes": sorted(engine.routes),
                }
                if getattr(engine, "max_size_bytes", None) is not None:
                    # capacity envelope (db_max_size_gb): surface the
                    # estimate so operators see headroom before writes
                    # start bouncing.  Reader lock: the estimator walks
                    # live props dicts, which writers mutate.
                    health["max_size_bytes"] = engine.max_size_bytes
                    with engine._rwlock.read():
                        health["approx_data_bytes"] = engine.approx_data_bytes()
                persistence = getattr(engine, "persistence", None)
                if persistence is not None and getattr(
                    persistence, "snapshot_store", None
                ) is not None:
                    # mirror staleness is a data-loss hazard on a later
                    # bootstrap-from-mirror; make it observable
                    health["mirror_failures"] = persistence.mirror_failures
                    if persistence.mirror_error is not None:
                        health["mirror_error"] = persistence.mirror_error
                return JsonResult(200, health)
            return JsonResult(
                404, {"error": {"kind": "NotFound", "message": path}}
            )

        if method != "POST":
            return JsonResult(
                404, {"error": {"kind": "NotFound", "message": path}}
            )

        # Query routes parse numeric vectors straight into array.array
        # (zero boxing); the value layer tags them as F64Array natively.
        body = decode_body(
            raw_body, fast_arrays=path.startswith("/v1/query")
        )
        if path == "/mcp":
            if not server.mcp_enabled:
                return JsonResult(404, {"error": {
                    "kind": "NotFound",
                    "message": "MCP is disabled ([db] mcp = false)"}})
            from .mcp import handle_mcp

            response = handle_mcp(
                engine, body, read_only=server.replica_of is not None
            )
            if response is None:  # notification: no body
                return BytesResult(202, b"", "application/json")
            return JsonResult(200, response)
        if path == "/v1/query":
            if warm and isinstance(body, dict) and body.get("request_type") == "write":
                raise QueryError("x-helix-warm applies to read requests only")
            if (
                server.replica_of
                and isinstance(body, dict)
                and body.get("request_type") == "write"
            ):
                raise QueryError(
                    "this instance is a read-only replica; route writes "
                    f"to the primary at {server.replica_of} "
                    "(x-helix-require-writer)"
                )
            return JsonResult(200, engine.execute(
                body, await_durable=await_durable, trace=trace,
                request_bytes=len(raw_body),
            ))
        if path.startswith("/v1/query/"):
            name = path[len("/v1/query/"):]
            # Stored-route bodies are the bare parameters object
            # (lib.rs:302-316); a {"parameters": ...} wrapper is also
            # accepted for symmetry with the dynamic envelope.
            params = body
            if isinstance(body, dict) and set(body) <= {"parameters"}:
                params = body.get("parameters") or {}
            if not isinstance(params, dict):
                raise QueryError("stored query body must be a parameters object")
            route = engine.routes.get(name)
            if (
                server.replica_of
                and route is not None
                and route.get("kind") == "write"
            ):
                # mirror the dynamic-route guard: a stored write executed
                # on a replica would silently diverge it from the primary
                raise QueryError(
                    "this instance is a read-only replica; route writes "
                    f"to the primary at {server.replica_of} "
                    "(x-helix-require-writer)"
                )
            return JsonResult(200, engine.execute_stored(
                name, params, await_durable=await_durable,
                request_bytes=len(raw_body),
            ))
        if path == "/v1/bundle":
            engine.telemetry.log_event(
                "deploying",
                routes=(
                    len(body.get("read_routes", {}))
                    + len(body.get("write_routes", {}))
                ) if isinstance(body, dict) else 0,
                # str/bytes bundles are valid load_bundle input; the
                # telemetry peek must not 500 them
            )
            engine.load_bundle(body)
            engine.telemetry.log_event(
                "deployed", routes=sorted(engine.routes)
            )
            if hasattr(server, "on_bundle_loaded"):
                server.on_bundle_loaded()
            return JsonResult(200, {"installed": sorted(engine.routes)})
        if path == "/v1/source":
            # Deployed source snapshot (push/sync reconciliation).
            if server.replica_of:
                raise QueryError(
                    "this instance is a read-only replica; push source "
                    f"to the primary at {server.replica_of}"
                )
            if not isinstance(body, dict) or "files" not in body:
                raise QueryError("source payload must carry files")
            engine.source_snapshot = body
            if engine.persistence is not None:
                engine.checkpoint()
            return JsonResult(200, {"stored": len(body["files"])})
        return JsonResult(
            404, {"error": {"kind": "NotFound", "message": path}}
        )
    except EngineError as exc:
        return JsonResult(400, {"error": exc.to_json()})
    except Exception as exc:  # pragma: no cover - defensive
        return JsonResult(
            500, {"error": {"kind": "Internal", "message": str(exc)}}
        )
