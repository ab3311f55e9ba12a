"""HTTP gateway: the engine's wire front door.

Routes (reference contract, ``sdks/rust/src/lib.rs:160-173``, ``:380-381``):

- ``POST /v1/query`` — dynamic :class:`DynamicQueryRequest` JSON body
- ``POST /v1/query/<name>`` — deployed stored route; body is the bare
  parameters object (``lib.rs:302-316``)
- ``POST /v1/bundle`` — install a queries.json bundle (wire v5/v4); the
  rebuild's local stand-in for the reference's cloud deploy path
- ``GET /v1/health`` — liveness; returns engine stats
- ``GET /v1/replication?after=<seq>`` — primary-side record ring tail
  for read replicas
- ``GET /v1/snapshot`` — replica seed: consistent snapshot + replication
  watermark (bootstrap for replicas behind the ring)
- ``POST /mcp`` — Model Context Protocol endpoint (JSON-RPC 2.0) exposing
  the query surface as agent tools (``DbConfig.mcp``, config.rs:173)

Behavior headers (``lib.rs:274-298``): ``x-helix-require-writer`` (accepted;
single-process serving is always the writer), ``x-helix-warm`` (reads only —
rejected on writes, matching the CLI preflight ``query.rs:172-187``),
``x-helix-await-durable`` (forwarded to the persistence layer when enabled).

Built on ``ThreadingHTTPServer``: reads execute concurrently against
epoch-consistent snapshots; writes serialize on the engine's writer lock.

Port copy of ``helix_tpu/server/http_server.py`` for ``helix_tpu_torch``.
The entry point is ``python -m helix_tpu_torch.server.http_server``; it
serves from the native gateway (falling back to the Python server only
when the native library cannot load, as the reference does), and its
engine runs on ``--device`` (``cuda`` unless told otherwise; without a
card that raises, and the CPU serves only on ``--device cpu``).
``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:

- ``HelixHTTPServer.__init__``: takes ``device`` (default ``"cuda"``)
  for the ``Engine`` it builds.
- ``serve``: takes ``device`` and hands it to the server.
- ``build_arg_parser``: adds ``--device`` (default ``cuda``).
- ``__main__``: passes ``--device`` to ``serve``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from .. import fastjson
from ..engine import Engine
from . import routes


class HelixHTTPServer:
    def __init__(
        self,
        engine: Engine | None = None,
        host: str = "0.0.0.0",
        port: int = 6969,
        api_key: str | None = None,
        data_dir: str | None = None,
        telemetry_path: str | None = None,
        metric: str = "cosine",
        batch_window_ms: float | None = 2.0,
        hbm_budget_bytes: int | None = None,
        bm25: bool = True,
        secondary_indices: list[str] | None = None,
        replica_of: str | None = None,
        snapshot_store: str | None = None,
        mcp: bool = True,
        shard_threshold: int | None = None,
        graph_shard_threshold: int | None = None,
        quant_candidates: int | None = None,
        max_size_bytes: int | None = None,
        device: str = "cuda",
    ):
        self.replica_of = replica_of
        self.follower = None
        if replica_of and data_dir and engine is None:
            # Replicas are stateless followers: disk state of unknown
            # replication position cannot be safely re-tailed, so disk
            # mode is ignored and the replica bootstraps from the
            # primary's ring / seed snapshot instead.
            data_dir = None
        self.engine = engine or Engine(
            metric=metric, data_dir=data_dir, batch_window_ms=batch_window_ms,
            hbm_budget_bytes=hbm_budget_bytes,
            bm25=bm25,
            secondary_indices=secondary_indices, snapshot_store=snapshot_store,
            quant_candidates=quant_candidates,
            shard_threshold=shard_threshold,
            graph_shard_threshold=graph_shard_threshold,
            max_size_bytes=max_size_bytes,
            device=device,
        )
        if replica_of:
            from ..engine.replication import Follower

            self.follower = Follower(self.engine, replica_of, api_key=api_key)
            self.follower.start()
        if telemetry_path:
            from ..telemetry import Telemetry

            self.engine.telemetry = Telemetry(telemetry_path)
            self.engine.telemetry.log_event("instance_start")
        self.mcp_enabled = mcp
        self.host = host
        self.port = port
        self.api_key = api_key
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt: str, *args: Any) -> None:
                pass  # request logging goes through the telemetry layer

            def _reply(self, status: int, payload: Any) -> None:
                body = fastjson.dumpb(payload, nan_null=True)
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authorized(self) -> bool:
                if server.api_key is None:
                    return True
                header = self.headers.get("Authorization", "")
                return header == f"Bearer {server.api_key}"

            def _dispatch(self, method: str) -> None:
                if self.headers.get("Transfer-Encoding"):
                    # chunked bodies are not deframed here: replying
                    # with length 0 would desync the keep-alive stream
                    self.close_connection = True
                    self._reply(501, {"error": {
                        "kind": "NotImplemented",
                        "message": "chunked bodies unsupported"}})
                    return
                if not self._authorized():
                    # consume the body first: HTTP/1.1 keep-alive would
                    # otherwise parse the unread body bytes as the next
                    # request line (smuggling; the native gateway drains
                    # before its 401 too)
                    length = int(self.headers.get("Content-Length") or 0)
                    if length:
                        self.rfile.read(length)
                    self._reply(401, {"error": {"kind": "Unauthorized",
                                                "message": "invalid api key"}})
                    return
                if method == "GET" and self.path.startswith("/v1/events"):
                    from urllib.parse import parse_qs, urlparse

                    query = parse_qs(urlparse(self.path).query)
                    self._handle_events(int(query.get("after", ["-1"])[0]))
                    return
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                result = routes.dispatch(
                    server, method, self.path, raw,
                    warm=self.headers.get("x-helix-warm", "").lower() == "true",
                    await_durable=self._await_durable(),
                    trace=self._trace(),
                )
                if isinstance(result, routes.JsonResult):
                    self._reply(result.status, result.payload)
                elif isinstance(result, routes.BytesResult):
                    self.send_response(result.status)
                    self.send_header("Content-Type", result.content_type)
                    self.send_header("Content-Length", str(len(result.body)))
                    self.end_headers()
                    self.wfile.write(result.body)
                elif isinstance(result, routes.FileResult):
                    import os as _os

                    size = _os.path.getsize(result.path)
                    self.send_response(result.status)
                    self.send_header("Content-Type", result.content_type)
                    self.send_header("Content-Length", str(size))
                    self.end_headers()
                    try:
                        with open(result.path, "rb") as fh:
                            while True:
                                chunk = fh.read(1 << 20)
                                if not chunk:
                                    break
                                self.wfile.write(chunk)
                    finally:
                        _os.unlink(result.path)

            def do_GET(self) -> None:  # noqa: N802
                self._dispatch("GET")

            def do_POST(self) -> None:  # noqa: N802
                self._dispatch("POST")

            def _handle_events(self, after: int) -> None:
                """Server-Sent Events stream of telemetry (the local analog
                of the reference's SSE deploy/progress channel,
                sse_client.rs:11-91).  ?after=<seq> resumes."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                telemetry = server.engine.telemetry
                try:
                    while True:
                        events = telemetry.events_since(after, timeout=5.0)
                        if not events:
                            self.wfile.write(b": keepalive\n\n")
                            self.wfile.flush()
                            continue
                        for event in events:
                            after = max(after, event.get("seq", after))
                            payload = json.dumps(event, ensure_ascii=False)
                            self.wfile.write(
                                f"id: {event.get('seq')}\ndata: {payload}\n\n".encode()
                            )
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    return

            def _await_durable(self) -> bool:
                return self.headers.get("x-helix-await-durable", "true").lower() != "false"

            def _trace(self) -> bool:
                return self.headers.get("x-helix-trace", "").lower() == "true"

        return Handler

    # ------------------------------------------------------------------

    def start(self) -> None:
        """Start serving in a background thread (returns once bound)."""
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_address[1]
        self._httpd.serve_forever()

    def stop(self) -> None:
        if self.follower is not None:
            self.follower.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.engine.close()


def serve(
    host: str = "0.0.0.0",
    port: int = 6969,
    api_key: str | None = None,
    engine: Engine | None = None,
    data_dir: str | None = None,
    telemetry_path: str | None = None,
    metric: str = "cosine",
    hbm_budget_bytes: int | None = None,
    bm25: bool = True,
    secondary_indices: list[str] | None = None,
    replica_of: str | None = None,
    snapshot_store: str | None = None,
    mcp: bool = True,
    native: bool = True,
    shard_threshold: int | None = None,
    graph_shard_threshold: int | None = None,
    quant_candidates: int | None = None,
    max_size_bytes: int | None = None,
    device: str = "cuda",
) -> None:
    import signal
    import sys

    server_cls: type = HelixHTTPServer
    if native:
        # The native epoll gateway is the production front door; the
        # ThreadingHTTPServer path stays as the pure-Python fallback.
        try:
            from ..native import load as native_load

            native_load()
            from .native_gateway import NativeGateway

            server_cls = NativeGateway
        except Exception as exc:
            print(f"native gateway unavailable ({exc}); "
                  "falling back to the Python server", file=sys.stderr)

    server = server_cls(
        engine, host, port, api_key,
        data_dir=data_dir, telemetry_path=telemetry_path, metric=metric,
        hbm_budget_bytes=hbm_budget_bytes, bm25=bm25,
        secondary_indices=secondary_indices, replica_of=replica_of,
        snapshot_store=snapshot_store, mcp=mcp,
        quant_candidates=quant_candidates,
        shard_threshold=shard_threshold,
        graph_shard_threshold=graph_shard_threshold,
        max_size_bytes=max_size_bytes,
        device=device,
    )

    def _shutdown(signum, frame):
        # Disk mode: checkpoint before exit so restart is snapshot-fast.
        server.engine.close()
        sys.exit(0)

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    server.serve_forever()


def build_arg_parser():
    """The server's CLI surface (also validated by the container test)."""
    import argparse

    parser = argparse.ArgumentParser(description="helix-tpu engine server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=6969)
    parser.add_argument("--api-key", default=None)
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--telemetry-path", default=None)
    parser.add_argument("--metric", default="cosine", choices=["cosine", "l2"])
    parser.add_argument("--quant-candidates", type=int, default=None,
                        help="candidate-pool floor re-ranked in exact f32 "
                             "by the quantized residency tiers (ef_search "
                             "analog; default 8*k for int8, 32*k for int4)")
    parser.add_argument("--max-size-gb", type=float, default=None,
                        help="capacity envelope on the authoritative "
                             "dataset (helix.toml db_max_size_gb, "
                             "reference default 20); non-reclaiming "
                             "writes past it are rejected")
    parser.add_argument("--hbm-budget-gb", type=float, default=None,
                        help="device-memory budget for resident vector "
                             "matrices; partitions beyond it serve from "
                             "the host-resident IVF tier (beyond-HBM)")
    parser.add_argument("--no-bm25", action="store_true")
    parser.add_argument("--no-mcp", action="store_true",
                        help="disable the POST /mcp JSON-RPC endpoint")
    parser.add_argument("--secondary-index", action="append", default=[],
                        help="Label.property equality index to create at boot")
    parser.add_argument("--replica-of", default=None,
                        help="primary gateway URL; serve as a read-only replica")
    parser.add_argument("--snapshot-store", default=None,
                        help="object store url (s3://, file://, memory://) "
                             "checkpoints mirror to and fresh nodes "
                             "bootstrap from")
    parser.add_argument("--shard-threshold", type=int, default=None,
                        help="live-vector count above which partitions "
                             "shard row-wise across the device mesh")
    parser.add_argument("--graph-shard-threshold", type=int, default=None,
                        help="node count above which traversals run "
                             "edge-partitioned across the device mesh")
    parser.add_argument("--legacy-server", action="store_true",
                        help="serve from the pure-Python ThreadingHTTPServer "
                             "instead of the native epoll gateway")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the engine (cuda raises "
                             "without a card; cpu serves from the host)")
    return parser


if __name__ == "__main__":
    args = build_arg_parser().parse_args()
    serve(
        args.host, args.port, args.api_key,
        data_dir=args.data_dir, telemetry_path=args.telemetry_path,
        metric=args.metric,
        hbm_budget_bytes=(
            int(args.hbm_budget_gb * (1 << 30))
            if args.hbm_budget_gb is not None else None
        ),
        bm25=not args.no_bm25, secondary_indices=args.secondary_index,
        replica_of=args.replica_of, snapshot_store=args.snapshot_store,
        mcp=not args.no_mcp, native=not args.legacy_server,
        quant_candidates=args.quant_candidates,
        shard_threshold=args.shard_threshold,
        graph_shard_threshold=args.graph_shard_threshold,
        max_size_bytes=(
            int(args.max_size_gb * (1 << 30))
            if args.max_size_gb is not None else None
        ),
        device=args.device,
    )
