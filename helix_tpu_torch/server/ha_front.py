"""HA gateway front: the local analog of the reference cloud topology —
"single writer + auto-scaling readers" behind redundant gateways
(``README.md:248``; serving headers ``sdks/rust/src/lib.rs:274-298``).

A thin HTTP front over one primary (writer) and N read replicas:

- writes (``request_type: "write"`` or ``x-helix-require-writer``) go to
  the primary; when the primary is down they fail fast with a clear
  503 instead of hanging;
- reads round-robin across healthy replicas and fall back to the
  primary; a backend that errors mid-request is marked down and the
  request retries on the next healthy backend;
- stored routes (``/v1/query/<name>``) are tried on a replica first;
  a "read-only replica" rejection reveals the route is a write, which
  is cached and re-sent to the primary (subsequent calls skip the
  probe);
- ``/v1/bundle`` deploys broadcast to every backend so stored routes
  exist fleet-wide.

Health is actively probed (``GET /v1/health`` every ``probe_s``) — the
failure-detection half of the reference's gateway HA story.

The DATA PATH rides the native C++ epoll proxy (``native/haproxy.cpp``):
client framing, routing, pooled keep-alive upstream connections, and
failover all run in native code; Python keeps the health prober, the
``/v1/ha`` topology endpoint, and the ``/v1/bundle`` broadcast (handed
over through the proxy's control queue).  When the native toolchain is
unavailable (or ``HELIX_HA_PYTHON=1``), the original pure-Python
ThreadingHTTPServer front serves instead with identical semantics.

Port copy of ``helix_tpu/server/ha_front.py`` for ``helix_tpu_torch``:
the native proxy is the port's own ``helix_tpu_torch.native``
(``haproxy.cpp``, a byte copy).

``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:
"""

from __future__ import annotations

import ctypes
import http.client
import json
import os
import re
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_WRITE_RE = re.compile(rb'"request_type"\s*:\s*"write"')


class _BackendTimeout(Exception):
    """Request-level timeout: the backend is slow, not dead."""

_HOP_HEADERS = {
    "connection", "keep-alive", "transfer-encoding", "host",
    "content-length",
}


class Backend:
    def __init__(self, url: str, role: str):
        self.url = url.rstrip("/")
        self.role = role  # "primary" | "replica"
        self.healthy = True
        self.last_error: str | None = None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "up" if self.healthy else "down"
        return f"<{self.role} {self.url} {state}>"


class HAFront:
    def __init__(
        self,
        primary: str,
        replicas: list[str] | None = None,
        host: str = "0.0.0.0",
        port: int = 0,
        probe_s: float = 0.5,
        probe_timeout_s: float = 2.0,
    ):
        self.primary = Backend(primary, "primary")
        self.replicas = [Backend(u, "replica") for u in (replicas or [])]
        self.host = host
        self.port = port
        self.probe_s = probe_s
        self.probe_timeout_s = probe_timeout_s
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._conn_local = threading.local()
        self._write_routes: set[str] = set()
        self._stop = threading.Event()
        self._httpd: ThreadingHTTPServer | None = None
        self._threads: list[threading.Thread] = []
        self._native: ctypes.CDLL | None = None
        self._px: int | None = None  # native proxy handle

    # -- health -----------------------------------------------------------

    def _probe(self, backend: Backend) -> None:
        was = backend.healthy
        try:
            with urllib.request.urlopen(
                f"{backend.url}/v1/health", timeout=self.probe_timeout_s
            ) as resp:
                backend.healthy = resp.status == 200
        except Exception as exc:
            backend.healthy = False
            backend.last_error = str(exc)
        if backend.healthy != was and self._px is not None:
            # transitions reach the native proxy immediately (not at the
            # next health tick) so routing flips with the probe
            try:
                self._push_backends()
            except Exception:
                pass

    def _health_loop(self) -> None:
        while not self._stop.wait(self.probe_s):
            for backend in [self.primary, *self.replicas]:
                self._probe(backend)
                if self._stop.is_set():
                    return
            if self._px is not None:
                try:
                    self._push_backends()
                except Exception:
                    # a transient DNS failure must not kill the prober;
                    # the previous topology stays in effect
                    pass

    # -- routing ----------------------------------------------------------

    def _read_order(self) -> list[Backend]:
        """Healthy replicas round-robin, primary as the fallback tail."""
        pool = [b for b in self.replicas if b.healthy]
        with self._rr_lock:
            self._rr += 1
            offset = self._rr
        pool = pool[offset % len(pool):] + pool[: offset % len(pool)] if pool else []
        unhealthy = [b for b in self.replicas if not b.healthy]
        tail = [self.primary] if self.primary.healthy else []
        # last resort: even unhealthy backends get one shot (probe lag)
        return pool + tail + unhealthy + ([] if tail else [self.primary])

    def _is_write(self, path: str, body: bytes, headers) -> bool:
        if headers.get("x-helix-require-writer", "").lower() == "true":
            return True
        if path == "/v1/query":
            return bool(_WRITE_RE.search(body))
        if path.startswith("/v1/query/"):
            return path[len("/v1/query/"):] in self._write_routes
        # source snapshots mutate engine state; MCP tools can write —
        # both belong on the writer
        return path in ("/v1/source", "/mcp")

    # Forwarding rides PERSISTENT per-thread backend connections
    # (http.client keep-alive).  The old urllib path paid a TCP connect
    # + teardown per proxied request, which capped the front at a few
    # hundred req/s; pooled connections measured ~8x that on the
    # failover-under-load test (tests/test_ha_front.py).

    def _connection(self, backend: Backend) -> http.client.HTTPConnection:
        cache = getattr(self._conn_local, "conns", None)
        if cache is None:
            cache = self._conn_local.conns = {}
        conn = cache.get(backend.url)
        if conn is None:
            parsed = urllib.parse.urlsplit(backend.url)
            conn = http.client.HTTPConnection(
                parsed.hostname, parsed.port or 80, timeout=120
            )
            cache[backend.url] = conn
        if conn.sock is None:
            conn.connect()
            # disable Nagle: request headers+body go in separate writes,
            # and Nagle x delayed-ACK costs ~40 ms per proxied request
            import socket as _socket

            conn.sock.setsockopt(
                _socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1
            )
        return conn

    def _drop_connection(self, backend: Backend) -> None:
        cache = getattr(self._conn_local, "conns", None)
        if cache is not None:
            conn = cache.pop(backend.url, None)
            if conn is not None:
                conn.close()

    def _forward(
        self, backend: Backend, method: str, path: str, body: bytes, headers,
        idempotent: bool = True,
    ) -> tuple[int, bytes, str]:
        fwd_headers = {
            key: value for key, value in headers.items()
            if key.lower() not in _HOP_HEADERS
        }
        payload = body if method == "POST" else None
        for attempt in (0, 1):
            conn = self._connection(backend)
            sent = False
            try:
                conn.request(method, path, body=payload, headers=fwd_headers)
                sent = True
                resp = conn.getresponse()
                data = resp.read()
                return (
                    resp.status, data,
                    resp.headers.get("Content-Type", "application/json"),
                )
            except TimeoutError as exc:
                # slow != dead: the backend may still be executing; do
                # not blind-retry (re-running the work) — surface a
                # typed timeout the read loop maps to 504 without
                # poisoning backend health
                self._drop_connection(backend)
                raise _BackendTimeout(str(exc)) from exc
            except (http.client.HTTPException, ConnectionError, OSError):
                # stale keep-alive (backend restarted/closed the socket):
                # reconnect once — but ONLY when the request either
                # never went out or is safe to re-run.  A write that was
                # already transmitted may have EXECUTED (crash before
                # the response): re-sending would duplicate it.
                self._drop_connection(backend)
                if attempt == 1 or (sent and not idempotent):
                    raise
        raise AssertionError("unreachable")

    def handle(
        self, method: str, path: str, body: bytes, headers
    ) -> tuple[int, bytes, str]:
        if path == "/v1/ha":
            return 200, json.dumps(self.topology()).encode(), "application/json"
        if method == "POST" and path == "/v1/bundle":
            # broadcast so stored routes exist on every backend; replica
            # failures are REPORTED, not swallowed — a silent partial
            # deploy would surface later as unknown-route errors
            result: tuple[int, bytes, str] | None = None
            replica_errors: list[str] = []
            for backend in [self.primary, *self.replicas]:
                if backend.role == "replica" and not backend.healthy:
                    # a blackholed replica would stall the single
                    # control thread for the full connect timeout; the
                    # prober already marked it down — report, skip
                    replica_errors.append(
                        f"{backend.url}: skipped (unhealthy: "
                        f"{backend.last_error})"
                    )
                    continue
                try:
                    out = self._forward(backend, method, path, body, headers)
                    if backend.role == "primary":
                        result = out
                    elif out[0] != 200:
                        replica_errors.append(
                            f"{backend.url}: HTTP {out[0]}"
                        )
                except Exception as exc:
                    backend.healthy = False
                    backend.last_error = str(exc)
                    if backend.role == "primary":
                        result = (503, json.dumps({"error": {
                            "kind": "Unavailable",
                            "message": f"primary unreachable: {exc}",
                        }}).encode(), "application/json")
                    else:
                        replica_errors.append(f"{backend.url}: {exc}")
            if result is not None and result[0] == 200 and replica_errors:
                payload = json.loads(result[1])
                payload["replica_errors"] = replica_errors
                result = (200, json.dumps(payload).encode(), result[2])
            if result is not None and result[0] == 200:
                self._seed_write_routes(body)
            return result or (503, b'{"error": {"kind": "Unavailable"}}',
                              "application/json")

        if self._is_write(path, body, headers):
            if not self.primary.healthy:
                self._probe(self.primary)  # one immediate recheck
            try:
                return self._forward(
                    self.primary, method, path, body, headers,
                    idempotent=False,
                )
            except _BackendTimeout as exc:
                return (504, json.dumps({"error": {
                    "kind": "Timeout",
                    "message": f"writer timed out: {exc}",
                }}).encode(), "application/json")
            except Exception as exc:
                self.primary.healthy = False
                self.primary.last_error = str(exc)
                return (503, json.dumps({"error": {
                    "kind": "Unavailable",
                    "message": (
                        "writer is unreachable; writes are unavailable "
                        f"until the primary returns ({exc})"
                    ),
                }}).encode(), "application/json")

        last_exc: Exception | None = None
        last_response: tuple[int, bytes, str] | None = None
        for backend in self._read_order():
            try:
                status, payload, ctype = self._forward(
                    backend, method, path, body, headers
                )
            except _BackendTimeout as exc:
                # the backend is still executing: re-issuing the same
                # (possibly expensive) query elsewhere multiplies load
                # and flaps healthy backends — report the timeout
                return (504, json.dumps({"error": {
                    "kind": "Timeout",
                    "message": f"backend timed out: {exc}",
                }}).encode(), "application/json")
            except Exception as exc:
                backend.healthy = False
                backend.last_error = str(exc)
                last_exc = exc
                continue
            if (
                status == 400
                and backend.role == "replica"
                and b"read-only replica" in payload
            ):
                # a write the byte-sniff missed (e.g. JSON-escaped
                # "request_type") or an undiscovered write-kind stored
                # route: remember stored routes, re-issue on the writer
                if path.startswith("/v1/query/"):
                    self._write_routes.add(path[len("/v1/query/"):])
                try:
                    return self._forward(
                        self.primary, method, path, body, headers,
                        idempotent=False,
                    )
                except _BackendTimeout as exc:
                    # slow writer, same contract as the direct write
                    # path: 504 without poisoning primary health (a
                    # 503 invites a client retry that would duplicate
                    # the still-executing write)
                    return (504, json.dumps({"error": {
                        "kind": "Timeout",
                        "message": f"writer timed out: {exc}",
                    }}).encode(), "application/json")
                except Exception as exc:
                    self.primary.healthy = False
                    self.primary.last_error = str(exc)
                    return (503, json.dumps({"error": {
                        "kind": "Unavailable",
                        "message": f"writer unreachable: {exc}",
                    }}).encode(), "application/json")
            if (
                status >= 400
                and backend.role == "replica"
                and path.startswith("/v1/query/")
            ):
                # e.g. a replica that missed a bundle deploy answers
                # "unknown stored query" — another backend may have the
                # route; keep the error only if every backend agrees
                last_response = (status, payload, ctype)
                continue
            return status, payload, ctype
        if last_response is not None:
            return last_response
        return (503, json.dumps({"error": {
            "kind": "Unavailable",
            "message": f"no healthy backend ({last_exc})",
        }}).encode(), "application/json")

    def topology(self) -> dict:
        learned = set(self._write_routes)
        if self._px is not None and self._native is not None:
            buf = ctypes.create_string_buffer(1 << 16)
            n = self._native.hxha_write_routes(self._px, buf, len(buf))
            if n > len(buf):
                buf = ctypes.create_string_buffer(int(n) + 1)
                n = self._native.hxha_write_routes(self._px, buf, len(buf))
            if n > 0:
                learned |= set(buf.raw[:n].decode().split("\n"))
        return {
            "primary": {
                "url": self.primary.url, "healthy": self.primary.healthy,
            },
            "replicas": [
                {"url": b.url, "healthy": b.healthy} for b in self.replicas
            ],
            "write_routes_learned": sorted(learned),
        }

    # -- native proxy plumbing --------------------------------------------

    def _backend_addr(self, url: str) -> tuple[str, int]:
        cached = getattr(self, "_addr_cache", None)
        if cached is None:
            cached = self._addr_cache = {}
        addr = cached.get(url)
        if addr is None:
            parsed = urllib.parse.urlsplit(url)
            # the native proxy connects by IPv4 literal; resolve once,
            # not on every 0.5 s health tick
            addr = cached[url] = (
                socket.gethostbyname(parsed.hostname or "127.0.0.1"),
                parsed.port or 80,
            )
        return addr

    def _push_backends(self) -> None:
        lines = []
        for backend in [self.primary, *self.replicas]:
            host, port = self._backend_addr(backend.url)
            role = "p" if backend.role == "primary" else "r"
            lines.append(f"{role} {host} {port} {1 if backend.healthy else 0}")
        self._native.hxha_set_backends(self._px, "\n".join(lines).encode())

    def _control_loop(self) -> None:
        """Serve /v1/ha and /v1/bundle handed over by the native proxy."""
        lib, px = self._native, self._px
        method = ctypes.create_string_buffer(16)
        path = ctypes.create_string_buffer(256)
        cap = 1 << 22
        body = ctypes.create_string_buffer(cap)
        hcap = 1 << 16
        hdrs = ctypes.create_string_buffer(hcap)
        blen = ctypes.c_longlong()
        hlen = ctypes.c_longlong()
        while not self._stop.is_set():
            reqid = lib.hxha_next_control(
                px, 200, method, len(method), path, len(path),
                body, cap, ctypes.byref(blen),
                hdrs, hcap, ctypes.byref(hlen),
            )
            if reqid == -1:
                return
            if reqid == -2:
                cap = max(cap, int(blen.value) + 1)
                hcap = max(hcap, int(hlen.value) + 1)
                body = ctypes.create_string_buffer(cap)
                hdrs = ctypes.create_string_buffer(hcap)
                continue
            if reqid == 0:
                continue
            # the proxy forwards the client's non-hop header lines
            # verbatim so the broadcast path sees the same headers the
            # pure-Python front would
            headers = {}
            for line in hdrs.raw[: hlen.value].decode(
                "latin-1"
            ).split("\r\n"):
                name, sep, value = line.partition(":")
                if sep:
                    headers[name.strip()] = value.strip()
            req_path = path.value.decode()
            req_body = body.raw[: blen.value]
            try:
                status, payload, ctype = self.handle(
                    method.value.decode(), req_path, req_body, headers,
                )
            except Exception as exc:  # pragma: no cover - defensive
                status, ctype = 500, "application/json"
                payload = json.dumps(
                    {"error": {"kind": "Internal", "message": str(exc)}}
                ).encode()
            lib.hxha_respond(px, reqid, status, ctype.encode(), payload,
                             len(payload))

    def _seed_write_routes(self, bundle_body: bytes) -> None:
        """A deployed bundle names its write routes up front — seed them
        into the proxy so the first call never needs the replica
        400-probe round trip."""
        try:
            routes = json.loads(bundle_body).get("write_routes") or {}
        except Exception:
            return
        for name in routes:
            self._write_routes.add(name)
            if self._px is not None:
                self._native.hxha_add_write_route(self._px, name.encode())

    def _start_native(self) -> bool:
        if os.environ.get("HELIX_HA_PYTHON"):
            return False
        try:
            from helix_tpu_torch.native import load

            self._native = load()
        except Exception:
            return False
        px = self._native.hxha_create(self.host.encode(), self.port)
        if not px:
            self._native = None
            return False
        self._px = px
        self._push_backends()
        self._native.hxha_start(px)
        self.port = self._native.hxha_port(px)
        self._ctl_thread = threading.Thread(
            target=self._control_loop, daemon=True
        )
        return True

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        for backend in [self.primary, *self.replicas]:
            self._probe(backend)
        if self._start_native():
            self._threads = [
                self._ctl_thread,
                threading.Thread(target=self._health_loop, daemon=True),
            ]
            for t in self._threads:
                t.start()
            return

        front = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # fully buffered responses: one TCP segment per reply instead
            # of a write per header line (Nagle x delayed-ACK stalls)
            wbufsize = -1

            def log_message(self, *args):  # quiet
                pass

            def _serve(self):
                if self.headers.get("Transfer-Encoding"):
                    # not dechunked here: forwarding an empty body would
                    # silently drop the payload
                    self.close_connection = True
                    err = (b'{"error": {"kind": "NotImplemented", '
                           b'"message": "chunked bodies unsupported"}}')
                    self.send_response(501)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(err)))
                    self.end_headers()
                    self.wfile.write(err)
                    return
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                status, payload, ctype = front.handle(
                    self.command, self.path, body, self.headers
                )
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            do_GET = do_POST = do_DELETE = _serve

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_port
        self._threads = [
            threading.Thread(target=self._httpd.serve_forever, daemon=True),
            threading.Thread(target=self._health_loop, daemon=True),
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        if self._px is not None:
            self._native.hxha_stop(self._px)
            # every thread that touches the handle must exit before it
            # is destroyed; if one is wedged (e.g. a broadcast stuck on
            # a hung backend), LEAK the handle rather than free memory
            # another thread is using
            busy = False
            for t in self._threads:
                t.join(timeout=10)
                busy = busy or t.is_alive()
            if not busy:
                self._native.hxha_destroy(self._px)
                self._px = None
            # else: the handle leaks AND stays set — a wedged thread
            # between its None-check and the native call would otherwise
            # pass NULL into C++ (segfault); the proxy is stopped, so
            # further calls on it are harmless
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="helix-tpu HA gateway front")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7070)
    parser.add_argument("--primary", required=True, help="writer URL")
    parser.add_argument("--replica", action="append", default=[],
                        help="read replica URL (repeatable)")
    parser.add_argument("--probe-interval", type=float, default=0.5)
    args = parser.parse_args(argv)
    front = HAFront(
        args.primary, args.replica, host=args.host, port=args.port,
        probe_s=args.probe_interval,
    )
    front.start()
    print(f"HA front on {args.host}:{front.port} -> "
          f"primary {args.primary}, {len(args.replica)} replicas",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        front.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
