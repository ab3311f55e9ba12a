"""The reference's HA front tests (``tests/test_ha_front.py``) on the
port: the port's ``HAFront`` over the port's servers (``device="cpu"``)
as primary and replicas; write routing, read fan-out, failover, stored-
route kind discovery, and the native proxy from the port's own loader.
Added: mixed clusters each way (the port's front over the reference's
servers, the reference's front over the port's), each replaying the
parity corpus' runtime bucket through the front and held to its golden.
Reference topology: single writer + autoscaled readers behind 3+
gateways (``README.md:248``)."""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from helix_tpu_torch.client import Client
from helix_tpu_torch.server import HelixHTTPServer
from helix_tpu_torch.server.ha_front import HAFront


def _post(port: int, path: str, payload: dict, headers: dict | None = None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


WRITE_USER = {
    "request_type": "write", "query_name": None,
    "query": {"queries": [{"Query": {
        "name": "u",
        "steps": [{"AddN": {"label": "User", "properties": [
            ["name", {"Value": {"String": "ha-user"}}]]}}],
        "condition": None}}], "returns": []},
    "parameters": {},
}

COUNT_USERS = {
    "request_type": "read", "query_name": None,
    "query": {"queries": [{"Query": {
        "name": "n",
        "steps": [{"NWhere": {"Eq": ["$label", {"String": "User"}]}}, "Count"],
        "condition": None}}], "returns": ["n"]},
    "parameters": {},
}


def _wait(predicate, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.1)
    return False


@pytest.fixture
def cluster():
    primary = HelixHTTPServer(host="127.0.0.1", port=0, device="cpu")
    primary.start()
    replicas = []
    for _ in range(2):
        replica = HelixHTTPServer(
            host="127.0.0.1", port=0,
            replica_of=f"http://127.0.0.1:{primary.port}", device="cpu",
        )
        replica.start()
        replicas.append(replica)
    front = HAFront(
        f"http://127.0.0.1:{primary.port}",
        [f"http://127.0.0.1:{r.port}" for r in replicas],
        host="127.0.0.1", probe_s=0.2,
    )
    front.start()
    yield primary, replicas, front
    front.stop()
    for r in replicas:
        r.stop()
    primary.stop()


def test_writes_reach_primary_reads_fan_out(cluster):
    primary, replicas, front = cluster
    status, _ = _post(front.port, "/v1/query", WRITE_USER)
    assert status == 200
    # the write landed on the primary and replicated out
    assert _wait(lambda: all(
        Client(f"http://127.0.0.1:{r.port}").query()
        .dynamic(COUNT_USERS).send()["n"] == 1
        for r in replicas
    )), "write did not replicate"
    # reads through the front see it too (served by a replica)
    status, out = _post(front.port, "/v1/query", COUNT_USERS)
    assert (status, out["n"]) == (200, 1)


def test_replica_failover(cluster):
    primary, replicas, front = cluster
    _post(front.port, "/v1/query", WRITE_USER)
    assert _wait(lambda: Client(f"http://127.0.0.1:{replicas[1].port}")
                 .query().dynamic(COUNT_USERS).send()["n"] == 1)
    replicas[0].stop()
    # every read must keep succeeding through the remaining backends
    for _ in range(6):
        status, out = _post(front.port, "/v1/query", COUNT_USERS)
        assert (status, out["n"]) == (200, 1)
    assert _wait(lambda: not front.replicas[0].healthy)


def test_primary_down_reads_survive_writes_fail_fast(cluster):
    primary, replicas, front = cluster
    _post(front.port, "/v1/query", WRITE_USER)
    assert _wait(lambda: all(
        Client(f"http://127.0.0.1:{r.port}").query()
        .dynamic(COUNT_USERS).send()["n"] == 1
        for r in replicas
    ))
    primary.stop()
    assert _wait(lambda: not front.primary.healthy)
    status, out = _post(front.port, "/v1/query", COUNT_USERS)
    assert (status, out["n"]) == (200, 1)
    status, out = _post(front.port, "/v1/query", WRITE_USER)
    assert status == 503
    assert "writes are unavailable" in out["error"]["message"]


def test_stored_route_kind_discovery(cluster):
    primary, replicas, front = cluster
    bundle = {
        "version": 5,
        "read_routes": {"count_users": {
            "queries": COUNT_USERS["query"]["queries"],
            "returns": ["n"]}},
        "read_parameters": {"count_users": []},
        "write_routes": {"add_user": {
            "queries": WRITE_USER["query"]["queries"], "returns": []}},
        "write_parameters": {"add_user": []},
    }
    status, _ = _post(front.port, "/v1/bundle", bundle)
    assert status == 200
    # write-kind stored route: replica rejects, front learns + retries
    status, _ = _post(front.port, "/v1/query/add_user", {})
    assert status == 200
    assert "add_user" in front.topology()["write_routes_learned"]
    # and the primary actually has the node
    assert _wait(
        lambda: Client(f"http://127.0.0.1:{primary.port}").query()
        .dynamic(COUNT_USERS).send()["n"] == 1
    )
    # read-kind stored route serves from a replica
    assert _wait(lambda: _post(
        front.port, "/v1/query/count_users", {})[1].get("n") == 1)


def test_require_writer_header_routes_to_primary(cluster):
    primary, replicas, front = cluster
    status, _ = _post(
        front.port, "/v1/query", COUNT_USERS,
        headers={"x-helix-require-writer": "true"},
    )
    assert status == 200
    # topology endpoint reports the fleet
    with urllib.request.urlopen(
        f"http://127.0.0.1:{front.port}/v1/ha", timeout=10
    ) as resp:
        topo = json.loads(resp.read())
    assert topo["primary"]["healthy"] and len(topo["replicas"]) == 2


def test_source_push_routes_to_primary(cluster):
    primary, replicas, front = cluster
    files = {"q.py": {"content_b64": "cGFzcw==", "sha256": "x",
                      "last_modified_ms": 1}}
    status, out = _post(front.port, "/v1/source", {"files": files})
    assert status == 200
    # the snapshot landed on the PRIMARY, where sync will look for it
    with urllib.request.urlopen(
        f"http://127.0.0.1:{primary.port}/v1/source", timeout=10
    ) as resp:
        assert "q.py" in json.loads(resp.read())["files"]
    # replicas reject direct source pushes outright
    status, out = _post(replicas[0].port, "/v1/source", {"files": files})
    assert status == 400 and "read-only replica" in out["error"]["message"]


def test_stored_route_failover_when_replica_lacks_bundle(cluster):
    primary, replicas, front = cluster
    # deploy the bundle ONLY to the primary (simulates a replica that
    # missed a broadcast, e.g. it was down during deploy)
    bundle = {
        "version": 5,
        "read_routes": {"count_users": {
            "queries": COUNT_USERS["query"]["queries"], "returns": ["n"]}},
        "read_parameters": {"count_users": []},
        "write_routes": {}, "write_parameters": {},
    }
    status, _ = _post(primary.port, "/v1/bundle", bundle)
    assert status == 200
    # the front must fail over past replicas' unknown-route errors to
    # the backend that has the route
    status, out = _post(front.port, "/v1/query/count_users", {})
    assert (status, out.get("n")) == (200, 0)


def test_failover_under_load_with_throughput():
    """Sustained concurrent reads while a replica dies mid-run: every
    request must succeed (the dying backend's in-flight failures retry
    on the next healthy one), and the front must sustain a real data
    rate through its pooled backend connections.  Backends are stub
    HTTP servers (canned engine responses) so the number measures the
    FRONT's proxy path, not engine compute; the measured QPS prints so
    bench notes can quote it."""
    import http.client
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Stub(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        wbufsize = -1  # single-segment replies (avoid Nagle stalls)
        canned = json.dumps({"n": 1}).encode()

        def log_message(self, *args):
            pass

        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            self.rfile.read(length)
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(self.canned)))
            self.end_headers()
            self.wfile.write(self.canned)

        def do_GET(self):  # /v1/health
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

    stubs = []
    for _ in range(3):
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        stubs.append(httpd)
    front = HAFront(
        f"http://127.0.0.1:{stubs[0].server_port}",
        [f"http://127.0.0.1:{s.server_port}" for s in stubs[1:]],
        host="127.0.0.1", probe_s=0.2,
    )
    front.start()
    try:
        body = json.dumps(COUNT_USERS).encode()
        n_threads, per_thread = 8, 250
        errors: list = []

        def worker():
            conn = http.client.HTTPConnection(
                "127.0.0.1", front.port, timeout=30
            )
            for _ in range(per_thread):
                try:
                    conn.request(
                        "POST", "/v1/query", body=body,
                        headers={"Content-Type": "application/json"},
                    )
                    resp = conn.getresponse()
                    payload = resp.read()
                    if resp.status != 200:
                        errors.append(payload[:200])
                except Exception as exc:  # pragma: no cover - diagnostics
                    errors.append(repr(exc))
            conn.close()

        start = time.perf_counter()
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        # kill a replica while the load is in flight
        time.sleep(0.2)
        stubs[1].shutdown()
        for t in threads:
            t.join(timeout=120)
        elapsed = time.perf_counter() - start

        total = n_threads * per_thread
        assert not errors, errors[:5]
        qps = total / elapsed
        print(f"\nHA front failover-under-load: {total} reads in "
              f"{elapsed:.2f}s = {qps:.0f} req/s (replica killed mid-run)")
        # the pooled-connection front must comfortably beat the old
        # per-request-connect ceiling (~300 req/s on this machine class)
        assert qps > 400, qps
    finally:
        front.stop()
        for s in stubs:
            s.shutdown()


def test_native_data_path_active():
    """The front's data path must ride the native C++ proxy when the
    toolchain is present (the pure-Python server is the fallback, not
    the default), and the proxy's stats must account proxied traffic."""
    import ctypes
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    pytest.importorskip("helix_tpu_torch.native")
    try:
        from helix_tpu_torch.native import load

        load()
    except Exception as exc:  # pragma: no cover - no toolchain
        pytest.skip(f"native build unavailable: {exc}")

    class Stub(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        wbufsize = -1

        def log_message(self, *args):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            body = b'{"n": 3}'
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        do_GET = do_POST

    stub = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    threading.Thread(target=stub.serve_forever, daemon=True).start()
    front = HAFront(f"http://127.0.0.1:{stub.server_port}", [],
                    host="127.0.0.1", probe_s=5.0)
    front.start()
    try:
        assert front._px is not None, "native proxy did not start"
        status, out = _post(front.port, "/v1/query", COUNT_USERS)
        assert (status, out) == (200, {"n": 3})
        proxied = ctypes.c_uint64()
        retries = ctypes.c_uint64()
        control = ctypes.c_uint64()
        front._native.hxha_stats(
            front._px, ctypes.byref(proxied), ctypes.byref(retries),
            ctypes.byref(control),
        )
        assert proxied.value >= 1
    finally:
        front.stop()
        stub.shutdown()


def test_stale_keepalive_reconnects_after_backend_restart():
    """A backend that restarts (new listener, same port) leaves the
    front's pooled connection stale; the next proxied request must
    transparently reconnect rather than fail."""
    import http.client
    import socket
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Stub(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        wbufsize = -1
        canned = b'{"n": 2}'

        def log_message(self, *args):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(self.canned)))
            self.end_headers()
            self.wfile.write(self.canned)

        do_GET = do_POST

    def start_stub(port=0):
        httpd = ThreadingHTTPServer(("127.0.0.1", port), Stub)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd

    stub = start_stub()
    port = stub.server_port
    front = HAFront(f"http://127.0.0.1:{port}", [], host="127.0.0.1",
                    probe_s=5.0)
    front.start()
    try:
        body = json.dumps(COUNT_USERS).encode()
        status, payload = _post(front.port, "/v1/query", json.loads(body))
        assert status == 200

        # restart the backend on the SAME port: pooled socket goes stale
        stub.shutdown()
        stub.server_close()
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                stub = start_stub(port)
                break
            except OSError:
                time.sleep(0.2)

        status, payload = _post(front.port, "/v1/query", json.loads(body))
        assert status == 200 and payload == {"n": 2}
    finally:
        front.stop()
        stub.shutdown()


def test_chunked_backend_response_through_native_proxy():
    """A non-native backend may answer with Transfer-Encoding: chunked;
    the native proxy must decode the chunk stream and relay a plain
    Content-Length response (our own gateways always send lengths, but
    the front cannot assume every fleet member is ours)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class ChunkedStub(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        wbufsize = -1

        def log_message(self, *args):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            body = b'{"n": 7}'
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            # two data chunks + a trailer section terminator
            for part in (body[:3], body[3:]):
                self.wfile.write(b"%x\r\n" % len(part))
                self.wfile.write(part)
                self.wfile.write(b"\r\n")
            self.wfile.write(b"0\r\n\r\n")

        do_GET = do_POST

    stub = ThreadingHTTPServer(("127.0.0.1", 0), ChunkedStub)
    threading.Thread(target=stub.serve_forever, daemon=True).start()
    front = HAFront(f"http://127.0.0.1:{stub.server_port}", [],
                    host="127.0.0.1", probe_s=5.0)
    front.start()
    try:
        if front._px is None:
            pytest.skip("native proxy unavailable")
        # twice: the second request exercises the pooled connection the
        # completed chunk stream left reusable
        for _ in range(2):
            status, out = _post(front.port, "/v1/query", COUNT_USERS)
            assert (status, out) == (200, {"n": 7})
    finally:
        front.stop()
        stub.shutdown()


def test_bundle_deploy_seeds_write_routes(cluster):
    """Deploying a bundle must seed its write routes into the front
    up-front: the very first stored write call routes straight to the
    primary with no replica 400-probe round trip."""
    primary, replicas, front = cluster
    bundle = {
        "version": 5,
        "read_routes": {}, "read_parameters": {},
        "write_routes": {"add_user": {
            "queries": WRITE_USER["query"]["queries"], "returns": []}},
        "write_parameters": {"add_user": []},
    }
    status, _ = _post(front.port, "/v1/bundle", bundle)
    assert status == 200
    # learned BEFORE any stored call was made
    assert "add_user" in front.topology()["write_routes_learned"]
    status, _ = _post(front.port, "/v1/query/add_user", {})
    assert status == 200
    assert _wait(
        lambda: Client(f"http://127.0.0.1:{primary.port}").query()
        .dynamic(COUNT_USERS).send()["n"] == 1
    )


def test_control_path_forwards_client_headers():
    """/v1/bundle rides the proxy's control queue; the client's non-hop
    headers (e.g. auth tokens) must reach the Python handler and be
    forwarded to the backends."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    seen: dict = {}

    class RecordingStub(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        wbufsize = -1

        def log_message(self, *args):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            if self.path == "/v1/bundle":
                seen.update(self.headers.items())
            body = b"{}"
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        do_GET = do_POST

    stub = ThreadingHTTPServer(("127.0.0.1", 0), RecordingStub)
    threading.Thread(target=stub.serve_forever, daemon=True).start()
    front = HAFront(f"http://127.0.0.1:{stub.server_port}", [],
                    host="127.0.0.1", probe_s=5.0)
    front.start()
    try:
        if front._px is None:
            pytest.skip("native proxy unavailable")
        status, _ = _post(
            front.port, "/v1/bundle",
            {"version": 5, "read_routes": {}, "read_parameters": {},
             "write_routes": {}, "write_parameters": {}},
            headers={"Authorization": "Bearer control-token"},
        )
        assert status == 200
        assert seen.get("Authorization") == "Bearer control-token"
    finally:
        front.stop()
        stub.shutdown()


def test_proxy_rejects_chunked_and_bad_content_length(cluster):
    """The native proxy must not forward a chunked request with an
    empty body (its chunk framing would parse as the next request —
    smuggling), nor honor a malformed Content-Length as 0."""
    import socket

    primary, replicas, front = cluster
    for raw in (
        b"POST /v1/query HTTP/1.1\r\nHost: x\r\n"
        b"Transfer-Encoding: chunked\r\n\r\n"
        b"5\r\nhello\r\n0\r\n\r\n",
        b"POST /v1/query HTTP/1.1\r\nHost: x\r\n"
        b"Content-Length: 2abc\r\n\r\n"
        b"GET /v1/health HTTP/1.1\r\n\r\n",
        # duplicate Content-Length: honoring the last value while a
        # front hop honors the first desynchronizes the stream
        b"POST /v1/query HTTP/1.1\r\nHost: x\r\n"
        b"Content-Length: 2\r\nContent-Length: 48\r\n\r\n"
        b"{}GET /v1/health HTTP/1.1\r\nHost: x\r\n\r\n",
    ):
        with socket.create_connection(
            ("127.0.0.1", front.port), timeout=5
        ) as s:
            s.sendall(raw)
            buf = b""
            deadline = time.time() + 5
            while time.time() < deadline:
                try:
                    chunk = s.recv(65536)
                except TimeoutError:
                    break
                if not chunk:
                    break
                buf += chunk
        # the connection must be torn down without proxying anything;
        # no smuggled /v1/health response may ever appear
        assert b'"nodes"' not in buf and b'"status"' not in buf


def test_escaped_write_rerouted_to_primary(cluster):
    """A dynamic write whose request_type is JSON-escaped slips past the
    byte sniff and lands on a replica; the replica's read-only 400 must
    reroute it to the primary, not surface to the client."""
    primary, replicas, front = cluster
    body = json.dumps({
        "request_type": "write", "query_name": None,
        "query": {"queries": [{"Query": {"name": "d", "steps": [
            {"AddN": {"label": "Esc", "properties": []}},
        ], "condition": None}}], "returns": []},
        "parameters": {},
    }).replace('"write"', '"\\u0077rite"').encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{front.port}/v1/query", data=body,
        headers={"content-type": "application/json"},
    )
    out = json.loads(urllib.request.urlopen(req, timeout=15).read())
    assert out["d"][0]["$label"] == "Esc"
    # the write executed exactly ONCE, on the primary
    n = Client(f"http://127.0.0.1:{primary.port}").execute({
        "request_type": "read",
        "query": {"queries": [{"Query": {"name": "n", "steps": [
            {"NWhere": {"Eq": ["$label", {"String": "Esc"}]}}, "Count",
        ], "condition": None}}], "returns": ["n"]},
    })["n"]
    assert n == 1


# -- mixed clusters: one package's front over the other's servers ----------


def _replay_through_front(make_server, front_cls) -> dict:
    """Replay the runtime bucket through ``front_cls`` over a primary and
    two replicas made by ``make_server``: each write goes to the primary
    and is waited for on both replicas; each read is sent twice, so
    that both replicas answer it (round robin), and must agree."""
    from tests.parity.replay import fixture_paths

    primary = make_server()
    primary.start()
    replicas = []
    front = None
    try:
        for _ in range(2):
            replicas.append(make_server(
                replica_of=f"http://127.0.0.1:{primary.port}"))
            replicas[-1].start()
        front = front_cls(
            f"http://127.0.0.1:{primary.port}",
            [f"http://127.0.0.1:{r.port}" for r in replicas],
            host="127.0.0.1", probe_s=0.2,
        )
        front.start()
        assert front._px is not None, "the native proxy did not start"
        results = {}
        for path in fixture_paths("runtime"):
            request = json.loads(path.read_text())
            if request["request_type"] == "write":
                status, out = _post(front.port, "/v1/query", request)
                assert status == 200, out
                head = primary.engine.replication.head_seq()
                assert _wait(lambda: all(r.follower.applied_seq >= head
                                         for r in replicas)), path.stem
            else:
                (status, out), again = (
                    _post(front.port, "/v1/query", request) for _ in range(2))
                assert status == 200 and again == (status, out), path.stem
            results[path.stem] = out
        return results
    finally:
        if front is not None:
            front.stop()
        for server in (*replicas, primary):
            server.stop()


@pytest.mark.parametrize("servers,front", [
    ("helix_tpu", "helix_tpu_torch"), ("helix_tpu_torch", "helix_tpu"),
])
def test_mixed_cluster_answers_the_golden(servers, front):
    import functools
    import importlib

    from tests.test_parity import approx_equal

    server_cls = importlib.import_module(f"{servers}.server").HelixHTTPServer
    front_cls = importlib.import_module(f"{front}.server.ha_front").HAFront
    device = {"device": "cpu"} if servers == "helix_tpu_torch" else {}
    make = functools.partial(server_cls, host="127.0.0.1", port=0, **device)
    got = _replay_through_front(make, front_cls)
    golden = json.loads((Path(__file__).parent / "parity" / "expected"
                         / "runtime.json").read_text())
    assert set(got) == set(golden)
    for name in golden:
        assert approx_equal(got[name], golden[name]), (
            f"{name}: {got[name]} vs golden {golden[name]}")
