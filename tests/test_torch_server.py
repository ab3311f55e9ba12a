"""The port's HTTP front door against the reference's.

A reference ``HelixHTTPServer`` (``helix_tpu``), the port's
``HelixHTTPServer`` and the port's ``NativeGateway`` (both on
``Engine(device="cpu")``) take the same requests over real sockets:
dynamic and stored queries, the vector fast path, ``/v1/bundle``,
``/v1/health``, ``/v1/source``, a 401 for a bad key, errors, and
``/mcp``.  The responses must be equal JSON.  Then: the fast path's
answers equal the interpreter's and are counted; vbatches of 1, 129
and 300 queries through the fused path (its kernel's plain version on
the CPU) answer as singles do; a port replica seeds from a reference
primary and from a port primary over ``/v1/snapshot`` and
``/v1/replication``; and the entry point ``python -m
helix_tpu_torch.server.http_server`` serves on ``--device cpu``, exits 0
on SIGTERM after its checkpoint, and exits nonzero naming CUDA when the
default device has no card.  Every server binds port 0 (the entry point
a free port), has socket timeouts, and stops in a ``finally`` block.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from helix_tpu.server import HelixHTTPServer as RefHTTPServer
from helix_tpu_torch.dsl import (
    DynamicQueryRequest, Expr, define_params, define_queries, g, param,
    read_batch, register_read, register_write, write_batch,
)
from helix_tpu_torch.native import NativeBuildError, load
from helix_tpu_torch.server import HelixHTTPServer
from helix_tpu_torch.server.native_gateway import NativeGateway

try:
    load()
except NativeBuildError:  # pragma: no cover
    pytest.skip("native toolchain unavailable", allow_module_level=True)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
KEY = "sekret"
DIM = 8
TIMEOUT = 30


def http(port: int, method: str, path: str, body=None, key: str | None = KEY,
         headers: dict | None = None):
    """``(status, JSON or None)`` of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {}),
                 **({"Authorization": f"Bearer {key}"} if key else {})})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        status, raw = exc.code, exc.read()
    return status, json.loads(raw) if raw else None


def unit(rng, n=None):
    v = rng.normal(size=(n or 1, DIM))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v if n else v[0]


def seed_request(n_docs: int = 64) -> dict:
    rng = np.random.default_rng(3)
    wb = (write_batch()
          .var_as("vidx", g().create_vector_index_nodes("Doc", "emb"))
          .var_as("tidx", g().create_text_index_nodes("Doc", "body")))
    words = "graph vector search engine node edge text rank".split()
    for i, vec in enumerate(unit(rng, n_docs)):
        wb = wb.var_as(f"d{i}", g().add_n("Doc", {
            "emb": [float(x) for x in vec], "title": f"t{i}",
            "body": " ".join(words[j % len(words)] for j in range(i % 5 + 2))}))
    return DynamicQueryRequest.write(wb).encode()


def bundle() -> dict:
    vec = define_params({"q": param.array(param.f32()), "k": param.i64()})
    doc = define_params({"title": param.string(),
                         "emb": param.array(param.f32())})
    return define_queries({
        "read": {
            "vsearch": register_read(
                lambda pp: read_batch().var_as(
                    "hits", g().vector_search_nodes(
                        "Doc", "emb", Expr.param("q"), Expr.param("k"))
                    .value_map(["$id", "$distance"]),
                ).returning(["hits"]), vec),
            "vsearch_title": register_read(
                lambda pp: read_batch().var_as(
                    "hits", g().vector_search_nodes(
                        "Doc", "emb", Expr.param("q"), Expr.param("k"))
                    .value_map(["title", "$distance"]),
                ).returning(["hits"]), vec),
        },
        "write": {
            "add_doc": register_write(
                lambda pp: write_batch().var_as(
                    "d", g().add_n("Doc", {"title": Expr.param("title"),
                                           "emb": Expr.param("emb")}),
                ).returning(["d"]), doc),
        },
    }).build_query_bundle()


def rpc(method, params=None, msg_id=1):
    body = {"jsonrpc": "2.0", "method": method}
    if msg_id is not None:
        body["id"] = msg_id
    if params is not None:
        body["params"] = params
    return ("POST", "/mcp", body)


def scenario() -> list:
    """``(name, method, path, body, headers, key)`` in order."""
    rng = np.random.default_rng(11)
    qs = [[float(x) for x in unit(rng)] for _ in range(8)]
    search = DynamicQueryRequest.read(read_batch().var_as(
        "hits", g().vector_search_nodes("Doc", "emb", qs[0], 4)
        .value_map(["$id", "$distance"])).returning(["hits"])).encode()
    steps = [
        ("health_empty", "GET", "/v1/health", None),
        ("seed", "POST", "/v1/query", seed_request()),
        ("bundle", "POST", "/v1/bundle", bundle()),
        ("count", "POST", "/v1/query", DynamicQueryRequest.read(
            read_batch().var_as("n", g().n_with_label("Doc").count())
            .returning(["n"])).encode()),
        ("dynamic_search", "POST", "/v1/query", search),
        ("dynamic_search_again", "POST", "/v1/query", search),
        ("stored_k3", "POST", "/v1/query/vsearch", {"q": qs[1], "k": 3}),
        ("stored_k5", "POST", "/v1/query/vsearch", {"q": qs[2], "k": 5}),
        ("stored_k64", "POST", "/v1/query/vsearch", {"q": qs[3], "k": 64}),
        ("stored_wrapped", "POST", "/v1/query/vsearch",
         {"parameters": {"q": qs[4], "k": 2}}),
        ("stored_title", "POST", "/v1/query/vsearch_title",
         {"q": qs[5], "k": 4}),
        ("stored_write", "POST", "/v1/query/add_doc",
         {"title": "new", "emb": qs[6]}),
        ("stored_after_write", "POST", "/v1/query/vsearch",
         {"q": qs[6], "k": 3}),
        ("stored_bad_dim", "POST", "/v1/query/vsearch",
         {"q": [1.0, 0.0], "k": 3}),
        ("stored_missing_k", "POST", "/v1/query/vsearch", {"q": qs[7]}),
        ("stored_unknown", "POST", "/v1/query/nope", {}),
        ("text_search", "POST", "/v1/query", DynamicQueryRequest.read(
            read_batch().var_as("hits", g().text_search_nodes("Doc", "body",
                                                        "graph rank", 5)
                                .value_map(["title", "$score"]))
            .returning(["hits"])).encode()),
        ("warm_write", "POST", "/v1/query", DynamicQueryRequest.write(
            write_batch().var_as("u", g().add_n("U"))).encode(),
         {"x-helix-warm": "true"}),
        ("bad_json", "POST", "/v1/query", "not a request"),
        ("not_found", "GET", "/v1/nothing", None),
        ("bad_key_get", "GET", "/v1/health", None, None, "wrong"),
        ("bad_key_post", "POST", "/v1/query/vsearch", {"q": qs[1], "k": 3},
         None, "wrong"),
        ("mcp_init", *rpc("initialize", {
            "protocolVersion": "2025-03-26", "capabilities": {},
            "clientInfo": {"name": "test", "version": "0"}})),
        ("mcp_tools", *rpc("tools/list")),
        ("mcp_vector", *rpc("tools/call", {"name": "vector_search",
                                           "arguments": {
                                               "label": "Doc",
                                               "property": "emb",
                                               "vector": qs[0], "k": 3}})),
        ("mcp_text", *rpc("tools/call", {"name": "text_search", "arguments": {
            "label": "Doc", "property": "body", "query": "vector", "k": 3}})),
        ("mcp_schema", *rpc("tools/call", {"name": "graph_schema",
                                           "arguments": {}})),
        ("mcp_notification", *rpc("notifications/initialized", msg_id=None)),
        ("source", "GET", "/v1/source", None),
        ("health_after", "GET", "/v1/health", None),
    ]
    return [s + (None,) * (6 - len(s)) for s in steps]


SCENARIO = scenario()
FRONT_DOORS = ("reference", "port_python", "port_native")


def start_server(kind: str, **kw):
    if kind == "reference":
        server = RefHTTPServer(host="127.0.0.1", port=0, **kw)
    elif kind == "port_python":
        server = HelixHTTPServer(host="127.0.0.1", port=0, device="cpu", **kw)
    else:
        server = NativeGateway(host="127.0.0.1", port=0, device="cpu", **kw)
    server.start()
    return server


@pytest.fixture(scope="module")
def answers():
    """Every front door's answers to the scenario, and the native
    gateway's counters after it."""
    out = {}
    fast = None
    for kind in FRONT_DOORS:
        server = start_server(kind, api_key=KEY)
        try:
            out[kind] = {
                name: http(server.port, method, path, body, key=key or KEY,
                           headers=headers)
                for name, method, path, body, headers, key in SCENARIO}
            if kind == "port_native":
                fast = server.stats()
        finally:
            server.stop()
    return out, fast


@pytest.mark.parametrize("step", [s[0] for s in SCENARIO])
def test_front_doors_answer_alike(answers, step):
    out, _ = answers
    ref = out["reference"][step]
    assert out["port_python"][step] == ref
    assert out["port_native"][step] == ref


def test_scenario_answers_what_it_should(answers):
    out, fast = answers
    ref = out["reference"]
    assert ref["health_empty"][1]["nodes"] == 0
    assert ref["count"] == (200, {"n": 64})
    assert [len(ref[f"stored_k{k}"][1]["hits"]) for k in (3, 5, 64)] \
        == [3, 5, 64]
    assert ref["stored_after_write"][1]["hits"][0]["$id"] \
        == ref["stored_write"][1]["d"][0]["$id"]
    for step in ("stored_bad_dim", "stored_missing_k", "stored_unknown",
                 "warm_write", "bad_json"):
        assert ref[step][0] == 400, step
    assert ref["bad_key_get"][0] == ref["bad_key_post"][0] == 401
    assert ref["not_found"][0] == 404
    assert {t["name"] for t in ref["mcp_tools"][1]["result"]["tools"]} == {
        "query", "vector_search", "text_search", "graph_schema"}
    assert ref["mcp_notification"] == (202, None)
    # the stored $id/$distance reads rode the native fast path
    assert fast["fast_requests"] >= 5, fast


@pytest.fixture()
def gateway():
    server = start_server("port_native")
    try:
        server.engine.execute(seed_request())
        status, _ = http(server.port, "POST", "/v1/bundle", bundle(), key=None)
        assert status == 200
        yield server
    finally:
        server.stop()


def test_fast_path_equals_slow_path_and_counts_every_request(gateway):
    rng = np.random.default_rng(4)
    before = gateway.stats()["fast_requests"]
    for i in range(16):
        params = {"q": [float(x) for x in unit(rng)], "k": 1 + i % 7}
        status, fast = http(gateway.port, "POST", "/v1/query/vsearch", params,
                            key=None)
        assert status == 200
        assert fast == json.loads(json.dumps(
            gateway.engine.execute_stored("vsearch", params)))
    assert gateway.stats()["fast_requests"] - before == 16


def pipelined(port: int, bodies: list, connections: int = 4) -> list:
    """Answers to ``bodies`` sent as pipelined stored-route requests over
    a few keep-alive connections, in order."""
    chunks = [list(range(c, len(bodies), connections))
              for c in range(connections)]
    answers = [None] * len(bodies)
    socks = []
    try:
        for idx in chunks:
            s = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
            socks.append(s)
            s.sendall(b"".join(
                b"POST /v1/query/vsearch HTTP/1.1\r\nHost: x\r\n"
                b"Content-Type: application/json\r\nContent-Length: "
                + str(len(b)).encode() + b"\r\n\r\n" + b
                for b in (json.dumps(bodies[i]).encode() for i in idx)))
        for s, idx in zip(socks, chunks):
            buf = b""
            for i in idx:
                while b"\r\n\r\n" not in buf:
                    buf += s.recv(1 << 16)
                head, buf = buf.split(b"\r\n\r\n", 1)
                assert head.startswith(b"HTTP/1.1 200"), head
                length = int(next(
                    line.split(b":")[1] for line in head.split(b"\r\n")
                    if line.lower().startswith(b"content-length")))
                while len(buf) < length:
                    buf += s.recv(1 << 16)
                answers[i], buf = json.loads(buf[:length]), buf[length:]
    finally:
        for s in socks:
            s.close()
    return answers


@pytest.fixture()
def fused_on_cpu(monkeypatch):
    """Route CPU searches through ``fused_topk`` (its kernel's plain
    version), as CUDA searches go, and record the batch sizes it sees."""
    from helix_tpu_torch.ops import distance as D
    from helix_tpu_torch.ops import fused_topk as TF

    seen = []
    real = TF.fused_topk

    def counted(xs16, xs32, qs, *args, **kwargs):
        seen.append(int(qs.shape[0]))
        return real(xs16, xs32, qs, *args, **kwargs)

    monkeypatch.setattr(D, "FUSED_ROW_THRESHOLD", 0)
    monkeypatch.setattr(TF, "fused_topk", counted)
    monkeypatch.setattr(TF, "supports_fused",
                        lambda n, d, metric, device, k=None: metric == "cosine"
                        and n % TF.TILE == 0 and k <= n // TF.BUCKET)
    return seen


def fused_engine(n_rows: int = 5000):
    from helix_tpu_torch.engine import Engine

    engine = Engine(device="cpu")
    rng = np.random.default_rng(12)
    rows = unit(rng, n_rows).astype(np.float32)
    engine.execute(DynamicQueryRequest.write(write_batch().var_as(
        "idx", g().create_vector_index_nodes("Doc", "emb"))).encode())
    engine.execute({
        "request_type": "write", "query_name": "ingest",
        "query": {"queries": [{"ForEach": {"param": "docs", "body": [
            {"Query": {"name": "d", "steps": [{"AddN": {
                "label": "Doc", "properties": [
                    ["emb", {"Expr": {"Param": "docs.emb"}}]]}}],
                "condition": None}}]}}], "returns": []},
        "parameters": {"docs": [{"emb": r} for r in rows.tolist()]},
        "parameter_types": {"docs": {"Array": "Object"}},
    })
    return engine


@pytest.mark.parametrize("batch", [1, 129, 300])
def test_vbatch_answers_equal_singles(fused_on_cpu, batch):
    """The fused path pads a batch of 1 (8 after ``search_packed_async``)
    to the kernel's 128 queries, 129 (256) to 256, and cuts 300 (512)
    into blocks of 256: each query's answer equals its own single
    search."""
    engine = fused_engine()
    part = engine.vectors.indexes[("NodeVector", "Doc", "emb")] \
        .partitions[("",)]
    qs = unit(np.random.default_rng(batch), batch).astype(np.float32)
    ids, dists = part.search_many(qs, 10)
    assert ids.shape == (batch, 10)
    for i in range(batch):
        one_ids, one_dists = part.search_many(qs[i:i + 1], 10)
        np.testing.assert_array_equal(ids[i], one_ids[0])
        np.testing.assert_allclose(dists[i], one_dists[0], rtol=1e-6, atol=0)
    # search_packed_async pads a batch to a power of two >= 8 first
    assert fused_on_cpu[0] >= batch and set(fused_on_cpu[1:]) == {8}


def test_pipelined_fast_path_batches_through_the_fused_path(fused_on_cpu):
    """300 requests in flight through the native gateway: fewer fused
    searches than requests, and every answer equals its single read."""
    server = NativeGateway(fused_engine(), host="127.0.0.1", port=0)
    server.start()
    try:
        assert http(server.port, "POST", "/v1/bundle", bundle(),
                    key=None)[0] == 200
        rng = np.random.default_rng(21)
        bodies = [{"q": [float(x) for x in unit(rng)], "k": 10}
                  for _ in range(300)]
        fused_on_cpu.clear()
        before = server.stats()["fast_requests"]
        got = pipelined(server.port, bodies)
        assert server.stats()["fast_requests"] - before == 300
        assert sum(fused_on_cpu) >= 300 and len(fused_on_cpu) < 300
        for body, answer in zip(bodies, got):
            want = server.engine.execute_stored("vsearch", body)
            assert [h["$id"] for h in answer["hits"]] \
                == [h["$id"] for h in want["hits"]]
            np.testing.assert_allclose(
                [h["$distance"] for h in answer["hits"]],
                [h["$distance"] for h in want["hits"]], rtol=1e-6, atol=1e-7)
    finally:
        server.stop()


def wait_for(predicate, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.1)
    return False


@pytest.mark.parametrize("primary_kind,replica_kind", [
    ("reference", "port_python"), ("reference", "port_native"),
    ("port_native", "port_python"), ("port_python", "port_native"),
])
def test_port_replica_seeds_and_follows(primary_kind, replica_kind):
    """A replica joining after the primary's ring trimmed seeds from
    ``/v1/snapshot``, tails ``/v1/replication``, and answers as the
    primary does (vector search included)."""
    primary = start_server(primary_kind)
    replica = None
    try:
        primary.engine.replication.cap = 4   # force the seed
        port = primary.port
        assert http(port, "POST", "/v1/query", seed_request(24),
                    key=None)[0] == 200
        for i in range(8):
            http(port, "POST", "/v1/query", DynamicQueryRequest.write(
                write_batch().var_as("u", g().add_n("User", {"i": i})))
                .encode(), key=None)
        assert primary.engine.replication.since(-1)[1], "ring must trim"
        replica = start_server(replica_kind,
                               replica_of=f"http://127.0.0.1:{port}")
        count = DynamicQueryRequest.read(read_batch().var_as(
            "n", g().n_with_label("User").count())).encode()
        assert wait_for(lambda: http(replica.port, "POST", "/v1/query", count,
                                     key=None)[1] == {"n": 8}), \
            replica.follower.last_error
        http(port, "POST", "/v1/query", DynamicQueryRequest.write(
            write_batch().var_as("u", g().add_n("User", {"i": 99}))).encode(),
            key=None)
        assert wait_for(lambda: http(replica.port, "POST", "/v1/query", count,
                                     key=None)[1] == {"n": 9})
        rng = np.random.default_rng(8)
        for q in unit(rng, 4):
            read = DynamicQueryRequest.read(read_batch().var_as(
                "hits", g().vector_search_nodes(
                    "Doc", "emb", [float(x) for x in q], 5)
                .value_map(["$id", "$distance", "title"])).returning(["hits"])
            ).encode()
            # ids exact; $distance to rtol 1e-6: the replica's index was
            # backfilled in bulk (one vectorised norm per block), the
            # primary's row by row, as in the reference
            got = http(replica.port, "POST", "/v1/query", read, key=None)
            want = http(port, "POST", "/v1/query", read, key=None)
            assert got[0] == want[0] == 200
            assert [(h["$id"], h["title"]) for h in got[1]["hits"]] \
                == [(h["$id"], h["title"]) for h in want[1]["hits"]]
            np.testing.assert_allclose(
                [h["$distance"] for h in got[1]["hits"]],
                [h["$distance"] for h in want[1]["hits"]], rtol=1e-6)
        assert http(replica.port, "POST", "/v1/query", DynamicQueryRequest.write(
            write_batch().var_as("u", g().add_n("User"))).encode(),
            key=None)[0] == 400
    finally:
        if replica is not None:
            replica.stop()
        primary.stop()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def entry_point(*args, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "helix_tpu_torch.server.http_server",
         "--host", "127.0.0.1", *args], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env={**os.environ, **(env or {})})


def test_entry_point_without_cuda_exits_naming_cuda():
    proc = entry_point("--port", str(free_port()),
                       env={"CUDA_VISIBLE_DEVICES": ""})
    try:
        _, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode != 0
    assert "CUDA" in err, err[-2000:]
    assert "native gateway unavailable" not in err


def test_entry_point_serves_on_the_cpu_and_recovers_after_sigterm(tmp_path):
    """``--device cpu --data-dir``: the native gateway answers, SIGTERM
    checkpoints and exits 0, and a restart serves the same answers (the
    durable HTTP write replayed or snapshotted)."""
    data = tmp_path / "data"
    answers = []
    for run in range(2):
        port = free_port()
        proc = entry_point("--port", str(port), "--device", "cpu",
                           "--data-dir", str(data))
        try:
            assert wait_for(lambda: _healthy(port), timeout=120), \
                proc.stderr.read() if proc.poll() is not None else "no answer"
            if run == 0:
                assert http(port, "POST", "/v1/query", seed_request(),
                            key=None)[0] == 200
                assert http(port, "POST", "/v1/bundle", bundle(),
                            key=None)[0] == 200
                assert http(port, "POST", "/v1/query/add_doc", {
                    "title": "durable", "emb": [1.0] + [0.0] * (DIM - 1)},
                    key=None, headers={"x-helix-await-durable": "true"})[0] \
                    == 200
            answers.append([
                http(port, "POST", "/v1/query/vsearch_title",
                     {"q": [1.0] + [0.0] * (DIM - 1), "k": 3}, key=None),
                {k: v for k, v in http(port, "GET", "/v1/health",
                                       key=None)[1].items()
                 if k != "epoch"}])   # the store's write counter restarts
            proc.send_signal(signal.SIGTERM)
            _, err = proc.communicate(timeout=120)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-2000:]
        assert "native gateway unavailable" not in err
        assert (data / "snapshot.bin").exists()
    assert answers[0] == answers[1]
    assert answers[0][0][1]["hits"][0]["title"] == "durable"


def _healthy(port: int) -> bool:
    try:
        return http(port, "GET", "/v1/health", key=None)[0] == 200
    except OSError:
        return False
