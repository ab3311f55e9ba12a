"""Serving soak (PyTorch port of ``benchmarks/soak.py``): mixed vector
search and ingest through the native gateway, tracking throughput,
latency percentiles and RSS stability.

A production-serving check, not a peak-throughput benchmark: the search
client runs closed-loop (one outstanding request per connection, the
latency-honest regime) while a second connection bulk-ingests waves of
2,000 documents; RSS is sampled before, during and after to catch leaks
in the C++ gateway, the parse path, or the engine's write path.  The
index (``n`` unit rows of seed 5) is exact and resident; above
``FUSED_ROW_THRESHOLD`` rows (65,536) each gateway read reaches kernel 1
(``NativeGateway._dispatch_vbatch`` -> ``Partition.search_many_async``,
one query padded to a block of 128).

Usage::

    python -m helix_tpu_torch.benchmarks.soak [--seconds 180] [--n 200000]
    python -m helix_tpu_torch.benchmarks.soak --device cpu --n 4096 \\
        --seconds 2

Prints one JSON line at the end.

Differences from the reference:

- ``--device cuda`` (the default; exits nonzero without a card) or
  ``cpu``: the engine, the partition and its ``PackedMatrix`` take it.
- The set-up is :func:`build` (the reference's lines, the same
  ``Partition`` internals poked), so a test can build the same index.
- After the soak and the settle, 16 single reads through the gateway
  (``/v1/query/vsearch``, fresh queries of the same generator) are held
  to an exact host oracle: ``post_soak_recall_at_10``.
- The line adds ``device``, ``post_soak_recall_at_10`` and
  ``kernel_launches`` (kernel 1's launches while the clients ran).
- ``main`` returns 1 when a client exits nonzero or prints no line, when
  ``nodes_final`` differs from ``ingested_docs`` (an acknowledged write
  is missing), or when the read-back recall is below
  :data:`RECALL_FLOOR`.  RSS gates nothing: on the card it includes the
  CUDA context.
- The client programs ``_CLIENT`` and ``_INGEST_CLIENT`` are the
  reference's, byte for byte.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

RECALL_FLOOR = 0.99
N_READBACK = 16


def rss_mb(pid: int) -> float:
    with open(f"/proc/{pid}/status") as fh:
        for line in fh:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024
    return 0.0


_CLIENT = r"""
import json, random, socket, sys, time

port, d, k, seconds = (int(sys.argv[1]), int(sys.argv[2]),
                       int(sys.argv[3]), float(sys.argv[4]))
random.seed(17)

def blob():
    v = [random.gauss(0.0, 1.0) for _ in range(d)]
    norm = max(sum(x * x for x in v) ** 0.5, 1e-9)
    body = json.dumps({"q": [x / norm for x in v], "k": k}).encode()
    return (b"POST /v1/query/vsearch HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: %d\r\n\r\n" % len(body) + body)

blobs = [blob() for _ in range(256)]

def read_response(s, buf):
    while True:
        split = buf.find(b"\r\n\r\n")
        if split >= 0:
            headers = buf[:split].decode("latin-1")
            length = int(headers.lower().split("content-length:")[1]
                         .split("\r\n")[0])
            if len(buf) >= split + 4 + length:
                return buf[split + 4 + length:]
        chunk = s.recv(1 << 16)
        if not chunk:
            raise ConnectionError("closed")
        buf += chunk

# closed-loop search client: latency-honest (one in flight)
s = socket.create_connection(("127.0.0.1", port), timeout=60)
s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
lat = []
end = time.perf_counter() + seconds
i = 0
buf = b""
while time.perf_counter() < end:
    t0 = time.perf_counter()
    s.sendall(blobs[i % 256])
    buf = read_response(s, buf)
    lat.append(time.perf_counter() - t0)
    i += 1
s.close()
lat.sort()
n = len(lat)
print(json.dumps({
    "search_requests": n,
    "search_qps": round(n / seconds, 1),
    "p50_ms": round(lat[n // 2] * 1000, 2),
    "p99_ms": round(lat[int(n * 0.99)] * 1000, 2),
    "max_ms": round(lat[-1] * 1000, 2),
}), flush=True)
"""

_INGEST_CLIENT = r"""
import json, random, socket, sys, time

port, d, seconds = int(sys.argv[1]), int(sys.argv[2]), float(sys.argv[3])
random.seed(23)
end = time.perf_counter() + seconds
total = 0
s = socket.create_connection(("127.0.0.1", port), timeout=120)
buf = b""
while time.perf_counter() < end:
    docs = [{"t": "s-%d" % i,
             "emb": [random.gauss(0.0, 1.0) for _ in range(d)]}
            for i in range(2000)]
    body = json.dumps({
        "request_type": "write", "query_name": "soak-ingest",
        "query": {"queries": [{"ForEach": {"param": "docs", "body": [
            {"Query": {"name": "dd", "steps": [{"AddN": {
                "label": "SoakDoc", "properties": [
                    ["t", {"Expr": {"Param": "docs.t"}}],
                    ["emb", {"Expr": {"Param": "docs.emb"}}],
                ]}}], "condition": None}}]}}], "returns": []},
        "parameters": {"docs": docs},
        "parameter_types": {"docs": {"Array": "Object"}},
    }).encode()
    s.sendall(b"POST /v1/query HTTP/1.1\r\nHost: x\r\n"
              b"Content-Length: %d\r\n\r\n" % len(body) + body)
    # wait for the response before the next wave (closed loop)
    while b"\r\n\r\n" not in buf or b"HTTP/1.1" not in buf:
        buf += s.recv(1 << 16)
    buf = b""
    total += 2000
    time.sleep(0.5)
s.close()
print(json.dumps({"ingested_docs": total}), flush=True)
"""


def build(n: int, d: int, device: torch.device | str, seed: int = 5):
    """The reference's soak index: ``n`` unit rows of ``default_rng(seed)``
    in one exact ``Partition`` of ``Doc.emb`` (ids 1..n), the ``vsearch``
    read route installed.  Returns ``(engine, partition, rng)``, the
    generator past the rows."""
    from ..engine import Engine
    from ..engine.vector import Partition
    from ..ops.distance import PackedMatrix

    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    matrix = PackedMatrix(d, "cosine", device=device)
    matrix.extend(data)

    engine = Engine(device=device, metric="cosine", batch_window_ms=None)
    engine.execute({
        "request_type": "write", "query_name": None,
        "query": {"queries": [{"Query": {"name": "idx", "steps": [
            {"CreateIndex": {"spec": {"NodeVector": {
                "label": "Doc", "property": "emb", "tenant_property": None,
            }}, "if_not_exists": True}}], "condition": None}}],
            "returns": []},
        "parameters": {},
    })
    index = engine.vectors.indexes[("NodeVector", "Doc", "emb")]
    part = Partition("cosine", device=torch.device(device))
    part.matrix = matrix
    part._ensure_capacity(matrix.n)
    part._ids[: matrix.n] = np.arange(1, matrix.n + 1, dtype=np.uint64)
    part._live[: matrix.n] = True
    part.n_rows = matrix.n
    part._n_live = matrix.n
    index.partitions[("",)] = part
    engine.load_bundle({
        "version": 5,
        "read_routes": {"vsearch": {"queries": [{"Query": {
            "name": "hits",
            "steps": [
                {"VectorSearchNodes": {
                    "label": "Doc", "property": "emb",
                    "query_vector": {"Expr": {"Param": "q"}},
                    "k": {"Expr": {"Param": "k"}},
                }},
                {"ValueMap": ["$id", "$distance"]},
            ], "condition": None}}], "returns": ["hits"]}},
        "read_parameters": {"vsearch": [
            {"name": "q", "ty": {"Array": "F32"}},
            {"name": "k", "ty": "I64"},
        ]},
        "write_routes": {}, "write_parameters": {},
    })
    return engine, part, rng


def readback(port: int, part, rng, d: int, k: int,
             n_reads: int = N_READBACK) -> float:
    """recall@k of ``n_reads`` single reads through the gateway at
    ``port`` against an exact host scan of the partition's rows (id =
    row + 1)."""
    matrix = part.matrix
    stored = matrix.data[: matrix.n, :d]
    hits = 0
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        for _ in range(n_reads):
            q = rng.normal(size=d).astype(np.float32)
            q /= np.linalg.norm(q)
            conn.request("POST", "/v1/query/vsearch",
                         body=json.dumps({"q": q.tolist(), "k": k}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise RuntimeError(f"read-back answered {resp.status}: "
                                   f"{body[:200]!r}")
            got = {int(h["$id"]) - 1 for h in json.loads(body)["hits"]}
            want = np.argsort(-(stored @ q), kind="stable")[:k]
            hits += len(got & set(want.tolist()))
    finally:
        conn.close()
    return hits / (n_reads * k)


def last_line(proc: subprocess.Popen, what: str) -> dict:
    try:
        out = proc.communicate(timeout=120)[0].strip().splitlines()
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0 or not out:
        raise RuntimeError(f"{what} exited {proc.returncode} with no line")
    return json.loads(out[-1])


def soak(args: argparse.Namespace, engine, part, rng, port: int) -> dict:
    """The clients against the gateway at ``port`` for ``args.seconds``,
    RSS sampled every 5 s, then the settle and the read-back: the line."""
    from ..ops import fused_topk as F

    # warm every padded batch-size bucket the soak can hit
    for b in (1, 8):
        part.search_many(
            rng.normal(size=(b, args.d)).astype(np.float32), args.k
        )
    rss_start = rss_mb(os.getpid())
    launched = F.bucket_scores.launches
    procs = []
    try:
        procs.append(subprocess.Popen(
            [sys.executable, "-S", "-c", _CLIENT, str(port),
             str(args.d), str(args.k), str(args.seconds)],
            stdout=subprocess.PIPE, text=True,
        ))
        procs.append(subprocess.Popen(
            [sys.executable, "-S", "-c", _INGEST_CLIENT, str(port),
             str(args.d), str(args.seconds)],
            stdout=subprocess.PIPE, text=True,
        ))
        samples = []
        deadline = time.time() + args.seconds
        while time.time() < deadline:
            time.sleep(5)
            samples.append(rss_mb(os.getpid()))
        search_out = last_line(procs[0], "the search client")
        ingest_out = last_line(procs[1], "the ingest client")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    launched = F.bucket_scores.launches - launched
    # settle + one idle GC tick, then final RSS
    time.sleep(6)
    rss_end = rss_mb(os.getpid())
    return {
        **search_out, **ingest_out,
        "seconds": args.seconds,
        "rss_start_mb": round(rss_start, 1),
        "rss_peak_mb": round(max(samples), 1),
        "rss_end_mb": round(rss_end, 1),
        "nodes_final": engine.store.node_count(),
        "device": (torch.cuda.get_device_name(part.device)
                   if part.device.type == "cuda" else "cpu"),
        "post_soak_recall_at_10": readback(port, part, rng, args.d, args.k),
        "kernel_launches": {"bucket_scores": launched},
    }


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="mixed search + ingest through the native gateway")
    parser.add_argument("--seconds", type=float, default=180.0)
    parser.add_argument("--n", type=int, default=200_000)
    parser.add_argument("--d", type=int, default=128)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("soak: no CUDA device (use --device cpu)", file=sys.stderr)
        return 1
    from ..native import load as load_native
    from ..server.native_gateway import NativeGateway

    load_native()
    engine, part, rng = build(args.n, args.d, device)
    gw = NativeGateway(engine, host="127.0.0.1", port=0)
    gw.start()
    try:
        line = soak(args, engine, part, rng, gw.port)
    except Exception as exc:  # noqa: BLE001 -- reported, exit 1
        print(f"soak: FAILED {exc!r}", file=sys.stderr)
        return 1
    finally:
        gw.stop(close_engine=False)
    print(json.dumps(line), flush=True)
    faults = []
    if line["nodes_final"] != line["ingested_docs"]:
        faults.append(f"nodes_final {line['nodes_final']} != ingested_docs "
                      f"{line['ingested_docs']}")
    if line["post_soak_recall_at_10"] < RECALL_FLOOR:
        faults.append(f"post-soak recall@{args.k} "
                      f"{line['post_soak_recall_at_10']} < {RECALL_FLOOR}")
    for fault in faults:
        print(f"soak: {fault}", file=sys.stderr)
    return 1 if faults else 0


if __name__ == "__main__":
    raise SystemExit(main())
