"""The one general generator: drives a cell's window from its mix's
parameters (``traffic/<mix>.json``, then ``cells/<cell>.json``).

``entry: engine`` — a closed loop of batches through the partition's
``search_many_async`` / ``finalize()``, ``in_flight`` batches
outstanding: batch i+1 is dispatched before batch i is finalized, the
pipelining the gateway's vbatch loop uses.  Latency of a batch: from its
dispatch call to the return of its ``finalize()``.

``entry: http`` — an open loop of single-query ``POST
/v1/query/<route>`` requests at ``rate_per_s``: the window's arrival
times are ``rate_per_s * seconds`` uniform draws, sorted (a Poisson
process given its count, so every seed offers the same number of
requests), sent by ``clients`` stdlib-only processes
(:mod:`hxbench.http_client`) over ``connections`` keep-alive, pipelined
connections each.  Latency of a request: from when it was due to when its
response was read whole."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np

from . import check, system

CLIENT = Path(__file__).resolve().parent / "http_client.py"
GRACE_S = 60.0
HTTP_WARM = 64


def percentile_ms(lat_s: list, q: float) -> float:
    return float(np.percentile(np.asarray(lat_s, np.float64), q) * 1e3)


# ------------------------------------------------------------- engine


class EngineLoop:
    def __init__(self, part, mix: dict, corpus, seconds: float):
        self.part = part
        self.mix = mix
        self.batch = int(mix["batch"])
        self.k = int(mix["k"])
        self.corpus = corpus
        n_batches = math.ceil(float(mix["pool_qps"]) * seconds / self.batch)
        self.pool = corpus.queries(n_batches * self.batch)

    def warm_batches(self) -> list[int]:
        return [self.batch]

    def window(self, seconds: float, spans) -> dict:
        part, b, k = self.part, self.batch, self.k
        in_flight = int(self.mix["in_flight"])
        pending: deque = deque()
        lat: list[float] = []
        answered: list[tuple] = []
        completed = failed = dispatched = 0
        t0 = time.perf_counter()
        t_end = t0 + seconds

        def finish() -> None:
            nonlocal completed, failed
            t_s, j, fin = pending.popleft()
            try:
                with spans.span("engine.finalize"):
                    ids, dists = fin()
            except Exception as exc:  # noqa: BLE001 — a failed batch counts
                print(f"batch {j} failed: {exc!r}", file=sys.stderr)
                failed += b
                return
            t_done = time.perf_counter()
            lat.append(t_done - t_s)
            answered.append((j, ids, dists))
            if t_done <= t_end:
                completed += b

        while time.perf_counter() < t_end:
            if (dispatched + 1) * b > len(self.pool):
                # a program faster than the pool was sized for: the pool
                # doubles (inside the window, so the rate pays for it)
                print(f"query pool of {len(self.pool)} doubled in the "
                      "window: pool_qps is below the rate", file=sys.stderr)
                self.pool = np.concatenate(
                    [self.pool, self.corpus.queries(len(self.pool))])
            q = self.pool[dispatched * b:(dispatched + 1) * b]
            t_s = time.perf_counter()
            try:
                with spans.span("engine.dispatch"):
                    fin = part.search_many_async(q, k)
            except Exception as exc:  # noqa: BLE001 — a failed batch counts
                print(f"batch {dispatched} failed: {exc!r}", file=sys.stderr)
                failed += b
                dispatched += 1
                continue
            pending.append((t_s, dispatched, fin))
            dispatched += 1
            if len(pending) >= in_flight:
                finish()
        while pending:
            finish()
        spans.record.count("batches", dispatched)
        spans.record.count("queries", dispatched * b)
        return {
            "attempted": dispatched * b,
            "failed": failed,
            "e2e": {"qps": completed / seconds,
                    "p50_ms": percentile_ms(lat, 50),
                    "p95_ms": percentile_ms(lat, 95)},
            "answered": answered,
        }

    def sample(self, result: dict, size: int, seed: int):
        """``(queries, ids, dists)`` of a sample of the answered queries."""
        answered = result["answered"]
        if not answered:
            return None
        rows = np.concatenate([
            np.arange(j * self.batch, (j + 1) * self.batch)
            for j, _, _ in answered])
        pick = check.sample(len(rows), size, seed)
        width = max(ids.shape[1] for _, ids, _ in answered)
        ids = np.concatenate([_pad(a, width, 0) for _, a, _ in answered])
        dists = np.concatenate([_pad(d, width, np.nan)
                                for _, _, d in answered])
        return self.pool[rows[pick]], ids[pick], dists[pick]

    def close(self) -> None:
        pass


def _pad(a: np.ndarray, width: int, fill) -> np.ndarray:
    a = np.asarray(a, np.float64 if isinstance(fill, float) else np.int64)
    if a.shape[1] == width:
        return a
    out = np.full((a.shape[0], width), fill, a.dtype)
    out[:, :a.shape[1]] = a
    return out


# --------------------------------------------------------------- http


class Counted:
    """Stands in the served partition's ``search_many_async`` for the
    window: counts each dispatch the vbatch loop forms and its queries,
    and times the dispatch and its ``finalize()`` as engine spans."""

    def __init__(self, part, spans):
        self.part = part
        self.inner = part.search_many_async
        self.spans = spans
        self.lock = threading.Lock()

    def __call__(self, queries, k):
        with self.lock:
            self.spans.record.count("dispatches")
            self.spans.record.count("queries_dispatched", len(queries))
        with self.spans.span("engine.dispatch"):
            fin = self.inner(queries, k)

        def finalize():
            with self.spans.span("engine.finalize"):
                return fin()

        return finalize

    def install(self) -> "Counted":
        self.part.search_many_async = self
        return self

    def remove(self) -> None:
        del self.part.search_many_async


class HttpLoop:
    def __init__(self, engine, part, mix: dict, config: dict, corpus,
                 seconds: float, seed: int, gw=None):
        self.engine = engine
        self.part = part
        self.mix = mix
        self.k = int(mix["k"])
        self.dim = int(config["dim"])
        if "rate_per_s" not in mix:
            raise ValueError("an http cell's rate_per_s goes in "
                             "cells/<workload>.json, found by a sweep "
                             "(hxbench.sweep)")
        n = int(round(float(mix["rate_per_s"]) * seconds))
        rng = np.random.default_rng([seed % (1 << 64), 6])
        self.due = np.sort(rng.uniform(0.0, seconds, n))
        self.pool = corpus.queries(n + HTTP_WARM)
        self.n = n
        self.sample_idx = check.sample(n, check.SAMPLE, seed)
        self.owns_gw = gw is None
        self.gw = system.serve(engine) if gw is None else gw
        self.procs: list[subprocess.Popen] = []

    def warm_batches(self) -> list[int]:
        """Every padded batch the vbatch loop can form: powers of two from
        8 to its cap (``search_packed_async`` pads a batch to one)."""
        cap = system.vbatch_cap()
        return [1 << e for e in range(3, cap.bit_length())]

    def start_clients(self) -> None:
        """Start the clients, hand each its requests, and wait until each
        has built them and connected; then send a few requests over HTTP
        (queries outside the window's) so the route is learned."""
        n_clients = int(self.mix["clients"])
        sample = set(int(i) for i in self.sample_idx)
        for c in range(n_clients):
            mine = np.arange(c, self.n, n_clients)
            header = {
                "port": self.gw.port, "dim": self.dim, "k": self.k,
                "path": f"/v1/query/{system.ROUTE}", "n": len(mine),
                "connections": int(self.mix["connections"]),
                "sample": [int(j) for j, i in enumerate(mine) if i in sample],
                "grace_s": GRACE_S,
            }
            proc = subprocess.Popen(
                [sys.executable, "-S", str(CLIENT)], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            self.procs.append(proc)
            proc.stdin.write(json.dumps(header).encode() + b"\n")
            proc.stdin.write(self.due[mine].astype(np.float64).tobytes())
            proc.stdin.write(np.ascontiguousarray(
                self.pool[mine], np.float32).tobytes())
            proc.stdin.flush()
        for proc in self.procs:
            line = proc.stdout.readline()
            if line.strip() != b"ready":
                raise RuntimeError(
                    f"client did not start: {line!r} "
                    f"{proc.stderr.read().decode()[-2000:]}")
        _http_warm(self.gw.port, self.pool[self.n:], self.k)

    def window(self, seconds: float, spans) -> dict:
        counted = Counted(self.part, spans).install()
        fast0 = system.fast_requests(self.gw)
        t0 = time.monotonic() + 0.05
        for proc in self.procs:
            proc.stdin.write(b"go %r\n" % t0)
            proc.stdin.flush()
            proc.stdin.close()
            proc.stdin = None
        time.sleep(max(0.0, t0 - time.monotonic()))
        time.sleep(seconds)
        return {"counted": counted, "fast0": fast0}

    def collect(self, result: dict, spans) -> dict:
        """Wait for the clients (each ends when its requests are answered,
        or ``GRACE_S`` past its last due time) and read their records."""
        outs = []
        try:
            for proc in self.procs:
                out, err = proc.communicate(timeout=GRACE_S + 120)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"client failed: {err.decode()[-2000:]}")
                outs.append(json.loads(out.decode().strip().splitlines()[-1]))
        finally:
            result["counted"].remove()
        n_clients = len(self.procs)
        lat = np.full(self.n, np.inf)
        late = np.zeros(self.n)
        status = np.zeros(self.n, np.int64)
        bodies: dict[int, str] = {}
        for c, out in enumerate(outs):
            mine = np.arange(c, self.n, n_clients)
            lat[mine] = [x if x >= 0 else np.inf for x in out["lat"]]
            late[mine] = out["late"]
            status[mine] = out["status"]
            for j, body in out["bodies"].items():
                bodies[int(mine[int(j)])] = body
        self.latencies = lat
        ok = (status == 200) & np.isfinite(lat)
        failed = int((~ok).sum())
        spans.record.count("fast_requests",
                           system.fast_requests(self.gw) - result["fast0"])
        print(json.dumps({"generator_late_ms": {
            "p50": float(np.percentile(late, 50) * 1e3),
            "p99": float(np.percentile(late, 99) * 1e3),
            "max": float(late.max() * 1e3)},
            "dispatches": spans.record.counts.get("dispatches", 0),
            "queries_dispatched":
                spans.record.counts.get("queries_dispatched", 0),
            "fast_requests": spans.record.counts["fast_requests"],
            "requests": self.n}), file=sys.stderr)
        lat_all = np.where(ok, lat, np.inf)
        return {
            "attempted": self.n,
            "failed": failed,
            "e2e": {"p50_ms": float(np.percentile(lat_all, 50) * 1e3),
                    "p95_ms": float(np.percentile(lat_all, 95) * 1e3)},
            "bodies": bodies,
        }

    def sample(self, result: dict, size: int, seed: int):
        idx = self.sample_idx
        ids = np.zeros((len(idx), self.k), np.int64)
        dists = np.full((len(idx), self.k), np.nan)
        for r, i in enumerate(idx):
            body = result["bodies"].get(int(i))
            if body is None:
                continue
            hits = json.loads(body).get("hits", [])[: self.k]
            for j, hit in enumerate(hits):
                ids[r, j] = int(hit["$id"])
                dists[r, j] = float(hit["$distance"])
        return self.pool[idx], ids, dists

    def close(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        if self.owns_gw:
            self.gw.stop(close_engine=False)


def _http_warm(port: int, queries: np.ndarray, k: int) -> None:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        for q in queries:
            body = json.dumps({"q": [float(v) for v in q], "k": k})
            conn.request("POST", f"/v1/query/{system.ROUTE}", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            if resp.status != 200:
                raise RuntimeError(f"warm-up request answered {resp.status}")
    finally:
        conn.close()
