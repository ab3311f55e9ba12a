"""The one general generator: drives a cell's window from its mix's
parameters (``traffic/<mix>.json``, then ``cells/<cell>.json``).

``entry: engine`` — a closed loop of batches through the partition's
``search_many_async`` / ``finalize()``, ``in_flight`` batches
outstanding: batch i+1 is dispatched before batch i is finalized, the
pipelining the gateway's vbatch loop uses.  Latency of a batch: from its
dispatch call to the return of its ``finalize()``.  ``insert_share``
(inserts as a share of all operations; absent or 0 for none) makes it a
write mix: after each dispatch the loop inserts until its inserts reach
``insert_share / (1 - insert_share)`` times the queries dispatched (one
per 19 at YCSB D's 0.05), each one ``Partition.add`` on the loop's
thread while the batches in flight stay outstanding, timed as the span
``engine.insert``.  The rows come from the seed's insert stream
(:meth:`hxbench.data.Corpus.inserts`), drawn before the window in
proportion to the query pool; their ids continue from the built rows'
(row position + 1).  The stream's first row is inserted in set-up, as
the first write after the bulk build grows the id table and the matrix
once; the window's inserts come after it.  ``latest_share`` (YCSB D's
``requestdistribution=latest``) is the share of each batch's queries
that are the newest rows acknowledged before its dispatch, newest
first, each searched with its own row; the rest come from the query
pool.  Each batch records the inserts acknowledged before its dispatch
and before its ``finalize()`` returned, which the comparison holds it to
(:mod:`hxbench.check`: a search returns every row acknowledged before
its dispatch, and may return those acknowledged before its finalize; a
latest query's own row is among its hits).  After the window the newest
acknowledged rows, up to one batch, are searched once more and held to
the same rule.  ``attempted`` and ``failed`` count the window's inserts
beside its queries; ``qps`` and the latencies stay the searches'.

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
from fractions import Fraction
from pathlib import Path

import numpy as np

from . import check, system

CLIENT = Path(__file__).resolve().parent / "http_client.py"
GRACE_S = 60.0
# inserts a write mix makes in set-up, before the window
SETUP_INSERTS = 1
HTTP_WARM = 64


def percentile_ms(lat_s: list, q: float) -> float:
    return float(np.percentile(np.asarray(lat_s, np.float64), q) * 1e3)


# ------------------------------------------------------------- engine


class EngineLoop:
    def __init__(self, part, mix: dict, corpus, seconds: float,
                 min_batches: int = 0):
        share = Fraction(str(mix.get("insert_share", 0)))
        latest = Fraction(str(mix.get("latest_share", 0)))
        if not 0 <= share < 1:
            raise ValueError(f"insert_share {share} is not in [0, 1)")
        if not 0 <= latest <= 1 or (latest and not share):
            raise ValueError(f"latest_share {latest} needs an insert_share "
                             "and is in [0, 1]")
        self.part = part
        self.mix = mix
        self.batch = int(mix["batch"])
        self.k = int(mix["k"])
        self.corpus = corpus
        # a rehearsal on a loaded CPU keeps its window open until this many
        # batches are answered (cells leave it 0)
        self.min_batches = min_batches
        n_batches = math.ceil(float(mix["pool_qps"]) * seconds / self.batch)
        self.pool = corpus.queries(n_batches * self.batch)
        # inserts per query dispatched: 1/19 for a 5% share
        self.ratio = share / (1 - share)
        # the slots of each batch that search the newest acknowledged rows
        self.n_latest = int(latest * self.batch)
        # element ids continue from the built rows' (row position + 1)
        self.base = int(part.n_rows)
        self.tried = 0
        # insert-pool index of each acknowledged insert, in order: the
        # i-th sits at row position base + i under id base + i + 1
        self.acked: list[int] = []
        self.inserts = None
        if self.ratio:
            self.inserts = corpus.inserts(
                SETUP_INSERTS + math.ceil(len(self.pool) * self.ratio))
            # set-up: the first write after the bulk build grows the id
            # table and the matrix, once
            for _ in range(SETUP_INSERTS):
                self.part.add(self.base + self.tried + 1,
                              self.inserts[self.tried])
                self.acked.append(self.tried)
                self.tried += 1

    def warm_batches(self) -> list[int]:
        return [self.batch]

    def _insert_up_to(self, queries: int, spans) -> int:
        """Insert until the window's inserts reach ``ratio`` times
        ``queries``; each is one ``Partition.add`` timed as the span
        ``engine.insert``.  Returns how many raised."""
        want = SETUP_INSERTS + \
            queries * self.ratio.numerator // self.ratio.denominator
        failed = 0
        while self.tried < want:
            if self.tried >= len(self.inserts):
                print(f"insert pool of {len(self.inserts)} doubled in the "
                      "window: pool_qps is below the rate", file=sys.stderr)
                self.inserts = np.concatenate(
                    [self.inserts, self.corpus.inserts(len(self.inserts))])
            row = self.inserts[self.tried]
            self.tried += 1
            try:
                with spans.span("engine.insert"):
                    self.part.add(self.base + len(self.acked) + 1, row)
            except Exception as exc:  # noqa: BLE001 — a failed insert counts
                print(f"insert {self.tried - 1} failed: {exc!r}",
                      file=sys.stderr)
                failed += 1
                continue
            self.acked.append(self.tried - 1)
        return failed

    def _latest(self, q: np.ndarray, seen: int):
        """``(queries, own)`` of a batch: ``q`` with its last ``n_latest``
        slots taken by the newest of the ``seen`` rows acknowledged before
        its dispatch, newest first; ``own [batch]`` is the acknowledged
        index of each slot's row, -1 where the pool's query stays."""
        take = min(self.n_latest, seen)
        own = np.full(self.batch, -1, np.int64)
        if not take:
            return q, own
        own[self.batch - take:] = np.arange(seen - 1, seen - 1 - take, -1)
        q = q.copy()
        q[self.batch - take:] = self.inserts[
            [self.acked[i] for i in own[self.batch - take:]]]
        return q, own

    def window(self, seconds: float, spans) -> dict:
        part, b, k = self.part, self.batch, self.k
        in_flight = int(self.mix["in_flight"])
        pending: deque = deque()
        lat: list[float] = []
        done: list[float] = []
        answered: list[tuple] = []
        failed = dispatched = 0
        t0 = time.perf_counter()
        t_end = t0 + seconds

        def finish() -> None:
            nonlocal failed
            t_s, j, fin, seen, own = pending.popleft()
            try:
                with spans.span("engine.finalize"):
                    ids, dists = fin()
            except Exception as exc:  # noqa: BLE001 — a failed batch counts
                print(f"batch {j} failed: {exc!r}", file=sys.stderr)
                failed += b
                return
            t_done = time.perf_counter()
            lat.append(t_done - t_s)
            done.append(t_done)
            answered.append((j, ids, dists, seen, len(self.acked), own))

        while time.perf_counter() < t_end:
            if (dispatched + 1) * b > len(self.pool):
                # a program faster than the pool was sized for: the pool
                # doubles (inside the window, so the rate pays for it)
                print(f"query pool of {len(self.pool)} doubled in the "
                      "window: pool_qps is below the rate", file=sys.stderr)
                self.pool = np.concatenate(
                    [self.pool, self.corpus.queries(len(self.pool))])
            q = self.pool[dispatched * b:(dispatched + 1) * b]
            seen = len(self.acked)
            own = None
            if self.n_latest:
                q, own = self._latest(q, seen)
            t_s = time.perf_counter()
            try:
                with spans.span("engine.dispatch"):
                    fin = part.search_many_async(q, k)
            except Exception as exc:  # noqa: BLE001 — a failed batch counts
                print(f"batch {dispatched} failed: {exc!r}", file=sys.stderr)
                failed += b
                fin = None
            if fin is not None:
                pending.append((t_s, dispatched, fin, seen, own))
            dispatched += 1
            if self.ratio:
                failed += self._insert_up_to(dispatched * b, spans)
            if len(pending) >= in_flight:
                finish()
        while pending:
            finish()
        window_s = seconds
        m = self.min_batches
        if 0 < m <= len(done) and done[m - 1] > t_end:
            # a rehearsal on a loaded CPU: the window closes at its first
            # answers
            t_end = done[m - 1]
            window_s = t_end - t0
        completed = b * sum(t <= t_end for t in done)
        spans.record.count("batches", dispatched)
        spans.record.count("queries", dispatched * b)
        inserts = 0
        if self.ratio:
            inserts = self.tried - SETUP_INSERTS
            acked = len(self.acked) - SETUP_INSERTS
            spans.record.count("inserts", acked)
            print(f"hxbench: inserts {acked} acknowledged of {inserts} in "
                  f"the window, {SETUP_INSERTS} in set-up", file=sys.stderr)
        return {
            "attempted": dispatched * b + inserts,
            "failed": failed,
            "e2e": {"qps": completed / window_s,
                    "p50_ms": percentile_ms(lat, 50),
                    "p95_ms": percentile_ms(lat, 95)},
            "answered": answered,
        }

    def _writes(self, seen, acked, own) -> dict:
        return {"inserts": self.inserts[self.acked], "seen": seen,
                "acked": acked, "own": own}

    def sample(self, result: dict, size: int, seed: int):
        """``(queries, ids, dists, writes)`` of a sample of the answered
        queries; ``writes`` is ``None`` without inserts, else the
        acknowledged rows (``inserts``, in order) and, for each sampled
        answer, how many of them were acknowledged before its batch's
        dispatch (``seen``) and before its ``finalize()`` returned
        (``acked``), and the acknowledged index of the row it searched
        with (``own``, -1 for a query of the pool)."""
        answered = result["answered"]
        if not answered:
            return None
        rows = np.concatenate([
            np.arange(a[0] * self.batch, (a[0] + 1) * self.batch)
            for a in answered])
        pick = check.sample(len(rows), size, seed)
        width = max(a[1].shape[1] for a in answered)
        ids = np.concatenate([_pad(a[1], width, 0) for a in answered])
        dists = np.concatenate([_pad(a[2], width, np.nan) for a in answered])
        queries = self.pool[rows[pick]]
        if not self.ratio:
            return queries, ids[pick], dists[pick], None
        counts = np.repeat([a[3:5] for a in answered], self.batch, axis=0)
        own = np.concatenate([
            np.full(self.batch, -1, np.int64) if a[5] is None else a[5]
            for a in answered])[pick]
        latest = own >= 0
        queries[latest] = self.inserts[np.asarray(self.acked)[own[latest]]]
        return queries, ids[pick], dists[pick], self._writes(
            counts[pick, 0], counts[pick, 1], own)

    def read_back(self):
        """The answers, in :meth:`sample`'s form, of one search after the
        window whose queries are the newest acknowledged rows (up to one
        batch), each its own; every acknowledged row is visible to it.
        ``None`` without inserts.  A search that raises returns no
        hits."""
        if not self.ratio:
            return None
        n = len(self.acked)
        newest = np.arange(max(0, n - self.batch), n)
        queries = self.inserts[np.asarray(self.acked, np.int64)[newest]]
        try:
            ids, dists = self.part.search_many(queries, self.k)
        except Exception as exc:  # noqa: BLE001 — an unread write counts
            print(f"read-back failed: {exc!r}", file=sys.stderr)
            ids = np.zeros((len(newest), 0), np.int64)
            dists = np.zeros((len(newest), 0))
        every = np.full(len(newest), n)
        return queries, ids, dists, self._writes(every, every, newest)

    def close(self) -> None:
        pass


def joined(answers, back):
    """The sampled answers followed by the read-back's, as one set of
    answers in :meth:`EngineLoop.sample`'s form; either may be ``None``."""
    if answers is None:
        return back
    if back is None:
        return answers
    width = max(answers[1].shape[1], back[1].shape[1])
    writes = {key: np.concatenate([answers[3][key], back[3][key]])
              for key in ("seen", "acked", "own")}
    writes["inserts"] = back[3]["inserts"]
    return (np.concatenate([answers[0], back[0]]),
            np.concatenate([_pad(answers[1], width, 0),
                            _pad(back[1], width, 0)]),
            np.concatenate([_pad(answers[2], width, np.nan),
                            _pad(back[2], width, np.nan)]),
            writes)


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
        if mix.get("insert_share"):
            raise ValueError("insert_share is a parameter of the engine "
                             "entry alone")
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
        return self.pool[idx], ids, dists, None

    def read_back(self):
        return None

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
