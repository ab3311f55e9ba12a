"""The port's host spans (``helix_tpu_torch.tracing``): recorded only
while a profiler records, at the exact search's and the native gateway's
boundaries, on the profiler's timeline where the profiled thread opens
them, and bounded."""

from __future__ import annotations

import http.client
import json
import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from helix_tpu_torch import tracing
from helix_tpu_torch.ops.distance import PackedMatrix, search_packed_async

CHILDREN = ("engine.live_count", "engine.h2d", "kernel.enqueue",
            "engine.mask_copy")


@pytest.fixture(autouse=True)
def empty_tracer():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture(scope="module")
def matrix():
    rng = np.random.default_rng(18)
    m = PackedMatrix(8, "cosine", device="cpu")
    m.extend(rng.normal(size=(8192, 8)).astype(np.float32))
    if m._grow_thread is not None:
        m._grow_thread.join()
    mask = np.ones(m.n, bool)
    mask[::7] = False
    queries = rng.normal(size=(4, 8)).astype(np.float32)
    return m, mask, queries


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def rows_named(snap, name):
    return [r for r in snap.spans if r[0] == name]


def test_nothing_is_recorded_outside_a_profiler(matrix):
    m, mask, queries = matrix
    search_packed_async(m, queries, 10, mask)()
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("a") as s:
        assert s.id is None
    assert tracing.record("b", 0, 1) is None
    tracing.count("c", 3)
    assert tracing.snapshot() == tracing.Snapshot([], {}, 0)


def test_device_path_search_records_its_spans(matrix):
    m, mask, queries = matrix
    with cpu_profile():
        finalize = search_packed_async(m, queries, 10, mask,
                                       use_device=True)
        finalize()
    snap = tracing.snapshot()
    (search,) = rows_named(snap, "engine.search")
    _, sid, parent, _, t0, t1 = search
    assert parent is None and t0 <= t1
    for name in CHILDREN:
        (child,) = rows_named(snap, name)
        assert child[2] == sid
        assert t0 <= child[4] <= child[5] <= t1
    (wait,) = rows_named(snap, "engine.d2h_wait")
    assert wait[2] == sid and wait[4] >= t1
    # the fixture's mask has dead rows: the dispatch snapshots it
    assert snap.dropped == 0 and snap.counts == {"engine.mask_snapshots": 1}


@pytest.mark.parametrize("tombstones", [False, True])
def test_partition_snapshots_the_mask_only_with_dead_rows(tombstones):
    """Through ``Partition`` the live count is the partition's own: each
    dispatch still records ``engine.live_count`` and ``engine.mask_copy``,
    and copies the mask (``engine.mask_snapshots``) only while a row is
    dead."""
    from helix_tpu_torch.engine.vector import Partition

    rng = np.random.default_rng(19)
    part = Partition("cosine", device=torch.device("cpu"))
    part.add_bulk(list(range(1, 4097)),
                  rng.normal(size=(4096, 8)).astype(np.float32))
    if tombstones:
        for element_id in range(1, 4097, 7):
            part.remove(element_id)
    queries = rng.normal(size=(4, 8)).astype(np.float32)
    dispatches = 3
    with cpu_profile():
        for _ in range(dispatches):
            ids, _ = part.search_many_async(queries, 10)()
            assert ids.shape == (4, 10)
    snap = tracing.snapshot()
    for name in ("engine.search", "engine.live_count", "engine.mask_copy"):
        assert len(rows_named(snap, name)) == dispatches
    expected = {"engine.mask_snapshots": dispatches} if tombstones else {}
    assert snap.dropped == 0 and snap.counts == expected


def test_host_path_records_the_search_and_its_live_count(matrix):
    m, mask, queries = matrix
    with cpu_profile():
        search_packed_async(m, queries, 10, mask, use_device=False)()
    snap = tracing.snapshot()
    assert sorted(r[0] for r in snap.spans) == ["engine.live_count",
                                                "engine.search"]
    (search,) = rows_named(snap, "engine.search")
    (live,) = rows_named(snap, "engine.live_count")
    assert live[2] == search[1]
    assert search[4] <= live[4] <= live[5] <= search[5]


def test_main_thread_spans_name_the_idle_gaps_of_the_trace(matrix):
    from hxbench.trace import WINDOW, reduce

    m, mask, queries = matrix
    with cpu_profile() as prof:
        with record_function(WINDOW):
            search_packed_async(m, queries, 10, mask, use_device=True)()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    events = trace["traceEvents"]
    notes = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    assert set(CHILDREN) | {"engine.search", "engine.d2h_wait"} <= set(notes)
    # the spans' unix clock and the trace's agree
    base_us = trace["baseTimeNanoseconds"] / 1000
    for row in tracing.snapshot().spans:
        assert abs(float(notes[row[0]]["ts"]) + base_us
                   - row[4] / 1000) < 2000
    # the device busy everywhere in the window but in the live count: the
    # one idle gap is named by the innermost span open in it
    win, live = notes[WINDOW], notes["engine.live_count"]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    l0, l1 = float(live["ts"]), float(live["ts"]) + float(live["dur"])
    busy = [{"ph": "X", "cat": "kernel", "name": "k", "ts": a, "dur": b - a}
            for a, b in ((w0, l0), (l1, w1))]
    out = reduce(events + busy)
    assert out["idle_gaps"][0][0] == "engine.live_count"
    assert out["idle_gaps"][0][1] == pytest.approx((l1 - l0) * 1e-6)


def test_spans_of_a_thread_started_before_the_profiler_are_kept():
    go, done = threading.Event(), threading.Event()

    def work():
        go.wait(10)
        with tracing.span("outer") as outer:
            with tracing.span("inner"):
                pass
        t = time.time_ns()
        tracing.record("crossed", t, t + 5, parent=outer.id)
        tracing.count("things", 2)
        done.set()

    thread = threading.Thread(target=work)
    thread.start()
    with cpu_profile():
        go.set()
        assert done.wait(10)
    thread.join()
    snap = tracing.snapshot()
    (outer,) = rows_named(snap, "outer")
    (inner,) = rows_named(snap, "inner")
    (crossed,) = rows_named(snap, "crossed")
    assert inner[2] == outer[1] and crossed[2] == outer[1]
    assert inner[3] == outer[3] == thread.native_id
    assert crossed[5] - crossed[4] == 5
    assert snap.counts == {"things": 2}
    # a snapshot takes nothing away; clear() does
    assert tracing.snapshot() == snap
    tracing.clear()
    assert tracing.snapshot() == tracing.Snapshot([], {}, 0)


def test_a_full_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    with cpu_profile():
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    snap = tracing.snapshot()
    assert [r[0] for r in snap.spans] == ["s0", "s1", "s2"]
    assert snap.dropped == 2


def test_threads_lose_no_span_count_or_drop(monkeypatch):
    """More threads than cores, switching often, into a buffer that
    fills: every span is kept or counted as dropped, the counter adds up
    and the ids are distinct."""
    import sys

    n_threads, per = 2 * (os.cpu_count() or 4) + 1, 400
    monkeypatch.setattr(tracing, "CAPACITY", n_threads * per // 2)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cpu_profile():
            def work():
                for _ in range(per):
                    with tracing.span("s"):
                        tracing.count("n")

            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    snap = tracing.snapshot()
    assert len(snap.spans) == tracing.CAPACITY
    assert len(snap.spans) + snap.dropped == n_threads * per
    assert snap.counts == {"n": n_threads * per}
    assert len({r[1] for r in snap.spans}) == len(snap.spans)


def _post(port: int, body: dict) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/v1/query/vsearch", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        return json.loads(resp.read())
    finally:
        conn.close()


def test_native_gateway_records_its_vbatch_spans():
    from helix_tpu_torch.native import NativeBuildError, load

    try:
        load()
    except NativeBuildError:  # pragma: no cover
        pytest.skip("native toolchain unavailable")
    from hxbench import system

    rng = np.random.default_rng(7)
    rows = rng.normal(size=(4096, 8)).astype(np.float32)
    engine, _ = system.build({"metric": "cosine"}, rows,
                             torch.device("cpu"))
    gw = system.serve(engine)
    try:
        queries = rng.normal(size=(4, 8)).astype(np.float32)
        with cpu_profile():
            for q in queries:
                hits = _post(gw.port, {"q": q.tolist(), "k": 5})["hits"]
                assert len(hits) == 5
            # the last group's span closes after its response is sent
            deadline = time.monotonic() + 10
            while len(rows_named(tracing.snapshot(), "server.respond")) \
                    < len(queries) and time.monotonic() < deadline:
                time.sleep(0.01)
    finally:
        gw.stop(close_engine=False)
    snap = tracing.snapshot()
    vbatches = {r[1]: r for r in rows_named(snap, "server.vbatch")}
    searches = rows_named(snap, "engine.search")
    assert vbatches and len(searches) == len(queries)
    for s in searches:
        v = vbatches[s[2]]
        assert v[4] <= s[4] <= s[5] <= v[5] and v[3] == s[3]
    for name in ("server.handoff_wait", "server.respond"):
        got = rows_named(snap, name)
        assert len(got) == len(queries)
        assert all(r[2] in vbatches for r in got)
    assert snap.counts["server.vbatch_queries"] == len(queries)
    assert snap.dropped == 0
