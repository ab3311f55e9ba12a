"""The readers of the program's own spans (``helix_tpu_torch.tracing``):
their means on hand-made snapshots, nothing where there is nothing to
read, and the six engine and kernel metrics in a traced rehearsal on the
CPU."""

from __future__ import annotations

import sys

import pytest

from helix_tpu_torch import tracing
from hxbench import spec
from hxbench.record import Record

from .conftest import rehearse

MS = 1_000_000  # ns
MEANS = {
    "engine.live_count_ms": "engine.live_count",
    "engine.mask_copy_ms": "engine.mask_copy",
    "engine.h2d_ms": "engine.h2d",
    "engine.d2h_wait_ms": "engine.d2h_wait",
    "kernel.enqueue_ms": "kernel.enqueue",
    "server.handoff_wait_ms": "server.handoff_wait",
    "server.respond_ms": "server.respond",
}
SERVER = ("server.vbatch_queries", "server.handoff_wait_ms",
          "server.respond_ms")
NEW = tuple(MEANS) + ("engine.search_self_ms", "server.vbatch_queries")
ENGINE_SIX = ("engine.live_count_ms", "engine.mask_copy_ms",
              "engine.h2d_ms", "engine.search_self_ms",
              "engine.d2h_wait_ms", "kernel.enqueue_ms")


def run_of(entry: str, traced: bool = True) -> Record:
    return Record(cell={}, config={}, traffic={"entry": entry},
                  trace={"busy_s": 1.0, "window_s": 2.0} if traced else None)


def entry_of(name: str) -> str:
    return "http" if name in SERVER else "engine"


def row(name, sid, parent, t0_ms, t1_ms, thread=1):
    return (name, sid, parent, thread, int(t0_ms * MS), int(t1_ms * MS))


@pytest.fixture
def snapshot(monkeypatch):
    """Install a hand-made snapshot: ``snapshot(spans, counts, dropped)``."""

    def install(spans, counts=None, dropped=0):
        snap = tracing.Snapshot(list(spans), dict(counts or {}), dropped)
        monkeypatch.setattr(tracing, "snapshot", lambda: snap)

    return install


@pytest.mark.parametrize("name", list(MEANS))
def test_mean_of_each_span(snapshot, name):
    span = MEANS[name]
    snapshot([row(span, 1, None, 0, 2), row(span, 2, None, 10, 13),
              row("other", 3, None, 0, 50), row(span, 4, 9, 20, 21.5)])
    assert spec.reader(name)(run_of(entry_of(name))) \
        == pytest.approx((2 + 3 + 1.5) / 3)


def test_search_self_time_subtracts_only_direct_children_inside_it(snapshot):
    snapshot([
        row("engine.search", 1, None, 0, 10),
        row("engine.live_count", 2, 1, 1, 4),
        row("nested", 3, 2, 2, 3),             # a grandchild: not again
        row("engine.mask_copy", 4, 1, 9, 11),  # 1 of its 2 ms inside
        row("engine.d2h_wait", 5, 1, 12, 15),  # in finalize(): outside
        row("engine.search", 6, None, 20, 24),
        row("kernel.enqueue", 7, 6, 21, 22),
        row("kernel.enqueue", 8, 99, 20, 24),  # another parent's child
    ])
    got = spec.reader("engine.search_self_ms")(run_of("engine"))
    assert got == pytest.approx(((10 - 3 - 1) + (4 - 1)) / 2)


def test_queries_per_vbatch(snapshot):
    snapshot([row("server.vbatch", 1, None, 0, 1),
              row("server.vbatch", 2, None, 2, 3)],
             {"server.vbatch_queries": 7})
    assert spec.reader("server.vbatch_queries")(run_of("http")) == 3.5


def everything():
    spans = [row("engine.search", 1, None, 0, 10),
             row("server.vbatch", 2, None, 0, 10)]
    spans += [row(s, 10 + i, 1, 1, 2) for i, s in enumerate(MEANS.values())]
    return spans, {"server.vbatch_queries": 4}


@pytest.mark.parametrize("name", NEW)
def test_each_reader_finds_nothing_in_an_empty_snapshot(snapshot, name):
    snapshot([])
    assert spec.reader(name)(run_of(entry_of(name))) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reader_gives_nothing_once_the_tracer_dropped(snapshot, name):
    spans, counts = everything()
    snapshot(spans, counts)
    assert spec.reader(name)(run_of(entry_of(name))) is not None
    snapshot(spans, counts, dropped=1)
    assert spec.reader(name)(run_of(entry_of(name))) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_only_a_traced_run(snapshot, name):
    spans, counts = everything()
    snapshot(spans, counts)
    assert spec.reader(name)(run_of(entry_of(name), traced=False)) is None


@pytest.mark.parametrize("name", SERVER)
def test_server_readers_give_nothing_in_an_engine_run(snapshot, name):
    spans, counts = everything()
    snapshot(spans, counts)
    assert spec.reader(name)(run_of("engine")) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reader_gives_nothing_where_the_program_has_no_tracer(
        monkeypatch, name):
    """As on a program without ``helix_tpu_torch.tracing``."""
    monkeypatch.setitem(sys.modules, "helix_tpu_torch.tracing", None)
    monkeypatch.delattr("helix_tpu_torch.tracing", raising=False)
    assert spec.reader(name)(run_of(entry_of(name))) is None


@pytest.mark.parametrize("name", ["deep10m-cos.batch256",
                                  "sift1m-l2.batch256"])
def test_traced_rehearsal_reports_the_program_spans(bench, name):
    """The six metrics in a traced run on the CPU, each batch cell: the
    dispatch's pieces add up to the mean ``engine.search``, which lies
    inside the harness's ``engine.dispatch``."""
    tracing.clear()
    try:
        line = rehearse(bench, name, trace=True)
        snap = tracing.snapshot()
    finally:
        tracing.clear()
    assert line["correct"], line["checked"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(ENGINE_SIX) <= set(got)
    assert all(got[k] >= 0 for k in ENGINE_SIX)
    searches = [r[5] - r[4] for r in snap.spans if r[0] == "engine.search"]
    mean_search = sum(searches) / len(searches) * 1e-6
    pieces = sum(got[k] for k in ENGINE_SIX if k != "engine.d2h_wait_ms")
    assert pieces == pytest.approx(mean_search, rel=1e-6)
    assert mean_search <= got["engine.dispatch_ms"]
