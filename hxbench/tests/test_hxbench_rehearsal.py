"""One rehearsal of each mix at a tiny size on the CPU, traced and not,
and the runs with the timed path broken underneath, which must come out
not correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hxbench import check, control, spec

from .conftest import HTTP_CELL, TINY_ROWS, rehearse, tiny

CELLS = ["deep10m-cos.batch256", "sift1m-l2.batch256", "deep10m-cos.http1"]


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal(bench, name):
    line = rehearse(bench, name)
    assert line["correct"], line["checked"]
    assert line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"] for m in spec.metrics_of(bench, name, "end_to_end")}
    if name == HTTP_CELL["name"]:
        want = {"p50_ms", "p95_ms", "setup_s"}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "checked"
    assert line["checked"]["failed"] == [0, 0]


@pytest.mark.parametrize("name", CELLS)
def test_traced_rehearsal(bench, name):
    line = rehearse(bench, name, trace=True)
    assert line["correct"], line["checked"]
    assert "window_s" in line["device"] and "breakdown" in line
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    if name == HTTP_CELL["name"]:
        assert set(line["metrics"]) == set()
        return
    allowed = {m["name"] for m in spec.metrics_of(bench, name, "per_layer")}
    assert set(line["metrics"]) <= allowed
    # the host-side readers read on the CPU; the device ones find nothing
    assert {"engine.dispatch_ms", "engine.finalize_ms"} <= set(line["metrics"])


def test_http_readers(bench):
    """The HTTP cell's readers over a traced rehearsal's record."""
    from hxbench import loops, system
    from hxbench.data import Corpus
    from hxbench.record import Record, Spans

    cell, config, mix = tiny(bench, HTTP_CELL["name"])
    corpus = Corpus(config["generator"], config["dim"], 5,
                    torch.device("cpu"))
    rows = corpus.rows(config["rows"])
    engine, part = system.build(config, rows, torch.device("cpu"))
    loop = loops.HttpLoop(engine, part, mix, config, corpus, 1.0, 5)
    record = Record(cell=cell, config=config, traffic=mix)
    try:
        loop.start_clients()
        result = loop.window(1.0, Spans(record, traced=False))
        loop.collect(result, Spans(record, traced=False))
    finally:
        loop.close()
    got = spec.reader("server.queries_per_dispatch")(record)
    assert got == record.counts["queries_dispatched"] / \
        record.counts["dispatches"] >= 1
    assert record.counts["queries_dispatched"] == \
        record.counts["fast_requests"] == loop.n
    record.trace = {"busy_s": 0.25, "window_s": 1.0, "kernel_s": 0.2}
    assert spec.reader("device.idle_pct.http")(record) == pytest.approx(75.0)
    assert spec.reader("device.idle_pct.batch")(record) is None


def _break(monkeypatch, how):
    from helix_tpu_torch.engine.vector import Partition

    real = Partition.search_many_async

    def broken(self, queries, k):
        fin = real(self, queries, k)

        def finalize():
            ids, dists = fin()
            ids, dists = ids.copy(), dists.copy()
            if how == "altered":
                ids[:, 0] = ids[:, 0] % TINY_ROWS + 1
            else:  # half of the batch left out
                half = (len(ids) + 1) // 2
                ids[half:] = 0
                dists[half:] = np.inf
            return ids, dists

        return finalize

    monkeypatch.setattr(Partition, "search_many_async", broken)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("how", ["altered", "half_left_out"])
def test_broken_path_is_not_correct(bench, monkeypatch, name, how):
    _break(monkeypatch, how)
    line = rehearse(bench, name)
    assert not line["correct"], line["checked"]


@pytest.mark.parametrize("name", ["deep10m-cos", "sift1m-l2"])
def test_control_is_not_correct(bench, name):
    config = spec.config(bench, name)
    config["rows"] = TINY_ROWS
    found = control.control_numbers(config, 2**31 + 21, torch.device("cpu"),
                                    n_queries=512)
    correct, checked = check.verdict(found, check.limits(config))
    assert not correct, checked


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_on_the_card(bench, cuda_device, name):
    line = rehearse(bench, name, device=cuda_device, rows=200_000)
    assert line["correct"], line["checked"]
    assert line["device"]["platform"] == "gpu"
