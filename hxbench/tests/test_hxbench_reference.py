"""The reference against a naive NumPy scan, the roofline arithmetic
against hand-worked numbers, and the trace reduction on a made-up
timeline."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hxbench import peaks, reference, spec, trace
from hxbench.data import Corpus
from hxbench.record import Record


def naive(rows, queries, k, metric):
    out_d, out_i = [], []
    for q in queries.astype(np.float64):
        d = []
        for x in rows.astype(np.float64):
            if metric == "cosine":
                d.append(1.0 - x @ q / (np.linalg.norm(x) * np.linalg.norm(q)))
            else:
                d.append(float(((x - q) ** 2).sum()))
        d = np.asarray(d)
        order = np.argsort(d, kind="stable")[:k]
        out_d.append(d[order])
        out_i.append(order)
    return np.asarray(out_d), np.asarray(out_i)


@pytest.mark.parametrize("name", ["deep10m-cos", "sift1m-l2"])
def test_reference_matches_a_naive_scan(bench, name):
    config = spec.config(bench, name)
    corpus = Corpus(config["generator"], int(config["dim"]), 2**31 + 3,
                    torch.device("cpu"))
    rows, queries = corpus.rows(700), corpus.queries(9)
    want_d, _ = naive(rows, queries, 10, config["metric"])
    got_d, got_i = reference.exact_topk(rows, queries, 10, config["metric"],
                                        torch.device("cpu"), block_rows=256)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-12, atol=1e-12)
    again = reference.distances_of(rows, queries, got_i, config["metric"])
    np.testing.assert_allclose(again, want_d, rtol=1e-12, atol=1e-12)
    if config["generator"].get("integer"):
        assert rows.min() >= 0 and rows.max() <= 255
        assert np.array_equal(rows, np.round(rows))


def test_distances_of_marks_out_of_range():
    rows = np.eye(3, dtype=np.float32)
    d = reference.distances_of(rows, rows[:1], np.array([[0, -1, 3]]), "l2")
    assert d[0, 0] == 0.0 and np.isnan(d[0, 1]) and np.isnan(d[0, 2])


def test_same_seed_same_data_other_seed_other_data(bench):
    config = spec.config(bench, "deep10m-cos")
    def make(seed):
        return Corpus(config["generator"], 96, seed,
                      torch.device("cpu")).rows(300)
    assert np.array_equal(make(2**33 + 1), make(2**33 + 1))
    assert not np.array_equal(make(2**33 + 1), make(2**33 + 2))


@pytest.mark.parametrize("name,least_ms,by", [
    # 9,990,000 * 96 * 2 + 256 * 96 * 4 + 256 * 10 * 12 = 1,918,209,024 B
    ("deep10m-cos", 1_918_209_024 / 3.35e12 * 1e3, "bytes"),
    # 1,000,000 * 128 * 2 + 256 * 128 * 4 + 256 * 10 * 12 = 256,161,792 B
    ("sift1m-l2", 256_161_792 / 3.35e12 * 1e3, "bytes"),
])
def test_roofline_arithmetic(bench, name, least_ms, by):
    config = spec.config(bench, name)
    n_bytes, ops = peaks.search_work(config["rows"], config["dim"], 256, 10)
    assert ops == 2 * 256 * config["rows"] * config["dim"]
    t, which = peaks.least_seconds(n_bytes, ops)
    assert which == by
    assert t * 1e3 == pytest.approx(least_ms, rel=1e-12)
    assert t * 1e3 == pytest.approx(
        {"deep10m-cos": 0.572600, "sift1m-l2": 0.0764662}[name], rel=1e-5)
    # the reader: 2 batches over 2 * (the least time) / 0.25 of kernels
    rec = Record(cell={}, config=config,
                 traffic={"entry": "engine", "batch": 256, "k": 10},
                 counts={"batches": 2},
                 trace={"kernel_s": 2 * t / 0.25, "busy_s": 1.0,
                        "window_s": 4.0})
    share = spec.reader("kernel.search_roofline")(rec)
    assert share == pytest.approx(25.0, rel=1e-12)
    assert spec.reader("device.idle_pct.batch")(rec) == pytest.approx(75.0)


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
         "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "engine.dispatch",
         "ts": 0.0, "dur": 30.0},
        {"ph": "X", "cat": "user_annotation", "name": "engine.finalize",
         "ts": 60.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 70.0,
         "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 95.0, "dur": 10.0},
    ]
    got = trace.reduce(ev)
    assert got["window_s"] == pytest.approx(100e-6)
    # busy: [10, 40] + [70, 80] + [95, 100]
    assert got["busy_s"] == pytest.approx(45e-6)
    # kernel time is the sum of kernel durations (k1 20 + k2 20 + k1 5)
    assert got["kernel_s"] == pytest.approx(45e-6)
    assert got["device_ops"][0] == ["k1", pytest.approx(25e-6)]
    # idle: [0, 10] in dispatch, [40, 70] outside (middle 55),
    # [80, 95] in finalize
    assert dict((n, s) for n, s in got["idle_gaps"]) == {
        "host outside any span": pytest.approx(30e-6),
        "engine.finalize": pytest.approx(15e-6),
        "engine.dispatch": pytest.approx(10e-6)}
