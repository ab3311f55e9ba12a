"""The cells beside the first two: ``openai5m-cos.batch256`` (D=1536,
k=100, kernel 1's streamed-query plan on the card) and
``deep10m-cos.batch16`` (16-query batches).  One rehearsal of each at a
tiny size on the CPU, traced and not; and the readers of kernel 1's
metrics, ``kernel.bucket_roofline`` and ``kernel.bucket_staged_ratio``,
over hand-made records, nothing where there is nothing to read."""

from __future__ import annotations

import pytest

from helix_tpu_torch import tracing
from hxbench import check, spec
from hxbench.record import Record

from .conftest import rehearse

NEW_CELLS = ["openai5m-cos.batch256", "deep10m-cos.batch16"]
KERNEL_METRICS = ("kernel.bucket_roofline", "kernel.bucket_staged_ratio")
# answers compared in a rehearsal: the float64 check of k=100 answers at
# D=1536 holds [S, k, D] on the host
SAMPLE = 256
# On the CPU a 256-query batch at D=1536 and k=100 re-ranks 800 f32
# candidates a query ([256, 800, 1536], 1.3 GB) and takes a second or
# more: the rehearsal of that cell sends 64-query batches over fewer rows
# in a longer window, so batches complete inside it on a loaded host.
SIZE = {"openai5m-cos.batch256": {"rows": 8_192, "seconds": 2.0,
                                  "batch": 64},
        "deep10m-cos.batch16": {}}


def rehearse_cell(bench, name, *, trace=False):
    size = dict(SIZE[name])
    batch = size.pop("batch", None)
    if batch is None:
        return rehearse(bench, name, trace=trace, **size)
    real = spec.traffic

    def smaller(cell, *args, **kwargs):
        return dict(real(cell, *args, **kwargs), batch=batch)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spec, "traffic", smaller)
        return rehearse(bench, name, trace=trace, **size)


@pytest.fixture(autouse=True)
def small_sample(monkeypatch):
    monkeypatch.setattr(check, "SAMPLE", SAMPLE)


def test_new_cells_find_their_files(bench):
    for name in NEW_CELLS:
        cell = spec.workload(bench, name)
        mix = spec.traffic(cell)
        config = spec.config(bench, cell["config"])
        assert mix["entry"] == "engine" and int(mix["k"]) == int(config["k"])
        layer = {m["name"] for m in spec.metrics_of(bench, name, "per_layer")}
        assert set(KERNEL_METRICS) <= layer
    openai = spec.traffic(spec.workload(bench, "openai5m-cos.batch256"))
    assert (openai["batch"], openai["k"], openai["pool_qps"]) == \
        (256, 100, 60000)
    small = spec.traffic(spec.workload(bench, "deep10m-cos.batch16"))
    assert (small["batch"], small["in_flight"], small["k"]) == (16, 2, 10)


@pytest.mark.parametrize("name", NEW_CELLS)
def test_rehearsal(bench, name):
    line = rehearse_cell(bench, name)
    assert line["correct"], line["checked"]
    assert line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"] for m in spec.metrics_of(bench, name, "end_to_end")}
    assert set(line["metrics"]) == want == {"qps", "p50_ms", "p95_ms",
                                            "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "checked"


@pytest.mark.parametrize("name", NEW_CELLS)
def test_traced_rehearsal(bench, name):
    line = rehearse_cell(bench, name, trace=True)
    assert line["correct"], line["checked"]
    assert "window_s" in line["device"] and "breakdown" in line
    allowed = {m["name"] for m in spec.metrics_of(bench, name, "per_layer")}
    assert set(line["metrics"]) <= allowed
    assert {"engine.dispatch_ms", "engine.finalize_ms"} <= set(line["metrics"])
    # on the CPU kernel 1 never launches: both of its metrics find nothing
    assert not set(KERNEL_METRICS) & set(line["metrics"])


def batch_run(device_ops, batches=100, rows=5_000_000, dim=1536, batch=256):
    return Record(cell={}, config={"rows": rows, "dim": dim},
                  traffic={"entry": "engine", "batch": batch, "k": 100},
                  counts={"batches": batches} if batches else {},
                  trace={"busy_s": 1.0, "window_s": 2.0, "kernel_s": 1.5,
                         "device_ops": device_ops})


KERNEL_1 = ("void (anonymous namespace)::bucket_scores_kernel<2, false>"
            "(CUtensorMap, CUtensorMap, float*, int, int, int, int, int)")
KERNEL_2 = ("void (anonymous namespace)::i8_bucket_scores_kernel<2, true>"
            "(CUtensorMap, CUtensorMap, float*, int, int, int, int, int)")


def test_bucket_roofline_over_kernel_1_alone():
    """The openai5m-cos shape: 15.44 GB, 4.61 ms at 3.35 TB/s; 10 ms of
    kernel 1 a batch (either template instantiation) reads 46.1%."""
    read = spec.reader("kernel.bucket_roofline")
    ops = [[KERNEL_1, 0.6], [KERNEL_1.replace("<2,", "<1,"), 0.4],
           [KERNEL_2, 5.0], ["select_block", 0.3]]
    n_bytes = 5_000_000 * 1536 * 2 + 256 * 1536 * 2 + 78_125 * 256 * 4
    assert read(batch_run(ops)) == pytest.approx(
        100 * n_bytes / 3.35e12 / 0.01)
    assert read(batch_run(ops)) == pytest.approx(46.09, abs=0.01)


@pytest.mark.parametrize("run", [
    batch_run([[KERNEL_2, 1.0], ["select_block", 0.3]]),   # no kernel 1
    batch_run([[KERNEL_1, 1.0]], batches=0),
    batch_run([[KERNEL_1, 1.0]], batch=None),
    Record(cell={}, config={"rows": 1, "dim": 1},
           traffic={"entry": "engine", "batch": 1, "k": 1}),
])
def test_bucket_roofline_finds_nothing(run):
    assert spec.reader("kernel.bucket_roofline")(run) is None


@pytest.fixture
def counters(monkeypatch):
    """Install hand-made tracer counters."""

    def install(counts, dropped=0):
        snap = tracing.Snapshot([], dict(counts), dropped)
        monkeypatch.setattr(tracing, "snapshot", lambda: snap)

    return install


def test_staged_ratio_reads_the_counters(counters):
    read = spec.reader("kernel.bucket_staged_ratio")
    counters({"kernel.bucket_scores.staged_bytes": 5.0 * 3072,
              "kernel.bucket_scores.row_bytes": 3072.0,
              "kernel.bucket_scores.streamed": 1})
    assert read(batch_run([])) == pytest.approx(5.0)


@pytest.mark.parametrize("counts, dropped, traced", [
    ({}, 0, True),                                      # nothing launched
    ({"kernel.bucket_scores.staged_bytes": 10.0}, 0, True),
    ({"kernel.bucket_scores.staged_bytes": 10.0,
      "kernel.bucket_scores.row_bytes": 2.0}, 3, True),  # spans dropped
    ({"kernel.bucket_scores.staged_bytes": 10.0,
      "kernel.bucket_scores.row_bytes": 2.0}, 0, False),  # untraced run
])
def test_staged_ratio_finds_nothing(counters, counts, dropped, traced):
    counters(counts, dropped)
    run = batch_run([])
    if not traced:
        run.trace = None
    assert spec.reader("kernel.bucket_staged_ratio")(run) is None
