"""The int8 rung with its f16 device re-rank as a served path: the
``deep100m-cos`` configuration of ``BENCHMARK.json`` (big-ann-benchmarks'
DEEP 100M under a 20 GiB HBM budget).

On the CPU: the int8 codes and the f16 rows built on the device slice by
slice equal the numpy quantizer's and ``astype(np.float16)`` bit for bit;
``Partition.search_many_async``'s deferred dispatch equals the eager
computation it replaced; the dispatch reads the partition's live count
and never counts the mask; its spans and the ``engine.quant_candidates``
counter record under a profiler; a served batch over the harness's rows
meets the configuration's limits, where a bf16 copy of the rows does
not; kernel 2's roofline reader; and a rehearsal of the cell through
``hxbench.run``.  On the card (``cuda``): the codes and the f16 rows
built there, and the served dispatch through kernel 2, against the same
numpy-built arithmetic.  The module imports no JAX, so its ``cuda``
tests run on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_int8_rung_served.py``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helix_tpu_torch import tracing
from helix_tpu_torch.engine.vector import Partition
from helix_tpu_torch.ops import quant as Q
from helix_tpu_torch.ops.distance import PackedMatrix, _round_up
from hxbench import check, reference, run, spec, system
from hxbench.data import Corpus
from hxbench.record import Record

CPU = torch.device("cpu")
SEED = 2**31 + 25
CONFIG = "deep100m-cos"
CELL = "deep100m-cos.int8"


def deep100m() -> dict:
    return spec.config(spec.load_benchmark(), CONFIG)


def scaled(config: dict, rows: int) -> dict:
    """The configuration at ``rows`` rows with its budget scaled to keep
    its bytes a row, so the same rung serves."""
    dep = dict(config["deployment"])
    dep["hbm_budget_bytes"] = dep["hbm_budget_bytes"] * rows // config["rows"]
    return dict(config, rows=rows, deployment=dep)


@pytest.fixture(autouse=True)
def empty_tracer():
    tracing.clear()
    yield
    tracing.clear()


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel 2 runs only on the card")
    return torch.device("cuda")


def awkward_rows(n: int, dim: int, seed: int) -> np.ndarray:
    """Unit rows, then a few rows of the values where rounding decides:
    ``x`` whose f32 product with 127 lies exactly halfway between two
    integers, components of exactly +-1 and beyond it, f16 halfway
    values and f16 subnormals."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n, dim)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    halves = [x for x in (np.float32((j + 0.5) / 127) for j in range(-127, 127))
              if float(x * np.float32(127.0)) % 1 == 0.5]
    special = np.array(
        halves + [1.0, -1.0, 1.5, -1.5, 0.0, -0.0, 1 + 2**-11, 1 + 3 * 2**-11,
                  2**-25, 3 * 2**-25, 2**-24 * 1.5, 65520.0 / 65536, 1e-8],
        np.float32)
    lead = -(-len(special) // dim)
    flat = rows[:lead].reshape(-1)
    flat[: len(special)] = special
    rows[:lead] = flat.reshape(lead, dim)
    return rows


def matrix_of(rows: np.ndarray, metric: str = "cosine",
              device=CPU) -> PackedMatrix:
    m = PackedMatrix(rows.shape[1], metric, device=device)
    m.extend(rows)
    if m._grow_thread is not None:
        m._grow_thread.join()
    # the awkward values as written, not normalised again
    m.data[: len(rows), : rows.shape[1]] = rows
    return m


def numpy_codes(m: PackedMatrix, n_rows: int) -> np.ndarray:
    padded = np.zeros((n_rows, m.dim_pad), np.float32)
    padded[: m.n] = m.data[: m.n]
    return Q.quantize_rows_unit(padded)


def numpy_f16(m: PackedMatrix, n_rows: int) -> np.ndarray:
    out = np.zeros((n_rows, m.dim_pad), np.float16)
    out[: m.n] = m.data[: m.n].astype(np.float16)
    return out


# slice rows: one row, a prime, the matrix's own 256 MB slices, and a
# size that leaves a ragged last slice
SLICE_ROWS = [1, 7, None, 1000]


@pytest.mark.parametrize("slice_rows", SLICE_ROWS)
def test_slice_built_codes_equal_the_numpy_quantizer(monkeypatch, slice_rows):
    m = matrix_of(awkward_rows(3_001, 96, 1))
    if slice_rows is not None:
        monkeypatch.setattr(m, "UPLOAD_CHUNK_BYTES", slice_rows * m.dim_pad * 4)
    n_rows = 8_192                       # past the host buffer: zero rows
    assert n_rows > len(m.data)
    got = Q.unit_codes_device(m, n_rows)
    assert got.dtype == torch.int8 and got.shape == (n_rows, m.dim_pad)
    assert np.array_equal(got.numpy(), numpy_codes(m, n_rows))
    assert not got[m.n:].any()


@pytest.mark.parametrize("slice_rows", SLICE_ROWS)
def test_slice_built_f16_rows_equal_astype(monkeypatch, slice_rows):
    m = matrix_of(awkward_rows(3_001, 96, 2))
    if slice_rows is not None:
        monkeypatch.setattr(m, "UPLOAD_CHUNK_BYTES", slice_rows * m.dim_pad * 4)
    xs16, sq = Q.QuantizedResident().rerank_arrays(m)
    n_rows = _round_up(m.n, m.ROW_PAD)
    assert xs16.dtype == torch.float16 and xs16.shape == (n_rows, m.dim_pad)
    want = numpy_f16(m, n_rows)
    assert np.array_equal(xs16.numpy().view(np.uint16), want.view(np.uint16))
    assert sq.shape == (1,)              # cosine reads no norms


@pytest.mark.parametrize("slice_rows", [1, 1000])
def test_slice_built_l2_codes_equal_quantize_rows(monkeypatch, slice_rows):
    rng = np.random.default_rng(3)
    rows = (rng.normal(size=(2_500, 40)) * 30).astype(np.float32)
    rows[5] = 0.0
    m = matrix_of(rows, "l2")
    monkeypatch.setattr(m, "UPLOAD_CHUNK_BYTES", slice_rows * m.dim_pad * 4)
    xs, sc, _ = Q.QuantizedResident().arrays(m)
    n_rows = _round_up(m.n, m.ROW_PAD)
    padded = np.zeros((n_rows, m.dim_pad), np.float32)
    padded[: m.n] = m.data[: m.n]
    values, scales = Q.quantize_rows(padded)
    assert np.array_equal(xs.numpy(), values)
    assert np.array_equal(sc.numpy().view(np.uint32), scales.view(np.uint32))


def test_the_cosine_arrays_are_the_codes_and_the_global_scale():
    m = matrix_of(awkward_rows(3_001, 96, 4))
    xs, sc, sq = Q.QuantizedResident().arrays(m)
    n_rows = _round_up(m.n, m.ROW_PAD)
    assert np.array_equal(xs.numpy(), numpy_codes(m, n_rows))
    assert sc.dtype == torch.float32 and sc.shape == (n_rows,)
    assert (sc.numpy() == Q.GLOBAL_SCALE).all()
    assert sq.shape == (1,)


# ------------------------------------------------------- the dispatch


def budgeted_partition(n: int, seed: int, dead: bool = False,
                       quant_candidates: int | None = None,
                       dim: int = 96, device=CPU) -> Partition:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(50, dim))
    rows = (centers[rng.integers(0, 50, n)]
            + 0.3 * rng.normal(size=(n, dim))).astype(np.float32)
    part = Partition("cosine", hbm_budget_bytes=n * 128 * 5,
                     quant_candidates=quant_candidates, device=device)
    part.add_bulk(list(range(1, n + 1)), rows)
    if dead:
        for element_id in range(3, n + 1, 13):
            part.remove(element_id)
    assert part._use_quant() and part._quant_rerank_device()
    assert system.rung(part) == "int8.device_rerank"
    return part


def queries(b: int, dim: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(b, dim)).astype(np.float32)


def eager_reference(part: Partition, qs: np.ndarray, k: int):
    """The rung as it computed before its dispatch was deferred: codes
    from the numpy quantizer, the f16 copy from ``astype``, the coarse
    phase, :func:`~helix_tpu_torch.ops.quant.device_rerank_topk` and the
    results brought to the host at once."""
    m = part.matrix
    dev, n = m.device, m.n
    n_rows = _round_up(n, m.ROW_PAD)
    if Q.use_fused(m):
        n_rows = Q.pad_rows_for_fused(n)
    xs_i8 = torch.from_numpy(numpy_codes(m, n_rows)).to(dev)
    n16 = _round_up(n, m.ROW_PAD)
    xs16 = torch.from_numpy(numpy_f16(m, n16)).to(dev)
    q = torch.from_numpy(m.prepare_queries(qs)).to(dev)
    k_cand = min(max(8 * k, 64, part.quant_candidates or 0), n)
    if Q.fused_route(m, n_rows, m.dim_pad, k_cand, Q.i8_kernel_refusal):
        _, cand = Q.int8_fused_coarse(xs_i8, q, n, k=k_cand)
    else:
        scales = torch.full((n_rows,), float(Q.GLOBAL_SCALE), device=dev)
        _, cand = Q.int8_coarse_topk(xs_i8, scales, q, n,
                                     torch.zeros(1, device=dev), k=k_cand)
    live = np.zeros(n16, np.uint8)
    live[: part.n_rows] = part.live_mask
    sq = torch.zeros(1, device=dev)
    d, p = Q.device_rerank_topk(xs16, sq, q, cand,
                                torch.from_numpy(live).to(dev), n, k=k)
    return part._map_hits(d.cpu().numpy(), p.cpu().numpy().astype(np.int64),
                          part.id_table)


@pytest.mark.parametrize("b", [16, 256])
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("dead", [False, True])
def test_the_deferred_dispatch_equals_the_eager_rung(b, k, dead):
    part = budgeted_partition(6_000, 5 + b + k, dead)
    qs = queries(b, 96, b * k)
    finalize = part.search_many_async(qs, k)
    ids, dists = finalize()
    want_ids, want_dists = eager_reference(part, qs, k)
    assert np.array_equal(ids, want_ids)
    assert np.array_equal(dists.view(np.uint64), want_dists.view(np.uint64))
    assert ids.shape == (b, k)
    if dead:
        assert not np.isin(ids, np.arange(3, 6_001, 13)).any()
    # and equal to the eager search the rung keeps
    d, p = part.quant.search(part.matrix, qs, k, part.live_mask, "cosine",
                             rerank_device=True)
    eager_ids, eager_dists = part._map_hits(d, p, part.id_table)
    assert np.array_equal(ids, eager_ids) and np.array_equal(dists, eager_dists)


def test_two_dispatches_in_flight_finalize_in_either_order():
    part = budgeted_partition(6_000, 6)
    qa, qb = queries(16, 96, 1), queries(16, 96, 2)
    fa = part.search_many_async(qa, 10)
    fb = part.search_many_async(qb, 10)
    got_b, got_a = fb(), fa()
    for got, q in ((got_a, qa), (got_b, qb)):
        want = eager_reference(part, q, 10)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


class CountingMask(np.ndarray):
    """A live mask that counts the times it is summed."""

    sums = 0

    def sum(self, *args, **kwargs):
        CountingMask.sums += 1
        return super().sum(*args, **kwargs)


def test_the_rung_reads_the_partitions_live_count(monkeypatch):
    part = budgeted_partition(6_000, 7)
    real = Partition.live_mask
    monkeypatch.setattr(Partition, "live_mask", property(
        lambda self: real.fget(self).view(CountingMask)))
    CountingMask.sums = 0
    qs = queries(16, 96, 3)
    part.search_many(qs, 10)
    mask = part.quant._live_dev
    for _ in range(3):
        part.search_many(qs, 10)
    assert CountingMask.sums == 0
    # the device mask is not rebuilt while the version and count hold
    assert part.quant._live_dev is mask
    assert mask[1] == part._n_live == 6_000
    # a tombstone bumps the version: rebuilt, still without a count
    part.remove(1)
    ids, _ = part.search_many(part.matrix.data[:1, :96].copy(), 10)
    assert CountingMask.sums == 0
    assert part.quant._live_dev is not mask
    assert part.quant._live_dev[1] == part._n_live == 5_999
    assert 1 not in set(ids[0].tolist())
    assert part.quant._live_dev[2][0] == 0


def test_without_a_count_the_mask_is_counted():
    """A caller that keeps no live count (``n_live`` None) still gets the
    mask counted, as the rung's search did before."""
    m = matrix_of(awkward_rows(2_000, 32, 8))
    live = np.ones(m.n, bool)
    live[::5] = False
    qr = Q.QuantizedResident()
    dev = qr._live_device(m, live, 2_048)
    assert qr._live_dev[1] == int(live.sum())
    assert dev.dtype == torch.uint8 and dev.shape == (2_048,)
    assert np.array_equal(dev.numpy()[: m.n], live.astype(np.uint8))
    assert not dev[m.n:].any()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_spans_and_the_candidate_counter_record_under_a_profiler():
    part = budgeted_partition(6_000, 9, quant_candidates=200)
    qs = queries(16, 96, 4)
    part.search_many(qs, 10)                   # builds the device copies
    tracing.clear()
    with cpu_profile():
        fins = [part.search_many_async(qs, 10) for _ in range(2)]
        for fin in fins:
            fin()
    snap = tracing.snapshot()
    searches = [r for r in snap.spans if r[0] == "engine.search"]
    assert len(searches) == 2
    for _, sid, parent, _, t0, t1 in searches:
        assert parent is None
        for name in ("engine.live_count", "engine.h2d", "kernel.enqueue"):
            (child,) = [r for r in snap.spans if r[0] == name and r[2] == sid]
            assert t0 <= child[4] <= child[5] <= t1
        (wait,) = [r for r in snap.spans
                   if r[0] == "engine.d2h_wait" and r[2] == sid]
        assert wait[4] >= t1
    assert snap.dropped == 0
    assert snap.counts == {"engine.quant_candidates": 2 * 16 * 200}


def test_nothing_records_outside_a_profiler():
    part = budgeted_partition(6_000, 10)
    part.search_many(queries(16, 96, 5), 10)
    assert tracing.snapshot() == tracing.Snapshot([], {}, 0)


def budgeted_partition_host(n: int) -> Partition:
    rng = np.random.default_rng(11)
    part = Partition("cosine", hbm_budget_bytes=n * 128 * 5, device=CPU)
    part.add_bulk(list(range(1, n + 1)),
                  rng.normal(size=(n, 96)).astype(np.float32))
    assert system.rung(part) == "int8.host_rerank"
    return part


def test_the_host_rerank_stays_eager_and_untraced(monkeypatch):
    monkeypatch.setenv("HELIX_QUANT_RERANK", "host")
    part = budgeted_partition_host(6_000)
    qs = queries(16, 96, 6)
    with cpu_profile():
        ids, _ = part.search_many(qs, 10)
    assert ids.shape == (16, 10)
    assert tracing.snapshot().spans == []


# ------------------------------------- served against the reference


@pytest.fixture(scope="module")
def served():
    """A batch of 256 served through ``Partition.search_many_async`` over
    40,960 of the harness's rows, the configuration's budget scaled to
    keep its bytes a row: ``(config, part, rows, queries, ids, dists)``."""
    config = scaled(deep100m(), 40_960)
    corpus = Corpus(config["generator"], 96, SEED, CPU)
    rows = corpus.rows(config["rows"])
    _, part = system.build(config, rows, CPU)
    assert system.rung(part) == "int8.device_rerank"
    assert part.quant_candidates == 640
    qs = corpus.queries(256)
    ids, dists = part.search_many_async(qs, 10)()
    return config, part, rows, qs, ids, dists


def test_the_configuration_is_deep_under_a_budget():
    cfg = deep100m()
    assert (cfg["dim"], cfg["k"], cfg["metric"]) == (96, 10, "cosine")
    assert cfg["reduced"] == ["rows"] and cfg["rows"] % 1_000_000 == 0
    assert cfg["generator"] == spec.config(spec.load_benchmark(),
                                           "deep10m-cos")["generator"]
    dep = cfg["deployment"]
    assert dep["hbm_budget_bytes"] == 20 << 30
    assert dep["quant_candidates"] == 64 * cfg["k"]
    # the budget sends the configured rows to the device re-rank
    n = cfg["rows"]
    assert n * (128 * 3 + 8) <= dep["hbm_budget_bytes"] < n * 128 * 6
    assert cfg["guarantees"]["distance"]["limit"] == 2.0 ** -11


def test_a_served_batch_meets_the_configurations_limits(served):
    config, _, rows, qs, ids, dists = served
    found = check.numbers(ids, dists, qs, rows, config, CPU)
    found["failed"] = 0
    correct, checked = check.verdict(found, check.limits(config))
    assert correct, checked
    assert 0 < found["dist_err"] <= 2.0 ** -11


def test_a_bf16_copy_of_the_rows_fails_the_distance_limit(served):
    """The control: the same candidates re-ranked through a bf16 copy of
    the rows instead of the f16 one miss the 2^-11 limit, and only
    through the copy's precision (the f16 copy passes)."""
    config, part, rows, qs, _, _ = served
    m = part.matrix
    xs_i8, scales, sq = part.quant.arrays(m)
    q = torch.from_numpy(m.prepare_queries(qs))
    _, cand = Q.int8_coarse_topk(xs_i8, scales, q, m.n, sq, k=640)
    live = torch.ones(m.n, dtype=torch.uint8)
    limit = check.limits(config)
    verdicts = {}
    for dtype in (torch.float16, torch.bfloat16):
        copy = torch.from_numpy(m.data[: m.n]).to(dtype)
        d, p = Q.device_rerank_topk(copy, sq, q, cand, live, m.n, k=10)
        ids, dists = part._map_hits(d.numpy(), p.numpy().astype(np.int64),
                                    part.id_table)
        found = check.numbers(ids, dists, qs, rows, config, CPU)
        found["failed"] = 0
        verdicts[dtype] = found, check.verdict(found, limit)[0]
    assert verdicts[torch.float16][1]
    found, correct = verdicts[torch.bfloat16]
    assert not correct and found["dist_err"] > 2.0 ** -11


def test_the_served_distances_are_within_f16_of_float64(served):
    _, _, rows, qs, ids, dists = served
    exact = reference.distances_of(rows, qs, ids.astype(np.int64) - 1,
                                   "cosine")
    assert np.abs(dists - exact).max() <= 2.0 ** -11


# ------------------------------------------------ kernel 2's roofline


def roofline_record(device_ops, batches=100):
    rec = Record(cell={}, config={"rows": 35_000_000, "dim": 96},
                 traffic={"entry": "engine", "batch": 256, "k": 10})
    rec.counts["batches"] = batches
    rec.trace = {"device_ops": device_ops, "kernel_s": 1.0}
    return rec


def test_the_i8_roofline_reader_finds_nothing_without_kernel_2():
    read = spec.reader("kernel.i8_bucket_roofline")
    assert read(roofline_record([["bucket_scores_kernel<2, true>", 0.5]])) \
        is None
    assert read(roofline_record([["i8_bucket_scores_kernel<2, true>", 0.5]],
                                batches=0)) is None
    rec = roofline_record([["i8_bucket_scores_kernel<2, true>", 0.5]])
    rec.trace = None
    assert read(rec) is None


def test_the_i8_roofline_reader_arithmetic():
    read = spec.reader("kernel.i8_bucket_roofline")
    ops = [["i8_bucket_scores_kernel<2, true>(signed char const*)", 0.3],
           ["bucket_scores_kernel<2, true>", 9.0],
           ["i8_bucket_scores_kernel<1, true>", 0.1],
           ["select_block<0>", 0.2]]
    n_bytes = 35_000_000 * 96 + 256 * 96 + math.ceil(35_000_000 / 64) * 256 * 4
    least = max(n_bytes / 3.35e12, 2.0 * 256 * 35_000_000 * 96 / 1979e12)
    assert least == n_bytes / 3.35e12
    got = read(roofline_record(ops))
    assert got == pytest.approx(100.0 * least / (0.4 / 100), rel=1e-12)
    # kernel 1's reader does not read kernel 2
    kernel1 = spec.reader("kernel.bucket_roofline")(roofline_record(ops))
    assert kernel1 is not None and kernel1 != got


# ------------------------------------------------ the cell, rehearsed


@pytest.mark.parametrize("trace", [False, True])
def test_a_rehearsal_of_the_cell_serves_int8_and_is_correct(capsys, trace):
    bench = spec.load_benchmark()
    cell = spec.workload(bench, CELL)
    config = scaled(spec.config(bench, cell["config"]), 20_480)
    mix = dict(spec.traffic(cell), pool_qps=2_000)
    t0 = time.perf_counter()
    line = run.run_cell(bench, cell, config, mix, SEED + 1, 1.0, trace, CPU,
                        age=lambda: time.perf_counter() - t0)
    err = capsys.readouterr().err
    assert "hxbench: rung int8.device_rerank\n" in err
    assert line["correct"], line["checked"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["checked"]["dist_err"][1] == 2.0 ** -11
    if not trace:
        assert set(line["metrics"]) == {"qps", "p50_ms", "p95_ms", "setup_s"}
        return
    allowed = {m["name"] for m in spec.metrics_of(bench, CELL, "per_layer")}
    assert set(line["metrics"]) <= allowed
    # the program's spans name the parts of the dispatch; the device's
    # readers find nothing on the CPU
    assert {"engine.dispatch_ms", "engine.finalize_ms", "engine.live_count_ms",
            "engine.h2d_ms", "engine.search_self_ms", "engine.d2h_wait_ms",
            "kernel.enqueue_ms"} <= set(line["metrics"])
    assert "kernel.i8_bucket_roofline" not in line["metrics"]


# ------------------------------------------------------------ the card


@pytest.mark.cuda
@pytest.mark.parametrize("slice_rows", [7, None])
def test_codes_and_f16_rows_built_on_the_card_equal_numpy(monkeypatch,
                                                          slice_rows):
    dev = card()
    m = matrix_of(awkward_rows(20_001, 96, 12), device=dev)
    if slice_rows is not None:
        monkeypatch.setattr(m, "UPLOAD_CHUNK_BYTES", slice_rows * m.dim_pad * 4)
    n_rows = Q.pad_rows_for_fused(m.n)
    codes = Q.unit_codes_device(m, n_rows)
    assert np.array_equal(codes.cpu().numpy(), numpy_codes(m, n_rows))
    xs16, _ = Q.QuantizedResident().rerank_arrays(m)
    want = numpy_f16(m, _round_up(m.n, m.ROW_PAD))
    assert np.array_equal(xs16.cpu().numpy().view(np.uint16),
                          want.view(np.uint16))


@pytest.mark.cuda
@pytest.mark.parametrize("b, k, dead", [(256, 10, False), (16, 100, True)])
def test_the_served_dispatch_on_the_card_equals_the_eager_rung(b, k, dead):
    """Through kernel 2 (``n >= TILE``, cosine, D 128, buckets enough
    for k=100's pool of 800): bit for bit the same arithmetic fed the
    numpy-built codes and f16 rows."""
    dev = card()
    part = budgeted_partition(70_000, 13, dead, quant_candidates=640,
                              device=dev)
    Q.i8_bucket_scores.launches = 0
    qs = queries(b, 96, 14)
    ids, dists = part.search_many_async(qs, k)()
    assert Q.i8_bucket_scores.launches == 1
    want_ids, want_dists = eager_reference(part, qs, k)
    assert np.array_equal(ids, want_ids)
    assert np.array_equal(dists, want_dists)
