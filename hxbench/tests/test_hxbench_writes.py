"""The write mix (``insert_share``, YCSB D's 5% inserts) on the engine
entry: a rehearsal at the tiny size on the CPU, the runs with the write
path broken underneath, which must come out not correct, the comparison's
read-your-writes rule on hand-made answers, and the mixes without inserts
left as they were."""

from __future__ import annotations

import math
import re

import numpy as np
import pytest
import torch

from hxbench import check, loops, spec, system
from hxbench.data import Corpus
from hxbench.record import Record, Spans

from .conftest import TINY_ROWS, WRITE_CELL, rehearse, tiny
from .test_hxbench_rehearsal import _break

NAME = WRITE_CELL["name"]
KEYS = ["failed", "bad_answers", "dist_err", "recall_miss"]
INSERTS = re.compile(r"hxbench: inserts (\d+) acknowledged of (\d+)")


def _inserts(stderr: str) -> tuple[int, int]:
    acked, tried = INSERTS.findall(stderr)[-1]
    return int(acked), int(tried)


def test_write_rehearsal(bench, capsys):
    line = rehearse(bench, NAME)
    assert line["correct"], line["checked"]
    assert list(line["checked"]) == KEYS + ["unread_writes"]
    assert line["checked"]["unread_writes"] == [0, 0]
    assert line["failed"] == 0
    acked, tried = _inserts(capsys.readouterr().err)
    queries = line["attempted"] - tried
    assert acked == tried > 0 and queries % 256 == 0
    # one insert for every 19 queries dispatched: 5% of all operations
    assert tried == queries // 19
    assert set(line["metrics"]) == {"p50_ms", "p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())


def _window(bench, seed: int = 2**31 + 41):
    """One window of the write mix driven by hand: ``(loop, part,
    record, result)``."""
    cell, config, mix = tiny(bench, NAME)
    corpus = Corpus(config["generator"], config["dim"], seed,
                    torch.device("cpu"))
    _, part = system.build(config, corpus.rows(config["rows"]),
                           torch.device("cpu"))
    loop = loops.EngineLoop(part, mix, corpus, 1.0, min_batches=1)
    record = Record(cell=cell, config=config, traffic=mix)
    result = loop.window(1.0, Spans(record, traced=False))
    return loop, part, record, result


def test_the_insert_stream_and_its_reader(bench):
    loop, part, record, result = _window(bench)
    queries = record.counts["queries"]
    acked = record.counts["inserts"]
    # one insert in set-up, then one for every 19 queries dispatched
    assert acked == len(loop.acked) - 1 == queries // 19 > 0
    assert result["attempted"] == queries + acked
    assert part.n_rows == TINY_ROWS + acked + 1
    # ids continue from the built rows' rule: position + 1
    assert list(part.id_table[TINY_ROWS:]) == \
        list(range(TINY_ROWS + 1, TINY_ROWS + acked + 2))
    # the rows inserted are the insert stream's, in order, drawn before
    # the window like the query pool (2,048 queries: 108 rows, and the
    # set-up's one)
    assert loop.acked == list(range(acked + 1))
    corpus = Corpus(record.config["generator"], record.config["dim"],
                    2**31 + 41, torch.device("cpu"))
    first = 1 + math.ceil(2048 / 19)
    np.testing.assert_array_equal(loop.inserts[:first],
                                  corpus.inserts(first))
    got = spec.reader("engine.insert_ms")(record)
    spans = record.spans["engine.insert"]
    assert len(spans) == acked
    assert got == pytest.approx(sum(spans) / acked * 1e3) and got > 0
    # each answered batch knows the inserts before its dispatch and its
    # finalize, and its last 16 queries are the newest of those before
    # its dispatch, newest first
    assert loop.n_latest == 16
    for j, _, _, seen, after, own in result["answered"]:
        assert seen == 1 + j * 256 // 19 <= after
        take = min(16, seen)
        assert list(own[256 - take:]) == \
            list(range(seen - 1, seen - 1 - take, -1))
        assert (own[:256 - take] == -1).all()
    queries, _, _, writes = loop.sample(result, 10**6, 5)
    own = writes["own"]
    latest = own >= 0
    assert latest.sum() == sum(min(16, a[3]) for a in result["answered"])
    np.testing.assert_array_equal(queries[latest], loop.inserts[own[latest]])
    assert (writes["seen"][latest] > own[latest]).all()
    assert spec.reader("engine.insert_ms")(
        Record(cell={}, config={}, traffic={"entry": "engine"})) is None


def _defer_while_in_flight(monkeypatch):
    """A program that acknowledges an insert made while a search is
    outstanding but stores it only once none is: a refresh deferred until
    idle.  Every search after the window sees every row."""
    from helix_tpu_torch.engine.vector import Partition

    real_add = Partition.add
    real_async = Partition.search_many_async
    held: list = []
    outstanding = [0]

    def flush(self):
        while held:
            real_add(self, *held.pop(0))

    def add(self, element_id, vec):
        if outstanding[0]:
            held.append((element_id, vec))
            return
        flush(self)
        real_add(self, element_id, vec)

    def search_many_async(self, queries, k):
        if not outstanding[0]:
            flush(self)
        outstanding[0] += 1
        fin = real_async(self, queries, k)

        def finalize():
            try:
                return fin()
            finally:
                outstanding[0] -= 1

        return finalize

    monkeypatch.setattr(Partition, "add", add)
    monkeypatch.setattr(Partition, "search_many_async", search_many_async)


def test_writes_missed_while_batches_are_in_flight_are_not_correct(
        bench, monkeypatch):
    """The read-back after the window finds every row, and the recall
    limit lets the few latest queries' misses through: the window's own-id
    reads of the newest rows catch it."""
    _defer_while_in_flight(monkeypatch)
    line = rehearse(bench, NAME)
    assert not line["correct"], line["checked"]
    assert line["checked"]["unread_writes"][0] > 0

    loop, _, record, result = _window(bench)
    config = record.config
    rows = Corpus(config["generator"], config["dim"], 2**31 + 41,
                  torch.device("cpu")).rows(TINY_ROWS)
    cpu = torch.device("cpu")
    window = loop.sample(result, check.SAMPLE, 2**31 + 41)
    back = loop.read_back()
    in_window = check.numbers(window[1], window[2], window[0], rows, config,
                              cpu, writes=window[3])
    after = check.numbers(back[1], back[2], back[0], rows, config, cpu,
                          writes=back[3])
    assert in_window["unread_writes"] > 0
    assert in_window["recall_miss"] <= check.limits(config)["recall_miss"]
    assert after["unread_writes"] == 0 and after["recall_miss"] == 0


def test_add_that_stores_nothing_is_not_correct(bench, monkeypatch):
    from helix_tpu_torch.engine.vector import Partition

    monkeypatch.setattr(Partition, "add", lambda self, element_id, vec: None)
    line = rehearse(bench, NAME)
    assert not line["correct"], line["checked"]
    assert line["checked"]["unread_writes"][0] > 0


def test_a_stale_device_copy_is_not_correct(bench, monkeypatch):
    """Searches served from the device copy made before the first insert:
    the copy's version check patched away."""
    from helix_tpu_torch.ops.distance import PackedMatrix

    real_arrays = PackedMatrix.device_arrays
    real_f32 = PackedMatrix.data_device

    def arrays(self):
        return self._device[1:] if self._device else real_arrays(self)

    def f32(self):
        return self._device32[1] if self._device32 else real_f32(self)

    monkeypatch.setattr(PackedMatrix, "device_arrays", arrays)
    monkeypatch.setattr(PackedMatrix, "data_device", f32)
    line = rehearse(bench, NAME)
    assert not line["correct"], line["checked"]


def test_an_id_past_the_acknowledged_rows_is_not_correct(bench,
                                                         monkeypatch):
    """An answer that names the row one past those acknowledged before its
    ``finalize()`` returned."""
    from helix_tpu_torch.engine.vector import Partition

    real = Partition.search_many_async

    def broken(self, queries, k):
        fin = real(self, queries, k)

        def finalize():
            ids, dists = fin()
            ids = ids.copy()
            ids[:, -1] = self.n_rows + 1
            return ids, dists

        return finalize

    monkeypatch.setattr(Partition, "search_many_async", broken)
    line = rehearse(bench, NAME)
    assert not line["correct"], line["checked"]
    assert line["checked"]["bad_answers"][0] > 0


@pytest.mark.parametrize("how", ["altered", "half_left_out"])
def test_broken_search_under_writes_is_not_correct(bench, monkeypatch, how):
    _break(monkeypatch, how)
    line = rehearse(bench, NAME)
    assert not line["correct"], line["checked"]


def _hand_made():
    """Eight built rows, two inserts, and one query that sits on the
    second insert; the first insert lies opposite it, farther than any
    built row."""
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(8, 4)).astype(np.float32)
    q = np.float32([1.0, 2.0, 0.5, -1.0])
    inserts = np.stack([-q, q])
    config = {"k": 2, "metric": "cosine", "guarantees": {
        "distance": {"kind": "absolute", "limit": 1e-5},
        "recall_at_k_min": 1.0}}
    return rows, inserts, inserts[1:2].copy(), config


def _writes(seen, acked, own=-1):
    return {"inserts": _hand_made()[1], "seen": [seen], "acked": [acked],
            "own": [own]}


def _answer(rows, inserts, query, positions):
    from hxbench import reference

    pos = np.asarray([positions])
    d = reference.distances_of(rows, query, pos, "cosine", inserts)
    return pos + 1, d


@pytest.mark.parametrize("seen,acked,ok", [
    (2, 2, True),    # the insert was acknowledged before the dispatch
    (1, 2, True),    # acknowledged after it, before the finalize: may show
    (1, 1, False),   # acknowledged after the finalize: out of range
])
def test_a_late_insert_may_show_and_an_unacknowledged_one_may_not(
        seen, acked, ok):
    rows, inserts, query, config = _hand_made()
    from hxbench import reference

    d_rows, p_rows = reference.exact_topk(rows, query, 2, "cosine",
                                          torch.device("cpu"))
    # the answer holds the query's own row (position 9) and the nearest
    # built row
    ids, dists = _answer(rows, inserts, query, [9, int(p_rows[0, 0])])
    found = check.numbers(ids, dists, query, rows, config,
                          torch.device("cpu"), writes=_writes(seen, acked))
    found["failed"] = 0
    correct, _ = check.verdict(found, check.limits(config, writes=True))
    assert correct is ok, found


def test_an_insert_acknowledged_before_dispatch_must_show():
    """Leaving out a row acknowledged before the dispatch misses recall;
    leaving it out when it came after the dispatch does not."""
    rows, inserts, query, config = _hand_made()
    from hxbench import reference

    _, p_rows = reference.exact_topk(rows, query, 2, "cosine",
                                     torch.device("cpu"))
    ids, dists = _answer(rows, inserts, query, list(p_rows[0]))
    for seen, miss in ((2, 0.5), (1, 0.0)):
        found = check.numbers(ids, dists, query, rows, config,
                              torch.device("cpu"), writes=_writes(seen, 2))
        assert found["recall_miss"] == miss and found["bad_answers"] == 0
        assert found["unread_writes"] == 0


@pytest.mark.parametrize("with_own,unread", [(True, 0), (False, 1)])
def test_a_query_with_an_inserts_own_row_must_find_it(with_own, unread):
    """The query is the second insert's own row (own index 1, position
    9), acknowledged before the dispatch."""
    rows, inserts, query, config = _hand_made()
    from hxbench import reference

    _, p_rows = reference.exact_topk(rows, query, 2, "cosine",
                                     torch.device("cpu"))
    positions = [9, int(p_rows[0, 0])] if with_own else list(p_rows[0])
    ids, dists = _answer(rows, inserts, query, positions)
    found = check.numbers(ids, dists, query, rows, config,
                          torch.device("cpu"), writes=_writes(2, 2, own=1))
    assert found["unread_writes"] == unread


def test_unread_writes_counts_each_missing_own_id():
    own = np.array([11, 12, 13])
    ids = np.array([[11, 4], [5, 12], [6, 7]], np.uint64)
    dists = np.array([[0.0, 0.2], [0.1, 3e-5], [0.0, 0.0]])
    # 11 found at 0; 12 found too far from 0; 13 not found
    assert check.unread_writes(own, ids, dists, 1e-5) == 2
    assert check.unread_writes(own, np.zeros((3, 0)), np.zeros((3, 0)),
                               1e-5) == 3


def test_without_insert_share_the_loop_is_as_before(bench, monkeypatch):
    """No key (or a share of 0): the same query pool, no insert drawn or
    made, the sample as the loop took it before the write mix, and the
    four checked numbers alone."""
    from helix_tpu_torch.engine.vector import Partition

    cell, config, mix = tiny(bench, "deep10m-cos.batch256")
    assert "insert_share" not in mix
    seed = 2**31 + 43
    corpus = Corpus(config["generator"], config["dim"], seed,
                    torch.device("cpu"))
    _, part = system.build(config, corpus.rows(config["rows"]),
                           torch.device("cpu"))
    loop = loops.EngineLoop(part, mix, corpus, 1.0)
    zero = loops.EngineLoop(part, dict(mix, insert_share=0),
                            Corpus(config["generator"], config["dim"], seed,
                                   torch.device("cpu")), 1.0)
    fresh = Corpus(config["generator"], config["dim"], seed,
                   torch.device("cpu"))
    want = fresh.queries(math.ceil(2_000 / 256) * 256)
    for each in (loop, zero):
        np.testing.assert_array_equal(each.pool, want)
        assert each.inserts is None and each.read_back() is None
        assert each.n_latest == 0 and each.acked == []

    rng = np.random.default_rng(5)
    answered = [(j, rng.integers(1, TINY_ROWS, (256, 10)),
                 rng.random((256, 10)), 0, 0, None) for j in (0, 1, 3)]
    got = loop.sample({"answered": answered}, 300, seed)
    rows = np.concatenate([np.arange(j * 256, (j + 1) * 256)
                           for j, *_ in answered])
    pick = check.sample(len(rows), 300, seed)
    ids = np.concatenate([a[1] for a in answered])
    dists = np.concatenate([a[2] for a in answered])
    np.testing.assert_array_equal(got[0], loop.pool[rows[pick]])
    np.testing.assert_array_equal(got[1], ids[pick])
    np.testing.assert_array_equal(got[2], dists[pick])
    assert got[3] is None and loops.joined(got, None) is got

    def refuse(self, element_id, vec):
        raise AssertionError("a mix without inserts inserted")

    monkeypatch.setattr(Partition, "add", refuse)
    line = rehearse(bench, "deep10m-cos.batch256")
    assert line["correct"], line["checked"]
    assert list(line["checked"]) == KEYS
    assert line["attempted"] % 256 == 0


@pytest.mark.parametrize("keys", [
    {"insert_share": 1},
    {"insert_share": -0.05},
    {"latest_share": 0.0625},
    {"insert_share": 0.05, "latest_share": 1.5},
])
def test_mix_parameters_out_of_range_are_refused(bench, keys):
    _, _, mix = tiny(bench, NAME)
    mix.pop("latest_share")
    mix.pop("insert_share")
    with pytest.raises(ValueError, match="_share"):
        loops.EngineLoop(None, dict(mix, **keys), None, 1.0)


def test_the_http_entry_refuses_inserts(bench):
    from .conftest import HTTP_CELL

    _, config, mix = tiny(bench, HTTP_CELL["name"])
    mix["insert_share"] = 0.05
    with pytest.raises(ValueError, match="insert_share"):
        loops.HttpLoop(None, None, mix, config, None, 1.0, 1, gw=object())
