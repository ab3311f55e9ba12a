"""The port's mesh serving paths against the JAX reference's on the CPU:
``ShardedInt8Search``, ``ShardedBM25``, and the engine's sharded exact
tier, int8 and int4 rungs and text partitions, with writes landing
between reads.

The reference runs on its 8 virtual CPU devices (``tests/conftest.py``),
the port on a virtual mesh of 8 CPU devices.  Tolerances: int8 host
re-rank candidates equal as sets of ids, and after the host re-rank (the
same native f32 code on both sides) ids and distances equal; int8 device
re-rank scores (f16 rows, f32 sums in another order) within 2e-3 with
ids equal; engine answers equal byte for byte as JSON where every score
is computed by the same code (the native re-rank, the exact BM25
arithmetic), and ids equal with ``$distance`` within 2e-3 after the
device re-rank.
"""

import json

import numpy as np
import pytest
import torch

from helix_tpu.dsl import g, read_batch, write_batch
from helix_tpu.engine import Engine as RefEngine
from helix_tpu.engine.text import TextPartition as RefText
from helix_tpu.engine.vector import Partition as RefPartition
from helix_tpu.ops.bm25 import ShardedBM25 as RefBM25
from helix_tpu.ops.quant import ShardedInt8Search as RefInt8
from helix_tpu.ops.quant import quantize_rows
from helix_tpu.parallel import make_mesh as ref_mesh
from helix_tpu_torch.engine import Engine as PortEngine
from helix_tpu_torch.engine.text import TextPartition as PortText
from helix_tpu_torch.engine.text import tokenize
from helix_tpu_torch.engine.vector import Partition as PortPartition
from helix_tpu_torch.ops.bm25 import DevicePostings, ShardedBM25
from helix_tpu_torch.ops.quant import ShardedInt8Search
from helix_tpu_torch.parallel import make_mesh, virtual_devices

from tests.test_torch_ladder import unit_data

torch.set_num_threads(2)
CPU = torch.device("cpu")
RERANK_TOL = 2e-3


@pytest.fixture
def mesh8():
    with virtual_devices("cpu", 8):
        yield make_mesh(device=CPU)


def clustered(rng, n, d):
    centers = rng.normal(size=(50, d)).astype(np.float32)
    data = centers[rng.integers(0, 50, size=n)] \
        + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    qs = centers[rng.integers(0, 50, size=16)] \
        + 0.3 * rng.normal(size=(16, d)).astype(np.float32)
    return data, qs / np.linalg.norm(qs, axis=1, keepdims=True)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_sharded_int8_matches_reference(mesh8, metric):
    rng = np.random.default_rng(4)
    n, d, k = 4001, 64, 10              # ragged over 8 shards
    data, qs = clustered(rng, n, d)
    values, scales = quantize_rows(data)
    sq = np.sum(data * data, axis=1).astype(np.float32)
    live = np.ones(n, np.uint8)
    sims = qs @ data.T
    oracle = np.argsort(-sims, axis=1)[:, :k]
    live[oracle[0, 0]] = 0               # a tombstone on the device path

    ref = RefInt8(ref_mesh(), k=80, metric=metric)
    r_arrays = ref.shard_arrays(values, scales, sq)
    _, r_cand = ref(*r_arrays[:3], qs, r_arrays[3])
    port = ShardedInt8Search(mesh8, k=80, metric=metric)
    p_arrays = port.shard_arrays(values, scales, sq)
    _, p_cand = port(*p_arrays[:3], qs, p_arrays[3])
    r_cand, p_cand = np.asarray(r_cand), p_cand.numpy()
    assert p_cand.shape == r_cand.shape
    for got, want in zip(p_cand, r_cand):
        assert set(got.tolist()) == set(want.tolist())
    if metric == "cosine":
        assert np.mean([len(set(oracle[i]) & set(p_cand[i])) / k
                        for i in range(len(qs))]) >= 0.98

    ref_rr = RefInt8(ref_mesh(), k=80, metric=metric, rerank_device=True,
                     k_out=k)
    r_s, r_i = ref_rr(*r_arrays[:3], qs, r_arrays[3],
                      rerank_arrays=ref_rr.shard_rerank_arrays(data, live))
    port_rr = ShardedInt8Search(mesh8, k=80, metric=metric,
                                rerank_device=True, k_out=k)
    p_s, p_i = port_rr(*p_arrays[:3], qs, p_arrays[3],
                       rerank_arrays=port_rr.shard_rerank_arrays(data, live))
    np.testing.assert_array_equal(p_i.numpy(), np.asarray(r_i))
    np.testing.assert_allclose(p_s.numpy(), np.asarray(r_s), atol=RERANK_TOL,
                               rtol=0)
    assert oracle[0, 0] not in p_i.numpy()[0]
    with pytest.raises(ValueError, match="shard_rerank_arrays"):
        port_rr(*p_arrays[:3], qs, p_arrays[3])


def rung(part):
    return part._use_quant(), part._use_quant4(), part._use_host_ivf()


@pytest.mark.parametrize("metric,budget,mode", [
    ("cosine", 16_384 * 200, "host"),    # int8 -> sharded int8, host re-rank
    ("cosine", 16_384 * 200, "device"),  # int8 -> sharded int8, f16 re-rank
    ("cosine", 16_384 * 200, "auto"),    # per-shard f16 copy fits: device
    ("cosine", 16_384 * 100, "host"),    # int4 -> sharded int8
    ("l2", 16_384 * 200, "host"),
    ("l2", 16_384 * 100, "device"),
])
def test_quantized_rungs_route_to_sharded_int8(mesh8, metric, budget, mode,
                                               monkeypatch):
    monkeypatch.setenv("HELIX_QUANT_RERANK", mode)
    n, d = 16_384, 64
    data = unit_data(n, d, seed=5)
    ref = RefPartition(metric, hbm_budget_bytes=budget)
    port = PortPartition(metric, hbm_budget_bytes=budget, device=CPU)
    for part in (ref, port):
        part.add_bulk(list(range(1, n + 1)), data)
        for element_id in (2, 77, 5000):
            part.remove(element_id)
    assert rung(port) == rung(ref)
    assert port._quant4_recall_serving()
    queries = unit_data(32, d, seed=6)
    want_ids, want_d = ref.search_many(queries, 10)
    got_ids, got_d = port.search_many(queries, 10)
    np.testing.assert_array_equal(got_ids, want_ids)
    on_device = port._quant_rerank_device_sharded(8)
    assert on_device == (mode != "host")
    assert np.max(np.abs(got_d - want_d)) <= (RERANK_TOL if on_device
                                              else 0.0)
    assert not np.isin(got_ids, [2, 77, 5000]).any()
    state = port._shard_state
    assert state["kind"] == "int8" and ref._shard_state["kind"] == "int8"
    assert port.quant is None and port.quant4 is None
    # alternating k keeps the arrays (keyed by the matrix version only)
    arrays = state["arrays"]
    port.search_many(queries[:2], 3)
    assert port._shard_state is state and state["arrays"] is arrays
    assert len(state["searchers"]) == 2


DIM = 16


def vsearch(eng, q, k=5):
    return eng.execute({
        "request_type": "read", "query_name": None,
        "query": read_batch().var_as("hits", g().vector_search_nodes(
            "Doc", "emb", [float(x) for x in q], k).value_map(["$id", "i"]))
        .returning(["hits"]).encode(),
        "parameters": {}})["hits"]


def hybrid(eng, q, label="REL"):
    return eng.execute({
        "request_type": "read", "query_name": None,
        "query": read_batch().var_as("rows", g().vector_search_nodes(
            "Doc", "emb", [float(x) for x in q], 5).out(label)
            .value_map(["i"])).returning(["rows"]).encode(),
        "parameters": {}})


def write(eng, batch):
    eng.execute({"request_type": "write", "query_name": None,
                 "query": batch.encode(), "parameters": {}})


def ingest(eng, rng, count=211):
    wb = write_batch().var_as("ix", g().create_vector_index_nodes("Doc", "emb"))
    for i in range(count):  # prime: ragged over every shard split
        wb = wb.var_as(f"n{i}", g().add_n("Doc", {
            "i": int(i), "emb": [float(x) for x in rng.normal(size=DIM)]}))
    write(eng, wb)
    ids = eng.execute({"request_type": "read", "query_name": None,
                       "query": read_batch().var_as(
                           "u", g().n_with_label("Doc").id())
                       .returning(["u"]).encode(), "parameters": {}})["u"]
    eb = write_batch()
    for j in range(400):
        a, b = rng.integers(0, count, 2)
        eb = eb.var_as(f"e{j}", g().n({"Ids": [ids[a]]}).add_e(
            "REL", {"Ids": [ids[b]]}))
    write(eng, eb)


def part_of(eng):
    return next(iter(eng.vectors.indexes.values())).partitions[("",)]


@pytest.fixture
def served(mesh8):
    """(reference sharded, port sharded, port one-device) engines over the
    same writes."""
    out = (RefEngine(shard_threshold=1, graph_shard_threshold=1),
           PortEngine(device="cpu", shard_threshold=1,
                      graph_shard_threshold=1),
           PortEngine(device="cpu"))
    for eng in out:
        ingest(eng, np.random.default_rng(5))
    yield out
    for eng in out:
        eng.close()


def same(engines, fn, *args):
    answers = [json.dumps(fn(eng, *args)) for eng in engines]
    assert len(set(answers)) == 1, answers
    return json.loads(answers[0])


def test_sharded_serving_refreshes_on_ingest(served):
    ref, port, single = served
    qrng = np.random.default_rng(31)
    q = qrng.normal(size=DIM)
    same(served, vsearch, q)
    part = part_of(port)
    assert part._shard_state is not None and part._shard_state["kind"] \
        == "exact", "sharded path never engaged"
    version_before = part._shard_state["version"]
    new_vecs = qrng.normal(size=(23, DIM))
    for eng in served:
        wb = write_batch()
        for i, vec in enumerate(new_vecs):
            wb = wb.var_as(f"m{i}", g().add_n("Doc", {
                "i": 1000 + i, "emb": [float(x) for x in vec]}))
        write(eng, wb)
    got = same(served, vsearch, new_vecs[7], 1)
    assert got[0]["i"] == 1007
    state = part_of(port)._shard_state
    assert state["version"] != version_before
    assert state["version"] == part_of(port).matrix.version
    for _ in range(4):
        q2 = qrng.normal(size=DIM)
        same(served, vsearch, q2)
        same(served, hybrid, q2)


def test_tombstones_and_fresh_edges_on_the_mesh(served):
    qrng = np.random.default_rng(77)
    q = qrng.normal(size=DIM)
    top = same(served, vsearch, q, 1)[0]
    for eng in served:
        write(eng, write_batch().var_as("d", g().n({"Ids": [top["$id"]]})
                                        .drop()))
    hits = same(served, vsearch, q)
    assert top["$id"] not in [h["$id"] for h in hits]
    hit_ids = [h["$id"] for h in hits]
    for eng in served:
        eb = write_batch()
        for j, hid in enumerate(hit_ids):
            eb = eb.var_as(f"e{j}", g().n({"Ids": [hid]}).add_e(
                "FRESH", {"Ids": [hit_ids[(j + 1) % len(hit_ids)]]}))
        write(eng, eb)
    rows = same(served, hybrid, q, "FRESH")["rows"]
    assert len(rows) == len(hit_ids)


def test_engine_sharded_exact_serving_matches_reference(mesh8):
    """800 rows x 24 above shard_threshold: the mesh path and its native
    re-rank answer as the reference's mesh (byte for byte) and the
    one-device path."""
    rng = np.random.default_rng(9)
    data = rng.normal(size=(800, 24)).astype(np.float32)
    rows = [{"i": int(i), "emb": [float(x) for x in data[i]]}
            for i in range(len(data))]

    def build(eng):
        write(eng, write_batch().var_as(
            "idx", g().create_vector_index_nodes("Doc", "emb")))
        eng.execute({
            "request_type": "write",
            "query": write_batch().for_each_param("docs", write_batch()
                                                  .var_as("d", g().add_n(
                                                      "Doc", [
                ("i", {"Expr": {"Param": "docs.i"}}),
                ("emb", {"Expr": {"Param": "docs.emb"}}),
            ]))).encode(),
            "parameters": {"docs": rows},
            "parameter_types": {"docs": {"Array": "Object"}}})
        return eng

    engines = (build(RefEngine(shard_threshold=100)),
               build(PortEngine(device="cpu", shard_threshold=100)),
               build(PortEngine(device="cpu")))
    for qi in (3, 77, 400):
        for k in (5, 12):
            def read(eng):
                return eng.execute({
                    "request_type": "read", "query_name": None,
                    "query": read_batch().var_as(
                        "hits", g().vector_search_nodes(
                            "Doc", "emb", [float(x) for x in data[qi]], k)
                        .value_map(["$id", "$distance", "i"]))
                    .returning(["hits"]).encode(), "parameters": {}})["hits"]

            hits = same(engines[:2], read)
            # the one-device engine scores 800 rows on the host in numpy:
            # ids equal, distances to f32 rounding
            single = read(engines[2])
            assert [h["$id"] for h in single] == [h["$id"] for h in hits]
            np.testing.assert_allclose(
                [h["$distance"] for h in single],
                [h["$distance"] for h in hits], atol=1e-6, rtol=0)
    state = part_of(engines[1])._shard_state
    assert state["kind"] == "exact" and len(state["searchers"]) == 2
    assert part_of(engines[2])._shard_state is None


WORDS = ("graph vector database search engine tpu index query latency "
         "throughput node edge embedding text score rank shard mesh").split()


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(4)
    return {doc_id: " ".join(rng.choice(WORDS, int(rng.integers(3, 30))))
            for doc_id in range(1, 1101)}   # 1100 docs: 5 of 8 shards


def test_sharded_bm25_matches_reference_and_host(mesh8, corpus):
    ref_host = RefText(device_threshold=10**9)
    port_host = PortText(device_threshold=10**9, device=CPU)
    for doc_id, text in corpus.items():
        ref_host.add(doc_id, text)
        port_host.add(doc_id, text)
    ref = RefBM25.build(ref_host.postings, ref_host.doc_len, ref_mesh())
    port = ShardedBM25.build(port_host.postings, port_host.doc_len, mesh8)
    assert port.rows_per_shard == ref.rows_per_shard == 256
    np.testing.assert_array_equal(port.slot_to_doc, ref.slot_to_doc)
    single = DevicePostings.build(port_host.postings, port_host.doc_len,
                                  device=CPU)
    for query in ("graph vector", "tpu index latency", "score shard mesh",
                  "missing-term", " ".join(WORDS[:16])):
        tokens = tokenize(query)
        r_ids, r_scores = ref.search(tokens, 10)
        p_ids, p_scores = port.search(tokens, 10)
        np.testing.assert_array_equal(p_ids, r_ids)
        np.testing.assert_allclose(p_scores, r_scores, rtol=1e-6, atol=0)
        h_ids, h_scores = port_host.search(query, 10)
        np.testing.assert_array_equal(p_ids, h_ids)
        np.testing.assert_allclose(p_scores, h_scores, rtol=1e-5, atol=0)
        np.testing.assert_array_equal(p_ids, single.search(tokens, 10)[0])
    assert port.search(["graph"] * 40, 5) is None
    assert port.search([f"zz{i}" for i in range(40)], 5)[0].size == 0


def test_sharded_bm25_tie_membership_across_shards(mesh8):
    """600 identical docs, inserted in scrambled order with churn, over 3
    shards: the top 300 are ids 1..300, across the shard boundary."""
    ids = list(range(1, 601))
    np.random.default_rng(9).shuffle(ids)
    parts = (RefText(device_threshold=10**9),
             PortText(device_threshold=10**9, device=CPU))
    for part in parts:
        for doc_id in ids:
            part.add(doc_id, "delta epsilon")
        for doc_id in (3, 11, 270):
            part.remove(doc_id)
            part.add(doc_id, "delta epsilon")
    ref = RefBM25.build(parts[0].postings, parts[0].doc_len, ref_mesh())
    port = ShardedBM25.build(parts[1].postings, parts[1].doc_len, mesh8)
    got, _ = port.search(tokenize("delta"), 300)
    assert got.tolist() == ref.search(tokenize("delta"), 300)[0].tolist() \
        == list(range(1, 301))


def test_text_partition_routes_to_sharded_bm25_on_the_mesh(mesh8, corpus):
    part = PortText(device_threshold=1, device=CPU)
    for doc_id, text in corpus.items():
        part.add(doc_id, text)
    host = PortText(device_threshold=10**9, device=CPU)
    for doc_id, text in corpus.items():
        host.add(doc_id, text)
    got = part.search("graph vector", 7)
    assert isinstance(part._device[1], ShardedBM25)
    np.testing.assert_array_equal(got[0], host.search("graph vector", 7)[0])


def test_text_search_through_the_engine_on_the_mesh(mesh8, corpus):
    """TextSearchNodes on the reference's mesh and the port's: equal
    answers (the same Okapi arithmetic, bit for bit)."""
    index = {"request_type": "write", "query_name": "w", "query": {
        "queries": [{"Query": {"name": "w", "steps": [{"CreateIndex": {
            "spec": {"NodeText": {"label": "Doc", "property": "body",
                                  "tenant_property": None}},
            "if_not_exists": True}}], "condition": None}}], "returns": []},
        "parameters": {}, "parameter_types": {}}
    docs = {"request_type": "write", "query_name": "ingest", "query": {
        "queries": [{"ForEach": {"param": "docs", "body": [
            {"Query": {"name": "d", "steps": [{"AddN": {
                "label": "Doc", "properties": [
                    ["i", {"Expr": {"Param": "docs.i"}}],
                    ["body", {"Expr": {"Param": "docs.body"}}]]}}],
                "condition": None}}]}}], "returns": []},
        "parameters": {"docs": [{"i": i, "body": t}
                                for i, t in corpus.items()]},
        "parameter_types": {"docs": {"Array": "Object"}}}
    engines = (RefEngine(), PortEngine(device="cpu"))
    for eng in engines:
        eng.execute(index)
        eng.execute(docs)
        eng.texts.indexes[("NodeText", "Doc", "body")].partitions[("",)] \
            .device_threshold = 1
    for query in ("graph vector", "shard mesh rank node"):
        same(engines, lambda eng: eng.execute({
            "request_type": "read", "query_name": "r", "query": {
                "queries": [{"Query": {"name": "r", "steps": [
                    {"TextSearchNodes": {
                        "label": "Doc", "property": "body",
                        "query_text": {"Expr": {"Param": "q"}},
                        "k": {"Expr": {"Param": "k"}}}},
                    {"ValueMap": ["$id", "$score", "i"]}],
                    "condition": None}}], "returns": ["r"]},
            "parameters": {"q": query, "k": 10},
            "parameter_types": {"q": "String", "k": "I64"}}))
    part = engines[1].texts.indexes[("NodeText", "Doc", "body")] \
        .partitions[("",)]
    assert isinstance(part._device[1], ShardedBM25)


@pytest.mark.parametrize("budget,rung", [(20_000 * 200, "int8"),
                                         (20_000 * 100, "int4")])
def test_budgeted_engine_on_the_mesh_answers_like_the_reference(
        mesh8, budget, rung, monkeypatch):
    """``Engine(device="cpu", hbm_budget_bytes=...)`` on the mesh: the
    int8 and int4 rungs serve through sharded int8 (host re-rank) and
    answer as the reference's engine on its mesh, byte for byte."""
    from tests.test_torch_engine import (
        BUNDLE, create_index, drop, gaussian_vectors, ingest as ingest_rows,
        search,
    )

    monkeypatch.setenv("HELIX_QUANT_RERANK", "host")
    data = gaussian_vectors(20_000, seed=7)
    engines = (RefEngine(hbm_budget_bytes=budget),
               PortEngine(device="cpu", hbm_budget_bytes=budget))
    for request in (create_index(), ingest_rows(0, data[:12_000]),
                    ingest_rows(12_000, data[12_000:]), drop([5, 55, 555])):
        same(engines, lambda eng: eng.execute(request))
    for eng in engines:
        eng.load_bundle(BUNDLE)
    for q in gaussian_vectors(8, seed=8):
        hits = same(engines, lambda eng: eng.execute(search(q, 10)))["hits"]
        assert len(hits) == 10 and not {5, 55, 555} & {h["$id"]
                                                      for h in hits}
        same(engines, lambda eng: eng.execute_stored(
            "vsearch", {"q": q.tolist(), "k": 10}))
    part = part_of(engines[1])
    assert part._use_quant() == (rung == "int8")
    assert part._use_quant4() == (rung == "int4")
    assert part._shard_state["kind"] == "int8"
    assert part.quant is None and part.quant4 is None
