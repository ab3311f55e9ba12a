"""Device BM25: the port's ``ops/bm25.py`` against the JAX reference's on
the same postings, and the port's engine against the reference engine
on the same text writes with the device path engaged.

Tolerances: ids exact and in the same order; scores within one float32
ulp.  Both sides sum each doc's per-term contributions in term order,
and the port computes each contribution as XLA compiles it on the CPU
(one rounding for ``tf + k1 * x``, ``idf`` scaled first), so on these
seeds the scores come out equal bit for bit.
"""

import json

import numpy as np
import pytest
import torch

import helix_tpu.ops.bm25 as J
import helix_tpu_torch.ops.bm25 as T
from helix_tpu.engine import Engine as RefEngine
from helix_tpu.engine.text import TextPartition as RefPartition
from helix_tpu.engine.text import tokenize
from helix_tpu_torch.engine import Engine as PortEngine
from helix_tpu_torch.engine.text import TextPartition as PortPartition

from tests.test_torch_ladder import single_device  # noqa: F401

torch.set_num_threads(2)
CPU = torch.device("cpu")

WORDS = (
    "graph vector database search engine tpu index query latency "
    "throughput node edge embedding text score rank shard mesh"
).split()


def corpus(n_docs, seed=4):
    """``tests/test_bm25_device.py``'s generator: docs of 3-29 words
    drawn from ``WORDS``, ids 1..n_docs."""
    rng = np.random.default_rng(seed)
    return {doc_id: " ".join(rng.choice(WORDS, int(rng.integers(3, 30))))
            for doc_id in range(1, n_docs + 1)}


def host_index(docs):
    part = RefPartition(device_threshold=10**9)
    for doc_id, text in docs.items():
        part.add(doc_id, text)
    return part


def assert_within_ulp(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


@pytest.fixture(scope="module")
def postings():
    host = host_index(corpus(400))
    return (host, J.DevicePostings.build(host.postings, host.doc_len),
            T.DevicePostings.build(host.postings, host.doc_len, device=CPU))


def test_host_arrays_match_reference(postings):
    host, ref, port = postings
    terms, docs, tf, lengths, slot_to_doc, df = T.DevicePostings.host_arrays(
        host.postings, host.doc_len)
    assert ref.vocab == port.vocab == {t: i for i, t in enumerate(terms)}
    np.testing.assert_array_equal(docs, np.asarray(ref.post_docs))
    np.testing.assert_array_equal(tf, np.asarray(ref.post_tf))
    np.testing.assert_array_equal(lengths, np.asarray(ref.doc_len))
    np.testing.assert_array_equal(slot_to_doc, ref.slot_to_doc)
    np.testing.assert_array_equal(df, ref.df)
    assert port.avgdl == ref.avgdl and port.n_docs == ref.n_docs
    assert port.post_docs.dtype == torch.int32 and port.post_docs.device == CPU


@pytest.mark.parametrize("query", [
    "graph vector", "tpu index latency", "score", "missing-term",
    "graph graph rank", " ".join(WORDS[:16]),
])
@pytest.mark.parametrize("k", [1, 10, 400])
def test_search_matches_reference(postings, query, k):
    _, ref, port = postings
    want = ref.search(tokenize(query), k)
    got = port.search(tokenize(query), k)
    assert got[0].tolist() == want[0].tolist()
    assert_within_ulp(got[1], want[1])


def test_bm25_scores_match_reference(postings):
    """The raw kernel output over every doc: scores within an ulp and
    the same slot order, ties to the lower slot on both sides."""
    import jax.numpy as jnp

    _, ref, port = postings
    rng = np.random.default_rng(5)
    for _ in range(8):
        tokens = list(rng.choice(WORDS, int(rng.integers(1, 12))))
        terms, idf = J._prepare_terms(ref.vocab, ref.df, ref.n_docs, tokens)
        w_s, w_i = J.bm25_scores(
            ref.post_docs, ref.post_tf, ref.doc_len, jnp.float32(ref.avgdl),
            jnp.asarray(terms), jnp.asarray(idf), k=400)
        g_s, g_i = T.bm25_scores(port.post_docs, port.post_tf, port.doc_len,
                                 port.avgdl, terms, idf, k=400)
        assert_within_ulp(g_s.numpy(), np.asarray(w_s))
        np.testing.assert_array_equal(g_i.numpy(), np.asarray(w_i))


def test_tie_membership_at_rank_k_matches_reference():
    """30 identical docs inserted in scrambled order (some churned to
    the dict's tail): every path returns the ten lowest ids."""
    ids = list(range(1, 31))
    np.random.default_rng(7).shuffle(ids)
    parts = (RefPartition(device_threshold=10**9),
             RefPartition(device_threshold=1),
             PortPartition(device_threshold=1, device=CPU))
    for part in parts:
        for doc_id in ids:
            part.add(doc_id, "alpha beta gamma")
        for doc_id in (3, 11, 27):
            part.remove(doc_id)
            part.add(doc_id, "alpha beta gamma")
    answers = [part.search("alpha", 10) for part in parts]
    for got_ids, _ in answers:
        assert got_ids.tolist() == list(range(1, 11))
    assert_within_ulp(answers[2][1], answers[1][1])
    assert parts[2]._device[1] is not None   # the port's device path served


def test_wide_and_unknown_queries(postings):
    _, ref, port = postings
    assert port.search(["graph"] * 17, 5) is None
    assert ref.search(["graph"] * 17, 5) is None
    ids, scores = port.search([f"zz{i}" for i in range(40)], 5)
    assert ids.size == 0 and scores.size == 0


def test_postings_cap_and_empty_index():
    host = host_index(corpus(60))
    assert T.DevicePostings.build(host.postings, host.doc_len,
                                  max_postings_cap=10, device=CPU) is None
    assert J.DevicePostings.build(host.postings, host.doc_len,
                                  max_postings_cap=10) is None
    assert T.DevicePostings.build({}, {}, device=CPU) is None


def test_partition_device_path_and_hysteresis():
    """The port's partition builds device postings at or above its
    threshold, on its device, and keeps the reference's rebuild
    hysteresis (stale versions serve from the host index)."""
    docs = corpus(80)
    ref = RefPartition(device_threshold=10**9)
    part = PortPartition(device_threshold=50, device=CPU)
    for doc_id, text in docs.items():
        part.add(doc_id, text)
        ref.add(doc_id, text)
    ids, scores = part.search("graph", 5)
    built = part._device
    assert built[0] == part.version and built[1].post_docs.device == CPU
    part.add(7777, "graph graph graph graph graph")
    ref.add(7777, "graph graph graph graph graph")
    ids, scores = part.search("graph", 5)
    want_ids, want_scores = ref.search("graph", 5)
    assert ids.tolist() == want_ids.tolist()   # host path, fresh data
    assert part._device is built                # no rebuild yet
    small = PortPartition(device_threshold=10**9, device=CPU)
    small.add(1, "graph")
    small.search("graph", 1)
    assert small._device is None               # below the threshold


def test_okapi_constants_in_lockstep():
    from helix_tpu_torch.engine import text as host_mod

    assert (T.K1, T.B, T.MAX_QUERY_TERMS) == (J.K1, J.B, J.MAX_QUERY_TERMS)
    assert (host_mod.K1, host_mod.B) == (T.K1, T.B)


def test_cuda_calls_count_only_cuda_tensors(postings):
    _, _, port = postings
    before = T.bm25_scores.cuda_calls
    port.search(["graph"], 3)
    assert T.bm25_scores.cuda_calls == before


# ------------------------------------------------------------ engine level


def text_writes(docs):
    return [{
        "request_type": "write", "query_name": "w", "query": {"queries": [{
            "Query": {"name": "w", "steps": [{"CreateIndex": {"spec": {
                "NodeText": {"label": "Doc", "property": "body",
                             "tenant_property": None}},
                "if_not_exists": True}}], "condition": None}}],
            "returns": []},
        "parameters": {}, "parameter_types": {}}, {
        "request_type": "write", "query_name": "ingest",
        "query": {"queries": [{"ForEach": {"param": "docs", "body": [
            {"Query": {"name": "d", "steps": [{"AddN": {
                "label": "Doc", "properties": [
                    ["i", {"Expr": {"Param": "docs.i"}}],
                    ["body", {"Expr": {"Param": "docs.body"}}]]}}],
                "condition": None}}]}}], "returns": []},
        "parameters": {"docs": [{"i": i, "body": text}
                                for i, text in docs.items()]},
        "parameter_types": {"docs": {"Array": "Object"}},
    }]


def text_read(query, k):
    return {"request_type": "read", "query_name": "t", "query": {
        "queries": [{"Query": {"name": "r", "steps": [
            {"TextSearchNodes": {"label": "Doc", "property": "body",
                                 "query_text": {"Expr": {"Param": "q"}},
                                 "k": {"Expr": {"Param": "k"}}}},
            {"ValueMap": ["$id", "$score", "i"]}], "condition": None}}],
        "returns": ["r"]},
        "parameters": {"q": query, "k": k},
        "parameter_types": {"q": "String", "k": "I64"}}


def test_engine_text_search_matches_reference(single_device):  # noqa: F811
    """The same writes into both engines; every partition's device
    threshold lowered to 1 so both serve from device postings (the
    reference pinned to one device: on its 8 virtual devices it would
    build the sharded postings)."""
    ref, port = RefEngine(), PortEngine(device="cpu")
    for request in text_writes(corpus(300, seed=8)):
        assert json.dumps(ref.execute(request)) == \
            json.dumps(port.execute(request))
    for engine in (ref, port):
        for part in engine.texts.indexes[("NodeText", "Doc", "body")] \
                .partitions.values():
            part.device_threshold = 1
    for query, k in (("graph vector", 10), ("mesh shard rank", 25),
                     ("node", 300), ("nothing here", 5)):
        a = ref.execute(text_read(query, k))["r"]
        b = port.execute(text_read(query, k))["r"]
        assert [h["$id"] for h in b] == [h["$id"] for h in a]
        assert [h["i"] for h in b] == [h["i"] for h in a]
        assert_within_ulp([h["$score"] for h in b], [h["$score"] for h in a])
    part = port.texts.indexes[("NodeText", "Doc", "body")].partitions[("",)]
    assert isinstance(part._device[1], T.DevicePostings)
