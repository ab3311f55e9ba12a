"""Device traversal: the port's ``ops/csr.py`` against the JAX reference's
on the same graphs, and the port's engine against the reference engine
on the same write batches with the device path forced.

Masks are sets of node slots, so every comparison is exact: masks equal,
counts equal, engine answers equal byte for byte as JSON.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helix_tpu.ops.csr as J
import helix_tpu_torch.ops.csr as T
from helix_tpu.engine import Engine as RefEngine
from helix_tpu.engine.exec import Executor as RefExecutor
from helix_tpu_torch.engine import Engine as PortEngine
from helix_tpu_torch.engine.exec import Executor as PortExecutor

from tests.test_torch_engine import exact_vectors

torch.set_num_threads(2)
CPU = torch.device("cpu")


def random_csr(n, avg_deg, n_labels, seed):
    """CSR arrays of a random multigraph (Poisson out-degrees)."""
    rng = np.random.default_rng(seed)
    degrees = rng.poisson(avg_deg, size=n)
    indptr = np.concatenate(([0], np.cumsum(degrees))).astype(np.int64)
    dst = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    lab = rng.integers(0, n_labels, size=int(indptr[-1])).astype(np.int32)
    return indptr, dst, lab


def both(indptr, dst, lab, n):
    ref = J.PaddedGraph.from_csr(indptr, dst, lab, n)
    port = T.PaddedGraph.from_csr(indptr, dst, lab, n, device=CPU)
    return ref, port


@pytest.fixture(scope="module")
def small():
    n = 500
    indptr, dst, lab = random_csr(n, 6, 3, seed=7)
    return (n, indptr, dst, lab) + both(indptr, dst, lab, n)


def test_host_arrays_match_reference(small):
    n, indptr, dst, lab, _, _ = small
    order = np.random.default_rng(1).permutation(len(dst)).astype(np.int32)
    for extra in ({}, {"edge_order": order}, {"max_degree_cap": 4}):
        want = J.PaddedGraph.host_arrays(indptr, dst, lab, n, **extra)
        got = T.PaddedGraph.host_arrays(indptr, dst, lab, n, **extra)
        if want is None:
            assert got is None
            continue
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_padded_graph_lives_on_its_device_as_int32(small):
    _, _, _, _, ref, port = small
    assert port.neighbors.dtype == port.edge_labels.dtype == torch.int32
    assert port.neighbors.device == CPU and (port.n, port.p) == (ref.n, ref.p)
    np.testing.assert_array_equal(port.neighbors.numpy(),
                                  np.asarray(ref.neighbors))


@pytest.mark.parametrize("hops", [0, 1, 2, 3])
@pytest.mark.parametrize("code", [-1, 1, 7])
def test_khop_mask_matches_reference(small, hops, code):
    n, _, _, _, ref, port = small
    start = np.zeros(n, bool)
    start[[0, 17, 123]] = True
    want = np.asarray(J.khop_mask(ref.neighbors, ref.edge_labels,
                                  jnp.asarray(start), jnp.int32(code), hops))
    got = T.khop_mask(port.neighbors, port.edge_labels,
                      torch.from_numpy(start), code, hops)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_khop_count_matches_reference(small):
    n, _, _, _, ref, port = small
    rng = np.random.default_rng(3)
    keep = rng.random(n) < 0.5
    for trial in range(4):
        start = rng.random(n) < 0.02
        want = int(J.khop_count(ref.neighbors, ref.edge_labels,
                                jnp.asarray(start), jnp.int32(trial % 3 - 1),
                                2, jnp.asarray(keep)))
        got = T.khop_count(port.neighbors, port.edge_labels,
                           torch.from_numpy(start), trial % 3 - 1, 2,
                           torch.from_numpy(keep))
        assert int(got) == want, trial


def test_hybrid_expand_matches_reference(small):
    n, _, _, _, ref, port = small
    seeds = np.pad(np.array([5, 9, 300, 9], np.int32), (0, 6),
                   constant_values=n)
    keep = np.random.default_rng(4).random(n) < 0.7
    for code, hops in ((-1, 1), (2, 2)):
        w_mask, w_count = J.hybrid_expand(
            ref.neighbors, ref.edge_labels, jnp.asarray(seeds),
            jnp.int32(code), hops, jnp.asarray(keep))
        g_mask, g_count = T.hybrid_expand(
            port.neighbors, port.edge_labels, torch.from_numpy(seeds),
            code, hops, torch.from_numpy(keep))
        np.testing.assert_array_equal(g_mask.numpy(), np.asarray(w_mask))
        assert int(g_count) == int(w_count)


def test_degree_cap_returns_none():
    indptr = np.array([0, 300])
    dst = np.zeros(300, np.int32)
    lab = np.zeros(300, np.int32)
    assert T.PaddedGraph.from_csr(indptr, dst, lab, 1, max_degree_cap=256,
                                  device=CPU) is None


def test_adaptive_hop_tiers_match_reference(monkeypatch):
    """Frontiers in each tier of the adaptive hop (compact 4096, compact
    65536, dense) at a size where all three exist (n > 65536): every
    hop's mask equals the reference's, and each tier served a hop."""
    n, deg = 80_000, 3
    rng = np.random.default_rng(12)
    dst = rng.integers(0, n, size=n * deg).astype(np.int32)
    lab = rng.integers(0, 3, size=n * deg).astype(np.int32)
    indptr = np.arange(n + 1, dtype=np.int64) * deg
    ref, port = both(indptr, dst, lab, n)
    monkeypatch.setattr(T, "TIER_HOPS", {4096: 0, 65536: 0, "dense": 0})
    cases = [(rng.random(n) < frac, code, hops) for frac, code, hops in (
        (0.005, 1, 3),    # ~400 live, growing through the compact tiers
        (0.3, -1, 1),     # ~24,000 live: the 65536 tier
        (0.9, 0, 2),      # ~72,000 live: dense, then a compact tier
        (0.9, -1, 2),     # dense twice
    )]
    for start, code, hops in cases:
        want = np.asarray(J.khop_mask(ref.neighbors, ref.edge_labels,
                                      jnp.asarray(start), jnp.int32(code),
                                      hops))
        got = T.khop_mask(port.neighbors, port.edge_labels,
                          torch.from_numpy(start), code, hops)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"code={code} hops={hops}")
    assert all(T.TIER_HOPS[tier] > 0 for tier in (4096, 65536, "dense")), \
        T.TIER_HOPS


def test_new_graph_runs_one_hop_of_each_shape(monkeypatch):
    """Building a graph on the CPU runs no hop: only a CUDA device has
    kernels to load (the card test below covers that side), and the hop
    counters never see it."""
    monkeypatch.setattr(T, "TIER_HOPS", {4096: 0, 65536: 0, "dense": 0})
    hops = []
    real = T._adaptive_hop
    monkeypatch.setattr(T, "_adaptive_hop",
                        lambda *a, **k: hops.append(1) or real(*a, **k))
    indptr, dst, lab = random_csr(5000, 2, 3, seed=9)
    T.PaddedGraph.from_csr(indptr, dst, lab, 5000, device=CPU)
    assert not hops and T.TIER_HOPS == {4096: 0, 65536: 0, "dense": 0}


@pytest.mark.cuda
def test_first_graph_on_a_card_loads_the_hop_kernels_once(monkeypatch):
    """The first graph on a CUDA device with a compact tier below its size
    runs one hop per shape class (one live row, 32 rows, every row; with
    and without a label); a smaller graph before it and any graph after
    it run none, and neither counter sees them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels load only on the card")
    dev = torch.device("cuda", torch.cuda.current_device())
    monkeypatch.setattr(T, "_WARM_DEVICES", set())
    monkeypatch.setattr(T, "TIER_HOPS", {4096: 0, 65536: 0, "dense": 0})
    calls = T.khop_mask.cuda_calls
    hops = []
    real = T._adaptive_hop
    monkeypatch.setattr(T, "_adaptive_hop",
                        lambda *a, **k: hops.append(1) or real(*a, **k))
    for n, want in ((3000, 6), (5000, 12), (6000, 12)):
        indptr, dst, lab = random_csr(n, 2, 3, seed=9)
        T.PaddedGraph.from_csr(indptr, dst, lab, n, device=dev)
        assert len(hops) == want, n
    assert T._WARM_DEVICES == {dev}
    assert T.TIER_HOPS == {4096: 0, 65536: 0, "dense": 0}
    assert T.khop_mask.cuda_calls == calls


def test_cuda_calls_count_only_cuda_tensors(small):
    _, _, _, _, _, port = small
    before = T.khop_mask.cuda_calls
    T.khop_mask(port.neighbors, port.edge_labels,
                torch.zeros(port.n, dtype=torch.bool), -1, 2)
    assert T.khop_mask.cuda_calls == before


# ------------------------------------------------------------ engine level


def _where(prop, op, value):
    return {op: [prop, {"I64": value}]}


def read(steps, params=None, types=None):
    return {"request_type": "read", "query_name": "r", "query": {
        "queries": [{"Query": {"name": "r", "steps": steps,
                               "condition": None}}], "returns": ["r"]},
        "parameters": params or {}, "parameter_types": types or {}}


def graph_writes(n_nodes, n_edges, seed):
    """Doc nodes (``i``, a tie-free ``emb``) then labeled edges, as
    ForEach write batches: each item links one source to a list of
    targets under one of three labels."""
    rng = np.random.default_rng(seed)
    vecs = exact_vectors(n_nodes, seed=seed)
    writes = [{
        "request_type": "write", "query_name": "w", "query": {"queries": [{
            "Query": {"name": "w", "steps": [{"CreateIndex": {"spec": {
                "NodeVector": {"label": "Doc", "property": "emb",
                               "tenant_property": None}},
                "if_not_exists": True}}], "condition": None}}],
            "returns": []},
        "parameters": {}, "parameter_types": {}}]
    docs = [{"i": i, "emb": v} for i, v in enumerate(vecs.tolist())]
    writes.append({
        "request_type": "write", "query_name": "ingest",
        "query": {"queries": [{"ForEach": {"param": "docs", "body": [
            {"Query": {"name": "d", "steps": [{"AddN": {
                "label": "Doc", "properties": [
                    ["i", {"Expr": {"Param": "docs.i"}}],
                    ["emb", {"Expr": {"Param": "docs.emb"}}]]}}],
                "condition": None}}]}}], "returns": []},
        "parameters": {"docs": docs},
        "parameter_types": {"docs": {"Array": "Object"}},
    })
    src = rng.integers(0, n_nodes, size=n_edges)
    dst = rng.integers(0, n_nodes, size=n_edges)
    lab = rng.integers(0, 3, size=n_edges)
    for code in range(3):
        items = {}
        for s, d in zip(src[lab == code], dst[lab == code]):
            items.setdefault(int(s) + 1, []).append(int(d) + 1)
        writes.append({
            "request_type": "write", "query_name": "edges",
            "query": {"queries": [{"ForEach": {"param": "e", "body": [
                {"Query": {"name": "x", "steps": [
                    {"N": {"Param": "e.src"}},
                    {"AddE": {"label": f"L{code}",
                              "to": {"Param": "e.dst"},
                              "properties": []}}],
                    "condition": None}}]}}], "returns": []},
            "parameters": {"e": [{"src": s, "dst": d}
                                 for s, d in items.items()]},
            "parameter_types": {"e": {"Array": "Object"}},
        })
    return writes, vecs


TRAVERSALS = {
    "out2_count": [{"NWhere": _where("i", "Lt", 40)}, {"Out": "L1"},
                   {"Out": "L1"}, "Dedup", "Count"],
    "in_where_count": [{"NWhere": _where("i", "Lt", 60)}, {"In": None},
                       {"Where": _where("i", "Gt", 300)}, "Dedup", "Count"],
    "both2_exists": [{"N": {"Ids": [3, 5]}}, {"Both": "L2"}, {"Both": "L2"},
                     "Dedup", "Exists"],
    "out_unknown_label": [{"NWhere": _where("i", "Lt", 40)}, {"Out": "NOPE"},
                          "Dedup", "Count"],
    "order_tail": [{"NWhere": _where("i", "Lt", 20)}, {"Out": "L0"},
                   {"Out": None}, "Dedup", {"OrderBy": ["i", "Desc"]},
                   {"Limit": 25}, {"Values": ["i"]}],
}


def hybrid_steps():
    return [{"VectorSearchNodes": {"label": "Doc", "property": "emb",
                                   "query_vector": {"Expr": {"Param": "q"}},
                                   "k": {"Expr": {"Param": "k"}}}},
            {"Out": None}, {"Out": "L0"}, "Dedup", "Count"]


@pytest.fixture(scope="module")
def graph_engines():
    writes, vecs = graph_writes(1500, 4500, seed=21)
    ref, port = RefEngine(), PortEngine(device="cpu")
    for request in writes:
        ref.execute(request)
        port.execute(request)
    return ref, port, vecs


@pytest.mark.parametrize("backend", ["device", "native", "auto"])
@pytest.mark.parametrize("name", sorted(TRAVERSALS))
def test_engine_traversal_matches_reference(graph_engines, name, backend,
                                            monkeypatch):
    ref, port, _ = graph_engines
    monkeypatch.setattr(RefExecutor, "device_traversal_min_nodes", 0)
    monkeypatch.setattr(PortExecutor, "device_traversal_min_nodes", 0)
    monkeypatch.setenv("HELIX_TRAVERSAL_BACKEND", backend)
    before = dict(port._traversal_router.runs) \
        if hasattr(port, "_traversal_router") else {}
    request = read(TRAVERSALS[name])
    a, b = json.dumps(ref.execute(request)), json.dumps(port.execute(request))
    assert a == b
    if backend != "auto" and name != "out_unknown_label":
        runs = port._traversal_router.runs
        assert runs[backend] == before.get(backend, 0) + 1


@pytest.mark.parametrize("backend", ["device", "native"])
def test_engine_hybrid_matches_reference(graph_engines, backend, monkeypatch):
    """Vector seed, then expansion: ``VectorSearchNodes -> Out -> Out ->
    Dedup -> Count``, the hybrid shape, on the device path and the
    native sweep."""
    ref, port, vecs = graph_engines
    monkeypatch.setattr(RefExecutor, "device_traversal_min_nodes", 0)
    monkeypatch.setattr(PortExecutor, "device_traversal_min_nodes", 0)
    monkeypatch.setenv("HELIX_TRAVERSAL_BACKEND", backend)
    queries = exact_vectors(6, seed=99)
    counts = set()
    for j, q in enumerate(queries):
        request = read(hybrid_steps(), {"q": q.tolist(), "k": 5 + 7 * j},
                       {"q": {"Array": "F32"}, "k": "I64"})
        a = json.dumps(ref.execute(request))
        before = port._traversal_router.runs[backend] \
            if hasattr(port, "_traversal_router") else 0
        b = json.dumps(port.execute(request))
        assert a == b, j
        assert port._traversal_router.runs[backend] == before + 1
        counts.add(json.loads(b)["r"])
    assert len(counts) > 2 and 0 not in counts
