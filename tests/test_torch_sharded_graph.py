"""The port's sharded graph (``helix_tpu_torch.parallel.ShardedGraph``)
and the engine's mesh traversal paths against the JAX reference on the
CPU.

The reference runs on its 8 virtual CPU devices (``tests/conftest.py``),
the port on a virtual mesh of 8 CPU devices; both get the same numpy
graphs and the same write batches.  Masks, counts and ordered expansions
are integer results: equal, and equal to a numpy BFS or the CSR order.
Engine answers are equal byte for byte as JSON, to the reference's
sharded engine and to the port's own one-device engine.
"""

import json

import numpy as np
import pytest
import torch

from helix_tpu.dsl import Predicate, SourcePredicate, g, read_batch, \
    write_batch
from helix_tpu.engine import Engine as RefEngine
from helix_tpu.engine.exec import Executor as RefExecutor
from helix_tpu.parallel import ShardedGraph as RefGraph
from helix_tpu.parallel import make_mesh as ref_mesh
from helix_tpu_torch.engine import Engine as PortEngine
from helix_tpu_torch.engine.exec import Executor as PortExecutor
from helix_tpu_torch.ops.csr import PaddedGraph
from helix_tpu_torch.parallel import ShardedGraph, make_mesh, \
    virtual_devices
from helix_tpu_torch.parallel import graph as graph_mod

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture
def mesh8():
    with virtual_devices("cpu", 8):
        yield make_mesh(device=CPU)


def random_graph(rng, n, deg, n_labels=4):
    dst = rng.integers(0, n, size=n * deg).astype(np.int32)
    lab = rng.integers(0, n_labels, size=n * deg).astype(np.int32)
    indptr = np.arange(n + 1, dtype=np.int64) * deg
    return indptr, dst, lab


def reverse(indptr, dst, lab, n):
    order = np.argsort(dst, kind="stable")
    rev_dst = np.repeat(np.arange(n), np.diff(indptr))[order].astype(np.int32)
    counts = np.bincount(dst, minlength=n)
    rev_indptr = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    return rev_indptr, rev_dst, lab[order]


def oracle_hop(n, indptr, dst, lab, mask, code):
    out = np.zeros(n, bool)
    for u in np.nonzero(mask)[0]:
        for e in range(indptr[u], indptr[u + 1]):
            if code < 0 or lab[e] == code:
                out[dst[e]] = True
    return out


def graphs(n, directions, mesh):
    return (RefGraph(ref_mesh(), n, directions),
            ShardedGraph(mesh, n, directions))


@pytest.mark.parametrize("n", [999, 1000, 1024, 130])
def test_khop_count_matches_reference_and_bfs(mesh8, n):
    rng = np.random.default_rng(n)
    indptr, dst, lab = random_graph(rng, n, deg=5)
    host = PaddedGraph.host_arrays(indptr, dst, lab, n)
    ref, port = graphs(n, {"out": host}, mesh8)
    assert port.n_pad == ref.n_pad
    start = rng.random(n) < 0.02
    keep = rng.random(n) < 0.5
    for code in (-1, 2, 99):
        expect = start
        for _ in range(2):
            expect = oracle_hop(n, indptr, dst, lab, expect, code)
        got = port.khop_count("out", start, code, hops=2, keep_mask=keep)
        assert got == int((expect & keep).sum())
        assert got == ref.khop_count("out", start, code, hops=2,
                                     keep_mask=keep)
    assert port.khop_count("out", np.zeros(n, bool), -1, 2) == 0


def test_mixed_plan_masks_match_reference(mesh8):
    """out-hop, filter, Both-hop: the engine planner's shape."""
    rng = np.random.default_rng(7)
    n = 777
    fwd = random_graph(rng, n, deg=4)
    rev = reverse(*fwd, n)
    dirs = {"out": PaddedGraph.host_arrays(*fwd, n),
            "in": PaddedGraph.host_arrays(*rev, n)}
    ref, port = graphs(n, dirs, mesh8)
    start = rng.random(n) < 0.03
    filt = rng.random(n) < 0.6
    plan = [("hop", ("out",)), ("mask", 0), ("hop", ("out", "in"))]
    got = port.run(plan, start, codes=[1, -1], masks=[filt])
    np.testing.assert_array_equal(
        got, ref.run(plan, start, codes=[1, -1], masks=[filt]))
    expect = oracle_hop(n, *fwd, start, 1) & filt
    np.testing.assert_array_equal(
        got, oracle_hop(n, *fwd, expect, -1) | oracle_hop(n, *rev, expect, -1))


def test_missing_codes_and_masks_raise(mesh8):
    n = 64
    rng = np.random.default_rng(5)
    port = ShardedGraph(mesh8, n, {"out": PaddedGraph.host_arrays(
        *random_graph(rng, n, 4), n)})
    start = np.zeros(n, bool)
    start[0] = True
    with pytest.raises(ValueError, match="label codes"):
        port.run([("hop", ("out",))], start, codes=[], masks=[])
    with pytest.raises(ValueError, match="no masks"):
        port.run([("mask", 0)], start, codes=[], masks=[])


def test_expand_frame_order_and_multiplicity(mesh8):
    rng = np.random.default_rng(3)
    n, deg = 257, 5
    indptr, dst, lab = random_graph(rng, n, deg, n_labels=3)
    eorder = rng.permutation(n * deg).astype(np.int32)
    host = PaddedGraph.host_arrays(indptr, dst, lab, n, edge_order=eorder)
    ref, port = graphs(n, {"out": host}, mesh8)
    frame = np.array([5, 5, 200, 3, 256, 5], np.int32)   # duplicated rows
    for code in (-1, 0, 2):
        parent, targets = port.expand_frame("out", code, frame)
        r_parent, r_targets = ref.expand_frame("out", code, frame)
        assert parent.tolist() == r_parent.tolist()
        assert targets.tolist() == r_targets.tolist()
        parent_e, eslots, targets_e = port.expand_frame_edges(
            "out", code, frame)
        for got, want in zip((parent_e, eslots, targets_e),
                             ref.expand_frame_edges("out", code, frame)):
            assert got.tolist() == np.asarray(want).tolist()
        wp, we, wt = [], [], []
        for row, v in enumerate(frame):
            for e in range(indptr[v], indptr[v + 1]):
                if code < 0 or lab[e] == code:
                    wp.append(row)
                    we.append(eorder[e])
                    wt.append(dst[e])
        assert parent.tolist() == wp and targets.tolist() == wt
        assert parent_e.tolist() == wp and eslots.tolist() == we
        assert targets_e.tolist() == wt
    empty = port.expand_frame("out", -1, np.empty(0, np.int32))
    assert all(len(a) == 0 for a in empty)


def test_expand_frame_edges_requires_edge_plane(mesh8):
    n = 16
    indptr = np.arange(n + 1, dtype=np.int64)
    host = PaddedGraph.host_arrays(indptr, np.arange(n, dtype=np.int32),
                                   np.zeros(n, np.int32), n)
    port = ShardedGraph(mesh8, n, {"out": host})
    with pytest.raises(KeyError):
        port.expand_frame_edges("out", -1, np.array([1], np.int32))


# ---- the engine's mesh traversal paths ----------------------------------


def _run(engine, batch, kind="read"):
    return engine.execute({"request_type": kind, "query_name": None,
                           "query": batch.encode(), "parameters": {}})


def _build(engine, n_nodes=300, n_edges=900, seed=11, dim=8):
    rng = np.random.default_rng(seed)
    wb = write_batch().var_as("ix", g().create_vector_index_nodes("Doc", "emb"))
    for i in range(n_nodes):
        wb = wb.var_as(f"n{i}", g().add_n("Doc", {
            "i": int(i), "emb": [float(x) for x in rng.normal(size=dim)]}))
    _run(engine, wb, "write")
    ids = _run(engine, read_batch().var_as(
        "u", g().n_with_label("Doc").id()).returning(["u"]))["u"]
    eb = write_batch()
    for j in range(n_edges):
        a, b = rng.integers(0, n_nodes, 2)
        eb = eb.var_as(f"e{j}", g().n({"Ids": [ids[a]]}).add_e(
            ["REL", "ALT"][j % 2], {"Ids": [ids[b]]}))
    _run(engine, eb, "write")


@pytest.fixture
def engines(mesh8):
    """(reference sharded, port sharded, port one-device) engines over the
    same writes; the port's two share the virtual mesh, and the
    one-device engine has no graph_shard_threshold."""
    out = (RefEngine(graph_shard_threshold=1),
           PortEngine(device="cpu", graph_shard_threshold=1),
           PortEngine(device="cpu"))
    for eng in out:
        _build(eng, seed=31)
    return out


QUERIES = {
    "out value_map": lambda: g().n_with_label("Doc").out("REL").value_map(),
    "two hops + filter": lambda: g().n_with_label("Doc").out("REL")
    .out("ALT").where_(Predicate.lt("i", 150)).values(["i"]),
    "both": lambda: g().n_where(SourcePredicate.eq("$label", "Doc"))
    .both("REL").id(),
    "any label": lambda: g().n_with_label("Doc").out(None).count(),
    "dedup": lambda: g().n_with_label("Doc").out("REL").dedup().id(),
    "in": lambda: g().n_with_label("Doc").in_("ALT").values(["i"]),
    "out_e": lambda: g().n_with_label("Doc").out_e("REL").edge_properties(),
    "in_e": lambda: g().n_with_label("Doc").in_e(None).id(),
    "both_e": lambda: g().n_with_label("Doc").both_e("ALT").count(),
    "other_n": lambda: g().n_with_label("Doc").out_e("REL").other_n()
    .values(["i"]),
    "in_e filter": lambda: g().n_with_label("Doc").in_e("ALT").other_n()
    .where_(Predicate.lt("i", 100)).id(),
    "hybrid": lambda: g().vector_search_nodes(
        "Doc", "emb", [0.3, -1.0, 0.5, 0.2, 0.0, 1.1, -0.4, 0.9], 5)
    .out("REL").value_map(),
}


@pytest.mark.parametrize("name", QUERIES)
def test_sharded_hops_match_reference_byte_for_byte(engines, monkeypatch,
                                                    name):
    ref, port, single = engines
    calls = []
    for method in ("expand_frame", "expand_frame_edges"):
        original = getattr(graph_mod.ShardedGraph, method)

        def spy(self, *a, _original=original, **kw):
            calls.append(1)
            return _original(self, *a, **kw)

        monkeypatch.setattr(graph_mod.ShardedGraph, method, spy)
    q = read_batch().var_as("r", QUERIES[name]()).returning(["r"])
    want = json.dumps(_run(ref, q), sort_keys=True)
    got = _run(port, q)
    assert json.dumps(got, sort_keys=True) == want
    assert json.dumps(_run(single, q), sort_keys=True) == want
    assert got["r"] not in ([], 0)   # non-vacuous
    assert calls, "the port's sharded hop never ran"


def khop(hops, label, where=None):
    t = g().n_where(SourcePredicate.lt("i", 8))
    for _ in range(hops):
        t = t.out(label)
    if where is not None:
        t = t.where(where)
    return read_batch().var_as("n", t.dedup().count()).returning(["n"])


def test_engine_routes_to_sharded_traversal(engines, monkeypatch):
    """Set-reduced traversals take the sharded plan executor past the
    planner's size floor and answer as the reference's mesh and the
    port's one-device engine do."""
    ref, port, single = engines
    for cls in (RefExecutor, PortExecutor):
        monkeypatch.setattr(cls, "device_traversal_min_nodes", 1)
    runs = []
    original = graph_mod.ShardedGraph.run

    def spy(self, *a, **kw):
        out = original(self, *a, **kw)
        runs.append(len(out))
        return out

    monkeypatch.setattr(graph_mod.ShardedGraph, "run", spy)
    requests = [khop(1, "REL"), khop(2, "REL"),
                khop(2, None, Predicate.gt("i", 50)),
                read_batch().var_as("page", g().n_where(
                    SourcePredicate.lt("i", 6)).out("REL").out("ALT").dedup()
                    .order_by("i", "Desc").limit(7).values(["i"]))
                .returning(["page"])]
    for q in requests:
        want = _run(ref, q)
        assert _run(port, q) == want
        assert _run(single, q) == want
    assert len(runs) == len(requests)


def test_one_device_mesh_takes_the_single_device_paths(monkeypatch):
    """graph_shard_threshold set but a one-device mesh: no sharded run."""
    monkeypatch.setattr(PortExecutor, "device_traversal_min_nodes", 1)
    monkeypatch.setattr(graph_mod.ShardedGraph, "__init__", None)
    eng = PortEngine(device="cpu", graph_shard_threshold=1)
    _build(eng, n_nodes=60, n_edges=150)
    assert _run(eng, khop(2, "REL"))["n"] >= 0
    assert _run(eng, read_batch().var_as("r", g().n_with_label("Doc").out(
        "REL").id()).returning(["r"]))["r"]
