"""Engine-level parity: the same write batches replayed into
``helix_tpu.engine.Engine`` and ``helix_tpu_torch.engine.Engine(device=
"cpu")`` must answer the same read requests.

State carries across as the same logical write requests (what the WAL
records).  Two data sets:

- integer vectors whose squared norm is exactly 2^20 (dim 64, padded
  to 128): normalisation divides by a power of two and every dot
  product is an exact f32 value whatever the summation order, so the
  two engines' answers are equal byte for byte as JSON, ``$distance``
  included (the seeds have no exact tie among the hits, whose order
  the reference's ``approx_max_k`` leaves to its implementation);
- ``bench.py``'s clustered Gaussian vectors: the f32 re-rank sums in
  another order than XLA's, so ``$distance`` may differ in the last bits;
  the seed shows no f32 near-tie, so ids are equal and distances agree
  within 1e-6.
"""

import functools
import json

import numpy as np
import pytest
import torch

from helix_tpu.engine import Engine as RefEngine
from helix_tpu.engine.errors import QueryError as RefQueryError
from helix_tpu_torch.engine import Engine as PortEngine
from helix_tpu_torch.engine.errors import QueryError as PortQueryError

torch.set_num_threads(2)

DIM = 64
N_ROWS = 6000
NORM = 1024


@functools.lru_cache(maxsize=1)
def _two_squares(limit):
    table = {}
    top = int(limit ** 0.5)
    for c in range(top + 1):
        for d in range(c, top + 1):
            if c * c + d * d > limit:
                break
            table.setdefault(c * c + d * d, (c, d))
    return table


def exact_vectors(n, seed):
    """Clustered integer vectors with |v|^2 == NORM^2 == 2^20: 60 drawn
    coordinates plus a four-square completion (Lagrange).  Normalising
    divides by 2^10 exactly, and by Cauchy-Schwarz every partial sum of a
    dot product is an integer multiple of 2^-20 of magnitude <= 1, so
    f32 holds it exactly in any summation order."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-150, 151, size=(40, DIM - 4))
    rows = centers[rng.integers(0, 40, size=n)] \
        + rng.integers(-30, 31, size=(n, DIM - 4))
    out = np.zeros((n, DIM), np.int64)
    out[:, : DIM - 4] = rows
    signs = rng.choice([-1, 1], size=(n, 4))
    two = _two_squares(NORM * NORM)
    for i, rest in enumerate(NORM * NORM - (rows ** 2).sum(axis=1)):
        found = None
        for a in range(NORM + 1):
            for b in range(a, NORM + 1):
                left = rest - a * a - b * b
                if left < 0:
                    break
                if left in two:
                    found = (a, b) + two[left]
                    break
            if found:
                break
        out[i, DIM - 4:] = np.asarray(found) * signs[i]
    assert np.all((out ** 2).sum(axis=1) == NORM * NORM)
    return out.astype(np.float32)


def gaussian_vectors(n, seed):
    """``bench.py``'s clustered cosine generator at test size."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(100, DIM)).astype(np.float32)
    data = centers[rng.integers(0, 100, size=n)] \
        + 0.3 * rng.normal(size=(n, DIM)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True) + 1e-9
    return data


def write(steps, params=None, types=None):
    return {
        "request_type": "write", "query_name": "w",
        "query": {"queries": [{"Query": {"name": "w", "steps": steps,
                                         "condition": None}}],
                  "returns": []},
        "parameters": params or {}, "parameter_types": types or {},
    }


def create_index(tenant=None):
    return write([{"CreateIndex": {"spec": {"NodeVector": {
        "label": "Doc", "property": "emb", "tenant_property": tenant,
    }}, "if_not_exists": True}}])


def ingest(first, rows, tenants=None):
    docs = [{"i": first + j, "emb": row} for j, row in enumerate(rows.tolist())]
    props = [["i", {"Expr": {"Param": "docs.i"}}],
             ["emb", {"Expr": {"Param": "docs.emb"}}]]
    if tenants is not None:
        for doc, t in zip(docs, tenants):
            doc["t"] = t
        props.append(["t", {"Expr": {"Param": "docs.t"}}])
    return {
        "request_type": "write", "query_name": "ingest",
        "query": {"queries": [{"ForEach": {"param": "docs", "body": [
            {"Query": {"name": "dd", "steps": [{"AddN": {
                "label": "Doc", "properties": props}}],
                "condition": None}}]}}], "returns": []},
        "parameters": {"docs": docs},
        "parameter_types": {"docs": {"Array": "Object"}},
    }


def drop(ids):
    return write([{"N": {"Param": "ids"}}, "Drop"], {"ids": ids},
                 {"ids": {"Array": "I64"}})


def search_steps(tenant=False):
    body = {"label": "Doc", "property": "emb",
            "query_vector": {"Expr": {"Param": "q"}},
            "k": {"Expr": {"Param": "k"}}}
    if tenant:
        body["tenant_value"] = {"Expr": {"Param": "t"}}
    return [{"VectorSearchNodes": body},
            {"ValueMap": ["$id", "$distance", "i"]}]


def search(q, k, tenant=None, with_tenant=False):
    params = {"q": q.tolist(), "k": k}
    types = {"q": {"Array": "F32"}, "k": "I64"}
    if with_tenant:
        params["t"] = tenant
        types["t"] = "String"
    return {
        "request_type": "read", "query_name": "vs",
        "query": {"queries": [{"Query": {
            "name": "hits", "steps": search_steps(with_tenant),
            "condition": None}}], "returns": ["hits"]},
        "parameters": params, "parameter_types": types,
    }


BUNDLE = {
    "version": 5,
    "read_routes": {"vsearch": {"queries": [{"Query": {
        "name": "hits", "steps": search_steps(), "condition": None}}],
        "returns": ["hits"]}},
    "read_parameters": {"vsearch": [
        {"name": "q", "ty": {"Array": "F32"}}, {"name": "k", "ty": "I64"},
    ]},
    "write_routes": {}, "write_parameters": {},
}


def replay(requests):
    ref, port = RefEngine(), PortEngine(device="cpu")
    for request in requests:
        a, b = ref.execute(request), port.execute(request)
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    return ref, port


def corpus_writes(data):
    half = len(data) // 2
    return [create_index(), ingest(0, data[:half]),
            ingest(half, data[half:])]


def test_engines_answer_byte_equal_on_exact_data():
    data = exact_vectors(N_ROWS, seed=0)
    queries = exact_vectors(12, seed=1)
    ref, port = replay(corpus_writes(data))
    first = ref.execute(search(queries[0], 10))["hits"]
    dead = [hit["$id"] for hit in first[:3]] + [7, 4000]
    replay_into = [drop(dead)]
    for request in replay_into:
        assert json.dumps(ref.execute(request)) == \
            json.dumps(port.execute(request))
    ref.load_bundle(BUNDLE)
    port.load_bundle(BUNDLE)
    answers = 0
    for j, q in enumerate(queries):
        for k in (10, 37):
            a = json.dumps(ref.execute(search(q, k)))
            b = json.dumps(port.execute(search(q, k)))
            dists = [h["$distance"] for h in json.loads(a)["hits"]]
            # An exact tie would be ordered by the reference's approx_max_k
            # candidate order, which is not tie-stable: this seed has none.
            assert len(set(dists)) == len(dists), f"seed has a tie: {j}, {k}"
            assert a == b, (j, k)
            answers += len(dists)
        a = json.dumps(ref.execute_stored("vsearch", {"q": q.tolist(), "k": 10}))
        b = json.dumps(port.execute_stored("vsearch", {"q": q.tolist(), "k": 10}))
        assert a == b, j
        assert not set(dead) & {h["$id"] for h in json.loads(b)["hits"]}
    assert answers == 12 * (10 + 37)


def test_engines_agree_on_gaussian_data():
    data = gaussian_vectors(N_ROWS, seed=2)
    queries = gaussian_vectors(8, seed=3)
    ref, port = replay(corpus_writes(data) + [drop([3, 33, 333])])
    for q in queries:
        a = ref.execute(search(q, 10))["hits"]
        b = port.execute(search(q, 10))["hits"]
        assert [h["$id"] for h in a] == [h["$id"] for h in b]
        assert [h["i"] for h in a] == [h["i"] for h in b]
        for ha, hb in zip(a, b):
            assert abs(ha["$distance"] - hb["$distance"]) <= 1e-6


def test_multitenant_index_errors_and_empty_results_match():
    data = gaussian_vectors(300, seed=4)
    tenants = ["a" if i % 3 else "b" for i in range(300)]
    ref, port = replay([create_index(tenant="t"), ingest(0, data, tenants)])
    q = data[5]
    # missing tenant_value: a query error on both, same message
    with pytest.raises(RefQueryError) as ea:
        ref.execute(search(q, 5))
    with pytest.raises(PortQueryError) as eb:
        port.execute(search(q, 5))
    assert str(ea.value) == str(eb.value)
    assert "multitenant" in str(eb.value)
    # unknown tenant: empty result on both
    for tenant, k in (("zz", 5), ("a", 5), ("b", 7)):
        a = ref.execute(search(q, k, tenant, with_tenant=True))
        b = port.execute(search(q, k, tenant, with_tenant=True))
        assert [h["$id"] for h in a["hits"]] == [h["$id"] for h in b["hits"]]
        assert (len(b["hits"]) == 0) == (tenant == "zz")
    # a write missing the tenant property fails on both
    bad = ingest(300, data[:2])
    with pytest.raises(Exception) as ea:
        ref.execute(bad)
    with pytest.raises(Exception) as eb:
        port.execute(bad)
    assert type(ea.value).__name__ == type(eb.value).__name__
    assert str(ea.value) == str(eb.value)


@pytest.mark.parametrize("knob,value", [
    ("data_dir", "data"),
    ("snapshot_store", "bucket"),
    ("hbm_budget_bytes", 1 << 30),
    ("quant_candidates", 64),
    ("shard_threshold", 1000),
    ("graph_shard_threshold", 1000),
])
def test_port_engine_refuses_unported_knobs(knob, value, tmp_path):
    """Every knob is ported: the residency ladder's two and the mesh's
    ``shard_threshold`` reach the vector manager (and its partitions),
    ``graph_shard_threshold`` the executor (through its engine), and
    the persistence slice's two open the data dir and its object-store
    mirror."""
    if knob in ("hbm_budget_bytes", "quant_candidates", "shard_threshold"):
        engine = PortEngine(device="cpu", **{knob: value})
        assert getattr(engine.vectors, knob) == value
        engine.execute(create_index())
        index = engine.vectors.indexes[("NodeVector", "Doc", "emb")]
        assert getattr(index, knob) == value
        assert getattr(index.partition_for(("",)), knob) == value
        return
    if knob == "graph_shard_threshold":
        from helix_tpu_torch.engine.exec import Executor

        engine = PortEngine(device="cpu", **{knob: value})
        assert Executor(engine).engine.graph_shard_threshold == value
        return
    if knob in ("data_dir", "snapshot_store"):
        store = f"file://{tmp_path / value}" if knob == "snapshot_store" \
            else None
        engine = PortEngine(device="cpu", data_dir=str(tmp_path / "data"),
                            snapshot_store=store)
        engine.checkpoint()
        assert (tmp_path / "data" / "snapshot.bin").exists()
        assert (store is None) == (engine.persistence.snapshot_store is None)
        assert store is None or (tmp_path / value / "snapshot.bin").exists()
        engine.close()
        return


def test_port_engine_needs_cuda_for_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PortEngine()
    assert PortEngine(device="cpu").device == torch.device("cpu")


def _node(x):
    return {"NWhere": {"Eq": ["x", {"I64": x}]}}


def test_port_engine_traversal_uses_the_native_sweep(monkeypatch):
    """Set-reduced traversals go through the traversal router, which
    samples both backends: on an engine whose device is not CUDA it tries
    the native C++ sweep first (twice: the first run is its warm-up),
    then the device path on the engine's device (here the CPU).  The
    size floor of the traversal planner is lowered so a small graph
    takes that route.  The process seeing a card changes none of it."""
    from helix_tpu.engine.exec import Executor as RefExecutor
    from helix_tpu_torch.engine.exec import Executor as PortExecutor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(RefExecutor, "device_traversal_min_nodes", 0)
    monkeypatch.setattr(PortExecutor, "device_traversal_min_nodes", 0)
    requests = [
        write([{"AddN": {"label": "P", "properties": [
            ["x", {"Value": {"I64": x}}]]}}])
        for x in range(6)
    ]
    for src, dst in ((0, 1), (0, 2), (1, 3), (2, 3), (3, 4)):
        requests.append({
            "request_type": "write", "query_name": "e",
            "query": {"queries": [
                {"Query": {"name": "s", "steps": [_node(src)],
                           "condition": None}},
                {"Query": {"name": "t", "steps": [_node(dst)],
                           "condition": None}},
                {"Query": {"name": "e", "steps": [
                    {"Inject": "s"},
                    {"AddE": {"label": "rel", "to": {"Var": "t"},
                              "properties": []}}], "condition": None}},
            ], "returns": []},
            "parameters": {}, "parameter_types": {}})
    ref, port = replay(requests)
    for hops in (1, 2, 3):
        read = {"request_type": "read", "query_name": "r", "query": {
            "queries": [{"Query": {"name": "r", "steps": (
                [_node(0)] + [{"Out": "rel"}] * hops + ["Dedup", "Count"]),
                "condition": None}}], "returns": ["r"]},
            "parameters": {}, "parameter_types": {}}
        a, b = ref.execute(read), port.execute(read)
        assert json.dumps(a) == json.dumps(b)
        assert b["r"] == {1: 2, 2: 1, 3: 1}[hops]
    assert not port._traversal_router.device_first
    assert port._traversal_router.runs == {"native": 2, "device": 1}
    graph = port.snapshots.get().padded_graph("out")
    assert graph.device == torch.device("cpu") and graph.n == 6


@pytest.mark.parametrize("device_first,order", [
    (True, ["device", "device", "native", "native"]),
    (False, ["native", "native", "device", "device"]),
])
def test_traversal_router_bootstrap_follows_the_engine_device(
        device_first, order, monkeypatch):
    """The router samples device first only when told so, which the
    engine does for a CUDA device, whatever cards the process sees."""
    from helix_tpu_torch.engine.exec import TraversalRouter

    monkeypatch.delenv("HELIX_TRAVERSAL_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    router = TraversalRouter(device_first=device_first)
    seen = []
    for _ in range(4):
        path = router.choose(device_available=True, native_available=True)
        router.record(path, 1e-3)
        seen.append(path)
    assert seen == order
