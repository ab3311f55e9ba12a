"""Entry points for a harness that compiles and checks the system (PyTorch
port of ``__graft_entry__.py``).

- :func:`entry` — the flagship compute path as one function and its
  example arguments: the chunked distance + running top-k search
  (``ops/distance.topk_scores``, the engine's VectorSearchNodes hot loop).
- :func:`dryrun_multichip` — builds an n-device mesh and runs one full
  sharded query step (row-sharded matrix + data-parallel queries + top-k
  merge), the sharded graph, text, int8 and k-means steps, and the
  engine's mesh paths against a one-device engine, on the reference's
  shapes, oracles and checks.

Both run on the card unless the caller passes ``device="cpu"``.  The
dry run sets a virtual mesh of ``n_devices`` over the devices of that
type (``parallel.virtual_devices``), the counterpart of the reference's
self-provisioned virtual CPU mesh: on one card every shard is ``cuda:0``.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def entry(device: str | torch.device = "cuda"):
    from .ops.distance import topk_scores

    device = torch.device(device)
    rng = np.random.default_rng(0)
    n, d, b, k = 2048, 128, 64, 10
    xs = rng.normal(size=(n, d)).astype(np.float32)
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    qs = rng.normal(size=(b, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    sq = np.sum(xs * xs, axis=1).astype(np.float32)

    def forward(xs, qs, n_valid, sq_norms):
        return topk_scores(
            xs, qs, n_valid, sq_norms, k=k, chunk=1024, metric="cosine"
        )

    example_args = (
        torch.from_numpy(xs).to(device),
        torch.from_numpy(qs).to(device),
        n,
        torch.from_numpy(sq).to(device),
    )
    return forward, example_args


def _request(kind: str, batch) -> dict:
    return {"request_type": kind, "query_name": None,
            "query": batch.encode(), "parameters": {}}


def dryrun_multichip(n_devices: int,
                     device: str | torch.device = "cuda") -> None:
    from .parallel import virtual_devices

    device = torch.device(device)
    with virtual_devices(device.type, n_devices):
        _dryrun(n_devices, device)


def _dryrun(n_devices: int, device: torch.device) -> None:
    from .parallel import (
        ShardedGraph, ShardedKMeans, ShardedVectorSearch, device_count,
        make_mesh,
    )

    # 2D mesh when possible: queries data-parallel x vectors row-sharded.
    data_axis = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
    mesh = make_mesh(n_devices, data=data_axis, device=device)

    # Shapes chosen to certify behavior, not just plumbing: row count is
    # RAGGED over the shard axis (65,521 is prime, so every shard split
    # pads), and k=32 exceeds a small shard's natural hit share.
    rng = np.random.default_rng(1)
    n, d, b, k = 65_521, 96, 64, 32
    xs_host = rng.normal(size=(n, d)).astype(np.float32)
    xs_host /= np.linalg.norm(xs_host, axis=1, keepdims=True)
    qs = xs_host[rng.integers(0, n, size=b)] + 0.05 * rng.normal(
        size=(b, d)
    ).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    sq = np.sum(xs_host * xs_host, axis=1).astype(np.float32)

    search = ShardedVectorSearch(mesh, k=k, chunk=2048, bf16=False)
    xs, sqd, n_valid = search.shard_arrays(xs_host, sq)
    dists, idx = search(xs, qs.astype(np.float32), n_valid, sqd)
    dists = dists.cpu().numpy()
    idx = idx.cpu().numpy()
    assert dists.shape == (b, k) and idx.shape == (b, k)
    assert np.all(np.diff(dists, axis=1) >= -1e-5)
    assert np.all((idx >= 0) & (idx < n))  # no padded-row leakage
    # Recall oracle: the sharded merge must reproduce brute force.
    sims = qs @ xs_host.T
    oracle = np.argsort(-sims, axis=1)[:, :k]
    recall = np.mean([
        len(set(idx[i]) & set(oracle[i])) / k for i in range(b)
    ])
    assert recall >= 0.99, f"sharded recall@{k} = {recall}"

    # Sharded GRAPH step: a 2-hop labeled traversal with a predicate mask
    # over an edge-partitioned adjacency, frontier exchanged per hop,
    # checked against a NumPy BFS oracle.  Node count ragged over the
    # shard axis.
    from .ops.csr import PaddedGraph

    gn, deg = 10_007, 6  # prime: every shard pads
    dst = rng.integers(0, gn, size=gn * deg).astype(np.int32)
    lab = rng.integers(0, 3, size=gn * deg).astype(np.int32)
    indptr = np.arange(gn + 1, dtype=np.int64) * deg
    nb, lb = PaddedGraph.host_arrays(indptr, dst, lab, gn)
    sgraph = ShardedGraph(mesh, gn, {"out": (nb, lb)})
    start = rng.random(gn) < 0.01
    keep = rng.random(gn) < 0.5
    got = sgraph.khop_count("out", start, 1, hops=2, keep_mask=keep)
    expect = start
    for _ in range(2):
        nxt = np.zeros(gn, bool)
        for u in np.nonzero(expect)[0]:
            sel = lab[indptr[u]:indptr[u + 1]] == 1
            nxt[dst[indptr[u]:indptr[u + 1]][sel]] = True
        expect = nxt
    assert got == int((expect & keep).sum()), (got, int((expect & keep).sum()))

    # Sharded TEXT step: doc-partitioned BM25 (global IDF/avgdl travel
    # with the query, per-shard Okapi scoring, top-k merge) against the
    # host inverted-index oracle.  Doc count prime, so the doc partition
    # is ragged over the shard axis.
    from .engine.text import TextPartition, tokenize
    from .ops.bm25 import ShardedBM25

    words = ("graph vector tpu mesh shard index query latency score "
             "edge node text").split()
    host_text = TextPartition(device_threshold=10**9, device=device)
    for doc_id in range(1, 524):  # 523 docs (prime)
        body = " ".join(rng.choice(words, size=int(rng.integers(3, 12))))
        host_text.add(doc_id, body)
    sh_bm25 = ShardedBM25.build(host_text.postings, host_text.doc_len, mesh)
    assert sh_bm25 is not None
    for query in ("graph vector latency", "mesh shard score"):
        h_ids, h_scores = host_text.search(query, 10)
        s_ids, s_scores = sh_bm25.search(tokenize(query), 10)
        assert np.allclose(sorted(h_scores), sorted(s_scores), rtol=1e-5), query
        h_map = dict(zip(h_ids.tolist(), h_scores.tolist()))
        s_map = dict(zip(s_ids.tolist(), s_scores.tolist()))
        for doc_id in set(h_map) & set(s_map):
            assert abs(h_map[doc_id] - s_map[doc_id]) < 1e-4

    # Quantized rung of the residency ladder at mesh scale: int8 rows
    # shard across the same mesh; the true top-k must survive the
    # coarse merge (exact f32 re-rank recovers exact order in serving).
    from .ops.quant import ShardedInt8Search, quantize_rows

    values, scales = quantize_rows(xs_host)
    qsearch = ShardedInt8Search(mesh, k=4 * k)
    xs_q, sc_q, sq_q, nv = qsearch.shard_arrays(values, scales, sq)
    _, cand = qsearch(xs_q, sc_q, sq_q, qs, nv)
    cand = cand.cpu().numpy()
    containment = np.mean([
        len(set(oracle[i]) & set(cand[i])) / k for i in range(b)
    ])
    assert containment >= 0.97, f"int8 sharded containment = {containment}"

    # Device-re-rank variant: each shard re-scores its own candidates
    # against a LOCAL f16 row copy (tombstones filtered by a sharded
    # live mask) and the merge carries EXACT scores — the returned ids
    # are final, no host re-rank.  One row is tombstoned to prove the
    # device-side liveness filter.
    live = np.ones(len(xs_host), np.uint8)
    dead_row = int(oracle[0][0])
    live[dead_row] = 0
    qsearch_rr = ShardedInt8Search(mesh, k=4 * k, rerank_device=True, k_out=k)
    rr_arrays = qsearch_rr.shard_rerank_arrays(xs_host, live)
    _, ids_rr = qsearch_rr(
        xs_q, sc_q, sq_q, qs, nv, rerank_arrays=rr_arrays
    )
    ids_rr = ids_rr.cpu().numpy()
    assert dead_row not in set(ids_rr[0].tolist())
    live_oracle = [
        [j for j in np.argsort(-sims[i]) if live[j]][:k] for i in range(b)
    ]
    rr_recall = np.mean([
        len(set(live_oracle[i]) & set(ids_rr[i])) / k for i in range(b)
    ])
    assert rr_recall >= 0.97, f"int8 sharded device-rerank recall = {rr_recall}"

    # The full "training step" analog: one sharded index-build iteration
    # (data-parallel k-means, centroid sums added on the merge device).
    kmeans = ShardedKMeans(mesh, n_clusters=16, bf16=False)
    centroids = kmeans.fit(xs_host, iters=2)
    assert centroids.shape == (16, d)
    assert np.all(np.isfinite(centroids))

    # Full HYBRID query at mesh scale: sharded vector seed -> sharded
    # ORDERED labeled expansion (frame semantics: order, multiplicity,
    # provenance — not membership masks) -> value_map projection,
    # byte-for-byte against the single-device engine.
    from .dsl import g as _g, read_batch, write_batch
    from .engine import Engine

    def build_engine(**kw):
        eng = Engine(device=device, **kw)
        grng = np.random.default_rng(17)
        wb = write_batch().var_as(
            "ix", _g().create_vector_index_nodes("Doc", "emb")
        )
        for i in range(211):  # prime: ragged over every shard split
            wb = wb.var_as(f"n{i}", _g().add_n("Doc", {
                "i": int(i),
                "emb": [float(x) for x in grng.normal(size=8)],
            }))
        eng.execute(_request("write", wb))
        ids = eng.execute(_request("read", read_batch().var_as(
            "u", _g().n_with_label("Doc").id()).returning(["u"])))["u"]
        eb = write_batch()
        for j in range(700):
            a2, b2 = grng.integers(0, 211, 2)
            eb = eb.var_as(f"e{j}", _g().n({"Ids": [ids[a2]]}).add_e(
                ["REL", "ALT"][j % 2], {"Ids": [ids[b2]]}
            ))
        eng.execute(_request("write", eb))
        return eng

    # shard_threshold=1 routes the engine's OWN vector search through
    # the mesh too (not just the standalone searchers above), so the
    # hybrid below certifies the full sharded serving stack
    sharded_eng = build_engine(shard_threshold=1, graph_shard_threshold=1)
    host_eng = build_engine()
    qrng = np.random.default_rng(9)
    req = _request("read", read_batch().var_as(
        "hits",
        _g().vector_search_nodes(
            "Doc", "emb", [float(x) for x in qrng.normal(size=8)], 5
        ).out("REL").value_map(),
    ).returning(["hits"]))
    got = sharded_eng.execute(req)
    want = host_eng.execute(req)
    assert json.dumps(got) == json.dumps(want), "hybrid mesh/host diverged"
    assert len(got["hits"]) > 0, "hybrid dryrun was vacuous"

    # Ordered EDGE steps at mesh scale: OutE with anchor provenance
    # through OtherN, byte-for-byte vs single device.
    ereq = _request("read", read_batch().var_as(
        "rows",
        _g().n_with_label("Doc").out_e("ALT").other_n().values(["i"]),
    ).returning(["rows"]))
    egot = sharded_eng.execute(ereq)
    ewant = host_eng.execute(ereq)
    assert json.dumps(egot) == json.dumps(ewant), "edge-step mesh diverged"
    assert len(egot["rows"]) > 0, "edge-step dryrun was vacuous"

    # Ingest-while-sharded: AddN + vector writes + a Drop land on BOTH
    # engines mid-serve -> the sharded engine must refresh its shard
    # state (matrix.version bump re-shards on the next search), surface
    # the new rows, filter the tombstone on the sharded path, and
    # traverse fresh edges — byte-for-byte vs single device.
    multi = device_count(device) > 1  # a one-device run has no mesh
    vpart = next(iter(
        sharded_eng.vectors.indexes.values()
    )).partitions[("",)]
    if multi:
        assert vpart._shard_state is not None, "sharded vector path never ran"
        version_before = vpart._shard_state["version"]

    mrng = np.random.default_rng(23)
    new_vecs = mrng.normal(size=(13, 8))
    preq = _request("read", read_batch().var_as(
        "top",
        _g().vector_search_nodes(
            "Doc", "emb", [float(x) for x in mrng.normal(size=8)], 1
        ).value_map(["$id"]),
    ).returning(["top"]))
    victim = sharded_eng.execute(preq)["top"][0]["$id"]
    assert victim == host_eng.execute(preq)["top"][0]["$id"]
    for eng in (sharded_eng, host_eng):
        mb = write_batch()
        for i2, vec in enumerate(new_vecs):
            mb = mb.var_as(f"w{i2}", _g().add_n("Doc", {
                "i": 5000 + i2, "emb": [float(x) for x in vec],
            }).add_e("FRESH", {"Ids": [victim]}))
        mb = mb.var_as("del", _g().n({"Ids": [victim]}).drop())
        eng.execute(_request("write", mb))

    # new row reachable at exact-match distance; tombstone filtered
    hreq = _request("read", read_batch().var_as(
        "hits",
        _g().vector_search_nodes(
            "Doc", "emb", [float(x) for x in new_vecs[4]], 3
        ).value_map(["$id", "i"]),
    ).returning(["hits"]))
    hgot = sharded_eng.execute(hreq)
    assert json.dumps(hgot) == json.dumps(host_eng.execute(hreq))
    assert hgot["hits"][0]["i"] == 5004, hgot["hits"][:1]
    assert victim not in [h["$id"] for h in hgot["hits"]]
    if multi:
        state = vpart._shard_state
        assert state is not None and state["version"] != version_before, (
            "mutation did not refresh the sharded vector state"
        )
        assert state["version"] == vpart.matrix.version
    # dropped node's edges must be gone from the sharded traversal
    # (FRESH edges pointed AT the victim; Drop removes incident edges)
    freq = _request("read", read_batch().var_as(
        "rows", _g().n_with_label("Doc").out_e("FRESH").other_n().id(),
    ).returning(["rows"]))
    fgot = sharded_eng.execute(freq)
    assert json.dumps(fgot) == json.dumps(host_eng.execute(freq))
    assert fgot["rows"] == [], "edges incident to a dropped node survived"


if __name__ == "__main__":
    import sys

    where = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    fn, args = entry(where)
    out = fn(*args)
    print("entry ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(4, where)
    print("dryrun_multichip ok")
