"""The system under test: ``helix_tpu_torch``'s engine with one
``NodeVector`` index whose single partition holds the run's rows, and for
HTTP cells the native gateway in front of it with the stored ``vsearch``
route.  This is the only module of the harness that imports the
program."""

from __future__ import annotations

import numpy as np
import torch

LABEL, PROPERTY = "Doc", "emb"
INDEX_KEY = ("NodeVector", LABEL, PROPERTY)
ROUTE = "vsearch"


def build(config: dict, rows: np.ndarray, device: torch.device):
    """``(engine, partition)``: the rows added under element ids
    ``1..N`` (row position + 1) through ``Partition.add_bulk``, the
    matrix's background grow waited out.  The residency ladder's knobs
    come from the configuration's ``deployment``: ``hbm_budget_bytes``
    and ``quant_candidates``, where absent or null the engine's default
    (no budget: the exact rung).  ``PackedMatrix.extend`` copies the
    rows, so the caller may free them once this returns."""
    from helix_tpu_torch.engine import Engine

    deployment = config.get("deployment") or {}
    engine = Engine(device=device, metric=config["metric"],
                    batch_window_ms=None,
                    hbm_budget_bytes=deployment.get("hbm_budget_bytes"),
                    quant_candidates=deployment.get("quant_candidates"))
    engine.execute({
        "request_type": "write", "query_name": None,
        "query": {"queries": [{"Query": {"name": "idx", "steps": [
            {"CreateIndex": {"spec": {"NodeVector": {
                "label": LABEL, "property": PROPERTY,
                "tenant_property": None,
            }}, "if_not_exists": True}}], "condition": None}}],
            "returns": []},
        "parameters": {},
    })
    part = engine.vectors.indexes[INDEX_KEY].partition_for(("",))
    part.add_bulk(list(range(1, len(rows) + 1)), rows)
    grow = part.matrix._grow_thread
    if grow is not None:
        grow.join()
    return engine, part


def rung(part) -> str:
    """The rung of the residency ladder that ``part`` serves, asked of
    the partition's own predicates in ``Partition.search_many_async``'s
    order: ``host_ivf``, ``host_exact``, ``int8.device_rerank`` or
    ``int8.host_rerank`` (where the int8 rung re-scores its candidates),
    ``int4``, ``sharded``, else ``exact``."""
    if part._use_host_ivf():
        return "host_ivf"
    if part._use_host_exact():
        return "host_exact"
    if part._use_quant():
        where = "device" if part._quant_rerank_device() else "host"
        return f"int8.{where}_rerank"
    if part._use_quant4():
        return "int4"
    if part._use_shard():
        return "sharded"
    return "exact"


def warm(part, batches: list[int], dim: int, k: int, seed: int) -> None:
    """One search at each batch size (the device copies upload at the
    first), then a device sync."""
    rng = np.random.default_rng([seed % (1 << 64), 5])
    for b in batches:
        for _ in range(2):
            part.search_many(rng.normal(size=(b, dim)).astype(np.float32), k)
    if part.device.type == "cuda":
        torch.cuda.synchronize(part.device)


def vsearch_bundle() -> dict:
    """The stored route ``vsearch(q, k)``: ``VectorSearchNodes`` then
    ``ValueMap [$id, $distance]``, which the gateway's vector fast path
    serves."""
    return {
        "version": 5,
        "read_routes": {ROUTE: {"queries": [{"Query": {
            "name": "hits",
            "steps": [
                {"VectorSearchNodes": {
                    "label": LABEL, "property": PROPERTY,
                    "query_vector": {"Expr": {"Param": "q"}},
                    "k": {"Expr": {"Param": "k"}},
                }},
                {"ValueMap": ["$id", "$distance"]},
            ], "condition": None}}], "returns": ["hits"]}},
        "read_parameters": {ROUTE: [
            {"name": "q", "ty": {"Array": "F32"}},
            {"name": "k", "ty": "I64"},
        ]},
        "write_routes": {}, "write_parameters": {},
    }


def serve(engine):
    """The native gateway over ``engine`` on an ephemeral local port,
    started, with the ``vsearch`` route loaded."""
    from helix_tpu_torch.native import load
    from helix_tpu_torch.server.native_gateway import NativeGateway

    load()
    engine.load_bundle(vsearch_bundle())
    gw = NativeGateway(engine, host="127.0.0.1", port=0)
    gw.start()
    return gw


def fast_requests(gw) -> int:
    return int(gw.stats()["fast_requests"])


def vbatch_cap() -> int:
    from helix_tpu_torch.server.native_gateway import NativeGateway

    return NativeGateway.VBATCH_CAP
