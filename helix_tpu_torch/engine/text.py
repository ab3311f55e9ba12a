"""BM25 full-text index manager.

Implements the reference's text-search contract (``TextSearchNodes``/
``TextSearchEdges`` steps, ``dsl.rs:2835``, ``:2871``; ``$score`` virtual
field, ``sdks/rust/README.md:527``): top-k hits, descending ``$score``,
tenant partitioning identical to vector indexes.

Host-side inverted index with Okapi BM25 scoring (k1=1.2, b=0.75).  The
scoring loop over candidate docs is NumPy-vectorized per term; a Pallas
postings-scan kernel can replace it for large corpora without changing
this interface.

Port copy of ``helix_tpu/engine/text.py`` for ``helix_tpu_torch``: it
imports the port's own copies of the framework-free modules (wire, dsl,
native, telemetry, fastjson), so importing this module loads nothing of
the JAX package.  ``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:

- ``TextPartition.__init__``: takes the engine's ``device``.
- ``TextPartition._device_postings``: builds ``DevicePostings`` on that
  device, or ``ShardedBM25`` over the mesh of that device's type where it
  holds more than one device (``parallel.device_count``).
- ``TextIndex.__init__``: takes ``device``.
- ``TextIndex.insert_element``: passes ``device`` to new partitions.
- ``TextManager.__init__``: takes ``device``.
- ``TextManager.on_index_created``: passes ``device`` on.
"""

from __future__ import annotations

import math
import re
from typing import Any

import numpy as np
import torch

from . import values as V
from .errors import QueryError, WriteError
from .store import Edge, GraphStore, IndexDef, Node

Tagged = Any

# Word characters minus underscore: for ASCII text this is exactly the
# old [a-z0-9]+ behavior (after casefold), but Unicode letters/digits
# now tokenize instead of silently vanishing — a non-Latin corpus used
# to index zero tokens per doc (deflating IDF/avgdl for the whole
# partition) and be unsearchable.
_TOKEN = re.compile(r"[^\W_]+")
_UNTENANTED = ("",)

# Okapi constants; ops/bm25.py declares the same values for the device
# kernel (kept in lockstep by tests/test_bm25_device.py).
K1 = 1.2
B = 0.75


def tokenize(text: str) -> list[str]:
    return _TOKEN.findall(text.casefold())


def _tenant_key(value: Tagged) -> tuple:
    comp = V.as_comparable(value)
    if comp is None:
        raise QueryError("tenant_value must be a scalar value")
    return comp


# Corpus size above which scoring moves to the device postings kernel.
DEVICE_THRESHOLD = 10_000


class TextPartition:
    def __init__(self, device_threshold: int = DEVICE_THRESHOLD, *,
                 device: torch.device):
        self.device = device
        self.postings: dict[str, dict[int, int]] = {}
        self.doc_len: dict[int, int] = {}
        self.doc_terms: dict[int, tuple[str, ...]] = {}  # distinct terms
        self.total_len = 0
        self.device_threshold = device_threshold
        self.version = 0
        self._device = None          # (version, DevicePostings)

    def add(self, doc_id: int, text: str) -> None:
        self.remove(doc_id)
        tokens = tokenize(text)
        self.doc_len[doc_id] = len(tokens)
        self.total_len += len(tokens)
        for token in tokens:
            bucket = self.postings.setdefault(token, {})
            bucket[doc_id] = bucket.get(doc_id, 0) + 1
        self.doc_terms[doc_id] = tuple(dict.fromkeys(tokens))
        self.version += 1

    def remove(self, doc_id: int) -> None:
        length = self.doc_len.pop(doc_id, None)
        if length is None:
            return
        self.total_len -= length
        # O(doc terms), not O(vocabulary): every property update does
        # remove+reinsert, and a full-buckets sweep made that
        # tenants x vocab dict work per write
        for token in self.doc_terms.pop(doc_id, ()):
            bucket = self.postings.get(token)
            if bucket is not None:
                bucket.pop(doc_id, None)
                if not bucket:
                    del self.postings[token]
        self.version += 1

    # Writes since the last device build before a rebuild is justified:
    # rebuilding is O(total postings) + a full device transfer, so an
    # interleaved write/search workload must not pay it per search.
    # Until the corpus quiesces (or drifts this far), stale-version
    # searches serve from the host index — correct, just not
    # device-accelerated.
    REBUILD_MIN_WRITES = 2048

    def _device_postings(self):
        cached = self._device
        if cached is not None and cached[0] == self.version:
            return cached[1]
        if (
            cached is not None
            and cached[1] is not None
            and self.version - cached[0] < self.REBUILD_MIN_WRITES
        ):
            return None  # hysteresis: host path until writes amortize
        from ..parallel import device_count

        if device_count(self.device) > 1:
            # doc-partitioned postings across the mesh (global IDF/avgdl
            # travel with the query; the per-shard top-k merge on the
            # partition's device) — the text workload's multi-device path
            from ..ops.bm25 import ShardedBM25
            from ..parallel import make_mesh

            built = ShardedBM25.build(
                self.postings, self.doc_len, make_mesh(device=self.device)
            )
        else:
            from ..ops.bm25 import DevicePostings

            built = DevicePostings.build(
                self.postings, self.doc_len, device=self.device
            )
        self._device = (self.version, built)
        return built

    def search(self, query: str, k: int) -> tuple[np.ndarray, np.ndarray]:
        n_docs = len(self.doc_len)
        if n_docs == 0:
            return np.empty(0, np.uint64), np.empty(0, np.float64)
        if n_docs >= self.device_threshold:
            device = self._device_postings()
            if device is not None:
                hit = device.search(tokenize(query), k)
                if hit is not None:
                    return hit
                # more known terms than the kernel pad: host path scores
                # every term (silent truncation would change rankings)
        avgdl = self.total_len / n_docs
        scores: dict[int, float] = {}
        for token in tokenize(query):
            bucket = self.postings.get(token)
            if not bucket:
                continue
            df = len(bucket)
            idf = math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
            for doc_id, tf in bucket.items():
                dl = self.doc_len[doc_id]
                denom = tf + K1 * (1.0 - B + B * dl / max(avgdl, 1e-9))
                scores[doc_id] = scores.get(doc_id, 0.0) + idf * (tf * (K1 + 1.0)) / denom
        if not scores:
            return np.empty(0, np.uint64), np.empty(0, np.float64)
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        ids = np.array([doc_id for doc_id, _ in ranked], np.uint64)
        vals = np.array([score for _, score in ranked], np.float64)
        return ids, vals


class TextIndex:
    def __init__(self, defn: IndexDef, *, device: torch.device):
        self.defn = defn
        self.device = device
        self.partitions: dict[tuple, TextPartition] = {}

    def insert_element(self, element: Node | Edge) -> None:
        value = element.props.get(self.defn.prop)
        if value is None or V.is_null(value):
            return
        text = V.text_of(value)
        if text is None:
            return
        if self.defn.tenant_property is not None:
            tenant_value = element.props.get(self.defn.tenant_property)
            if tenant_value is None or V.is_null(tenant_value):
                raise WriteError(
                    f"write to multitenant text index {self.defn.label}."
                    f"{self.defn.prop} requires tenant property "
                    f"'{self.defn.tenant_property}'"
                )
            tenant = _tenant_key(tenant_value)
        else:
            tenant = _UNTENANTED
        self.partitions.setdefault(
            tenant, TextPartition(device=self.device)
        ).add(element.id, text)

    def remove_element(self, element_id: int) -> None:
        # Prune emptied tenant partitions: a tenant-churn workload would
        # otherwise grow this dict forever and pay an O(dead tenants)
        # scan on every delete.
        dead = []
        for tenant, part in self.partitions.items():
            part.remove(element_id)
            if not part.doc_len:
                dead.append(tenant)
        for tenant in dead:
            del self.partitions[tenant]

    def search(
        self, query: str, k: int, tenant_value: Tagged | None
    ) -> tuple[np.ndarray, np.ndarray]:
        if self.defn.tenant_property is not None:
            if tenant_value is None:
                raise QueryError(
                    f"text index {self.defn.label}.{self.defn.prop} is "
                    "multitenant; search requires tenant_value"
                )
            part = self.partitions.get(_tenant_key(tenant_value))
            if part is None:
                return np.empty(0, np.uint64), np.empty(0, np.float64)
            return part.search(query, k)
        part = self.partitions.get(_UNTENANTED)
        if part is None:
            return np.empty(0, np.uint64), np.empty(0, np.float64)
        return part.search(query, k)


class TextManager:
    """Store write-hook + search facade over all text indexes."""

    def __init__(self, *, device: torch.device):
        self.device = device
        self.indexes: dict[tuple, TextIndex] = {}

    def on_index_created(self, store: GraphStore, defn: IndexDef) -> None:
        if defn.spec_tag not in ("NodeText", "EdgeText"):
            return
        index = TextIndex(defn, device=self.device)
        self.indexes[defn.key()] = index
        table = (
            store.nodes_by_label.get(defn.label, ())
            if defn.kind == "node"
            else store.edges_by_label.get(defn.label, ())
        )
        records = store.nodes if defn.kind == "node" else store.edges
        for element_id in table:
            index.insert_element(records[element_id])

    def on_index_dropped(self, store: GraphStore, defn: IndexDef) -> None:
        self.indexes.pop(defn.key(), None)

    def _matching(self, kind: str, label: str):
        for index in self.indexes.values():
            if index.defn.kind == kind and index.defn.label == label:
                yield index

    def on_node_added(self, store: GraphStore, node: Node) -> None:
        for index in self._matching("node", node.label):
            index.insert_element(node)

    def on_nodes_added_bulk(self, store: GraphStore, nodes: list) -> None:
        """Bulk-ingest hook: resolve the matching indexes ONCE for the
        whole batch (all rows share a label on the ForEach-AddN fast
        path); a batch whose label has no text index costs one lookup
        instead of a per-row generator walk."""
        if not nodes:
            return
        for index in self._matching("node", nodes[0].label):
            for node in nodes:
                index.insert_element(node)

    def on_edge_added(self, store: GraphStore, edge: Edge) -> None:
        for index in self._matching("edge", edge.label):
            index.insert_element(edge)

    def on_node_dropped(self, store: GraphStore, node: Node) -> None:
        for index in self._matching("node", node.label):
            index.remove_element(node.id)

    def on_edge_dropped(self, store: GraphStore, edge: Edge) -> None:
        for index in self._matching("edge", edge.label):
            index.remove_element(edge.id)

    def on_property_set(
        self, store: GraphStore, kind: str, element: Any, name: str, old: Tagged | None
    ) -> None:
        for index in self._matching(kind, element.label):
            if index.defn.prop == name or index.defn.tenant_property == name:
                index.remove_element(element.id)
                index.insert_element(element)

    def search(
        self,
        kind: str,
        label: str,
        prop: str,
        query: str,
        k: int,
        tenant_value: Tagged | None,
    ) -> tuple[np.ndarray, np.ndarray]:
        spec_tag = "NodeText" if kind == "nodes" else "EdgeText"
        index = self.indexes.get((spec_tag, label, prop))
        if index is None:
            raise QueryError(
                f"no text index on {label}.{prop}; create one with "
                "create_text_index_nodes/edges first"
            )
        if k <= 0:
            return np.empty(0, np.uint64), np.empty(0, np.float64)
        return index.search(query, k, tenant_value)
