"""Columnar / CSR snapshots of the graph store.

Rebuilt lazily per mutation epoch, these arrays are the interpreter's (and
the TPU kernels') view of the graph: packed node/edge id arrays, interned
label codes, CSR adjacency in both directions, and per-property columns.
This is the device-ready layout the build plan calls for (SURVEY.md §7.2):
``indptr/indices`` CSR per direction plus property columns, with only
predicate-relevant columns promoted to device.

All arrays here are NumPy; JAX device copies are created on demand by the
ops layer and cached keyed on (epoch, name).

Port copy of ``helix_tpu/engine/snapshot.py`` for ``helix_tpu_torch``: it
imports the port's own copies of the framework-free modules (wire, dsl,
native, telemetry, fastjson), so importing this module loads nothing of
the JAX package.  ``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:

- ``GraphSnapshot.padded_graph``: builds the padded adjacency on the
  snapshot's ``device``, which :class:`SnapshotCache` hands down.
- ``GraphSnapshot.sharded_graph``: the mesh over the snapshot's device.
- ``SnapshotCache.__init__``: takes the engine's ``device``.
- ``SnapshotCache.get``: sets ``device`` on every snapshot it makes.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import values as V
from .store import GraphStore

UINT64 = np.uint64


def gather_ranges(
    indptr: np.ndarray, slots: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized CSR range gather.

    For each row ``slots[i]``, yields the positions
    ``indptr[slot] .. indptr[slot+1]`` flattened, plus ``src_rows`` mapping
    every output back to its originating input row ``i``.
    """
    starts = indptr[slots]
    degrees = indptr[slots + 1] - starts
    total = int(degrees.sum())
    if total == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64))
    src_rows = np.repeat(np.arange(len(slots), dtype=np.int64), degrees)
    # positions = starts[src] + intra-range offset
    cum = np.concatenate(([0], np.cumsum(degrees)))[:-1]
    offsets = np.arange(total, dtype=np.int64) - np.repeat(cum, degrees)
    positions = np.repeat(starts, degrees) + offsets
    return src_rows, positions


def _dense_slot_array(ids: np.ndarray) -> np.ndarray | None:
    """id -> slot lookup array when the id space is dense enough
    (ids are u64 counters, so it almost always is); None otherwise."""
    n = len(ids)
    if n == 0:
        return np.full(1024, -1, np.int64)
    max_id = int(ids.max())
    if max_id > 4 * n + 1024:
        return None
    arr = np.full(max_id + 1, -1, np.int64)
    arr[ids.astype(np.int64)] = np.arange(n, dtype=np.int64)
    return arr


class PropertyColumn:
    """One property over all elements of a kind, aligned to snapshot slots.

    The public arrays are exact-length VIEWS over capacity-padded
    backing buffers (``_bufs``), so append-only epoch extensions write
    the tail in place (amortized O(tail)) instead of copying the column
    — safe for concurrent readers of the previous snapshot, whose views
    cover only the untouched prefix."""

    __slots__ = (
        "numeric", "numeric_mask", "int_mask", "dt_mask", "strings",
        "string_mask", "present", "null_mask", "_bufs",
    )

    def __init__(self, n: int):
        self.numeric = np.zeros(n, np.float64)
        self.numeric_mask = np.zeros(n, bool)
        # int_mask: the numeric value came from an integral tag
        # (I64/DateTime) — aggregation/grouping need int-vs-float
        # fidelity on the wire ("10" vs "10.0")
        self.int_mask = np.zeros(n, bool)
        # dt_mask: the value is a DateTime (numeric for compares, but
        # renders as RFC3339 — value exports must not emit the millis)
        self.dt_mask = np.zeros(n, bool)
        self.strings: np.ndarray | None = None  # object array, lazily
        self.string_mask: np.ndarray | None = None
        self.present = np.zeros(n, bool)
        # explicit Null values (distinct from absent: exports emit None
        # for them, exactly like the per-row to_plain path)
        self.null_mask = np.zeros(n, bool)
        self._bufs: dict[str, np.ndarray] = {}


def _grown(
    bufs: dict[str, np.ndarray], name: str, view: np.ndarray | None,
    n_old: int, n_new: int, dtype, fill=0,
) -> tuple[np.ndarray, np.ndarray]:
    """(buffer, view[:n_new]) with the tail slots writable: reuses the
    backing buffer when it has capacity, else reallocates at 2x."""
    buf = bufs.get(name)
    if buf is None and view is not None and len(view) == n_old:
        buf = view  # exactly-sized initial build
    if buf is None or len(buf) < n_new:
        cap = max(n_new, 2 * (len(buf) if buf is not None else n_old), 1024)
        new = np.full(cap, fill, dtype=dtype) if fill is not None else np.empty(
            cap, dtype=dtype
        )
        if n_old and view is not None:
            new[:n_old] = view[:n_old]
        buf = new
    return buf, buf[:n_new]


class GraphSnapshot:
    """Immutable columnar view of one store epoch."""

    def __init__(self, store: GraphStore):
        self.epoch = store.epoch
        self.struct_epoch = store.struct_epoch
        self._store = store

        # ---- nodes ----
        self.node_ids = np.array(store.node_order, dtype=UINT64)
        self.n_nodes = len(self.node_ids)
        self.node_labels: list[str] = []
        self.label_code: dict[str, int] = {}
        codes = np.empty(self.n_nodes, np.int32)
        for i, nid in enumerate(store.node_order):
            label = store.nodes[nid].label
            code = self.label_code.get(label)
            if code is None:
                code = len(self.node_labels)
                self.label_code[label] = code
                self.node_labels.append(label)
            codes[i] = code
        self.node_label_codes = codes

        # ---- edges ----
        self.edge_ids = np.array(store.edge_order, dtype=UINT64)
        self.n_edges = len(self.edge_ids)
        self.edge_labels: list[str] = []
        self.edge_label_code: dict[str, int] = {}
        e_codes = np.empty(self.n_edges, np.int32)
        e_src = np.empty(self.n_edges, np.int64)
        e_dst = np.empty(self.n_edges, np.int64)
        node_slot = {int(nid): i for i, nid in enumerate(store.node_order)}
        self._node_slot = node_slot
        self._edge_slot = {int(eid): i for i, eid in enumerate(store.edge_order)}
        self._node_slot_arr = _dense_slot_array(self.node_ids)
        self._edge_slot_arr = _dense_slot_array(self.edge_ids)
        for i, eid in enumerate(store.edge_order):
            edge = store.edges[eid]
            code = self.edge_label_code.get(edge.label)
            if code is None:
                code = len(self.edge_labels)
                self.edge_label_code[edge.label] = code
                self.edge_labels.append(edge.label)
            e_codes[i] = code
            e_src[i] = node_slot[edge.src]
            e_dst[i] = node_slot[edge.dst]
        self.edge_label_codes = e_codes
        self.edge_src = e_src   # node slots
        self.edge_dst = e_dst

        # ---- CSR adjacency (edge indices sorted by endpoint slot) ----
        self.out_indptr, self.out_edges = self._build_csr(e_src)
        self.in_indptr, self.in_edges = self._build_csr(e_dst)

        self._columns: dict[tuple[str, str], PropertyColumn] = {}
        self._padded: dict[str, object] = {}
        self._node_bufs: dict[str, np.ndarray] = {}
        self._label_ids: dict[tuple[str, str], np.ndarray] = {}

    @classmethod
    def extended(cls, prev: "GraphSnapshot", store: GraphStore) -> "GraphSnapshot":
        """Snapshot for a node-APPEND-only epoch delta: reuse prev's
        edge/CSR arrays untouched, copy-extend the node arrays and any
        cached property columns with just the appended rows, instead of
        the full per-row Python rebuild (seconds at 1M rows vs ~ms).

        Safety: prev's slot dicts are taken over and extended in place.
        That is sound under the engine's RWLock discipline — writes are
        exclusive, every query re-fetches the snapshot at its start, so
        no reader can still be using ``prev`` when the first post-write
        read triggers this extension (SnapshotCache serializes it)."""
        self = cls.__new__(cls)
        self.epoch = store.epoch
        self.struct_epoch = store.struct_epoch
        self._store = store
        old_n = prev.n_nodes
        order = store.node_order
        n = len(order)
        tail = order[old_n:]

        bufs = prev._node_bufs
        self._node_bufs = bufs
        buf, self.node_ids = _grown(
            bufs, "node_ids", prev.node_ids, old_n, n, UINT64
        )
        buf[old_n:n] = tail
        bufs["node_ids"] = buf
        self.n_nodes = n
        self.node_labels = prev.node_labels
        self.label_code = prev.label_code
        buf, self.node_label_codes = _grown(
            bufs, "node_label_codes", prev.node_label_codes, old_n, n, np.int32
        )
        for i, nid in enumerate(tail, start=old_n):
            label = store.nodes[nid].label
            code = self.label_code.get(label)
            if code is None:
                code = len(self.node_labels)
                self.label_code[label] = code
                self.node_labels.append(label)
            buf[i] = code
        bufs["node_label_codes"] = buf

        self._node_slot = prev._node_slot
        for i, nid in enumerate(tail, start=old_n):
            self._node_slot[int(nid)] = i
        self._edge_slot = prev._edge_slot

        # ---- edges: extend arrays for any appended tail ----
        old_e = prev.n_edges
        eorder = store.edge_order
        ne = len(eorder)
        etail = eorder[old_e:]
        self.n_edges = ne
        self.edge_labels = prev.edge_labels
        self.edge_label_code = prev.edge_label_code
        if etail:
            buf, self.edge_ids = _grown(
                bufs, "edge_ids", prev.edge_ids, old_e, ne, UINT64
            )
            buf[old_e:ne] = etail
            bufs["edge_ids"] = buf
            ecodes, self.edge_label_codes = _grown(
                bufs, "edge_label_codes", prev.edge_label_codes, old_e, ne,
                np.int32,
            )
            esrc, self.edge_src = _grown(
                bufs, "edge_src", prev.edge_src, old_e, ne, np.int64
            )
            edst, self.edge_dst = _grown(
                bufs, "edge_dst", prev.edge_dst, old_e, ne, np.int64
            )
            bufs["edge_label_codes"] = ecodes
            bufs["edge_src"] = esrc
            bufs["edge_dst"] = edst
            node_slot = self._node_slot
            edge_slot = self._edge_slot
            edges_tab = store.edges
            for i, eid in enumerate(etail, start=old_e):
                edge = edges_tab[eid]
                code = self.edge_label_code.get(edge.label)
                if code is None:
                    code = len(self.edge_labels)
                    self.edge_label_code[edge.label] = code
                    self.edge_labels.append(edge.label)
                ecodes[i] = code
                esrc[i] = node_slot[edge.src]
                edst[i] = node_slot[edge.dst]
                edge_slot[int(eid)] = i
        else:
            self.edge_ids = prev.edge_ids
            self.edge_label_codes = prev.edge_label_codes
            self.edge_src = prev.edge_src
            self.edge_dst = prev.edge_dst

        arr = prev._node_slot_arr
        if arr is not None and tail:
            max_id = max(tail)
            if max_id >= len(arr):
                grown = np.full(
                    max(max_id + 1, 2 * len(arr)), -1, np.int64
                )
                grown[: len(arr)] = arr
                arr = grown
            arr[np.asarray(tail, np.int64)] = np.arange(
                old_n, n, dtype=np.int64
            )
        self._node_slot_arr = arr
        earr = prev._edge_slot_arr
        if earr is not None and etail:
            max_id = max(etail)
            if max_id >= len(earr):
                grown_e = np.full(
                    max(max_id + 1, 2 * len(earr)), -1, np.int64
                )
                grown_e[: len(earr)] = earr
                earr = grown_e
            earr[np.asarray(etail, np.int64)] = np.arange(
                old_e, ne, dtype=np.int64
            )
        self._edge_slot_arr = earr
        # per-label id arrays: append each tail id to its label's
        # cached array (only labels already materialized)
        self._label_ids = prev._label_ids
        if tail:
            by_label: dict[str, list] = {}
            for nid in tail:
                by_label.setdefault(store.nodes[nid].label, []).append(nid)
            for label, ids_ in by_label.items():
                cached = self._label_ids.get(("node", label))
                if cached is not None:
                    self._label_ids[("node", label)] = np.concatenate(
                        [cached, np.asarray(ids_, UINT64)]
                    )
        if etail:
            by_elabel: dict[str, list] = {}
            for eid in etail:
                by_elabel.setdefault(store.edges[eid].label, []).append(eid)
            for label, ids_ in by_elabel.items():
                cached = self._label_ids.get(("edge", label))
                if cached is not None:
                    self._label_ids[("edge", label)] = np.concatenate(
                        [cached, np.asarray(ids_, UINT64)]
                    )

        if etail:
            # Vectorized CSR merge: each appended edge lands at the END
            # of its endpoint's range (matching the stable argsort the
            # full build uses — new edges have the highest indices), so
            # one np.insert per direction replaces the O(E log E)
            # re-sort.  The native-kernel CSR cache (targets/labels)
            # merges the same way, so a single AddE costs O(E) memcpy,
            # not an argsort + full re-gather (measured 330 -> ~25 ms
            # per add+traversal cycle at 1M edges).
            self._padded = {}
            new_idx = np.arange(old_e, ne, dtype=np.int64)
            tail_ecodes = np.asarray(self.edge_label_codes[old_e:ne])
            for direction in ("out", "in"):
                if direction == "out":
                    endpoint = self.edge_src
                    other_all = self.edge_dst
                    prev_indptr, prev_order = prev.out_indptr, prev.out_edges
                else:
                    endpoint = self.edge_dst
                    other_all = self.edge_src
                    prev_indptr, prev_order = prev.in_indptr, prev.in_edges
                base_indptr = np.concatenate(
                    [prev_indptr,
                     np.full(n - old_n, prev_indptr[-1], np.int64)]
                )
                v = np.asarray(endpoint[old_e:ne])
                # new edges with DIFFERENT endpoints can share an insert
                # position (every range between them empty); np.insert
                # keeps the given value order at equal positions, so
                # sort the tail by (endpoint, edge index) to match the
                # full build's stable argsort
                perm = np.lexsort((new_idx, v))
                v_s = v[perm]
                pos = base_indptr[v_s + 1]
                order_new = np.insert(
                    np.asarray(prev_order), pos, new_idx[perm]
                )
                counts = np.bincount(v, minlength=n)
                indptr_new = base_indptr + np.concatenate(
                    ([0], np.cumsum(counts))
                )
                prev_cache = prev._padded.get(f"csr:{direction}")
                if prev_cache is not None:
                    _, tgt, lab = prev_cache
                    other = np.asarray(other_all[old_e:ne], np.int32)
                    self._padded[f"csr:{direction}"] = (
                        indptr_new,
                        np.insert(tgt, pos, other[perm]),
                        np.insert(
                            lab, pos, tail_ecodes[perm].astype(np.int32)
                        ),
                    )
                if direction == "out":
                    self.out_indptr, self.out_edges = indptr_new, order_new
                else:
                    self.in_indptr, self.in_edges = indptr_new, order_new
            # fresh exact-length arrays replace any capacity buffers
            bufs.pop("out_indptr", None)
            bufs.pop("in_indptr", None)
        else:
            # CSR: new nodes have no incident edges — indptr extends
            # with the terminal value, edge index arrays carry over
            buf, self.out_indptr = _grown(
                bufs, "out_indptr", prev.out_indptr, old_n + 1, n + 1,
                np.int64,
            )
            buf[old_n + 1 : n + 1] = buf[old_n]
            bufs["out_indptr"] = buf
            self.out_edges = prev.out_edges
            buf, self.in_indptr = _grown(
                bufs, "in_indptr", prev.in_indptr, old_n + 1, n + 1,
                np.int64,
            )
            buf[old_n + 1 : n + 1] = buf[old_n]
            bufs["in_indptr"] = buf
            self.in_edges = prev.in_edges

        self._columns = {}
        for (kind, prop), col in prev._columns.items():
            if kind == "node":
                self._columns[(kind, prop)] = _extend_column(
                    col, store.nodes, tail, prop, n
                )
            else:
                self._columns[(kind, prop)] = _extend_column(
                    col, store.edges, etail, prop, ne
                )
        if not etail:
            # no edge delta: device/padded caches are invalidated only
            # by node-count growth (rebuilt lazily) — EXCEPT the merged
            # native-CSR caches, whose targets/labels are untouched by
            # a node-only append: carry them with the already-extended
            # indptr instead of paying a full O(E) endpoint re-gather
            # on the next traversal (alternating AddN/traverse is the
            # ingest hot path)
            carried: dict[str, object] = {}
            for direction in ("out", "in"):
                cache = prev._padded.get(f"csr:{direction}")
                if cache is not None:
                    indptr_new = (
                        self.out_indptr if direction == "out"
                        else self.in_indptr
                    )
                    carried[f"csr:{direction}"] = (
                        indptr_new, cache[1], cache[2]
                    )
            self._padded = carried
        return self

    def patch_cell(self, kind: str, eid: int, prop: str) -> None:
        """Apply one property-value mutation to the cached columns:
        exact-match columns patch in place at the element's slot;
        dotted-path columns derived from the property drop (lazy
        rebuild).  Safe under the RWLock discipline: the first read
        after a write applies patches before any reader uses the
        snapshot, and pre-write readers have already drained."""
        slot_map = self._node_slot if kind == "node" else self._edge_slot
        slot = slot_map.get(int(eid))
        table = self._store.nodes if kind == "node" else self._store.edges
        rec = table.get(int(eid))
        for key in list(self._columns.keys()):
            k, p = key
            if k != kind:
                continue
            if p == prop:
                if slot is None or rec is None:
                    del self._columns[key]
                    continue
                _patch_column_cell(
                    self._columns[key], slot, V.get_path(rec.props, p)
                )
            elif p.split(".", 1)[0] == prop:
                del self._columns[key]

    def _build_csr(self, endpoint: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        order = np.argsort(endpoint, kind="stable")
        counts = np.bincount(endpoint, minlength=self.n_nodes)
        indptr = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
        return indptr, order.astype(np.int64)

    # ---- device padded adjacency ----------------------------------------

    # Padded-adjacency budget: N x P x 8 bytes (slots + label codes) per
    # direction, resident in HBM next to the vector matrices.  Beyond
    # this the planner falls back to the native sweep / sharded path
    # rather than silently OOMing the device.
    PADDED_BYTES_CAP = 2 << 30

    def padded_graph(self, direction: str, max_degree_cap: int = 256):
        """Padded adjacency for ``out``/``in`` expansion on the snapshot's
        device (ops/csr.py layout); None when the max degree exceeds the
        cap or the padded layout would blow the device-memory budget.
        Cached per snapshot (epoch)."""
        if direction in self._padded:
            return self._padded[direction]
        from ..ops.csr import PaddedGraph

        if direction == "out":
            indptr, order = self.out_indptr, self.out_edges
            endpoint = self.edge_dst
        else:
            indptr, order = self.in_indptr, self.in_edges
            endpoint = self.edge_src
        degrees = np.diff(indptr)
        max_deg = int(degrees.max()) if len(degrees) else 0
        if self.n_nodes * max(max_deg, 1) * 8 > self.PADDED_BYTES_CAP:
            self._padded[direction] = None
            return None
        graph = PaddedGraph.from_csr(
            indptr,
            endpoint[order].astype(np.int32),
            self.edge_label_codes[order],
            self.n_nodes,
            max_degree_cap=max_degree_cap,
            device=self.device,
        )
        self._padded[direction] = graph
        return graph

    # The sharded path splits the padded layout across the mesh, so its
    # budget is host-side (one full copy during construction).
    PADDED_HOST_BYTES_CAP = 16 << 30

    def padded_host(self, direction: str, max_degree_cap: int = 256,
                    include_edges: bool = False):
        """Host-layout padded adjacency ``(neighbors, labels)`` — or
        ``(neighbors, labels, edge_slots)`` with ``include_edges``, the
        plane the mesh-scale edge steps need — (no device upload); None
        above the degree or host-bytes cap.  Cached per snapshot."""
        key = f"padhost{'+e' if include_edges else ''}:{direction}"
        if key in self._padded:
            return self._padded[key]
        from ..ops.csr import PaddedGraph

        if direction == "out":
            indptr, order = self.out_indptr, self.out_edges
            endpoint = self.edge_dst
        else:
            indptr, order = self.in_indptr, self.in_edges
            endpoint = self.edge_src
        degrees = np.diff(indptr)
        max_deg = int(degrees.max()) if len(degrees) else 0
        if self.n_nodes * max(max_deg, 1) * 8 > self.PADDED_HOST_BYTES_CAP:
            self._padded[key] = None
            return None
        host = PaddedGraph.host_arrays(
            indptr,
            endpoint[order].astype(np.int32),
            self.edge_label_codes[order],
            self.n_nodes,
            max_degree_cap=max_degree_cap,
            # order[i] IS the global edge slot at CSR position i
            edge_order=order.astype(np.int32) if include_edges else None,
        )
        self._padded[key] = host
        return host

    def sharded_graph(self, directions: tuple[str, ...],
                      with_edges: bool = False):
        """Multi-device edge-partitioned adjacency (parallel/graph.py)
        over the mesh of the snapshot's device type, cached per snapshot
        for the direction set the plan needs; None when any direction
        exceeds the padding degree cap.  ``with_edges`` uploads the
        edge-slot plane so ordered edge steps (OutE/InE) run sharded
        too."""
        key = ("sharded", directions, with_edges)
        if key in self._padded:
            return self._padded[key]
        from ..parallel import ShardedGraph, make_mesh

        dirmap = {}
        for direction in directions:
            host = self.padded_host(direction, include_edges=with_edges)
            if host is None:
                self._padded[key] = None
                return None
            dirmap[direction] = host
        graph = ShardedGraph(make_mesh(device=self.device), self.n_nodes,
                             dirmap)
        self._padded[key] = graph
        return graph

    def csr_arrays(self, direction: str):
        """(indptr int64, target slots int32, label codes int32) for the
        native BFS kernel (native/bfs.cpp).  Cached per snapshot."""
        key = f"csr:{direction}"
        if key in self._padded:
            return self._padded[key]
        if direction == "out":
            indptr, order = self.out_indptr, self.out_edges
            endpoint = self.edge_dst
        else:
            indptr, order = self.in_indptr, self.in_edges
            endpoint = self.edge_src
        arrays = (
            indptr,
            np.ascontiguousarray(endpoint[order], np.int32),
            np.ascontiguousarray(self.edge_label_codes[order], np.int32),
        )
        self._padded[key] = arrays
        return arrays

    # ---- id <-> slot -----------------------------------------------------

    def node_slots(self, ids: np.ndarray) -> np.ndarray:
        """Map node ids to slots; raises KeyError on unknown ids."""
        arr = self._node_slot_arr
        if arr is not None:
            idx = np.asarray(ids, np.int64)
            ok = (idx >= 0) & (idx < len(arr))
            slots = np.where(ok, arr[np.where(ok, idx, 0)], -1)
            if (slots < 0).any():
                bad = idx[slots < 0]
                raise KeyError(int(bad[0]))
            return slots
        return np.fromiter(
            (self._node_slot[int(i)] for i in ids), np.int64, count=len(ids)
        )

    def node_slots_or_neg(self, ids: np.ndarray) -> np.ndarray:
        arr = self._node_slot_arr
        if arr is not None:
            idx = np.asarray(ids, np.int64)
            ok = (idx >= 0) & (idx < len(arr))
            return np.where(ok, arr[np.where(ok, idx, 0)], -1)
        get = self._node_slot.get
        return np.fromiter(
            (get(int(i), -1) for i in ids), np.int64, count=len(ids)
        )

    def edge_slots(self, ids: np.ndarray) -> np.ndarray:
        arr = self._edge_slot_arr
        if arr is not None:
            idx = np.asarray(ids, np.int64)
            ok = (idx >= 0) & (idx < len(arr))
            slots = np.where(ok, arr[np.where(ok, idx, 0)], -1)
            if (slots < 0).any():
                bad = idx[slots < 0]
                raise KeyError(int(bad[0]))
            return slots
        return np.fromiter(
            (self._edge_slot[int(i)] for i in ids), np.int64, count=len(ids)
        )

    def edge_slots_or_neg(self, ids: np.ndarray) -> np.ndarray:
        arr = self._edge_slot_arr
        if arr is not None:
            idx = np.asarray(ids, np.int64)
            ok = (idx >= 0) & (idx < len(arr))
            return np.where(ok, arr[np.where(ok, idx, 0)], -1)
        get = self._edge_slot.get
        return np.fromiter(
            (get(int(i), -1) for i in ids), np.int64, count=len(ids)
        )

    def label_ids(self, kind: str, label: str) -> np.ndarray:
        """uint64 id array of one label's elements, cached per snapshot
        (extended in place by append epochs)."""
        key = (kind, label)
        cached = self._label_ids.get(key)
        if cached is not None:
            return cached
        table = (
            self._store.nodes_by_label if kind == "node"
            else self._store.edges_by_label
        )
        rows = table.get(label, ())
        n = self.n_nodes if kind == "node" else self.n_edges
        arr = np.array(rows, UINT64)
        if len(arr) and kind == "node":
            # guard against rows appended after this snapshot's epoch
            arr = arr[self.node_slots_or_neg(arr) >= 0]
        elif len(arr):
            arr = arr[self.edge_slots_or_neg(arr) >= 0]
        self._label_ids[key] = arr
        return arr

    # ---- property columns --------------------------------------------------

    def column(self, kind: str, prop: str) -> PropertyColumn:
        key = (kind, prop)
        col = self._columns.get(key)
        if col is not None:
            return col
        if kind == "node":
            order = self._store.node_order
            table = self._store.nodes
            n = self.n_nodes
        else:
            order = self._store.edge_order
            table = self._store.edges
            n = self.n_edges
        col = PropertyColumn(n)
        strings: list[Any] = []
        any_string = False
        for i, eid in enumerate(order[:n]):
            value = V.get_path(table[eid].props, prop)
            if value is V.MISSING or V.is_null(value):
                if value is not V.MISSING:
                    col.null_mask[i] = True
                strings.append(None)
                continue
            col.present[i] = True
            num = V.as_number(value)
            if num is not None:
                col.numeric[i] = float(num)
                col.numeric_mask[i] = True
                col.int_mask[i] = isinstance(num, int)
                if V.tag_of(value) == "DateTime":
                    col.dt_mask[i] = True
                strings.append(None)
            elif V.tag_of(value) == "String":
                strings.append(V.payload_of(value))
                any_string = True
            elif V.tag_of(value) == "Bool":
                col.numeric[i] = 1.0 if V.payload_of(value) else 0.0
                strings.append(None)
            else:
                strings.append(None)
        if any_string:
            col.strings = np.array(strings, dtype=object)
            col.string_mask = np.array([s is not None for s in strings], bool)
        self._columns[key] = col
        return col


def _patch_column_cell(col: PropertyColumn, slot: int, value) -> None:
    """Rewrite one cell of a cached column from a fresh tagged value."""
    col.present[slot] = False
    col.numeric[slot] = 0.0
    col.numeric_mask[slot] = False
    col.int_mask[slot] = False
    col.dt_mask[slot] = False
    col.null_mask[slot] = False
    if col.strings is not None:
        col.strings[slot] = None
        col.string_mask[slot] = False
    if value is V.MISSING or V.is_null(value):
        col.null_mask[slot] = value is not V.MISSING
        return
    col.present[slot] = True
    num = V.as_number(value)
    if num is not None:
        col.numeric[slot] = float(num)
        col.numeric_mask[slot] = True
        col.int_mask[slot] = isinstance(num, int)
        col.dt_mask[slot] = V.tag_of(value) == "DateTime"
        return
    tag = V.tag_of(value)
    if tag == "String":
        if col.strings is None:
            n = len(col.present)
            col.strings = np.full(n, None, dtype=object)
            col.string_mask = np.zeros(n, bool)
            col._bufs["strings"] = col.strings
            col._bufs["string_mask"] = col.string_mask
        col.strings[slot] = V.payload_of(value)
        col.string_mask[slot] = True
    elif tag == "Bool":
        col.numeric[slot] = 1.0 if V.payload_of(value) else 0.0


def _extend_column(
    col: PropertyColumn, table: dict, tail: list, prop: str, n: int
) -> PropertyColumn:
    """Extend a cached node/edge column with the appended rows in place
    (amortized O(tail) via the capacity buffers)."""
    old_n = len(col.present)
    out = PropertyColumn.__new__(PropertyColumn)
    bufs = col._bufs
    out._bufs = bufs
    nbuf, out.numeric = _grown(bufs, "numeric", col.numeric, old_n, n, np.float64)
    bufs["numeric"] = nbuf
    mbuf, out.numeric_mask = _grown(
        bufs, "numeric_mask", col.numeric_mask, old_n, n, bool
    )
    bufs["numeric_mask"] = mbuf
    pbuf, out.present = _grown(bufs, "present", col.present, old_n, n, bool)
    bufs["present"] = pbuf
    ibuf, out.int_mask = _grown(bufs, "int_mask", col.int_mask, old_n, n, bool)
    bufs["int_mask"] = ibuf
    dbuf, out.dt_mask = _grown(bufs, "dt_mask", col.dt_mask, old_n, n, bool)
    bufs["dt_mask"] = dbuf
    ubuf, out.null_mask = _grown(bufs, "null_mask", col.null_mask, old_n, n, bool)
    bufs["null_mask"] = ubuf
    nbuf[old_n:n] = 0.0
    mbuf[old_n:n] = False
    pbuf[old_n:n] = False
    ibuf[old_n:n] = False
    dbuf[old_n:n] = False
    ubuf[old_n:n] = False
    any_string = col.strings is not None
    tail_strings: list[Any] | None = None
    for j, nid in enumerate(tail):
        i = old_n + j
        value = V.get_path(table[nid].props, prop)
        if value is V.MISSING or V.is_null(value):
            if value is not V.MISSING:
                ubuf[i] = True
            if tail_strings is not None:
                tail_strings.append(None)
            continue
        pbuf[i] = True
        num = V.as_number(value)
        if num is not None:
            nbuf[i] = float(num)
            mbuf[i] = True
            ibuf[i] = isinstance(num, int)
            dbuf[i] = V.tag_of(value) == "DateTime"
            if tail_strings is not None:
                tail_strings.append(None)
        elif V.tag_of(value) == "String":
            if tail_strings is None:
                # first string in this tail: backfill Nones for the
                # rows already processed
                tail_strings = [None] * j
            tail_strings.append(V.payload_of(value))
            any_string = True
        elif V.tag_of(value) == "Bool":
            nbuf[i] = 1.0 if V.payload_of(value) else 0.0
            if tail_strings is not None:
                tail_strings.append(None)
        else:
            if tail_strings is not None:
                tail_strings.append(None)
    if any_string:
        sbuf, out.strings = _grown(
            bufs, "strings", col.strings, old_n, n, object, fill=None
        )
        smbuf, out.string_mask = _grown(
            bufs, "string_mask", col.string_mask, old_n, n, bool
        )
        if tail_strings is not None:
            sbuf[old_n:n] = tail_strings
            smbuf[old_n:n] = [s is not None for s in tail_strings]
        else:
            sbuf[old_n:n] = None
            smbuf[old_n:n] = False
        bufs["strings"] = sbuf
        bufs["string_mask"] = smbuf
    else:
        out.strings = None
        out.string_mask = None
    return out


class SnapshotCache:
    """Epoch-keyed snapshot holder attached to a store.

    Node-append-only epoch deltas (ingest) extend the previous snapshot
    (GraphSnapshot.extended); anything structural rebuilds."""

    def __init__(self, store: GraphStore, *, device: torch.device):
        self._store = store
        self.device = device
        self._snapshot: GraphSnapshot | None = None
        import threading

        self._lock = threading.Lock()

    def get(self) -> GraphSnapshot:
        snap = self._snapshot
        store = self._store
        if snap is not None and snap.epoch == store.epoch:
            return snap
        with self._lock:
            snap = self._snapshot
            if snap is not None and snap.epoch == store.epoch:
                return snap
            if (
                snap is not None
                and snap.struct_epoch == store.struct_epoch
                and len(store.node_order) >= snap.n_nodes
                and len(store.edge_order) >= snap.n_edges
            ):
                try:
                    snap = GraphSnapshot.extended(snap, store)
                    # patches after extension: an element appended and
                    # then patched within the same delta has its slot
                    for kind, eid, prop in store.pending_patches:
                        snap.patch_cell(kind, eid, prop)
                except Exception:
                    # a failed extension/patch must never poison the
                    # cache (every later read would re-raise): fall
                    # back to the full rebuild, which is always valid
                    snap = GraphSnapshot(store)
            else:
                snap = GraphSnapshot(store)
            store.pending_patches.clear()
            # the device the padded adjacency lives on (padded_graph)
            snap.device = self.device
            self._snapshot = snap
            return snap
