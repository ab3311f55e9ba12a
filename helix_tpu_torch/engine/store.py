"""Authoritative host-side graph store.

Single-writer, in-memory row store with incremental adjacency, label
interning, and an index registry.  The TPU never sees this structure —
the interpreter reads device-ready columnar snapshots built from it by
:mod:`helix_tpu.engine.snapshot`, refreshed per mutation epoch (the
TPU-native analog of the reference's LMDB/S3-backed engine storage;
reference topology: single writer + replicated readers, ``README.md:248``).

Node and edge IDs are u64 counters in separate namespaces (reference
``sdks/rust/src/dsl.rs:896-900``).

Port copy of ``helix_tpu/engine/store.py`` for ``helix_tpu_torch``: it
imports the port's own copies of the framework-free modules (wire, dsl,
native, telemetry, fastjson), so importing this module loads nothing of
the JAX package.  ``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in: nothing.
"""

from __future__ import annotations

import bisect
import json
from typing import Any, Iterable

from . import values as V
from .errors import QueryError, WriteError

Tagged = Any


class Node:
    __slots__ = ("id", "label", "props")

    def __init__(self, node_id: int, label: str, props: dict[str, Tagged]):
        self.id = node_id
        self.label = label
        self.props = props


class Edge:
    __slots__ = ("id", "label", "src", "dst", "props")

    def __init__(self, edge_id: int, label: str, src: int, dst: int, props: dict[str, Tagged]):
        self.id = edge_id
        self.label = label
        self.src = src
        self.dst = dst
        self.props = props


def index_key(value: Tagged) -> Any:
    """Hashable index key with cross-tag numeric equality."""
    comp = V.as_comparable(value)
    if comp is not None:
        return comp
    return ("json", json.dumps(V.to_plain(value), sort_keys=True, default=str))


class EqualityIndex:
    """Hash index over one property of one label; optionally unique."""

    def __init__(self, label: str, prop: str, unique: bool):
        self.label = label
        self.prop = prop
        self.unique = unique
        self.buckets: dict[Any, list[int]] = {}

    def insert(self, element_id: int, value: Tagged) -> None:
        key = index_key(value)
        bucket = self.buckets.setdefault(key, [])
        if self.unique and bucket:
            raise WriteError(
                f"unique index violation on {self.label}.{self.prop}: "
                f"{V.to_plain(value)!r} already exists"
            )
        bucket.append(element_id)

    def remove(self, element_id: int, value: Tagged) -> None:
        key = index_key(value)
        bucket = self.buckets.get(key)
        if bucket and element_id in bucket:
            bucket.remove(element_id)
            if not bucket:
                del self.buckets[key]

    def lookup(self, value: Tagged) -> list[int]:
        return list(self.buckets.get(index_key(value), ()))


class RangeIndex:
    """Sorted index over one numeric/string property of one label."""

    def __init__(self, label: str, prop: str, direction: str = "Asc"):
        self.label = label
        self.prop = prop
        self.direction = direction
        self.keys: list[Any] = []       # comparable sort keys
        self.ids: list[int] = []        # parallel element ids

    @staticmethod
    def sort_key(value: Tagged) -> Any:
        comp = V.as_comparable(value)
        if comp is None:
            return None
        return comp

    def insert(self, element_id: int, value: Tagged) -> None:
        key = self.sort_key(value)
        if key is None:
            return
        pos = bisect.bisect_right(self.keys, key)
        self.keys.insert(pos, key)
        self.ids.insert(pos, element_id)

    def remove(self, element_id: int, value: Tagged) -> None:
        key = self.sort_key(value)
        if key is None:
            return
        lo = bisect.bisect_left(self.keys, key)
        hi = bisect.bisect_right(self.keys, key)
        for i in range(lo, hi):
            if self.ids[i] == element_id:
                del self.keys[i]
                del self.ids[i]
                return

    def scan(
        self,
        lo: Tagged | None = None,
        hi: Tagged | None = None,
        lo_strict: bool = False,
        hi_strict: bool = False,
    ) -> list[int]:
        start = 0
        end = len(self.keys)
        if lo is not None:
            key = self.sort_key(lo)
            if key is not None:
                start = (
                    bisect.bisect_right(self.keys, key)
                    if lo_strict
                    else bisect.bisect_left(self.keys, key)
                )
        if hi is not None:
            key = self.sort_key(hi)
            if key is not None:
                end = (
                    bisect.bisect_left(self.keys, key)
                    if hi_strict
                    else bisect.bisect_right(self.keys, key)
                )
        out = self.ids[start:end]
        return out[::-1] if self.direction == "Desc" else out


class IndexDef:
    """A declared index (vector/text carry config, eq/range carry state)."""

    __slots__ = ("spec_tag", "kind", "label", "prop", "unique", "direction",
                 "tenant_property", "impl")

    def __init__(self, spec_tag: str, fields: dict[str, Any]):
        self.spec_tag = spec_tag
        self.kind = "node" if spec_tag.startswith("Node") else "edge"
        self.label = fields["label"]
        self.prop = fields["property"]
        self.unique = bool(fields.get("unique", False))
        self.direction = fields.get("direction", "Asc")
        self.tenant_property = fields.get("tenant_property")
        self.impl: Any = None

    def key(self) -> tuple:
        return (self.spec_tag, self.label, self.prop)


class GraphStore:
    """The single-writer authoritative store."""

    def __init__(self):
        self.nodes: dict[int, Node] = {}
        self.edges: dict[int, Edge] = {}
        self.node_order: list[int] = []
        self.edge_order: list[int] = []
        self.out_adj: dict[int, list[int]] = {}   # node id -> [edge ids]
        self.in_adj: dict[int, list[int]] = {}
        self.nodes_by_label: dict[str, list[int]] = {}
        self.edges_by_label: dict[str, list[int]] = {}
        self._next_node_id = 1
        self._next_edge_id = 1
        self.indexes: dict[tuple, IndexDef] = {}
        self.epoch = 0
        # Structural epoch: bumped by mutations that invalidate slot
        # layout, edges, or existing property values.  Pure node
        # APPENDS (add_node / add_nodes_bulk — the ingest hot path)
        # bump only ``epoch``, letting the snapshot layer extend its
        # arrays instead of rebuilding them per write (at 1M rows a
        # full rebuild costs seconds; an extension costs ~ms).
        self.struct_epoch = 0
        # Property patches since the last snapshot sync: (kind, id,
        # prop) cells the snapshot layer can patch in place instead of
        # rebuilding columns (slots are unaffected by value changes).
        self.pending_patches: list[tuple[str, int, str]] = []
        # Observers (vector/text index managers) notified on writes.
        self._write_hooks: list[Any] = []

    # -- epoch / hooks ------------------------------------------------

    def bump(self) -> None:
        self.epoch += 1
        self.struct_epoch += 1
        self.pending_patches.clear()  # a rebuild covers them

    def bump_patch(self, kind: str, element_id: int, name: str) -> None:
        """Property-value mutation: slot layout and every other column
        stay valid; the snapshot layer patches this one cell."""
        self.epoch += 1
        self.pending_patches.append((kind, element_id, name))
        if len(self.pending_patches) > 20_000:
            # degenerate churn: one rebuild beats 20k cell patches
            self.struct_epoch += 1
            self.pending_patches.clear()

    def bump_append(self) -> None:
        """Append-only mutation (node or edge): snapshot arrays stay
        valid as a prefix (see GraphSnapshot.extended)."""
        self.epoch += 1

    def add_write_hook(self, hook: Any) -> None:
        self._write_hooks.append(hook)

    # -- reads ---------------------------------------------------------

    def node(self, node_id: int) -> Node:
        try:
            return self.nodes[node_id]
        except KeyError:
            raise QueryError(f"unknown node id {node_id}") from None

    def edge(self, edge_id: int) -> Edge:
        try:
            return self.edges[edge_id]
        except KeyError:
            raise QueryError(f"unknown edge id {edge_id}") from None

    def has_node(self, node_id: int) -> bool:
        return node_id in self.nodes

    def has_edge(self, edge_id: int) -> bool:
        return edge_id in self.edges

    def node_count(self) -> int:
        return len(self.nodes)

    def edge_count(self) -> int:
        return len(self.edges)

    # -- index registry -------------------------------------------------

    def create_index(self, spec: dict, if_not_exists: bool) -> None:
        tag = next(iter(spec))
        idx = IndexDef(tag, spec[tag])
        key = idx.key()
        if key in self.indexes:
            if if_not_exists:
                return
            raise WriteError(f"index already exists: {key}")
        if tag == "NodeEquality" or tag == "EdgeEquality":
            idx.impl = EqualityIndex(idx.label, idx.prop, idx.unique)
            self._backfill_scalar(idx)
        elif tag in ("NodeRange", "EdgeRange"):
            idx.impl = RangeIndex(idx.label, idx.prop, idx.direction)
            self._backfill_scalar(idx)
        # Vector/Text index state lives in their managers (write hooks).
        # Hooks run BEFORE registration: a failed backfill (e.g. an
        # existing element missing the tenant property) must not leave
        # a broken index registered — on_index_dropped is idempotent,
        # so unwinding notifies every hook including the one that
        # partially registered before failing.
        try:
            for hook in self._write_hooks:
                hook.on_index_created(self, idx)
        except Exception:
            for hook in self._write_hooks:
                try:
                    hook.on_index_dropped(self, idx)
                except Exception:
                    pass
            raise
        self.indexes[key] = idx
        self.bump()

    def drop_index(self, spec: dict) -> None:
        tag = next(iter(spec))
        idx = IndexDef(tag, spec[tag])
        dropped = self.indexes.pop(idx.key(), None)
        if dropped is not None:
            for hook in self._write_hooks:
                hook.on_index_dropped(self, dropped)
            self.bump()

    def _backfill_scalar(self, idx: IndexDef) -> None:
        elements: Iterable = (
            (self.nodes[i] for i in self.nodes_by_label.get(idx.label, ()))
            if idx.kind == "node"
            else (self.edges[i] for i in self.edges_by_label.get(idx.label, ()))
        )
        for el in elements:
            value = el.props.get(idx.prop)
            if value is not None and not V.is_null(value):
                idx.impl.insert(el.id, value)

    def find_index(self, spec_tag: str, label: str, prop: str) -> IndexDef | None:
        return self.indexes.get((spec_tag, label, prop))

    def scalar_indexes_for(self, kind: str, label: str, prop: str) -> list[IndexDef]:
        tags = ("NodeEquality", "NodeRange") if kind == "node" else ("EdgeEquality", "EdgeRange")
        out = []
        for tag in tags:
            idx = self.indexes.get((tag, label, prop))
            if idx is not None:
                out.append(idx)
        return out

    def _scalar_index_hooks(self, kind: str, label: str):
        for idx in self.indexes.values():
            if idx.kind == kind and idx.label == label and idx.impl is not None:
                yield idx

    # -- writes ----------------------------------------------------------

    def add_node(self, label: str, props: dict[str, Tagged]) -> int:
        node_id = self._next_node_id
        self._next_node_id += 1
        node = Node(node_id, label, dict(props))
        # Index + hook validation first so a failed write leaves no trace.
        # Track successful inserts so a unique violation raised by a LATER
        # index rolls back entries already placed in earlier ones (a leaked
        # phantom entry would permanently reject legitimate values).
        inserted: list[tuple[Any, Tagged]] = []
        try:
            for idx in self._scalar_index_hooks("node", label):
                value = node.props.get(idx.prop)
                if value is not None and not V.is_null(value):
                    idx.impl.insert(node_id, value)
                    inserted.append((idx.impl, value))
            for hook in self._write_hooks:
                hook.on_node_added(self, node)
        except Exception:
            for impl, value in inserted:
                impl.remove(node_id, value)
            # unwind hook effects too: a failure must not leave
            # vector/text entries behind for an id that the next add
            # will REUSE (phantom hits).  ALL hooks are notified — the
            # failing hook itself may have partially applied (one
            # manager serves several indexes) and on_*_dropped is
            # idempotent.
            for hook in self._write_hooks:
                try:
                    hook.on_node_dropped(self, node)
                except Exception:
                    pass
            self._next_node_id -= 1
            raise
        self.nodes[node_id] = node
        self.node_order.append(node_id)
        self.nodes_by_label.setdefault(label, []).append(node_id)
        self.out_adj[node_id] = []
        self.in_adj[node_id] = []
        self.bump_append()
        return node_id

    def add_nodes_bulk(
        self, label: str, props_list: list[dict[str, Tagged]],
        copy_props: bool = True,
    ) -> list[int]:
        """Bulk :meth:`add_node`: one hook dispatch + one bookkeeping
        extend for the whole batch (the ForEach-AddN ingest hot path).

        All-or-nothing like the per-node path: a unique violation or
        hook error anywhere in the batch unwinds every index entry and
        hook effect before re-raising, leaving the store untouched.
        """
        if not props_list:
            return []
        first_id = self._next_node_id
        nodes = [
            Node(first_id + i, label, dict(props) if copy_props else props)
            for i, props in enumerate(props_list)
        ]
        self._next_node_id += len(nodes)
        inserted: list[tuple[Any, int, Tagged]] = []
        hooked: list[Any] = []
        try:
            for idx in self._scalar_index_hooks("node", label):
                for node in nodes:
                    value = node.props.get(idx.prop)
                    if value is not None and not V.is_null(value):
                        idx.impl.insert(node.id, value)
                        inserted.append((idx.impl, node.id, value))
            for hook in self._write_hooks:
                # registered before the call: a hook failing mid-batch may
                # have partially applied, and its removal path is a no-op
                # for ids it never saw
                hooked.append(hook)
                bulk = getattr(hook, "on_nodes_added_bulk", None)
                if bulk is not None:
                    bulk(self, nodes)
                else:
                    for node in nodes:
                        hook.on_node_added(self, node)
        except Exception:
            # counter FIRST: an unwind step raising must not leave the
            # id counter advanced (ids would be skipped forever)
            self._next_node_id = first_id
            for impl, node_id, value in inserted:
                try:
                    impl.remove(node_id, value)
                except Exception:
                    pass  # keep unwinding; the original error surfaces
            for hook in hooked:
                for node in nodes:
                    try:
                        hook.on_node_dropped(self, node)
                    except Exception:
                        pass  # same guard add_node uses: idempotent drops
            raise
        by_label = self.nodes_by_label.setdefault(label, [])
        nodes_map, out_adj, in_adj = self.nodes, self.out_adj, self.in_adj
        for node in nodes:
            node_id = node.id
            nodes_map[node_id] = node
            out_adj[node_id] = []
            in_adj[node_id] = []
        ids = [n.id for n in nodes]
        self.node_order.extend(ids)
        by_label.extend(ids)
        self.bump_append()
        return ids

    def add_edge(self, label: str, src: int, dst: int, props: dict[str, Tagged]) -> int:
        if src not in self.nodes:
            raise QueryError(f"unknown source node id {src}")
        if dst not in self.nodes:
            raise QueryError(f"unknown target node id {dst}")
        edge_id = self._next_edge_id
        self._next_edge_id += 1
        edge = Edge(edge_id, label, src, dst, dict(props))
        inserted: list[tuple[Any, Tagged]] = []
        try:
            for idx in self._scalar_index_hooks("edge", label):
                value = edge.props.get(idx.prop)
                if value is not None and not V.is_null(value):
                    idx.impl.insert(edge_id, value)
                    inserted.append((idx.impl, value))
            for hook in self._write_hooks:
                hook.on_edge_added(self, edge)
        except Exception:
            for impl, value in inserted:
                impl.remove(edge_id, value)
            for hook in self._write_hooks:
                try:
                    hook.on_edge_dropped(self, edge)
                except Exception:
                    pass
            self._next_edge_id -= 1
            raise
        self.edges[edge_id] = edge
        self.edge_order.append(edge_id)
        self.edges_by_label.setdefault(label, []).append(edge_id)
        self.out_adj[src].append(edge_id)
        self.in_adj[dst].append(edge_id)
        self.bump_append()  # edge APPEND: snapshot extends + re-sorts CSR
        return edge_id

    def set_property(self, kind: str, element_id: int, name: str, value: Tagged) -> None:
        el = self.node(element_id) if kind == "node" else self.edge(element_id)
        old = el.props.get(name)
        had_old = old is not None and not V.is_null(old)
        # Each index update is remove(old)+insert(new); a unique violation in
        # a later index (or inside one index's insert) must restore every
        # index already touched, so the whole method is apply-all-or-nothing.
        updated: list[Any] = []
        try:
            for idx in self._scalar_index_hooks(kind, el.label):
                if idx.prop != name:
                    continue
                if had_old:
                    idx.impl.remove(element_id, old)
                try:
                    if not V.is_null(value):
                        idx.impl.insert(element_id, value)
                except Exception:
                    if had_old:
                        idx.impl.insert(element_id, old)
                    raise
                updated.append(idx.impl)
            el.props[name] = value
            try:
                for hook in self._write_hooks:
                    hook.on_property_set(self, kind, el, name, old)
            except Exception:
                if old is None:
                    el.props.pop(name, None)
                else:
                    el.props[name] = old
                # restore hook state from the reverted props: hooks
                # rebuild from current props (remove + reinsert), so a
                # partially-applied hook's removal is undone here —
                # without this, a failed write silently drops the
                # element from its vector/text indexes
                for hook in self._write_hooks:
                    try:
                        hook.on_property_set(self, kind, el, name, value)
                    except Exception:
                        pass
                raise
        except Exception:
            for impl in updated:
                if not V.is_null(value):
                    impl.remove(element_id, value)
                if had_old:
                    impl.insert(element_id, old)
            raise
        self.bump_patch(kind, element_id, name)

    def remove_property(self, kind: str, element_id: int, name: str) -> None:
        el = self.node(element_id) if kind == "node" else self.edge(element_id)
        old = el.props.pop(name, None)
        had_old = old is not None and not V.is_null(old)
        if had_old:
            for idx in self._scalar_index_hooks(kind, el.label):
                if idx.prop == name:
                    idx.impl.remove(element_id, old)
        try:
            for hook in self._write_hooks:
                hook.on_property_set(self, kind, el, name, old)
        except Exception:
            # all-or-nothing like set_property: restore the property,
            # its scalar entries, and hook state before re-raising
            if old is not None:
                el.props[name] = old
            if had_old:
                for idx in self._scalar_index_hooks(kind, el.label):
                    if idx.prop == name:
                        idx.impl.insert(element_id, old)
            for hook in self._write_hooks:
                try:
                    hook.on_property_set(self, kind, el, name, None)
                except Exception:
                    pass
            raise
        self.bump_patch(kind, element_id, name)

    def _drop_edges_batched(self, node_id: int, incident: list[int]) -> None:
        """Drop a high-degree node's incident edges with ONE pass over
        edge_order / each affected label list, instead of an O(E)
        ``list.remove`` per edge (dropping a 10k-degree node in a
        1M-edge graph was quadratic — minutes for one DropN)."""
        dead = set(incident)
        dead_by_label: dict[str, set[int]] = {}
        for edge_id in incident:
            edge = self.edges.pop(edge_id, None)
            if edge is None:
                continue
            dead_by_label.setdefault(edge.label, set()).add(edge_id)
            # adjacency on the OTHER endpoint (this node's lists are
            # popped wholesale by drop_node)
            if edge.src != node_id and edge.src in self.out_adj:
                self.out_adj[edge.src].remove(edge_id)
            if edge.dst != node_id and edge.dst in self.in_adj:
                self.in_adj[edge.dst].remove(edge_id)
            for idx in self._scalar_index_hooks("edge", edge.label):
                value = edge.props.get(idx.prop)
                if value is not None and not V.is_null(value):
                    idx.impl.remove(edge_id, value)
            for hook in self._write_hooks:
                hook.on_edge_dropped(self, edge)
        self.edge_order = [e for e in self.edge_order if e not in dead]
        for label, ids in dead_by_label.items():
            self.edges_by_label[label] = [
                e for e in self.edges_by_label[label] if e not in ids
            ]

    def drop_edge(self, edge_id: int) -> None:
        edge = self.edges.pop(edge_id, None)
        if edge is None:
            return
        self.edge_order.remove(edge_id)
        self.edges_by_label[edge.label].remove(edge_id)
        if edge.src in self.out_adj:
            self.out_adj[edge.src].remove(edge_id)
        if edge.dst in self.in_adj:
            self.in_adj[edge.dst].remove(edge_id)
        for idx in self._scalar_index_hooks("edge", edge.label):
            value = edge.props.get(idx.prop)
            if value is not None and not V.is_null(value):
                idx.impl.remove(edge_id, value)
        for hook in self._write_hooks:
            hook.on_edge_dropped(self, edge)
        self.bump()

    def drop_node(self, node_id: int) -> None:
        node = self.nodes.get(node_id)
        if node is None:
            return
        incident = list(dict.fromkeys(
            list(self.out_adj.get(node_id, ()))
            + list(self.in_adj.get(node_id, ()))
        ))
        if len(incident) > 64:
            self._drop_edges_batched(node_id, incident)
        else:
            for edge_id in incident:
                self.drop_edge(edge_id)
        self.nodes.pop(node_id)
        self.node_order.remove(node_id)
        self.nodes_by_label[node.label].remove(node_id)
        self.out_adj.pop(node_id, None)
        self.in_adj.pop(node_id, None)
        for idx in self._scalar_index_hooks("node", node.label):
            value = node.props.get(idx.prop)
            if value is not None and not V.is_null(value):
                idx.impl.remove(node_id, value)
        for hook in self._write_hooks:
            hook.on_node_dropped(self, node)
        self.bump()

    # -- transactional undo primitives -----------------------------------
    #
    # Write batches execute as one transaction (reference semantics:
    # dsl.rs:4443-4474).  The executor records an inverse op for every
    # mutation; on failure it replays them in reverse via these raw
    # primitives, then restores the id counters.  Restored elements land at
    # the end of order/adjacency lists, which preserves set semantics (a
    # rolled-back batch leaves no observable trace since everything newer
    # was also undone).

    def save_counters(self) -> tuple[int, int]:
        return (self._next_node_id, self._next_edge_id)

    def restore_counters(self, saved: tuple[int, int]) -> None:
        self._next_node_id, self._next_edge_id = saved

    def raw_remove_node(self, node_id: int) -> None:
        node = self.nodes.pop(node_id, None)
        if node is None:
            return
        self.node_order.remove(node_id)
        self.nodes_by_label[node.label].remove(node_id)
        self.out_adj.pop(node_id, None)
        self.in_adj.pop(node_id, None)
        for idx in self._scalar_index_hooks("node", node.label):
            value = node.props.get(idx.prop)
            if value is not None and not V.is_null(value):
                idx.impl.remove(node_id, value)
        for hook in self._write_hooks:
            hook.on_node_dropped(self, node)
        self.bump()

    def raw_restore_node(self, node: Node) -> None:
        if node.id in self.nodes:
            # idempotent: rollback may replay a restore for an element
            # that a partially-failed batched drop never removed
            return
        self.nodes[node.id] = node
        self.node_order.append(node.id)
        self.nodes_by_label.setdefault(node.label, []).append(node.id)
        self.out_adj.setdefault(node.id, [])
        self.in_adj.setdefault(node.id, [])
        for idx in self._scalar_index_hooks("node", node.label):
            value = node.props.get(idx.prop)
            if value is not None and not V.is_null(value):
                idx.impl.insert(node.id, value)
        for hook in self._write_hooks:
            hook.on_node_added(self, node)
        self.bump()

    def raw_remove_edge(self, edge_id: int) -> None:
        self.drop_edge(edge_id)

    def raw_restore_edge(self, edge: Edge) -> None:
        if edge.id in self.edges:
            return  # idempotent; see raw_restore_node
        self.edges[edge.id] = edge
        self.edge_order.append(edge.id)
        self.edges_by_label.setdefault(edge.label, []).append(edge.id)
        # membership-checked appends: a drop that failed between its
        # own adjacency removals must not leave duplicates on restore
        out_bucket = self.out_adj.setdefault(edge.src, [])
        if edge.id not in out_bucket:
            out_bucket.append(edge.id)
        in_bucket = self.in_adj.setdefault(edge.dst, [])
        if edge.id not in in_bucket:
            in_bucket.append(edge.id)
        for idx in self._scalar_index_hooks("edge", edge.label):
            value = edge.props.get(idx.prop)
            if value is not None and not V.is_null(value):
                idx.impl.insert(edge.id, value)
        for hook in self._write_hooks:
            hook.on_edge_added(self, edge)
        self.bump()

    def raw_restore_prop(
        self, kind: str, element_id: int, name: str, old: Tagged | None
    ) -> None:
        """Restore a property to ``old`` (None = was absent)."""
        el = self.node(element_id) if kind == "node" else self.edge(element_id)
        current = el.props.get(name)
        for idx in self._scalar_index_hooks(kind, el.label):
            if idx.prop != name:
                continue
            if current is not None and not V.is_null(current):
                idx.impl.remove(element_id, current)
            if old is not None and not V.is_null(old):
                idx.impl.insert(element_id, old)
        if old is None:
            el.props.pop(name, None)
        else:
            el.props[name] = old
        for hook in self._write_hooks:
            hook.on_property_set(self, kind, el, name, current)
        self.bump()
