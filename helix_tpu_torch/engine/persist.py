"""Durability: snapshot store + logical WAL replay.

Disk mode (the rebuild's analog of the reference's S3-backed engine
storage, ``local_runtime.rs:20-26``, ``:773-786``): the authoritative
store checkpoints to a snapshot file, and every committed write batch is
appended to the native WAL (``helix_tpu/native/wal.cpp``) as a *logical*
record — the serialized write request plus its evaluation clock, so
``Timestamp``/``DateTimeNow`` expressions replay deterministically.

Startup: load the newest snapshot, then re-execute surviving WAL records.
Checkpoint: atomically replace the snapshot, then truncate the WAL.

Write-path ordering: the record is appended *after* the batch commits in
memory but *before* the client is acknowledged; a crash in the window
loses only unacknowledged writes.  ``x-helix-await-durable: false``
(reference ``lib.rs:292-298``) skips the per-record fsync.

Port copy of ``helix_tpu/engine/persist.py`` for ``helix_tpu_torch``:
it logs to the port's own WAL (``helix_tpu_torch/native/wal.cpp``, a
byte copy of the reference's).  A snapshot holds plain containers,
scalars and numpy arrays only, never a torch tensor (the device copies
are rebuilt from the host rows after recovery), so a data dir written
by either package recovers in the other.
``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:
"""

from __future__ import annotations

import array
import hashlib
import io
import logging
import os
import pickle
from pathlib import Path
from typing import Any

from ..native import Wal, replay

SNAPSHOT_NAME = "snapshot.bin"
WAL_NAME = "wal.log"
SNAPSHOT_VERSION = 2
# Known-loadable versions (2 adds the WAL watermark; 1 lacks it and
# replays the whole WAL, the pre-watermark behavior).
SNAPSHOT_VERSIONS = (1, 2)

# On-disk framing: magic + sha256(payload) + pickled payload.  The digest
# makes torn/corrupted checkpoints fail loudly instead of feeding garbage
# to the unpickler; files without the magic are legacy bare pickles.
_SNAPSHOT_MAGIC = b"HXSNAP02"


def frame_snapshot_blob(payload_blob: bytes) -> bytes:
    return _SNAPSHOT_MAGIC + hashlib.sha256(payload_blob).digest() + payload_blob


def read_snapshot_blob(blob: bytes) -> Any:
    """Parse a snapshot blob (framed or legacy) with a restricted
    unpickler — a tampered snapshot raises instead of executing code."""
    if blob[: len(_SNAPSHOT_MAGIC)] == _SNAPSHOT_MAGIC:
        digest = blob[len(_SNAPSHOT_MAGIC) : len(_SNAPSHOT_MAGIC) + 32]
        payload = blob[len(_SNAPSHOT_MAGIC) + 32 :]
        if hashlib.sha256(payload).digest() != digest:
            raise RuntimeError("snapshot checksum mismatch (corrupted file)")
        return restricted_loads(payload)
    return restricted_loads(blob)


def read_snapshot_file(path: str | Path) -> Any:
    """Streaming variant of :func:`read_snapshot_blob` for on-disk
    snapshots: hash in a first chunked pass, then unpickle straight from
    the file handle.  Peak memory is the unpickled objects, not
    2x-the-blob (a multi-GB snapshot must not need its own size again
    just to start up)."""
    with open(path, "rb") as fh:
        head = fh.read(len(_SNAPSHOT_MAGIC))
        if head != _SNAPSHOT_MAGIC:
            fh.seek(0)
            return restricted_load(fh)  # legacy bare pickle
        digest = fh.read(32)
        hasher = hashlib.sha256()
        while True:
            chunk = fh.read(1 << 22)
            if not chunk:
                break
            hasher.update(chunk)
        if hasher.digest() != digest:
            raise RuntimeError("snapshot checksum mismatch (corrupted file)")
        fh.seek(len(_SNAPSHOT_MAGIC) + 32)
        return restricted_load(fh)


#: pickle globals a snapshot is allowed to reference: plain containers,
#: scalars, and numpy arrays only (vector blocks).  Anything else —
#: i.e. any smuggled callable — raises UnpicklingError.
_ALLOWED_PICKLE_GLOBALS = {
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    # fast-parsed vector payloads ({"F64Array": array('d', ...)})
    ("array", "array"),
    ("array", "_array_reconstructor"),
}


def restricted_load(fileobj) -> Any:
    """Streaming restricted unpickle from a file-like object (a replica
    seed can be GBs — never require the full byte string in memory)."""
    allowed = _ALLOWED_PICKLE_GLOBALS

    class Restricted(pickle.Unpickler):
        def find_class(self, module, name):
            if (module, name) in allowed:
                return super().find_class(module, name)
            raise pickle.UnpicklingError(
                f"snapshot contains forbidden global {module}.{name}"
            )

    return Restricted(fileobj).load()


def restricted_loads(data: bytes) -> Any:
    return restricted_load(io.BytesIO(data))


class Persistence:
    def __init__(self, data_dir: str | Path, snapshot_store: Any = None):
        self.dir = Path(data_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.snapshot_path = self.dir / SNAPSHOT_NAME
        self.wal_path = self.dir / WAL_NAME
        self.wal: Wal | None = None
        # Optional object-store mirror (reference: S3-backed engine
        # storage, local_runtime.rs:20-26).  Checkpoints upload there;
        # a node with no local snapshot bootstraps from it.
        if isinstance(snapshot_store, str):
            from .objstore import open_store

            snapshot_store = open_store(snapshot_store)
        self.snapshot_store = snapshot_store
        # Mirror health: a flaky object store must not fail the write
        # path, but silent staleness turns a later bootstrap-from-mirror
        # into silent data loss — so failures are logged and surfaced
        # (``/v1/health`` reports these).
        self.mirror_failures = 0
        self.mirror_error: str | None = None
        # Monotonic WAL record sequence; persists across restarts through
        # recover().  The snapshot records the last sequence it contains
        # (its watermark) so a crash between snapshot-replace and
        # WAL-truncate cannot double-apply records on the next start.
        self._seq = 0

    # -- startup -----------------------------------------------------------

    def recover(self, engine: Any) -> int:
        """Load snapshot + replay surviving WAL records into the engine.
        Records at or below the snapshot's watermark are already inside
        the snapshot and are skipped.  Returns the number of replayed
        write batches."""
        watermark = 0
        payload = None
        if self.snapshot_path.exists():
            payload = read_snapshot_file(self.snapshot_path)
        elif self.snapshot_store is not None:
            from .objstore import SNAPSHOT_KEY

            blob = self.snapshot_store.get(SNAPSHOT_KEY)
            if blob is not None:
                payload = read_snapshot_blob(blob)
        if payload is not None:
            restore_snapshot_payload(engine, payload)
            watermark = int(payload.get("wal_seq", 0))
        self._seq = watermark
        replayed = 0
        if self.wal_path.exists():
            from .. import fastjson

            for record in replay(self.wal_path):
                # Native codec with the boxing-free array path: a WAL
                # full of bulk-ingest ForEach bodies replays at codec
                # speed and feeds exec.py's fast_arrays ingest path,
                # matching the follower feed (replication.Follower).
                entry = fastjson.loads(record, fast_arrays=True)
                seq = entry.get("seq")
                if seq is not None:
                    if seq <= watermark:
                        continue  # already inside the snapshot
                    self._seq = max(self._seq, seq)
                else:
                    # Legacy record without a sequence: replay (legacy
                    # snapshots carry no watermark, so watermark == 0).
                    self._seq += 1
                engine.apply_logged_write(
                    entry["request"], entry["now_ms"],
                    request_bytes=len(record),
                )
                replayed += 1
        self.wal = Wal(self.wal_path)
        return replayed

    # -- write path ---------------------------------------------------------

    def log_write(self, request: dict, now_ms: int, sync: bool = True) -> None:
        assert self.wal is not None, "recover() must run before writes"
        self._seq += 1
        from .. import fastjson

        record = fastjson.dumpb(
            {"seq": self._seq, "now_ms": now_ms, "request": request},
            compact=True,
        )
        self.wal.append(record, sync=sync)

    # -- checkpoint ---------------------------------------------------------

    def checkpoint(self, engine: Any) -> None:
        payload = build_snapshot_payload(engine)
        payload["wal_seq"] = self._seq
        blob = frame_snapshot_blob(pickle.dumps(payload, protocol=5))
        tmp = self.snapshot_path.with_suffix(".tmp")
        with open(tmp, "wb") as fh:
            fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.snapshot_path)
        if self.snapshot_store is not None:
            from .objstore import SNAPSHOT_KEY

            try:
                self.snapshot_store.put(SNAPSHOT_KEY, blob)
                self.mirror_error = None
            except Exception as exc:
                # The local checkpoint is authoritative; a flaky mirror
                # must not fail the write path — but it must be visible.
                self.mirror_failures += 1
                self.mirror_error = str(exc)
                logging.getLogger("helix_tpu.persist").warning(
                    "snapshot mirror upload failed (%d so far): %s",
                    self.mirror_failures, exc,
                )
        if self.wal is not None:
            self.wal.reset()

    def close(self) -> None:
        if self.wal is not None:
            self.wal.close()
            self.wal = None


def build_snapshot_payload(engine: Any) -> dict:
    """Serializable snapshot of the engine's authoritative state.

    Used both for disk checkpoints and for replica seeding over
    ``GET /v1/snapshot``.  The caller must hold a lock that excludes
    writers (either side of the engine's RW lock works)."""
    store = engine.store
    extractor = _VectorExtractor()
    nodes_map, edges_map = store.nodes, store.edges
    strip = extractor.strip
    return {
        "version": SNAPSHOT_VERSION,
        "routes": engine.routes,
        "source_snapshot": engine.source_snapshot,
        "nodes": [
            (nid, (node := nodes_map[nid]).label, strip(node.props))
            for nid in store.node_order
        ],
        "edges": [
            (
                eid,
                (edge := edges_map[eid]).label,
                edge.src,
                edge.dst,
                strip(edge.props),
            )
            for eid in store.edge_order
        ],
        "vector_blocks": extractor.blocks(),
        "counters": store.save_counters(),
        "index_specs": [
            {defn.spec_tag: _spec_fields(defn)}
            for defn in store.indexes.values()
        ],
    }


def restore_snapshot_payload(engine: Any, payload: dict) -> None:
    """Rebuild engine state from :func:`build_snapshot_payload` output.

    The engine's store must be empty; index specs re-create through the
    normal path so scalar index state is rebuilt and the vector/text
    managers backfill via their write hooks."""
    from .store import Edge, Node

    if payload.get("version") not in SNAPSHOT_VERSIONS:
        raise RuntimeError(
            f"unsupported snapshot version {payload.get('version')}"
        )
    rehydrate = _VectorRehydrator(payload.get("vector_blocks", {}))
    store = engine.store
    # Bound-method / comprehension forms: the per-row loop with
    # attribute lookups was the restart hot spot after rehydration
    # (200k Node objects) — batch the container updates instead.
    node_rows = payload["nodes"]
    props_of = rehydrate.props
    store.nodes.update(
        (nid, Node(nid, label, props_of(props)))
        for nid, label, props in node_rows
    )
    store.node_order.extend(r[0] for r in node_rows)
    store.out_adj.update((r[0], []) for r in node_rows)
    store.in_adj.update((r[0], []) for r in node_rows)
    by_label = store.nodes_by_label
    for nid, label, _ in node_rows:
        bucket = by_label.get(label)
        if bucket is None:
            bucket = by_label[label] = []
        bucket.append(nid)
    edge_rows = payload["edges"]
    store.edges.update(
        (eid, Edge(eid, label, src, dst, props_of(props)))
        for eid, label, src, dst, props in edge_rows
    )
    store.edge_order.extend(r[0] for r in edge_rows)
    e_by_label = store.edges_by_label
    out_adj, in_adj = store.out_adj, store.in_adj
    for eid, label, src, dst, _ in edge_rows:
        bucket = e_by_label.get(label)
        if bucket is None:
            bucket = e_by_label[label] = []
        bucket.append(eid)
        out_adj[src].append(eid)
        in_adj[dst].append(eid)
    store._next_node_id, store._next_edge_id = payload["counters"]
    for spec in payload["index_specs"]:
        store.create_index(spec, if_not_exists=True)
    store.bump()
    engine.routes = payload.get("routes", {})
    engine.source_snapshot = payload.get("source_snapshot", {"files": {}})


# Vector properties at/above this length are extracted into stacked
# numpy blocks in the checkpoint.  Measured at 200k x 128-d: snapshot
# size 235 MB -> 107 MB (F32Array stores at its contractual f32 width);
# CPU cost is a wash (the rehydration tolist() offsets the pickle
# savings), so the win is disk/IO footprint.
VECTOR_EXTRACT_MIN_LEN = 8

_VECTOR_TAGS = {"F32Array": "f32", "F64Array": "f64"}
_REF_KEY = "__hxvec__"


class _VectorExtractor:
    """Strips long numeric-array property values into grouped matrices."""

    def __init__(self):
        import numpy as np

        self._np = np
        self._groups: dict[tuple, list] = {}

    def strip(self, props: dict) -> dict:
        out = None
        for name, value in props.items():
            if not isinstance(value, dict) or len(value) != 1:
                continue
            tag = next(iter(value))
            kind = _VECTOR_TAGS.get(tag)
            if kind is None:
                continue
            # Bulk-ingest fast path stores vectors as array.array
            # (exec.py fast_arrays), interactive writes as lists; both
            # must hit the stacked-block compaction.
            vec = value[tag]
            if (
                not isinstance(vec, (list, array.array))
                or len(vec) < VECTOR_EXTRACT_MIN_LEN
            ):
                continue
            key = (tag, len(vec))
            rows = self._groups.setdefault(key, [])
            rows.append(vec)
            if out is None:
                out = dict(props)
            out[name] = {_REF_KEY: [tag, len(vec), len(rows) - 1]}
        return out if out is not None else props

    def blocks(self) -> dict:
        dtype = {"F32Array": self._np.float32, "F64Array": self._np.float64}
        return {
            key: self._np.asarray(rows, dtype[key[0]])
            for key, rows in self._groups.items()
        }


class _VectorRehydrator:
    """Re-inflates vector references from the stacked matrices.

    Rows come back as ``array.array('d')`` carved out of the block's
    f64 byte buffer — a memcpy per row instead of the per-element
    boxing ``ndarray.tolist`` pays (this was the restart hot spot at
    200k+ vectors; f32 blocks widen losslessly, so the observable
    values match what ``tolist`` produced).  Mutates the props dict in
    place: extracted rows always live in dicts ``_VectorExtractor.strip``
    created (or the unpickler did), never in a caller's live store."""

    def __init__(self, blocks: dict):
        import numpy as np

        self._np = np
        self._blocks = blocks
        self._bufs: dict[tuple, memoryview] = {}

    def props(self, props: dict) -> dict:
        for name, value in props.items():
            if not (isinstance(value, dict) and _REF_KEY in value):
                continue
            tag, width, row = value[_REF_KEY]
            key = (tag, width)
            buf = self._bufs.get(key)
            if buf is None:
                block = self._np.ascontiguousarray(
                    self._blocks[key], self._np.float64
                )
                buf = self._bufs[key] = memoryview(block.tobytes())
            vec = array.array("d")
            vec.frombytes(buf[row * width * 8 : (row + 1) * width * 8])
            props[name] = {tag: vec}
        return props


def _spec_fields(defn: Any) -> dict:
    fields: dict[str, Any] = {"label": defn.label, "property": defn.prop}
    if defn.spec_tag.endswith("Equality"):
        # Edge equality too: the wire layer accepts {"EdgeEquality":
        # {..., "unique": true}} and IndexDef enforces it, so dropping
        # the flag here would silently un-unique the index across a
        # checkpoint/restore or replica seed.
        fields["unique"] = defn.unique
    if defn.spec_tag.endswith("Range") and defn.direction != "Asc":
        fields["direction"] = defn.direction
    if defn.tenant_property is not None:
        fields["tenant_property"] = defn.tenant_property
    return fields
