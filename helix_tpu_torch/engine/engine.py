"""Engine facade: one database instance.

Wires the store, snapshot cache, vector/text index managers, persistence,
and the executor together, and exposes the entry points the serving layer
needs: :meth:`execute` (dynamic requests, ``POST /v1/query``),
:meth:`execute_stored` (deployed routes, ``POST /v1/query/<name>``), and
:meth:`checkpoint` (disk-mode snapshot + WAL truncation).

Port of ``helix_tpu/engine/engine.py`` for ``helix_tpu_torch``: the
engine holds an explicit ``torch.device`` (``"cuda"`` unless told
otherwise; the CPU tests pass ``"cpu"``) and hands it to the vector
indexes (with the residency ladder's knobs, ``hbm_budget_bytes`` and
``quant_candidates``), to the snapshot cache (the padded adjacency of
device traversal) and to the text indexes (device BM25 postings).
Disk mode (``data_dir``, ``snapshot_store``) and replica seeds are the
reference's code: a snapshot holds host state only, and the first search
after recovery rebuilds the device arrays.  The mesh knobs
(``shard_threshold``, ``graph_shard_threshold``) pass on as in the
reference; their paths engage where the mesh over the engine's device
type (``parallel/mesh.py``) holds more than one device.
``tests/test_torch_engine_copy.py`` holds the rest of the code equal to
the reference's.

Differs from the reference in:

- ``Engine.__init__``: takes ``device`` and hands it down; makes the
  traversal router, device first when the device is CUDA.
- ``Engine.load_replica_seed``: the new snapshot cache gets the engine's
  device.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from .. import wire
from ..telemetry import NullTelemetry, Telemetry
from ..dsl import load_query_bundle
from .errors import EngineError, QueryError, WriteError
from .exec import Executor
from .rwlock import RWLock
from .snapshot import SnapshotCache
from .store import GraphStore
from .text import TextManager
from .vector import VectorManager

# Write batches containing any of these steps reclaim space and stay
# allowed above the capacity envelope (so a full database can be
# shrunk back under its cap).
_RECLAIM_TAGS = frozenset(
    {
        "Drop",
        "DropEdge",
        "DropEdgeLabeled",
        "DropEdgeById",
        "DropIndex",
        "RemoveProperty",
    }
)

# Rows sampled per footprint re-estimate (engine.approx_data_bytes).
_SIZE_SAMPLE = 512


def _has_reclaim_step(entries: Any) -> bool:
    """Recursive key scan for reclaim steps (same discipline as the
    executor's ``_has_invalidating_steps``): a false positive only
    relaxes the envelope for one batch, never correctness."""
    stack = [entries]
    while stack:
        item = stack.pop()
        if isinstance(item, dict):
            for key, val in item.items():
                if key in _RECLAIM_TAGS:
                    return True
                stack.append(val)
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
        elif isinstance(item, str) and item in _RECLAIM_TAGS:
            return True
    return False


def _tagged_bytes(value: Any) -> int:
    """Approximate payload bytes of one tagged property value."""
    if not isinstance(value, dict) or len(value) != 1:
        return 16
    tag = next(iter(value))
    payload = value[tag]
    if tag == "F32Array":
        return 16 + 4 * len(payload)
    if tag in ("F64Array", "I64Array"):
        return 16 + 8 * len(payload)
    if tag in ("String", "Bytes"):
        return 16 + len(payload)
    if tag == "StringArray":
        return 16 + sum(len(s) + 8 for s in payload)
    if tag == "Array":
        return 16 + sum(_tagged_bytes(v) for v in payload)
    if tag == "Object" and isinstance(payload, dict):
        return 16 + sum(
            len(k) + _tagged_bytes(v) for k, v in payload.items()
        )
    return 16


class Engine:
    def __init__(
        self,
        device: str | torch.device = "cuda",
        metric: str = "cosine",
        data_dir: str | None = None,
        batch_window_ms: float | None = None,
        shard_threshold: int | None = None,
        hbm_budget_bytes: int | None = None,
        bm25: bool = True,
        secondary_indices: list[str] | None = None,
        snapshot_store: str | None = None,
        graph_shard_threshold: int | None = None,
        quant_candidates: int | None = None,
        max_size_bytes: int | None = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Engine(device='cuda') but torch sees no CUDA device; pass "
                "device='cpu' to run on the host"
            )
        self.store = GraphStore()
        self.snapshots = SnapshotCache(self.store, device=self.device)
        self.vectors = VectorManager(
            metric=metric, batch_window_ms=batch_window_ms,
            shard_threshold=shard_threshold,
            hbm_budget_bytes=hbm_budget_bytes,
            quant_candidates=quant_candidates,
            device=self.device,
        )
        self.texts = TextManager(device=self.device)
        from .exec import TraversalRouter

        self._traversal_router = TraversalRouter(
            device_first=self.device.type == "cuda"
        )
        self.store.add_write_hook(self.vectors)
        self.store.add_write_hook(self.texts)
        # Single-writer semantics with shared readers (reference topology
        # README.md:248): reads run concurrently, write batches exclusive.
        self._rwlock = RWLock()
        self.routes: dict[str, dict] = {}  # name -> {kind, query, parameters}
        # Deployed source snapshot for push/sync reconciliation.
        self.source_snapshot: dict = {"files": {}}
        self.telemetry: Telemetry = NullTelemetry()
        # Primary-side replication ring (read-replica shipping); must exist
        # before recovery, which re-feeds recovered writes into it.
        from .replication import ReplicationLog

        self.replication = ReplicationLog()
        self.persistence = None
        if data_dir is not None:
            from .persist import Persistence

            self.persistence = Persistence(data_dir, snapshot_store=snapshot_store)
            self.persistence.recover(self)
        self._writes_since_checkpoint = 0
        self.checkpoint_every = 10_000  # write batches between auto-checkpoints
        # Multi-chip graph scale-out (parallel/graph.py): traversals over
        # snapshots at/above this node count route to the edge-partitioned
        # sharded executor when a device mesh is present.  Opt-in, like
        # the vector shard_threshold.
        self.graph_shard_threshold = graph_shard_threshold
        self.bm25_enabled = bm25
        # Capacity envelope (reference ``db_max_size_gb``,
        # helix-cli/src/config.rs:203-205): an approximate cap on the
        # authoritative dataset footprint.  When the estimate exceeds
        # it, write batches are rejected unless they contain a reclaim
        # step (drops / RemoveProperty), so a full database can still
        # be shrunk back under the cap.  Reads are never affected.
        self.max_size_bytes = max_size_bytes
        self._size_estimate_bytes = 0
        self._size_estimate_rows = -1
        # DbConfig.graph_config.secondary_indices (reference
        # config.rs:148-226): "Label.property" equality indexes created
        # at boot.
        for entry in secondary_indices or []:
            label, _, prop = entry.partition(".")
            if label and prop:
                self.store.create_index(
                    {"NodeEquality": {"label": label, "property": prop,
                                      "unique": False}},
                    if_not_exists=True,
                )

    # -- dynamic requests ------------------------------------------------

    def execute(
        self, request: dict, await_durable: bool = True, trace: bool = False,
        request_bytes: int | None = None,
    ) -> dict:
        executor = Executor(self)
        steps_trace: list | None = [] if trace else None
        query_name = request.get("query_name") if isinstance(request, dict) else None
        request_type = (
            request.get("request_type", "?") if isinstance(request, dict) else "?"
        )
        start = time.perf_counter()
        try:
            if isinstance(request, dict) and request.get("request_type") == "write":
                now_ms = int(time.time() * 1000)
                with self._rwlock.write():
                    if self.max_size_bytes is not None:
                        self._enforce_capacity(request)
                    result = executor.execute(
                        request, now_ms=now_ms, trace=steps_trace
                    )
                    # Reclaim steps shrink the footprint without
                    # necessarily moving row counts past the sampling
                    # drift threshold (RemoveProperty moves none):
                    # invalidate so /v1/health headroom and the next
                    # capacity check see the reclaimed bytes.
                    if self.max_size_bytes is not None and _has_reclaim_step(
                        request.get("query")
                    ):
                        self._size_estimate_rows = -1
                    # durability BEFORE shipping: a record a follower
                    # can fetch must already be in the WAL, or a crash
                    # in between leaves the replica ahead of a primary
                    # that forgot the write
                    if self.persistence is not None:
                        self.persistence.log_write(
                            request, now_ms, sync=await_durable
                        )
                    self.replication.append(
                        request, now_ms, approx_bytes=request_bytes
                    )
                    if self.persistence is not None:
                        self._writes_since_checkpoint += 1
                        if self._writes_since_checkpoint >= self.checkpoint_every:
                            self._checkpoint_unlocked()
            else:
                with self._rwlock.read():
                    result = executor.execute(request, trace=steps_trace)
        except wire.WireError as exc:
            self.telemetry.query_event(
                False, query_name, request_type,
                int((time.perf_counter() - start) * 1e6), error=str(exc),
            )
            raise QueryError(str(exc)) from exc
        except EngineError as exc:
            self.telemetry.query_event(
                False, query_name, request_type,
                int((time.perf_counter() - start) * 1e6), error=str(exc),
            )
            raise
        except (TypeError, KeyError, IndexError, ValueError, AttributeError) as exc:
            # Malformed payload shapes that slip past wire validation must
            # surface as 400-class query errors, not internal crashes.
            self.telemetry.query_event(
                False, query_name, request_type,
                int((time.perf_counter() - start) * 1e6), error=str(exc),
            )
            raise QueryError(
                f"malformed query: {type(exc).__name__}: {exc}"
            ) from exc
        except Exception as exc:
            self.telemetry.query_event(
                False, query_name, request_type,
                int((time.perf_counter() - start) * 1e6), error=str(exc),
            )
            raise
        elapsed_us = int((time.perf_counter() - start) * 1e6)
        self.telemetry.query_event(True, query_name, request_type, elapsed_us)
        if steps_trace is not None:
            result["$trace"] = {
                "time_taken_usec": elapsed_us,
                "query_name": query_name,
                "steps": steps_trace,
            }
        return result

    # -- capacity envelope -------------------------------------------------

    def approx_data_bytes(self) -> int:
        """Approximate authoritative dataset footprint in bytes.

        Sampled estimate: the most recent ``_SIZE_SAMPLE`` nodes/edges
        give an average row size, scaled by the row counts (vector
        properties dominate real corpora and are counted exactly per
        sampled row).  Refreshes lazily once rows drift ~1.5% past the
        last estimate, so the ingest hot path pays nothing between
        refreshes.  This is an envelope guard, not an allocator — the
        reference's ``db_max_size_gb`` is the same class of cap."""
        store = self.store
        rows = len(store.nodes) + len(store.edges)
        # Refresh floor of 128 rows keeps small capacity envelopes
        # honest (1024 heavy rows can be several times a sub-MB cap);
        # at scale the relative rows//64 term dominates anyway.
        if self._size_estimate_rows >= 0 and abs(
            rows - self._size_estimate_rows
        ) < max(128, self._size_estimate_rows // 64):
            return self._size_estimate_bytes
        total = 0
        for order, table, base in (
            (store.node_order, store.nodes, 24),
            (store.edge_order, store.edges, 40),
        ):
            count = len(order)
            if not count:
                continue
            sample = order[-_SIZE_SAMPLE:]
            sampled = 0
            for eid in sample:
                element = table.get(eid)
                if element is None:
                    continue
                sampled += base + sum(
                    len(name) + _tagged_bytes(value)
                    for name, value in element.props.items()
                )
            total += (sampled * count) // len(sample)
        self._size_estimate_bytes = total
        self._size_estimate_rows = rows
        return total

    def _enforce_capacity(self, request: dict) -> None:
        """Reject non-reclaiming write batches past the size envelope.
        Caller holds the writer lock."""
        if self.approx_data_bytes() <= self.max_size_bytes:
            return
        if _has_reclaim_step(request.get("query")):
            return
        # The cached estimate may be stale-high: reclaims that slipped
        # under the row-drift threshold (or prior out-of-band
        # invalidation misses) must not wedge the instance in a
        # permanent over-cap reject loop.  Recompute once before
        # rejecting — the cost is paid only on the reject path.
        self._size_estimate_rows = -1
        if self.approx_data_bytes() <= self.max_size_bytes:
            return
        gb = self.max_size_bytes / float(1 << 30)
        raise WriteError(
            f"database size limit exceeded (db_max_size_gb={gb:g}, "
            f"~{self._size_estimate_bytes} bytes resident); drop data "
            "or raise db_max_size_gb"
        )

    def apply_logged_write(
        self, request: dict, now_ms: int, request_bytes: int | None = None
    ) -> None:
        """Re-execute a WAL record during recovery (no re-logging)."""
        Executor(self).execute(request, now_ms=now_ms)
        self.replication.append(request, now_ms, approx_bytes=request_bytes)

    def apply_replicated(
        self, request: dict, now_ms: int, request_bytes: int | None = None
    ) -> None:
        """Apply a primary's record on a replica (exclusive, no re-log)."""
        with self._rwlock.write():
            Executor(self).execute(request, now_ms=now_ms)
            self.replication.append(
                request, now_ms, approx_bytes=request_bytes
            )

    def export_replica_seed(self) -> dict:
        """Consistent snapshot + replication watermark for seeding a
        replica that is behind the primary's record ring.  Shared lock:
        writes are exclusive, so the seq and the payload agree."""
        from .persist import build_snapshot_payload

        with self._rwlock.read():
            return {
                "seed_seq": self.replication.head_seq(),
                # lineage captured ATOMICALLY with the watermark: the
                # follower records this epoch after loading, so a
                # primary restart mid-download cannot trigger a second
                # full reseed of a seed that already matches the new
                # lineage
                "epoch": self.replication.epoch,
                "payload": build_snapshot_payload(self),
            }

    def load_replica_seed(self, seed: dict) -> None:
        """Replace all engine state with a primary's seed snapshot and
        align the local replication ring so cascaded replicas keep the
        primary's sequence numbering."""
        from .persist import restore_snapshot_payload
        from .snapshot import SnapshotCache
        from .store import GraphStore

        with self._rwlock.write():
            self.store = GraphStore()
            self.snapshots = SnapshotCache(self.store, device=self.device)
            self.vectors.indexes = {}
            self.texts.indexes = {}
            self.store.add_write_hook(self.vectors)
            self.store.add_write_hook(self.texts)
            restore_snapshot_payload(self, seed["payload"])
            self.replication.reset_to(seed["seed_seq"] + 1)

    def checkpoint(self) -> None:
        """Snapshot + truncate the WAL.  Takes the writer lock so the
        snapshot never observes a half-applied batch."""
        if self.persistence is not None:
            with self._rwlock.write():
                self._checkpoint_unlocked()

    def _checkpoint_unlocked(self) -> None:
        """Checkpoint body; caller holds the writer lock."""
        if self.persistence is not None:
            self.persistence.checkpoint(self)
            self._writes_since_checkpoint = 0

    def close(self) -> None:
        if self.persistence is not None:
            self.checkpoint()
            self.persistence.close()
        self.telemetry.close()

    # -- stored routes ----------------------------------------------------

    def load_bundle(self, bundle: Any) -> None:
        """Install a queries.json bundle (wire v5; legacy v4 accepted)."""
        if not isinstance(bundle, dict) or "version" not in bundle:
            bundle = load_query_bundle(bundle)
        version = bundle.get("version", -1)
        if version != wire.QUERY_BUNDLE_VERSION and version not in wire.QUERY_BUNDLE_LEGACY_VERSIONS:
            raise QueryError(f"unsupported query bundle version {version}")
        # Build the full table FIRST, swap atomically: concurrent stored
        # queries must never observe a wiped/partial route table during
        # a deploy (and a malformed bundle must not destroy the old one).
        routes: dict[str, dict] = {}
        for kind, routes_key, params_key in (
            ("read", "read_routes", "read_parameters"),
            ("write", "write_routes", "write_parameters"),
        ):
            params_table = bundle.get(params_key, {})
            for name, query in bundle.get(routes_key, {}).items():
                routes[name] = {
                    "kind": kind,
                    "query": query,
                    "parameters": params_table.get(name, []),
                }
        self.routes = routes
        # Deployed routes survive disk-mode restarts.
        if self.persistence is not None:
            self.checkpoint()

    def execute_stored(
        self, name: str, parameters: dict | None, await_durable: bool = True,
        request_bytes: int | None = None,
    ) -> dict:
        route = self.routes.get(name)
        if route is None:
            raise QueryError(f"unknown stored query: {name}")
        request = {
            "request_type": route["kind"],
            "query_name": name,
            "query": route["query"],
            "parameters": parameters or {},
            "parameter_types": {
                p["name"]: p["ty"] for p in route["parameters"]
            },
        }
        return self.execute(
            request, await_durable=await_durable, request_bytes=request_bytes
        )
