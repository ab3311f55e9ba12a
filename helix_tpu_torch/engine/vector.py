"""Vector index manager: tenant-partitioned residency-ladder indexes.

Implements the reference vector-search contract (``sdks/rust/src/dsl.rs``
``:129-155`` result fields, ``:326-330`` multitenancy):

- search returns up to ``k`` hits ascending by ``$distance``
- multitenant index + missing ``tenant_value`` on search => query error
- multitenant index + unknown tenant => empty result set
- write with a vector present but missing tenant property => write error

Each (kind, label, property) index holds one partition per tenant value
(single partition ``()`` when untenanted).  Partitions are
:class:`~helix_tpu.ops.distance.PackedMatrix` instances searched on the
MXU through the residency ladder (exact / int8 / int4 / host IVF).

Port of ``helix_tpu/engine/vector.py`` for ``helix_tpu_torch``: partitions
hold the port's :class:`~helix_tpu_torch.ops.distance.PackedMatrix` on the
engine's ``torch.device`` and walk the residency ladder: exact, int8
(``ops/quant.py``), int4 (``ops/quant4.py``), then host-exact for l2 and
host IVF for cosine (``ops/ivf.py``, centroids on the partition's
device).  Where the mesh over the partition's device type
(``parallel/mesh.py``) holds more than one device, the reference's mesh
branches serve: the sharded exact tier above ``shard_threshold``
(``parallel/sharded.py``, kernel 1 per shard on CUDA) and sharded int8
for the int8 and int4 rungs (``ops/quant.py:ShardedInt8Search``).
``tests/test_torch_engine_copy.py`` holds the rest of the code equal to
the reference's.

Differs from the reference in:

- ``Partition.__init__``: takes ``device``.
- ``Partition.add``: builds the matrix on the partition's device.
- ``Partition.add_bulk``: builds the matrix on the partition's device.
- ``Partition.search_many_async``: passes the exact search the live
  count it keeps (``n_live``), so no dispatch counts the mask, and
  dispatches the int8 rung through ``_search_quant_async``.
- ``Partition._search_quant``: counts the mesh's devices with
  ``parallel.device_count``; passes the live count on (``n_live``).
- ``Partition._search_quant_async``: the int8 rung's dispatch, deferred
  where it re-ranks on the device (new in the port).
- ``Partition._search_quant_sharded``: the mesh over the partition's
  device; the searcher's outputs come to the host as tensors.
- ``Partition._quant4_recall_serving``: as ``_search_quant``.
- ``Partition._search_quant4``: as ``_search_quant``.
- ``Partition._ensure_host_ivf``: builds the IVF index on the partition's
  device.
- ``Partition._use_shard``: as ``_search_quant``.
- ``Partition._search_sharded``: as ``_search_quant_sharded``; ``bf16``
  on a CUDA mesh (where the reference says a TPU backend), and kernel 1
  per shard only where each shard holds at least ``FUSED_ROW_THRESHOLD``
  rows, the one-device tier's rule (the reference fuses any shard on a
  TPU; a shard of few valid rows has too few 64-row buckets, one
  candidate each, to supply ``8 k`` candidates).
- ``VectorIndex.__init__``: takes ``device``.
- ``VectorIndex.partition_for``: passes ``device`` on.
- ``VectorManager.__init__``: takes ``device``.
- ``VectorManager.on_index_created``: passes ``device`` on.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.distance import PackedMatrix, search_packed_async
from . import values as V
from .errors import QueryError, WriteError
from .store import Edge, GraphStore, IndexDef, Node

Tagged = Any

_UNTENANTED = ("",)


def _tenant_key(value: Tagged) -> tuple:
    comp = V.as_comparable(value)
    if comp is not None and comp[0] in ("numarr", "strarr"):
        # arrays are comparable but NOT scalars: a client accidentally
        # passing the vector itself as tenant_value would get silently
        # isolated per-vector partitions instead of the promised error
        comp = None
    if comp is None:
        raise QueryError("tenant_value must be a scalar value")
    return comp


def _fast_vector(value):
    """Typed float arrays are pure floats by construction (PropertyValue
    coercion on write), so skip the per-element re-coercion
    ``values.f32_vector`` does; everything else takes the slow path.

    Probed with ``dict.get`` rather than ``next(iter(.items()))`` — the
    items-view + tuple allocation measured ~2x the cost of two gets on
    the bulk-ingest path."""
    if type(value) is dict and len(value) == 1:
        payload = value.get("F64Array")
        if payload is None:
            payload = value.get("F32Array")
        if payload is not None and (
            isinstance(payload, list) or type(payload).__name__ == "array"
        ):
            return payload
    return V.f32_vector(value)


class Partition:
    """One tenant partition: packed matrix + id bookkeeping.

    Serving always goes through the residency ladder (exact MXU scan →
    int8 → int4 → host IVF); the ladder's recall/capacity trade-offs
    replace the reference's HNSW tunables
    (helix-cli/src/config.rs:191-201) on this hardware.
    """

    def __init__(
        self,
        metric: str,
        shard_threshold: int | None = None,
        hbm_budget_bytes: int | None = None,
        quant_candidates: int | None = None,
        *,
        device: torch.device,
    ):
        self.metric = metric
        self.device = device
        self.matrix: PackedMatrix | None = None
        # Row bookkeeping lives in growable numpy arrays (not Python
        # lists): the serving path reads the id table and live mask on
        # EVERY search, and a list->ndarray conversion is O(N) Python
        # work per query — ~30 ms at 1M rows, dwarfing the kernel.
        self._ids = np.empty(1024, np.uint64)
        self._live = np.zeros(1024, bool)
        self.n_rows = 0
        self._n_live = 0
        self.pos: dict[int, int] = {}
        # Multi-device: shard the matrix across the mesh above this size.
        self.shard_threshold = shard_threshold
        self._shard_state: dict | None = None
        # Beyond-budget laddering (gated by hbm_budget_bytes): exact
        # bf16+f32 residency while it fits, then int8 codes + exact f32
        # re-rank (ops/quant.py), then packed int4 (ops/quant4.py), then
        # the host rungs (host-exact for l2; host IVF for cosine).
        self.hbm_budget_bytes = hbm_budget_bytes
        # Candidate-pool floor for the quantized rungs (the reference's
        # ef_search analog, ``config.rs:199-201``).
        self.quant_candidates = quant_candidates
        self.quant = None
        self.quant4 = None
        self.host_ivf = None
        self.host_ivf_rows = 0
        self.host_ivf_rebuild_fraction = 0.1

    def add(self, element_id: int, vec: np.ndarray) -> None:
        if self.matrix is None:
            self.matrix = PackedMatrix(len(vec), self.metric, device=self.device)
        elif len(vec) != self.matrix.dim:
            raise WriteError(
                f"vector dimension mismatch: index dim {self.matrix.dim}, "
                f"got {len(vec)}"
            )
        if element_id in self.pos:
            row = self.pos[element_id]
            self.matrix.overwrite(row, vec)
            if not self._live[row]:
                self._n_live += 1
            self._live[row] = True
            return
        pos = self.matrix.append(vec)
        self._ensure_capacity(1)
        self._ids[self.n_rows] = element_id
        self._live[self.n_rows] = True
        self.pos[element_id] = pos
        self.n_rows += 1
        self._n_live += 1

    def _ensure_capacity(self, extra: int) -> None:
        need = self.n_rows + extra
        if need <= len(self._ids):
            return
        cap = max(need, 2 * len(self._ids))
        ids = np.empty(cap, np.uint64)
        ids[: self.n_rows] = self._ids[: self.n_rows]
        self._ids = ids
        live = np.zeros(cap, bool)
        live[: self.n_rows] = self._live[: self.n_rows]
        self._live = live

    @property
    def id_table(self) -> np.ndarray:
        """uint64 row->element-id view (no copy)."""
        return self._ids[: self.n_rows]

    @property
    def live_mask(self) -> np.ndarray:
        """bool row-liveness view (no copy)."""
        return self._live[: self.n_rows]

    def add_bulk(self, ids: list[int], vecs: np.ndarray) -> None:
        """Backfill fast path: bulk-append fresh ids (index creation over
        an existing table; recovery).  Ids already present fall back to
        per-row adds."""
        if len(ids) == 0:
            return
        if self.matrix is None:
            self.matrix = PackedMatrix(
                vecs.shape[1], self.metric, device=self.device
            )
        if vecs.shape[1] != self.matrix.dim:
            raise WriteError(
                f"vector dimension mismatch: index dim {self.matrix.dim}, "
                f"got {vecs.shape[1]}"
            )
        if len(set(ids)) != len(ids) or any(i in self.pos for i in ids):
            # duplicates (intra-batch or vs existing) take the per-row
            # path, whose remove+reinsert keeps pos/live consistent —
            # bulk-appending a duplicate would leave an untombstonable
            # ghost row behind the first occurrence
            for element_id, vec in zip(ids, vecs):
                self.add(element_id, vec)
            return
        first = self.matrix.extend(vecs)
        for offset, element_id in enumerate(ids):
            self.pos[element_id] = first + offset
        count = len(ids)
        self._ensure_capacity(count)
        self._ids[self.n_rows : self.n_rows + count] = np.asarray(ids, np.uint64)
        self._live[self.n_rows : self.n_rows + count] = True
        self.n_rows += count
        self._n_live += count

    def remove(self, element_id: int) -> None:
        pos = self.pos.pop(element_id, None)
        if pos is None or self.matrix is None:
            return
        if self._live[pos]:
            self._n_live -= 1
        self._live[pos] = False
        self.matrix.overwrite(pos, None)

    def live_count(self) -> int:
        return self._n_live

    def search(self, query: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        ids, dists = self.search_many(query[None, :], k)
        return ids[0], dists[0]

    def search_many(
        self, queries: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched search: (ids [B, k'], dists [B, k']) ascending."""
        return self.search_many_async(queries, k)()

    def search_many_async(self, queries: np.ndarray, k: int):
        """Dispatch a batched search; returns ``finalize() -> (ids,
        dists)``.  The exact tier and the int8 rung's device re-rank
        defer their D2H so a serving loop can overlap dispatches
        (``search_packed_async``, :meth:`_search_quant_async`); the other
        tiers compute eagerly and return a pre-resolved closure."""
        b = len(queries)
        if self.matrix is None or self.live_count() == 0:
            empty = (
                np.empty((b, 0), np.uint64),
                np.empty((b, 0), np.float64),
            )
            return lambda: empty
        if self._use_host_ivf():
            dists, positions = self._search_host_ivf(queries, k)
            id_table = self.id_table  # stable view; see exact tier below
            return lambda: self._map_hits(dists, positions, id_table)
        if self._use_host_exact():
            dists, positions = self._search_host_exact(queries, k)
            id_table = self.id_table
            return lambda: self._map_hits(dists, positions, id_table)
        if self._use_quant():
            return self._search_quant_async(queries, k)
        if self._use_quant4():
            dists, positions = self._search_quant4(queries, k)
            id_table = self.id_table  # stable view; see exact tier below
            return lambda: self._map_hits(dists, positions, id_table)
        if self._use_shard():
            dists, positions = self._search_sharded(queries, k)
            id_table = self.id_table  # stable view; see exact tier below
            return lambda: self._map_hits(dists, positions, id_table)
        inner = search_packed_async(
            self.matrix, queries, k, valid_mask=self.live_mask,
            n_live=self._n_live,
        )
        # dispatch-time id-table snapshot: the view is already stable
        # (_ids is append-only; _ensure_capacity reallocates instead of
        # mutating), so no O(n) copy is needed — ~80 MB/dispatch at 10M
        # rows before this
        id_table = self.id_table

        def finalize():
            dists, positions = inner()
            return self._map_hits(dists, positions, id_table)

        return finalize

    def _map_hits(
        self, dists: np.ndarray, positions: np.ndarray, id_table: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        # Tiers pad short rows with position -1 / +inf sentinels (native
        # rerank with < k live candidates, tombstoned ANN rows).  Mapping
        # a -1 through clip() would return row 0's id as a bogus hit —
        # compact valid entries left, trim to the widest row, and mark
        # any residual ragged cells (id 0 is never allocated).
        valid = (
            (positions >= 0)
            & (positions < len(id_table))
            & np.isfinite(dists)
        )
        if not valid.all():
            order = np.argsort(~valid, axis=1, kind="stable")
            dists = np.take_along_axis(dists, order, axis=1)
            positions = np.take_along_axis(positions, order, axis=1)
            valid = np.take_along_axis(valid, order, axis=1)
            width = int(valid.sum(axis=1).max())
            dists = dists[:, :width]
            positions = positions[:, :width]
            valid = valid[:, :width]
            dists = np.where(valid, dists, np.inf)
        ids = np.where(valid, id_table[np.where(valid, positions, 0)], 0)
        return ids.astype(np.uint64), dists.astype(np.float64)

    # -- residency accounting ----------------------------------------------

    def _exact_resident_bytes(self) -> int:
        # f32 + bf16 device copies of the padded matrix
        return self.matrix.n * self.matrix.dim_pad * 6

    def _quant_resident_bytes(self) -> int:
        # int8 matrix + one f32 scale per row
        return self.matrix.n * (self.matrix.dim_pad + 4)

    def _quant4_resident_bytes(self) -> int:
        # packed nibbles + one f32 scale per row
        return self.matrix.n * (self.matrix.dim_pad // 2 + 4)

    def _quant_dev_resident_bytes(self) -> int:
        # int8 matrix + f16 re-rank copy + f32 scale + f32 sq norm
        return self.matrix.n * (self.matrix.dim_pad * 3 + 8)

    def _quant_rerank_device(self) -> bool:
        """Within the int8 rung, re-rank on device when an f16 row copy
        fits next to the int8 codes (3 B/dim total): candidates then
        never round-trip to host memory, and the rung serves at
        coarse-phase speed instead of host-RAM-gather speed (measured
        ~7x at the 100k smoke config; LADDER artifact).  Override with
        ``HELIX_QUANT_RERANK=host|device`` (auto = budget-based)."""
        import os

        mode = os.environ.get("HELIX_QUANT_RERANK", "auto")
        if mode == "host":
            return False
        if mode == "device":
            return True
        return self._quant_dev_resident_bytes() <= self.hbm_budget_bytes

    # -- int8 quantized residency tier -------------------------------------

    def _use_quant(self) -> bool:
        if self.hbm_budget_bytes is None or self.matrix is None:
            return False
        return (
            self._exact_resident_bytes() > self.hbm_budget_bytes
            and self._quant_resident_bytes() <= self.hbm_budget_bytes
        )

    def _search_quant(
        self, queries: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        from ..ops.quant import QuantizedResident
        from ..parallel import device_count

        if device_count(self.device) > 1:
            return self._search_quant_sharded(queries, k)
        if self.quant is None:
            self.quant = QuantizedResident()
        return self.quant.search(
            self.matrix, queries, k, self.live_mask, self.metric,
            k_cand_floor=self.quant_candidates,
            rerank_device=self._quant_rerank_device(),
            n_live=self._n_live,
        )

    def _search_quant_async(self, queries: np.ndarray, k: int):
        """The int8 rung's dispatch.  With its device re-rank on one
        device, ``QuantizedResident.search(deferred=True)`` only enqueues
        and ``finalize()`` waits for the D2H, as the exact tier's does;
        the host re-rank and the mesh compute eagerly.  The live count is
        the partition's own (``_n_live``), so no dispatch counts the
        mask."""
        from ..ops.quant import QuantizedResident
        from ..parallel import device_count

        id_table = self.id_table  # stable view; see the exact tier
        if device_count(self.device) > 1 or not self._quant_rerank_device():
            dists, positions = self._search_quant(queries, k)
            return lambda: self._map_hits(dists, positions, id_table)
        if self.quant is None:
            self.quant = QuantizedResident()
        inner = self.quant.search(
            self.matrix, queries, k, self.live_mask, self.metric,
            k_cand_floor=self.quant_candidates, rerank_device=True,
            n_live=self._n_live, deferred=True,
        )

        def finalize():
            dists, positions = inner()
            return self._map_hits(dists, positions, id_table)

        return finalize

    def _search_quant_sharded(
        self, queries: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Mesh-sharded int8 coarse phase + exact f32 re-rank (the
        quantized rung at multi-device scale).

        Re-rank runs per shard on its device when the f16 copy fits the
        per-device budget (rows re-score where they live; the merge then
        carries f32-accumulated f16 re-rank scores, and the host re-rank
        drops out) and on the host in f32 otherwise."""
        from ..ops.quant import ShardedInt8Search, quantize_rows
        from ..parallel import make_mesh

        n = self.matrix.n
        k_cand = min(max(8 * k, 64, self.quant_candidates or 0), n)
        state = self._shard_state
        if (
            state is None
            or state.get("kind") != "int8"
            or state["version"] != self.matrix.version
        ):
            # Arrays are keyed by matrix version only: quantization and
            # the upload must not repeat when clients alternate k;
            # searchers are made per k_cand and share the arrays (row
            # padding is k-independent).
            state = {
                "kind": "int8", "version": self.matrix.version,
                "mesh": make_mesh(device=self.device), "searchers": {},
                "arrays": None, "rr_arrays": None,
            }
            self._shard_state = state
        n_shard = int(state["mesh"].shape["shard"])
        use_dev = self._quant_rerank_device_sharded(n_shard)
        skey = (k_cand, k if use_dev else None)
        search = state["searchers"].get(skey)
        if search is None:
            search = ShardedInt8Search(
                state["mesh"], k=k_cand, metric=self.metric,
                rerank_device=use_dev, k_out=k,
            )
            state["searchers"][skey] = search
        if state["arrays"] is None:
            values, scales = quantize_rows(self.matrix.data[:n])
            state["arrays"] = search.shard_arrays(
                values, scales, self.matrix.sq_norms[:n]
            )
        xs_i8, scales, sq, n_valid = state["arrays"]
        qs = self.matrix.prepare_queries(queries)
        if use_dev:
            if state["rr_arrays"] is None:
                state["rr_arrays"] = search.shard_rerank_arrays(
                    self.matrix.data[:n], self.live_mask
                )
            sims, ids = search(
                xs_i8, scales, sq, qs, n_valid,
                rerank_arrays=state["rr_arrays"],
            )
            sims = sims.cpu().numpy().astype(np.float32)
            pos = ids.cpu().numpy().astype(np.int64)
            if self.metric == "cosine":
                dists = 1.0 - sims
            else:
                q_sq = np.sum(qs * qs, axis=1, keepdims=True)
                dists = q_sq - sims
            dead = pos < 0
            return (
                np.where(dead, np.inf, dists).astype(np.float32),
                np.where(dead, -1, pos),
            )
        from ..native import rerank as native_rerank

        _, cand = search(xs_i8, scales, sq, qs, n_valid)
        cand = cand.cpu().numpy().astype(np.int64)
        live = self.live_mask
        cand = np.where(
            (cand < n) & live[np.clip(cand, 0, n - 1)], cand, -1
        )
        return native_rerank(
            self.matrix.data[:n], self.matrix.sq_norms[:n], qs, cand, k,
            self.metric,
        )

    def _quant_rerank_device_sharded(self, n_shard: int) -> bool:
        """Mesh variant of :meth:`_quant_rerank_device`: rows shard
        1/n_shard per chip, so the f16 re-rank copy fits whenever the
        PER-CHIP slice of (int8 + f16 + scales) is inside the budget."""
        import os

        mode = os.environ.get("HELIX_QUANT_RERANK", "auto")
        if mode == "host":
            return False
        if mode == "device":
            return True
        per_chip = self._quant_dev_resident_bytes() // max(n_shard, 1)
        return per_chip <= self.hbm_budget_bytes

    # -- int4 packed residency tier ----------------------------------------

    def _quant4_recall_serving(self) -> bool:
        """Recall-safety gate for the int4 rung: the scale-aware
        candidate pool (ops/quant4.recall_safe_pool_int4) must stay
        within INT4_MAX_POOL, or the walk moves on to host-IVF; an
        explicit quant_candidates override wider than the safe pool
        re-enables the rung (the operator owns the trade).  On a mesh the
        rung serves through sharded int8, whose pool rule this is not."""
        from ..ops.quant4 import INT4_MAX_POOL, recall_safe_pool_int4
        from ..parallel import device_count

        if device_count(self.device) > 1:
            # the mesh path serves this rung via sharded int8 (see
            # _search_quant4), whose 8-bit noise holds the floor at the
            # ordinary pool — the int4 pool rule does not apply
            return True

        need = recall_safe_pool_int4(self.matrix.n)
        if self.quant_candidates is not None \
                and self.quant_candidates >= need:
            return True
        return need <= INT4_MAX_POOL

    def _use_quant4(self) -> bool:
        if self.hbm_budget_bytes is None or self.matrix is None:
            return False
        return (
            self._quant_resident_bytes() > self.hbm_budget_bytes
            and self._quant4_resident_bytes() <= self.hbm_budget_bytes
            and self._quant4_recall_serving()
        )

    def _search_quant4(
        self, queries: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        from ..ops.quant4 import Int4Resident
        from ..parallel import device_count

        if device_count(self.device) > 1:
            # On a mesh the corpus shards 1/n_dev per device, so the int8
            # rung fits per shard whenever whole-corpus int4 does
            # (int8/n_dev < int4 for n_dev >= 2): route to the sharded
            # int8 path rather than paying 4-bit noise.
            return self._search_quant_sharded(queries, k)
        if self.quant4 is None:
            self.quant4 = Int4Resident()
        return self.quant4.search(
            self.matrix, queries, k, self.live_mask, self.metric,
            k_cand_floor=self.quant_candidates,
        )

    # -- beyond-HBM host-IVF tier ------------------------------------------

    def _use_host_exact(self) -> bool:
        """Beyond-budget rung for non-cosine metrics: host-IVF is
        cosine-only, and without this an over-budget l2 corpus fell
        through to the exact tier and uploaded past the HBM budget
        (device OOM) — the budget knob silently ignored exactly when it
        mattered."""
        if self.hbm_budget_bytes is None or self.metric == "cosine":
            return False
        if self.matrix is None:
            return False
        return self._quant4_resident_bytes() > self.hbm_budget_bytes

    def _search_host_exact(
        self, queries: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact numpy scan on the host-resident matrix — slow but
        correct when no device rung fits the budget."""
        qs = self.matrix.prepare_queries(queries)
        n = self.matrix.n
        data = self.matrix.data[:n]
        sims = qs @ data.T
        if self.metric == "l2":
            d = (
                self.matrix.sq_norms[:n][None, :]
                - 2.0 * sims
                + np.sum(qs * qs, axis=1, keepdims=True)
            )
        else:
            d = 1.0 - sims
        live = self.live_mask
        d = np.where(live[None, :], d, np.inf)
        k_eff = min(k, n)
        idx = np.argpartition(d, k_eff - 1, axis=1)[:, :k_eff]
        part_d = np.take_along_axis(d, idx, axis=1)
        order = np.argsort(part_d, axis=1, kind="stable")
        return (
            np.take_along_axis(part_d, order, axis=1).astype(np.float64),
            np.take_along_axis(idx, order, axis=1).astype(np.int64),
        )

    def _use_host_ivf(self) -> bool:
        if self.hbm_budget_bytes is None or self.metric != "cosine":
            return False
        if self.matrix is None:
            return False
        return (
            self._exact_resident_bytes() > self.hbm_budget_bytes
            and self._quant_resident_bytes() > self.hbm_budget_bytes
            and (
                self._quant4_resident_bytes() > self.hbm_budget_bytes
                # int4 fits but cannot hold the recall floor at a
                # serviceable pool: fall past it, never below 0.95
                or not self._quant4_recall_serving()
            )
        )

    def _ensure_host_ivf(self) -> None:
        from ..ops.ivf import HostIVFIndex

        n = self.matrix.n
        stale = (
            self.host_ivf is None
            or (n - self.host_ivf_rows)
            > self.host_ivf_rebuild_fraction * max(self.host_ivf_rows, 1)
        )
        if not stale:
            return
        self.host_ivf = HostIVFIndex.build(
            self.matrix.data[:n, : self.matrix.dim_pad],
            normalize=False,  # packed rows are already unit-norm (cosine)
            device=self.device,
        )
        self.host_ivf_rows = n

    def _search_host_ivf(
        self, queries: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Host-resident IVF over the build snapshot + exact host scan of
        the delta rows; tombstoned rows drop via the sentinel path."""
        self._ensure_host_ivf()
        qs = self.matrix.prepare_queries(queries)
        # widen by the tombstone count so the dead-drop below can still
        # return k live hits (same scheme as the exact tier's k_query)
        n_dead = self.n_rows - self._n_live
        k_eff = min(k + n_dead, self.host_ivf_rows)
        dists, positions = self.host_ivf.search(
            qs, k_eff, nprobe=32, normalize=False
        )
        dists = np.asarray(dists, np.float32)
        positions = np.asarray(positions, np.int64)
        n = self.matrix.n
        if n > self.host_ivf_rows:
            delta = self.matrix.data[self.host_ivf_rows : n]
            delta_d = (1.0 - qs @ delta.T).astype(np.float32)
            delta_i = np.arange(self.host_ivf_rows, n)[None, :].repeat(
                len(queries), 0
            )
            dists = np.concatenate([dists, delta_d], axis=1)
            positions = np.concatenate([positions, delta_i], axis=1)
        # tombstones to +inf, then (re)establish ascending top-k
        live = self.live_mask
        dead = ~live[np.clip(positions, 0, max(len(live) - 1, 0))]
        dists = np.where(dead, np.inf, dists)
        order = np.argsort(dists, axis=1, kind="stable")[:, :k]
        return (
            np.take_along_axis(dists, order, axis=1),
            np.take_along_axis(positions, order, axis=1),
        )

    # -- sharded tier ------------------------------------------------------

    def _use_shard(self) -> bool:
        if self.shard_threshold is None or self.live_count() < self.shard_threshold:
            return False
        from ..parallel import device_count

        return device_count(self.device) > 1

    def _search_sharded(
        self, queries: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Row-sharded search over the device mesh + top-k merge on the
        partition's device, followed by an exact native re-rank of the
        merged candidates."""
        from ..native import rerank as native_rerank
        from ..ops.distance import FUSED_ROW_THRESHOLD
        from ..parallel import ShardedVectorSearch, make_mesh

        n = self.matrix.n
        state = self._shard_state
        if (
            state is None
            or state.get("kind", "exact") != "exact"
            or state["version"] != self.matrix.version
        ):
            mesh = make_mesh(device=self.device)
            state = {
                "kind": "exact",
                "version": self.matrix.version,
                "mesh": mesh,
                "searchers": {},
                "arrays": None,
            }
            self._shard_state = state
        k_scan = min(n, max(32, 8 * k))
        searcher = state["searchers"].get(k_scan)
        if searcher is None:
            # kernel 1 per shard only where each shard holds as many rows
            # as the one-device tier fuses: one candidate per 64-row
            # bucket, so a shard of few valid rows would supply too few
            n_shard = int(state["mesh"].shape["shard"])
            fused = (
                self.device.type == "cuda" and self.metric == "cosine"
                and n // n_shard >= FUSED_ROW_THRESHOLD
            )
            searcher = ShardedVectorSearch(
                state["mesh"], k=k_scan, metric=self.metric,
                bf16=self.device.type == "cuda", use_fused=fused,
            )
            state["searchers"][k_scan] = searcher
            # arrays stay: shard_arrays depends only on mesh/tile/fused
            # (k-independent), so alternating k must not re-upload the
            # matrix — same invariant as the int8 tier
        if state["arrays"] is None:
            state["arrays"] = searcher.shard_arrays(
                self.matrix.data[:n], self.matrix.sq_norms[:n]
            )
        xs, sqd, n_valid = state["arrays"]
        qs = self.matrix.prepare_queries(queries)
        _, cand = searcher(xs, qs, n_valid, sqd)
        cand = cand.cpu().numpy().astype(np.int64)
        live = self.live_mask
        cand = np.where(
            (cand < n) & live[np.clip(cand, 0, n - 1)], cand, -1
        )
        dists, positions = native_rerank(
            self.matrix.data[:n], self.matrix.sq_norms[:n], qs, cand, k,
            self.metric,
        )
        return dists, positions


class VectorIndex:
    """All partitions of one declared (kind, label, property) index."""

    def __init__(
        self,
        defn: IndexDef,
        metric: str,
        shard_threshold: int | None = None,
        hbm_budget_bytes: int | None = None,
        quant_candidates: int | None = None,
        *,
        device: torch.device,
    ):
        self.defn = defn
        self.metric = metric
        self.device = device
        self.shard_threshold = shard_threshold
        self.hbm_budget_bytes = hbm_budget_bytes
        self.quant_candidates = quant_candidates
        self.partitions: dict[tuple, Partition] = {}

    def partition_for(self, tenant: tuple) -> Partition:
        part = self.partitions.get(tenant)
        if part is None:
            part = Partition(
                self.metric,
                shard_threshold=self.shard_threshold,
                hbm_budget_bytes=self.hbm_budget_bytes,
                quant_candidates=self.quant_candidates,
                device=self.device,
            )
            self.partitions[tenant] = part
        return part

    def insert_element(self, element: Node | Edge) -> None:
        value = element.props.get(self.defn.prop)
        if value is None or V.is_null(value):
            return
        vec = _fast_vector(value)
        if vec is None:
            return  # non-vector value in the indexed property: not indexed
        if self.defn.tenant_property is not None:
            tenant_value = element.props.get(self.defn.tenant_property)
            if tenant_value is None or V.is_null(tenant_value):
                raise WriteError(
                    f"write to multitenant vector index {self.defn.label}."
                    f"{self.defn.prop} requires tenant property "
                    f"'{self.defn.tenant_property}'"
                )
            try:
                tenant = _tenant_key(tenant_value)
            except QueryError:
                raise WriteError(
                    f"tenant property '{self.defn.tenant_property}' on "
                    f"{self.defn.label}.{self.defn.prop} must be a "
                    "scalar value"
                ) from None
        else:
            tenant = _UNTENANTED
        self.partition_for(tenant).add(element.id, np.asarray(vec, np.float32))

    def insert_elements_bulk(self, elements: list) -> None:
        """Index-creation backfill: group rows per tenant partition and
        bulk-append (one matrix extend per partition instead of a
        per-row pack/normalize)."""
        groups: dict[tuple, tuple[list[int], list]] = {}
        prop = self.defn.prop
        tenant_prop = self.defn.tenant_property
        fast_vector = _fast_vector
        is_null = V.is_null
        if tenant_prop is None:
            # untenanted: one group, no per-element tenant branch (the
            # bulk-ingest hot path)
            ids, vecs = groups.setdefault(_UNTENANTED, ([], []))
            for element in elements:
                value = element.props.get(prop)
                if value is None or is_null(value):
                    continue
                vec = fast_vector(value)
                if vec is None:
                    continue
                ids.append(element.id)
                vecs.append(vec)
            if not ids:
                del groups[_UNTENANTED]
        else:
            for element in elements:
                value = element.props.get(prop)
                if value is None or is_null(value):
                    continue
                vec = fast_vector(value)
                if vec is None:
                    continue
                tenant_value = element.props.get(tenant_prop)
                if tenant_value is None or is_null(tenant_value):
                    raise WriteError(
                        f"write to multitenant vector index {self.defn.label}."
                        f"{prop} requires tenant property '{tenant_prop}'"
                    )
                try:
                    tenant = _tenant_key(tenant_value)
                except QueryError:
                    raise WriteError(
                        f"tenant property '{tenant_prop}' on "
                        f"{self.defn.label}.{prop} must be a scalar value"
                    ) from None
                ids, vecs = groups.setdefault(tenant, ([], []))
                ids.append(element.id)
                vecs.append(vec)
        for tenant, (ids, vecs) in groups.items():
            try:
                first = vecs[0]
                # type/length uniformity via set(map(...)): two C-speed
                # passes, ~10x cheaper than a generator all() at 50k rows
                if (
                    type(first).__name__ == "array"
                    and first.typecode in ("d", "f")
                    and len(set(map(type, vecs))) == 1
                    and len({v.typecode for v in vecs}) == 1
                    and len(set(map(len, vecs))) == 1
                ):
                    # fast-parsed rows: one buffer join + frombuffer is
                    # ~3x np.asarray over 10k small array('d') objects.
                    # dtype follows the typecode — joining 'f' rows as
                    # f64 would reinterpret the bytes, not convert them.
                    # (bytes.join reads the arrays' buffers directly;
                    # wrapping each in memoryview().cast measured 10x
                    # slower at 200k rows)
                    joined = b"".join(vecs)
                    dtype = np.float64 if first.typecode == "d" else np.float32
                    block = np.frombuffer(joined, dtype).reshape(
                        len(vecs), len(first)
                    ).astype(np.float32)
                else:
                    block = np.asarray(vecs, np.float32)
            except (ValueError, TypeError) as exc:
                # ragged / non-numeric rows: same error class as the
                # per-row path raises on a dimension mismatch
                raise WriteError(
                    f"vector dimension mismatch in bulk write to "
                    f"{self.defn.label}.{self.defn.prop}: {exc}"
                ) from exc
            self.partition_for(tenant).add_bulk(ids, block)

    def remove_element(self, element_id: int) -> None:
        for part in self.partitions.values():
            part.remove(element_id)

    def search(
        self, query: np.ndarray, k: int, tenant_value: Tagged | None
    ) -> tuple[np.ndarray, np.ndarray]:
        part = self.partition_for_search(tenant_value)
        if part is None:
            return np.empty(0, np.uint64), np.empty(0, np.float64)
        return part.search(query, k)

    def partition_for_search(self, tenant_value: Tagged | None) -> "Partition | None":
        if self.defn.tenant_property is not None:
            if tenant_value is None:
                raise QueryError(
                    f"vector index {self.defn.label}.{self.defn.prop} is "
                    "multitenant; search requires tenant_value"
                )
            return self.partitions.get(_tenant_key(tenant_value))
        return self.partitions.get(_UNTENANTED)


class VectorManager:
    """Store write-hook + search facade over all vector indexes."""

    def __init__(
        self,
        metric: str = "cosine",
        batch_window_ms: float | None = None,
        shard_threshold: int | None = None,
        hbm_budget_bytes: int | None = None,
        quant_candidates: int | None = None,
        *,
        device: torch.device,
    ):
        self.metric = metric
        self.device = device
        self.shard_threshold = shard_threshold
        self.hbm_budget_bytes = hbm_budget_bytes
        self.quant_candidates = quant_candidates
        self.indexes: dict[tuple, VectorIndex] = {}
        self.batcher = None
        if batch_window_ms is not None:
            from .batching import DynamicBatcher

            self.batcher = DynamicBatcher(window_s=batch_window_ms / 1000.0)

    # -- write hook interface ------------------------------------------

    def on_index_created(self, store: GraphStore, defn: IndexDef) -> None:
        if defn.spec_tag not in ("NodeVector", "EdgeVector"):
            return
        index = VectorIndex(
            defn, self.metric,
            shard_threshold=self.shard_threshold,
            hbm_budget_bytes=self.hbm_budget_bytes,
            quant_candidates=self.quant_candidates,
            device=self.device,
        )
        self.indexes[defn.key()] = index
        table = (
            store.nodes_by_label.get(defn.label, ())
            if defn.kind == "node"
            else store.edges_by_label.get(defn.label, ())
        )
        records = store.nodes if defn.kind == "node" else store.edges
        index.insert_elements_bulk([records[eid] for eid in table])

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
        """Bulk-ingest hook: one matrix extend per (index, tenant) group
        instead of a per-row pack (the ForEach-AddN hot path)."""
        if not nodes:
            return
        for index in self._matching("node", nodes[0].label):
            index.insert_elements_bulk(nodes)

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

    # -- search ----------------------------------------------------------

    def search(
        self,
        kind: str,
        label: str,
        prop: str,
        query: list[float],
        k: int,
        tenant_value: Tagged | None,
    ) -> tuple[np.ndarray, np.ndarray]:
        spec_tag = "NodeVector" if kind == "nodes" else "EdgeVector"
        index = self.indexes.get((spec_tag, label, prop))
        if index is None:
            raise QueryError(
                f"no vector index on {label}.{prop}; create one with "
                "create_vector_index_nodes/edges first"
            )
        if k <= 0:
            return np.empty(0, np.uint64), np.empty(0, np.float64)
        vec = np.asarray(query, np.float32)
        part = index.partition_for_search(tenant_value)
        if part is None or part.matrix is None or part.live_count() == 0:
            return np.empty(0, np.uint64), np.empty(0, np.float64)
        if len(vec) != part.matrix.dim:
            # validated on BOTH paths: without this the unbatched route
            # surfaced a numpy-flavored ValueError 500 where a batched
            # deployment returned a clean QueryError
            raise QueryError(
                f"query_vector dimension {len(vec)} does not match index "
                f"dimension {part.matrix.dim}"
            )
        if self.batcher is not None:
            # Coalesce concurrent searches against the same partition into
            # one device dispatch (see engine/batching.py).
            ids, dists = self.batcher.submit(part, vec, k)
            return ids, dists
        ids, dists = part.search(vec, k)
        return ids, dists
