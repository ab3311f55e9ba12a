"""Multi-device graph traversal: edge-partitioned adjacency + frontier
exchange on the merge device (PyTorch port of
``helix_tpu/parallel/graph.py``).

- The padded adjacency (``ops/csr.py`` layout: an ``[N, P]``
  neighbor-slot matrix per direction) is partitioned by source row
  across the ``shard`` axis: each shard's device holds its rows'
  edges, so every edge lives on exactly one device.
- The frontier is a boolean mask over node slots.  Each hop, every
  shard expands its local rows' edges into a full-width mask on its
  device, and the masks OR together on the merge device (the reference's
  ``psum``): the frontier exchange.  Each shard then takes its slice of
  the merged mask.
- Ordered frame expansion (:meth:`ShardedGraph.expand_frame`,
  :meth:`~ShardedGraph.expand_frame_edges`): each frame row's edges live
  on the one shard that owns its source row, so the merged ``[t, P]``
  target block takes each row from its owner (the reference sums
  ``target + 1`` blocks that are zero off the owner).

Node count pads to ``rows_per_shard * n_shard``; padded rows have no
edges, start dead and are masked out of every filter.  Neighbor pad is
the drop slot ``n_pad``, label pad -1, edge-slot pad -1.

Deliberate differences from the reference: nothing is compiled, so there
is no per-plan compile cache; each hop scatters every row's masked slots
(the reference's dense form), per shard, in eager torch.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh, shard_rows

# Plan ops:
#   ("hop", ("out",))            expand outgoing edges
#   ("hop", ("in",))             expand incoming edges
#   ("hop", ("out", "in"))       Both: union of the two expansions
#   ("mask", slot_index)         AND with filter mask number `slot_index`
PlanOp = tuple


class ShardedGraph:
    """Device-resident sharded adjacency for one graph snapshot.

    ``directions`` maps ``"out"``/``"in"`` to host ``(neighbors,
    edge_labels[, edge_slots])`` planes in the ``ops/csr.py`` padded
    layout (``[N, P]`` int32, neighbor pad = ``N``, label pad = -1, edge
    slot pad = -1).  Only the directions a workload needs must be
    present."""

    def __init__(
        self,
        mesh: Mesh,
        n_nodes: int,
        directions: dict[str, tuple[np.ndarray, ...]],
    ):
        self.mesh = mesh
        self.n_shard = int(mesh.shape["shard"])
        self.n_nodes = n_nodes
        rows = -(-n_nodes // self.n_shard)
        # Shard slices in whole 128-row blocks, as the reference.
        rows = ((rows + 127) // 128) * 128
        self.rows_per_shard = rows
        self.n_pad = rows * self.n_shard
        devs = mesh.shard_devices
        self.arrays: dict[str, list[tuple[torch.Tensor, torch.Tensor]]] = {}
        self.edge_planes: dict[str, list[torch.Tensor]] = {}
        for direction, planes in directions.items():
            neighbors, labels = planes[0], planes[1]
            nb = np.full((self.n_pad, neighbors.shape[1]), self.n_pad, np.int32)
            lb = np.full((self.n_pad, neighbors.shape[1]), -1, np.int32)
            # real neighbor slots keep their global ids; the original pad
            # sentinel (n_nodes) moves to the padded drop slot (n_pad)
            nb[:n_nodes] = np.where(
                neighbors[:n_nodes] >= n_nodes, self.n_pad, neighbors[:n_nodes]
            )
            lb[:n_nodes] = labels[:n_nodes]
            self.arrays[direction] = list(zip(
                shard_rows(nb, self.n_shard, devs),
                shard_rows(lb, self.n_shard, devs),
            ))
            if len(planes) > 2 and planes[2] is not None:
                # global edge slots per adjacency position (pad = -1):
                # the plane the ordered edge steps (OutE/InE) ride
                es = np.full((self.n_pad, neighbors.shape[1]), -1, np.int32)
                es[:n_nodes] = planes[2][:n_nodes]
                self.edge_planes[direction] = shard_rows(
                    es, self.n_shard, devs)

    # -- plan execution ----------------------------------------------------

    def _shard_masks(self, host: np.ndarray) -> list[torch.Tensor]:
        padded = np.zeros(self.n_pad, bool)
        padded[: self.n_nodes] = host[: self.n_nodes]
        return shard_rows(padded, self.n_shard, self.mesh.shard_devices)

    def _hop(self, masks: list[torch.Tensor], directions: tuple,
             code: int) -> list[torch.Tensor]:
        """One hop: each shard scatters its live rows' label-matching
        targets into a full-width mask, the masks OR on the merge device,
        and each shard takes its slice back."""
        merge = self.mesh.device
        n_pad = self.n_pad
        rows = self.rows_per_shard
        full = torch.zeros(n_pad, dtype=torch.bool, device=merge)
        for s, mask in enumerate(masks):
            contrib = torch.zeros(n_pad + 1, dtype=torch.bool,
                                  device=mask.device)
            for direction in directions:
                nb, lb = self.arrays[direction][s]
                ok = mask[:, None]
                if code >= 0:
                    ok = ok & (lb == code)
                targets = torch.where(ok, nb, n_pad)
                contrib.index_fill_(0, targets.reshape(-1).long(), True)
            full |= contrib[:n_pad].to(merge, non_blocking=True)
        return [full[s * rows:(s + 1) * rows].to(mask.device)
                for s, mask in enumerate(masks)]

    def run(
        self,
        plan: list,
        start_mask: np.ndarray,
        codes: list[int],
        masks: list[np.ndarray],
    ) -> np.ndarray:
        """Execute a traversal plan; returns the final membership mask
        (host bool ``[n_nodes]``).

        ``plan`` entries: ``("hop", directions_tuple)`` consuming the
        next entry of ``codes`` (edge-label code, -1 = any), or
        ``("mask", i)`` ANDing with ``masks[i]``.
        """
        if not masks and any(op[0] == "mask" for op in plan):
            raise ValueError(
                "plan contains a mask op but no masks were provided"
            )
        n_hops = sum(1 for op in plan if op[0] == "hop")
        if len(codes) < n_hops:
            # a missing code would otherwise read a placeholder 0 — a
            # REAL label code — and silently label-filter the hop
            raise ValueError(
                f"plan contains {n_hops} hop ops but only "
                f"{len(codes)} label codes were provided"
            )
        frontier = self._shard_masks(start_mask)
        filters = [self._shard_masks(np.asarray(m, bool)) for m in masks]
        hop_i = 0
        for op in plan:
            if op[0] == "hop":
                frontier = self._hop(frontier, tuple(op[1]),
                                     int(codes[hop_i]))
                hop_i += 1
            else:
                frontier = [f & keep for f, keep in
                            zip(frontier, filters[op[1]])]
        merge = self.mesh.device
        out = torch.cat([f.to(merge, non_blocking=True) for f in frontier])
        return out.cpu().numpy()[: self.n_nodes]

    # -- ordered frame expansion (full interpreter semantics) --------------

    def _owned(self, frame_slots: np.ndarray):
        """Per shard: (frame rows it owns, their local row indices)."""
        rows = self.rows_per_shard
        shard = np.asarray(frame_slots, np.int64) // rows
        local = np.asarray(frame_slots, np.int64) - shard * rows
        for s in range(self.n_shard):
            sel = np.nonzero(shard == s)[0]
            if len(sel):
                yield s, sel, local[sel]

    def expand_frame(
        self, direction: str, label_code: int, frame_slots: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """One ordered hop over the mesh with full interpreter
        semantics: returns ``(parent_rows, target_slots)`` where entry
        order is frame order x adjacency slot order — exactly the
        single-device ``_expand_edges`` expansion order, with
        multiplicity (a frame row appearing twice expands twice).

        ``frame_slots`` are global node slots (invalid rows must be
        dropped by the caller).  ``label_code`` -1 = any label.
        """
        t = len(frame_slots)
        if t == 0:
            return (np.empty(0, np.int64), np.empty(0, np.int32))
        merge = self.mesh.device
        planes = self.arrays[direction]
        width = planes[0][0].shape[1]
        merged = torch.full((t, width), self.n_pad, dtype=torch.int32,
                            device=merge)
        for s, sel, local in self._owned(frame_slots):
            nb, lb = planes[s]
            idx = torch.from_numpy(local).to(nb.device)
            nbr = nb.index_select(0, idx)
            if label_code >= 0:
                nbr = torch.where(lb.index_select(0, idx) == label_code,
                                  nbr, self.n_pad)
            merged[torch.from_numpy(sel).to(merge)] = nbr.to(merge)
        merged = merged.cpu().numpy()
        parent, slot_rank = np.nonzero(merged != self.n_pad)
        return parent.astype(np.int64), merged[parent, slot_rank]

    def expand_frame_edges(
        self, direction: str, label_code: int, frame_slots: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One ordered EDGE hop over the mesh: returns ``(parent_rows,
        edge_slots, target_slots)`` in frame order x adjacency slot
        order — the single-device ``_expand_edges`` expansion order.
        Requires the direction's edge plane (built with
        ``edge_order``); raises KeyError otherwise."""
        es_planes = self.edge_planes[direction]
        t = len(frame_slots)
        if t == 0:
            return (
                np.empty(0, np.int64), np.empty(0, np.int32),
                np.empty(0, np.int32),
            )
        merge = self.mesh.device
        planes = self.arrays[direction]
        width = planes[0][0].shape[1]
        edges = torch.full((t, width), -1, dtype=torch.int32, device=merge)
        targets = torch.full((t, width), self.n_pad, dtype=torch.int32,
                             device=merge)
        for s, sel, local in self._owned(frame_slots):
            nb, lb = planes[s]
            idx = torch.from_numpy(local).to(nb.device)
            esr = es_planes[s].index_select(0, idx)
            ok = esr >= 0
            if label_code >= 0:
                ok = ok & (lb.index_select(0, idx) == label_code)
            rows = torch.from_numpy(sel).to(merge)
            edges[rows] = torch.where(ok, esr, -1).to(merge)
            targets[rows] = torch.where(
                ok, nb.index_select(0, idx), self.n_pad).to(merge)
        edges = edges.cpu().numpy()
        targets = targets.cpu().numpy()
        parent, slot_rank = np.nonzero(edges >= 0)
        return (
            parent.astype(np.int64),
            edges[parent, slot_rank],
            targets[parent, slot_rank],
        )

    def khop_count(
        self,
        direction: str,
        start_mask: np.ndarray,
        label_code: int,
        hops: int,
        keep_mask: np.ndarray | None = None,
    ) -> int:
        """Distinct nodes in the ``hops``-step frontier passing ``keep``
        (the BASELINE config[2] shape) — convenience over :meth:`run`."""
        plan = [("hop", (direction,)) for _ in range(hops)]
        masks: list[np.ndarray] = []
        if keep_mask is not None:
            masks.append(keep_mask)
            plan.append(("mask", 0))
        final = self.run(plan, start_mask, [label_code] * hops, masks)
        return int(final.sum())
