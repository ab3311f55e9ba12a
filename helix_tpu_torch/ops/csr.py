"""Device graph traversal over a padded adjacency (PyTorch port of
``helix_tpu/ops/csr.py``).

The layout is the reference's: per direction an ``[N, P]`` int32
neighbor-slot matrix (P = max degree, rows padded with ``N``) and a
parallel int32 edge-label-code matrix (pad ``-1``).  A frontier is a
``[N]`` bool mask (set semantics); one hop scatters ``True`` into the
next mask at every label-matching neighbor slot of a live row.  The
scatter writes only ``True``, so duplicate targets are harmless, and the
pad target ``N`` lands in an ``N + 1`` buffer that is cut afterwards.

Each hop is frontier-size-adaptive, as in the reference.  XLA picks a
tier with ``lax.cond`` inside one jit; eager torch reads the live count
once per hop (``mask.nonzero()``, one device sync that also yields the
live rows) and picks the tier on the host:

- a compact tier (live count <= 4096 or <= 65536): gather only the live
  rows' neighbor and label slots and scatter ``F * P`` targets;
- the dense tier: scatter every row's masked slots (``N * P``).

Every tier yields the same mask; the choice affects cost only.  Eager
torch has no fixed shapes to pad the live list to, so both compact tiers
run the same gather; ``TIER_HOPS`` counts the hops each tier served.

The first :class:`PaddedGraph` on a CUDA device in a process runs one
hop of each shape class the hop launches (:func:`_load_hop_kernels`).
CUDA loads a kernel's module at its first launch (lazy loading; 77-108
ms for ``index_select``'s small-index kernel on the H100), and the
engine's traversal router, which leaves out only each backend's first
run, would time that load as the device path's cost wherever a later
read first reached a new shape class (a frontier of at most 16 rows).
The reference pays its one XLA compile in that first run.

Indices stay int32 in the resident matrices (``PADDED_BYTES_CAP``
reckons 8 bytes per slot); only the scattered slice is widened to int64
for ``index_fill_``.  ``khop_mask.cuda_calls`` counts the calls made on
CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch


class PaddedGraph:
    """Device-ready padded adjacency for one direction."""

    def __init__(
        self,
        neighbors: np.ndarray,    # [N, P] int32 dst slots, N = pad
        edge_labels: np.ndarray,  # [N, P] int32 edge label codes, -1 = pad
        *,
        device: torch.device | str,
    ):
        self.n = neighbors.shape[0]
        self.p = neighbors.shape[1]
        self.device = torch.device(device)
        self.neighbors = torch.from_numpy(
            np.ascontiguousarray(neighbors, np.int32)).to(self.device)
        self.edge_labels = torch.from_numpy(
            np.ascontiguousarray(edge_labels, np.int32)).to(self.device)
        _load_hop_kernels(self)

    @staticmethod
    def host_arrays(
        indptr: np.ndarray,
        edge_endpoint_slots: np.ndarray,  # dst slot per edge index, CSR order
        edge_label_codes: np.ndarray,     # label code per edge index, CSR order
        n_nodes: int,
        max_degree_cap: int = 256,
        edge_order: np.ndarray | None = None,  # global edge slot per CSR pos
    ) -> "tuple[np.ndarray, ...] | None":
        """Padded (neighbors, labels[, edge_slots]) host layout from CSR;
        None when max degree exceeds the cap (callers fall back to the
        host gather path).  ``edge_order`` (the CSR-order global edge
        slot of each position) adds a third plane, pad = -1."""
        assert indptr[0] == 0, "CSR views must be rebased to offset 0"
        degrees = np.diff(indptr)
        p = int(degrees.max()) if len(degrees) and degrees.max() > 0 else 1
        if p > max_degree_cap:
            return None
        neighbors = np.full((n_nodes, p), n_nodes, np.int32)
        labels = np.full((n_nodes, p), -1, np.int32)
        eslots = (
            np.full((n_nodes, p), -1, np.int32)
            if edge_order is not None else None
        )
        total = int(degrees.sum())
        if total:
            rows = np.repeat(np.arange(n_nodes), degrees)
            ranks = np.arange(total) - np.repeat(indptr[:-1], degrees)
            neighbors[rows, ranks] = edge_endpoint_slots[:total]
            labels[rows, ranks] = edge_label_codes[:total]
            if eslots is not None:
                eslots[rows, ranks] = edge_order[:total]
        if eslots is not None:
            return neighbors, labels, eslots
        return neighbors, labels

    @staticmethod
    def from_csr(
        indptr: np.ndarray,
        edge_endpoint_slots: np.ndarray,
        edge_label_codes: np.ndarray,
        n_nodes: int,
        max_degree_cap: int = 256,
        *,
        device: torch.device | str,
    ) -> "PaddedGraph | None":
        host = PaddedGraph.host_arrays(
            indptr, edge_endpoint_slots, edge_label_codes, n_nodes,
            max_degree_cap,
        )
        if host is None:
            return None
        return PaddedGraph(*host, device=device)


# Compact-tier sizes for the adaptive hop (the reference's).  A hop whose
# live count fits the smallest tier below N gathers the live rows; above
# every tier it takes the dense scatter.
_COMPACT_TIERS = (4096, 65536)
TIER_HOPS: dict = {4096: 0, 65536: 0, "dense": 0}


def _scatter_true(n: int, targets: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(n + 1, dtype=torch.bool, device=targets.device)
    out.index_fill_(0, targets.reshape(-1).long(), True)
    return out[:n]


def _adaptive_hop(neighbors, edge_labels, mask, label_code: int,
                  count: bool = True):
    n, _ = neighbors.shape
    live = mask.nonzero().squeeze(1)      # one sync: the count and the rows
    cnt = int(live.numel())
    tier = next((f for f in _COMPACT_TIERS if f < n and cnt <= f), "dense")
    if count:
        TIER_HOPS[tier] += 1
    if tier == "dense":
        rows, labs = neighbors, edge_labels
        ok = mask[:, None]
        if label_code >= 0:
            ok = ok & (labs == label_code)
    else:
        rows = neighbors.index_select(0, live)
        labs = edge_labels.index_select(0, live)
        ok = (labs == label_code) if label_code >= 0 else None
    targets = rows if ok is None else torch.where(ok, rows, n)
    return _scatter_true(n, targets)


# CUDA devices whose hop kernels this process has loaded.
_WARM_DEVICES: set = set()


def _load_hop_kernels(graph: PaddedGraph) -> None:
    """On a CUDA device not yet warm: one hop from one live row
    (``index_select``'s small-index kernel), from 32 rows (its
    large-index kernel) and from every row (the dense tier), with and
    without a label, so that every kernel the hop launches is loaded
    before a traversal is timed.  Counted neither in ``TIER_HOPS`` nor in
    ``khop_mask.cuda_calls``.  A graph with no compact tier below its
    size loads only the dense tier's kernels and leaves the device cold
    for the next graph."""
    device = graph.neighbors.device
    if device.type != "cuda" or device in _WARM_DEVICES:
        return
    for live in (1, min(graph.n, 32), graph.n):
        mask = torch.zeros(graph.n, dtype=torch.bool, device=device)
        mask[:live] = True
        for code in (-1, 0):
            _adaptive_hop(graph.neighbors, graph.edge_labels, mask, code,
                          count=False)
    if graph.n > _COMPACT_TIERS[0]:
        _WARM_DEVICES.add(device)


def khop_mask(
    neighbors: torch.Tensor,    # [N, P] int32, pad = N
    edge_labels: torch.Tensor,  # [N, P] int32, pad = -1
    start_mask: torch.Tensor,   # [N] bool
    label_code: int,            # -1 = any label
    hops: int,
) -> torch.Tensor:
    """Frontier mask after exactly ``hops`` expansions (BFS frontier, not
    closure): each hop replaces the mask with the neighbor set."""
    if neighbors.is_cuda:
        khop_mask.cuda_calls += 1
    mask = start_mask
    for _ in range(hops):
        mask = _adaptive_hop(neighbors, edge_labels, mask, int(label_code))
    return mask


khop_mask.cuda_calls = 0


def khop_count(
    neighbors: torch.Tensor,
    edge_labels: torch.Tensor,
    start_mask: torch.Tensor,
    label_code: int,
    hops: int,
    keep_mask: torch.Tensor,    # [N] bool post-filter (where_ predicate mask)
) -> torch.Tensor:
    """Count of distinct nodes in the k-hop frontier passing a filter
    (0-d int64 tensor on the graph's device)."""
    mask = khop_mask(neighbors, edge_labels, start_mask, label_code, hops)
    return torch.sum(mask & keep_mask)


def hybrid_expand(
    neighbors: torch.Tensor,
    edge_labels: torch.Tensor,
    seed_slots: torch.Tensor,   # [k] int32 vector-hit slots (pad = N)
    label_code: int,
    hops: int,
    keep_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hybrid step: seed slots from a vector top-k, expand the graph
    neighborhood, return the filtered membership mask and its size."""
    n = neighbors.shape[0]
    start = _scatter_true(n, seed_slots)
    mask = khop_mask(neighbors, edge_labels, start, label_code, hops)
    mask = mask & keep_mask
    return mask, torch.sum(mask)
