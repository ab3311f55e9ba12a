"""IVF (inverted-file) ANN index: k-means build + probed search (PyTorch
port of ``helix_tpu/ops/ivf.py``).

The residency ladder's last rung for cosine: :class:`HostIVFIndex` keeps
the cell-sorted corpus in host memory and only the coarse centroids on
the device.  A search probes the ``nprobe`` nearest cells per query with
one device matmul, then scores either the union of the probed cells on
the device (streamed through pinned memory in bounded chunks) or each
query's own cells on the host (``helix_tpu_torch.native.rerank``), as the
measured-cost :class:`ProbeRouter` decides.  :class:`IVFIndex` is the
device-resident variant.

- **build** = spherical k-means, all matmuls: bf16 assignment (f32 sums
  of bf16 products) + ``argmax``, and ``index_add_`` for the
  reference's ``segment_sum`` centroid update; then a stable counting
  sort groups rows by cell.
- **search** = ``probe_cells`` (f32 query x centroid scores, top
  ``nprobe``) and ``score_block`` (exact f32 scan, top k).

Deliberate differences from the reference:

- Every f32 matmul here runs in true f32, the reference's
  ``Precision.HIGHEST``: TF32 is turned off by
  :func:`~helix_tpu_torch.ops.distance.require_fp32_matmul`, the port's
  one policy for that flag.
- Top-k breaks ties toward the lower index, as ``lax.top_k`` does
  (:func:`~helix_tpu_torch.ops.distance._top_k`).
- k-means sums its bf16 products and its ``index_add_`` in another
  order than XLA, so assignments near a tie can differ and the centroids
  drift; it is held to the reference by quality (inertia, recall), and
  the parity tests install the reference's fitted state
  (:func:`helix_tpu_torch.convert.host_ivf_from_reference`).
- The padding the reference adds for its compiled shapes is dropped
  (eager torch compiles none): k-means scans only real rows (the padded
  rows carry zero weight there), and a streamed union chunk goes to the
  device at its own row count instead of the next power of two.

``kmeans_fit``, ``probe_cells`` and ``score_block`` count their calls on
CUDA tensors in ``.cuda_calls``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .distance import _coarse_dot, _top_k, require_fp32_matmul


def kmeans_fit(
    data: torch.Tensor,       # [N, D] float32 (pre-normalized for cosine)
    init: torch.Tensor,       # [C, D] initial centroids
    *,
    n_clusters: int,
    iters: int,
    chunk: int = 131072,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Spherical k-means.  Returns (centroids [C, D], assign [N])."""
    if data.is_cuda:
        kmeans_fit.cuda_calls += 1
    n, d = data.shape
    chunk = min(chunk, n)
    data16 = data.to(torch.bfloat16)
    ones = torch.ones(n, dtype=torch.float32, device=data.device)

    def assign_all(centroids):
        c16 = centroids.to(torch.bfloat16)
        return torch.cat([
            torch.argmax(_coarse_dot(data16[s:s + chunk], c16), dim=1)
            for s in range(0, n, chunk)
        ])

    centroids = init.float()
    require_fp32_matmul()
    for _ in range(iters):
        assign = assign_all(centroids)
        sums = torch.zeros((n_clusters, d), dtype=torch.float32,
                           device=data.device).index_add_(0, assign, data)
        counts = torch.zeros(n_clusters, dtype=torch.float32,
                             device=data.device).index_add_(0, assign, ones)
        fresh = sums / torch.clamp(counts, min=1.0)[:, None]
        # Keep empty cells at their previous position.
        fresh = torch.where(counts[:, None] > 0, fresh, centroids)
        norms = torch.linalg.norm(fresh, dim=1, keepdim=True)
        centroids = fresh / torch.clamp(norms, min=1e-9)
    return centroids, assign_all(centroids)


kmeans_fit.cuda_calls = 0


def _assign_rows(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment for one row chunk (build path)."""
    require_fp32_matmul()
    return torch.argmax(x @ c.T, dim=1)


def ivf_search(
    packed: torch.Tensor,     # [N, D] rows grouped by cell (f32)
    centroids: torch.Tensor,  # [C, D]
    cell_rows: torch.Tensor,  # [C, M] row indices into packed (pad = N)
    qs: torch.Tensor,         # [B, D]
    *,
    k: int,
    nprobe: int,
    pad: int,                 # M
) -> tuple[torch.Tensor, torch.Tensor]:
    """Probed search.  Returns (cosine distances [B,k], packed-row idx)."""
    n = packed.shape[0]
    b = qs.shape[0]
    cscores = _coarse_dot(qs.to(torch.bfloat16), centroids.to(torch.bfloat16))
    _, probes = _top_k(cscores, nprobe)       # [B, nprobe]
    cand = cell_rows[probes].reshape(b, nprobe * pad)  # [B, nprobe*M]
    valid = cand < n
    safe = torch.where(valid, cand, 0)
    vectors = packed[safe]                             # [B, nprobe*M, D]
    require_fp32_matmul()
    sims = torch.einsum("bmd,bd->bm", vectors, qs)
    sims = torch.where(valid, sims, float("-inf"))
    best_s, pos = _top_k(sims, min(k, sims.shape[1]))
    best_rows = torch.gather(cand, 1, pos)
    # rows selected from padding (fewer than k valid candidates in the
    # probed cells) carry the sentinel index n — emit -1 so callers can
    # strip them instead of indexing out of bounds
    best_rows = torch.where(torch.isfinite(best_s), best_rows, -1)
    return 1.0 - best_s, best_rows


def _normalized(data: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(data, axis=1, keepdims=True)
    return data / np.maximum(norms, 1e-9)


class IVFIndex:
    """Built index: packed rows, centroids, cell table, id mapping, all
    on one device."""

    def __init__(
        self,
        packed: torch.Tensor,
        centroids: torch.Tensor,
        cell_rows: torch.Tensor,
        row_to_original: np.ndarray,
        pad: int,
        build_seconds: float,
    ):
        self.packed = packed
        self.centroids = centroids
        self.cell_rows = cell_rows
        self.row_to_original = row_to_original
        self.pad = pad
        self.build_seconds = build_seconds

    @staticmethod
    def build(
        data: np.ndarray,
        n_clusters: int | None = None,
        iters: int = 8,
        seed: int = 0,
        normalize: bool = True,
        *,
        device: torch.device | str,
    ) -> "IVFIndex":
        start = time.perf_counter()
        device = torch.device(device)
        data = np.asarray(data, np.float32)
        if normalize:
            data = _normalized(data)
        n = len(data)
        if n_clusters is None:
            n_clusters = max(16, int(4 * math.sqrt(n)))
        n_clusters = min(n_clusters, n)
        rng = np.random.default_rng(seed)
        init = data[rng.choice(n, n_clusters, replace=False)]

        centroids, assign = kmeans_fit(
            torch.from_numpy(data).to(device),
            torch.from_numpy(init).to(device),
            n_clusters=n_clusters, iters=iters,
        )
        assign_h = assign.cpu().numpy()

        order = np.argsort(assign_h, kind="stable")
        packed_h = data[order]
        counts = np.bincount(assign_h, minlength=n_clusters)
        indptr = np.concatenate(([0], np.cumsum(counts)))
        pad = max(1, int(counts.max()))
        cell_rows = np.full((n_clusters, pad), n, np.int64)
        rows = np.arange(n)
        ranks = rows - indptr[assign_h[order]]
        cell_rows[assign_h[order], ranks] = rows
        index = IVFIndex(
            torch.from_numpy(packed_h).to(device),
            centroids,
            torch.from_numpy(cell_rows).to(device),
            order,
            pad,
            0.0,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        index.build_seconds = time.perf_counter() - start
        return index

    def search(
        self, queries: np.ndarray, k: int, nprobe: int = 16,
        normalize: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (distances [B,k], original row indices [B,k])."""
        queries = np.asarray(queries, np.float32)
        if normalize:
            queries = _normalized(queries)
        nprobe = min(nprobe, self.centroids.shape[0])
        dists, rows = ivf_search(
            self.packed, self.centroids, self.cell_rows,
            torch.from_numpy(queries).to(self.packed.device),
            k=k, nprobe=nprobe, pad=self.pad,
        )
        rows_h = rows.cpu().numpy()
        # -1 marks short rows (< k candidates in the probed cells);
        # keep the sentinel through the id mapping for callers to strip
        valid = rows_h >= 0
        mapped = np.where(
            valid, self.row_to_original[np.where(valid, rows_h, 0)], -1
        )
        return dists.cpu().numpy(), mapped


def probe_cells(
    centroids: torch.Tensor,  # [C, D]
    qs: torch.Tensor,         # [B, D] normalized queries
    *,
    nprobe: int,
) -> torch.Tensor:
    """Top-``nprobe`` coarse cells per query: one [B, C] f32 matmul."""
    if centroids.is_cuda:
        probe_cells.cuda_calls += 1
    require_fp32_matmul()
    sims = qs @ centroids.T
    _, cells = _top_k(sims, nprobe)
    return cells


probe_cells.cuda_calls = 0


def score_block(
    block: torch.Tensor,      # [M, D] candidate rows (union of probed cells)
    qs: torch.Tensor,         # [B, D]
    n_valid: int,             # valid rows in block
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k of the query batch against a streamed block."""
    if block.is_cuda:
        score_block.cuda_calls += 1
    require_fp32_matmul()
    sims = qs @ block.T
    cols = torch.arange(block.shape[0], device=block.device)
    sims = torch.where((cols < n_valid)[None, :], sims, float("-inf"))
    best_s, pos = _top_k(sims, k)
    return 1.0 - best_s, pos


score_block.cuda_calls = 0


class ProbeRouter:
    """Measured per-unit-cost routing between the two scoring paths of
    the beyond-budget tier (same philosophy as the engine's
    ``TraversalRouter``: route on measurement, not backend identity).

    - **device** (union-stream): cost scales with the H2D bytes of the
      probed-cell union — the right path when batches are dense.
    - **host** (probed re-rank): cost scales with per-query candidate
      incidences — the right path when the link is thin or probe lists
      barely overlap.

    The router keeps an EWMA of each path's measured cost *per unit of
    its own work* (seconds per union row / per incidence), predicts
    both costs for the batch at hand, and picks the cheaper; every
    64th decision re-samples the loser so a stale estimate can flip
    the route back.  ``HELIX_IVF_BACKEND=device|host`` forces a path.
    """

    EXPLORE_EVERY = 64
    ALPHA = 0.3

    def __init__(self):
        self.rate: dict[str, float] = {}   # seconds per work unit
        self.runs: dict[str, int] = {"device": 0, "host": 0}
        self.decisions = 0

    def choose(self, device_units: float, host_units: float) -> str:
        import os

        mode = os.environ.get("HELIX_IVF_BACKEND", "auto")
        if mode in ("device", "host"):
            return mode
        for path in ("host", "device"):  # bootstrap: one sample each
            if path not in self.rate:
                return path
        self.decisions += 1
        pred = {
            "device": self.rate["device"] * max(device_units, 1.0),
            "host": self.rate["host"] * max(host_units, 1.0),
        }
        best = min(pred, key=pred.get)
        if self.decisions % self.EXPLORE_EVERY == 0:
            worst = max(pred, key=pred.get)
            if worst != best:
                return worst
        return best

    def record(self, path: str, elapsed_s: float, units: float) -> None:
        self.runs[path] = self.runs.get(path, 0) + 1
        if self.runs[path] == 1 and path == "device":
            return  # warm-up: first allocations dominate the first run
        per_unit = elapsed_s / max(units, 1.0)
        prev = self.rate.get(path)
        self.rate[path] = (
            per_unit if prev is None
            else prev + self.ALPHA * (per_unit - prev)
        )


class HostIVFIndex:
    """Beyond-budget IVF tier: the packed corpus stays in HOST memory;
    the device holds only the coarse centroids.

    Per search batch: (1) one device matmul probes the ``nprobe``
    nearest cells per query; (2) scoring routes by measured cost
    (``ProbeRouter``) between two paths:

    - **union-stream (device)**: the host gathers the UNION of probed
      cells (contiguous ranges after the build's counting sort) into a
      pinned staging tensor, one chunk at a time; each chunk streams H2D
      and every query exact-scans it.  Scoring the union instead of
      per-query probe lists only ADDS candidates, so recall is >=
      classical IVF at the same nprobe.
    - **probed re-rank (host)**: classical IVF — each query scores only
      its own probed cells' rows, through the native row-sorted re-rank
      kernel (``helix_tpu_torch.native.rerank``), with zero H2D.

    Build scales past device memory too: k-means fits on a
    device-resident SAMPLE (``sample_cap`` rows), then assignment
    streams the full corpus through the device in chunks.
    """

    #: cap on bytes of candidate block resident on the device per
    #: streamed chunk — the union can exceed device memory at the corpus
    #: scales this tier exists for
    STREAM_BYTES = 1 << 30

    def __init__(
        self,
        packed: np.ndarray,            # [N, D] host, cell-sorted, normalized
        centroids: torch.Tensor,       # [C, D] device
        indptr: np.ndarray,            # [C+1] cell boundaries in packed
        row_to_original: np.ndarray,   # packed row -> original row
        build_seconds: float,
    ):
        self.packed = packed
        self.centroids = centroids
        self.device = centroids.device
        self.indptr = indptr
        self.row_to_original = row_to_original
        self.build_seconds = build_seconds
        self.n = len(packed)
        # observability (advertised cost model): defined from birth and
        # refreshed per search, including early-return empty searches
        self.last_block_rows = 0
        self.last_streamed_bytes = 0
        self.last_path = None
        self.router = ProbeRouter()
        # cosine-only tier: the re-rank kernel never reads sq_norms
        self._sq_unused = np.zeros(1, np.float32)

    @staticmethod
    def build(
        data: np.ndarray,
        n_clusters: int | None = None,
        iters: int = 8,
        seed: int = 0,
        normalize: bool = True,
        sample_cap: int = 2_000_000,
        assign_chunk: int = 1_000_000,
        *,
        device: torch.device | str,
    ) -> "HostIVFIndex":
        start = time.perf_counter()
        device = torch.device(device)
        data = np.asarray(data, np.float32)
        if normalize:
            data = _normalized(data)
        n = len(data)
        if n_clusters is None:
            n_clusters = max(16, int(4 * math.sqrt(n)))
        n_clusters = min(n_clusters, n)
        rng = np.random.default_rng(seed)

        # fit on a device-resident sample; the full corpus never needs
        # to be device-resident at once
        sample = (
            data if n <= sample_cap
            else data[rng.choice(n, sample_cap, replace=False)]
        )
        init = sample[rng.choice(len(sample), n_clusters, replace=False)]
        centroids, _ = kmeans_fit(
            torch.from_numpy(np.ascontiguousarray(sample)).to(device),
            torch.from_numpy(init).to(device),
            n_clusters=n_clusters, iters=iters,
        )

        # streamed assignment of every row; the [chunk, C] f32 scores
        # are bounded to ~512 MB (chunk scales inversely with C)
        assign_chunk = min(
            assign_chunk, max(8192, (512 << 20) // (n_clusters * 4))
        )
        assign_h = np.empty(n, np.int32)
        for lo in range(0, n, assign_chunk):
            hi = min(n, lo + assign_chunk)
            block = torch.from_numpy(data[lo:hi]).to(device)
            assign_h[lo:hi] = _assign_rows(block, centroids).cpu().numpy()

        order = np.argsort(assign_h, kind="stable")
        packed = np.ascontiguousarray(data[order])
        counts = np.bincount(assign_h, minlength=n_clusters)
        indptr = np.concatenate(([0], np.cumsum(counts)))
        return HostIVFIndex(
            packed, centroids, indptr, order,
            time.perf_counter() - start,
        )

    def search(
        self,
        queries: np.ndarray,
        k: int,
        nprobe: int = 32,
        normalize: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (distances [B,k'], original row indices [B,k'])."""
        queries = np.asarray(queries, np.float32)
        if normalize:
            queries = _normalized(queries)
        nprobe = min(nprobe, int(self.centroids.shape[0]))
        qs_dev = torch.from_numpy(queries).to(self.device)
        cells = probe_cells(self.centroids, qs_dev, nprobe=nprobe) \
            .cpu().numpy()

        # union of probed cells -> contiguous ranges in packed
        probed = np.unique(cells)
        starts = self.indptr[probed]
        ends = self.indptr[probed + 1]
        total = int((ends - starts).sum())
        if total == 0:
            b = len(queries)
            self.last_path = "empty"   # neither scorer ran (contract:
            self.last_block_rows = 0   # fields refresh EVERY search)
            self.last_streamed_bytes = 0
            return np.zeros((b, 0), np.float32), np.zeros((b, 0), np.int64)

        # per-query incidence count (the host path's work unit)
        q_counts = (self.indptr[cells + 1] - self.indptr[cells]).sum(axis=1)
        incidences = int(q_counts.sum())

        path = self.router.choose(
            device_units=float(total), host_units=float(incidences)
        )
        t0 = time.perf_counter()
        if path == "host":
            out = self._search_probed_host(
                queries, min(k, total), cells, q_counts
            )
            self.router.record("host", time.perf_counter() - t0, incidences)
            self.last_path = "host"
            self.last_block_rows = 0
            self.last_streamed_bytes = 0
            return out
        out = self._search_union_device(
            qs_dev, k, starts, ends, total
        )
        self.router.record("device", time.perf_counter() - t0, total)
        self.last_path = "device"
        return out

    def _search_probed_host(
        self, queries: np.ndarray, k_eff: int, cells: np.ndarray,
        q_counts: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Classical per-query probed IVF through the native row-sorted
        re-rank kernel: zero H2D, FLOPs bounded by the probe lists."""
        from ..native import rerank as native_rerank

        b = len(queries)
        kc = max(1, int(q_counts.max()))
        cand = np.full((b, kc), -1, np.int64)
        starts = self.indptr[cells]
        ends = self.indptr[cells + 1]
        # Vectorized ragged fill: each (query, probed cell) run writes
        # arange(start, end) at its running column offset.
        lens = ends - starts                       # [B, nprobe]
        col_off = np.cumsum(lens, axis=1) - lens   # run -> first column
        flat_lens = lens.ravel()
        nz = flat_lens > 0
        reps = flat_lens[nz]
        if len(reps):
            run_rows = np.repeat(
                np.arange(b, dtype=np.int64), lens.shape[1]
            )[nz]
            run_cols = col_off.ravel()[nz]
            run_starts = starts.ravel()[nz]
            within = (
                np.arange(int(reps.sum()), dtype=np.int64)
                - np.repeat(np.cumsum(reps) - reps, reps)
            )
            cand[
                np.repeat(run_rows, reps), np.repeat(run_cols, reps) + within
            ] = np.repeat(run_starts, reps) + within
        dists, rows = native_rerank(
            self.packed, self._sq_unused, queries, cand, k_eff, "cosine"
        )
        valid = rows >= 0
        mapped = np.where(
            valid, self.row_to_original[np.where(valid, rows, 0)], -1
        )
        return dists, mapped

    def _search_union_device(
        self, qs_dev: torch.Tensor, k: int,
        starts: np.ndarray, ends: np.ndarray, total: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        block_rows = np.concatenate(
            [np.arange(s, e) for s, e in zip(starts, ends)]
        )
        dim = self.packed.shape[1]
        # observability: bytes the last search streamed to the device
        # (the tier's cost model is data movement, not FLOPs)
        self.last_block_rows = total
        self.last_streamed_bytes = int(total * dim * 4)
        k_eff = min(k, total)
        # Stream the union through the device in bounded chunks (the
        # candidate set can exceed device memory); per-chunk top-k on
        # the device, cross-chunk merge on the host.
        stream_rows = max(1 << 16, self.STREAM_BYTES // (4 * dim))
        if total <= stream_rows:
            spans = [(0, total)]
        else:
            spans = [
                (lo, min(total, lo + stream_rows))
                for lo in range(0, total, stream_rows)
            ]
        packed = torch.from_numpy(self.packed)
        rows = torch.from_numpy(block_rows)
        parts_d, parts_i = [], []
        for lo, hi in spans:
            m = hi - lo
            # gathered straight into a staging tensor by torch's threaded
            # index_select, unpadded (eager torch has no compiled shape to
            # pad to).  One per chunk, never shared, since reads search
            # concurrently; on CUDA it is pinned (an asynchronous H2D copy
            # at full link rate), and torch's pinned-memory cache hands a
            # block out again only once the copy that reads it has ended.
            staging = torch.empty((m, dim), dtype=torch.float32,
                                  pin_memory=self.device.type == "cuda")
            torch.index_select(packed, 0, rows[lo:hi], out=staging)
            piece = staging.to(self.device, non_blocking=True)
            dists, pos = score_block(piece, qs_dev, m, k=min(k_eff, m))
            parts_d.append(dists.cpu().numpy())
            parts_i.append(block_rows[pos.cpu().numpy() + lo])
        if len(parts_d) == 1:
            dists_h, rows_h = parts_d[0], parts_i[0]
        else:
            merged_d = np.concatenate(parts_d, axis=1)
            merged_i = np.concatenate(parts_i, axis=1)
            order = np.argsort(merged_d, axis=1, kind="stable")[:, :k_eff]
            dists_h = np.take_along_axis(merged_d, order, axis=1)
            rows_h = np.take_along_axis(merged_i, order, axis=1)
        return dists_h, self.row_to_original[rows_h]
