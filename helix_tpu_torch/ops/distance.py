"""Batched distance + top-k over a device-resident packed matrix (PyTorch
port of ``helix_tpu/ops/distance.py``).

Two phases, as in the reference: a coarse bf16 scan that picks
``rerank * k`` candidates per query (:func:`topk_resident`, plain torch
ops but for the l2 single shot's score step, the Hopper kernel
``csrc/l2_scores.cu`` through :func:`l2_scores`; or the fused Hopper
kernel through :func:`resident_topk_auto`), then an exact f32 re-rank of
those candidates on the device.  The
re-rank runs with TF32 off (:func:`require_fp32_matmul`), so
``$distance`` is a true f32 value as in the reference.

Deliberate differences from the reference:

- ``approx_max_k`` becomes an exact top-k in ``lax.top_k``'s order, ties
  toward the lower index (as ``approx_max_k`` is on the CPU): its sites
  and ``lax.top_k``'s select through :func:`_top_k`, the selection kernel
  ``csrc/select_topk.cu`` on the card (``ops/topk.py``).
- ``copy_to_host_async`` becomes a non-blocking copy into pinned host
  tensors plus a recorded CUDA event that ``finalize`` waits on.

:func:`topk_scores` (the self-contained search of ``graft.entry``) and
the mesh's per-shard scan (``parallel/sharded.py:_local_topk``) share one
chunked scan with a running top-k, :func:`chunked_topk`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels, tracing
from . import topk as _topk


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pick_chunk(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= target."""
    if n <= target:
        return n
    for c in range(target, 0, -1):
        if n % c == 0:
            return c
    return n


# [B, N] f32 score-buffer budget for the single-shot coarse phase.
SINGLE_SHOT_BYTES = 2 << 30


def require_fp32_matmul() -> None:
    """The exact re-rank must be true fp32: TF32 keeps ~3 decimal digits
    and would move ``$distance`` away from the reference.  The port's one
    policy for the flag, set before every f32 matmul that stands for the
    reference's ``Precision.HIGHEST`` (re-rank, IVF).  The flags are
    process-wide and only ever turned off here (torch's own default for
    matmul), so a concurrent reader never finds TF32 switched back on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``'s counterpart: exact top-k along the last axis,
    descending in its total order (+NaN, +inf, ..., +0.0, -0.0, ...,
    -inf, -NaN), ties to the lower index, so candidate sets match the
    reference even where bf16 scores tie.  ``approx_max_k``'s
    counterpart too: exact, as it is on the CPU, where XLA orders f32
    rows as ``lax.top_k`` does (``ops/topk.py``).  On the card the
    selection kernel (``ops/topk.select_topk``)."""
    return _topk.select_topk(x, k)


def _coarse_dot(qs16: torch.Tensor, xs16: torch.Tensor) -> torch.Tensor:
    """f32 sums of bf16 products (``preferred_element_type=f32``)."""
    return qs16.float() @ xs16.float().T


# What csrc/l2_scores.cu takes: whole 64-row tiles (N % 64, N < 2^31),
# the feature dim in 64-column chunks (one 128-byte swizzle row of bf16;
# PackedMatrix.DIM_PAD is 128, so every matrix qualifies), and a compute
# width of 128 or 256 queries (its m64n128 / m64n256 product).  A batch
# runs in launches of at most L2_MAX_WIDTH queries, each writing its rows
# of one output.
L2_TILE_ROWS = 64
L2_DEPTH = 64
L2_WIDTHS = (128, 256)
L2_MAX_WIDTH = L2_WIDTHS[-1]


def l2_kernel_refusal(n: int, d: int) -> str | None:
    """Why ``csrc/l2_scores.cu`` cannot take ``xs [n, d]``, or None when
    it can (any batch: :func:`l2_query_blocks` splits it)."""
    if n <= 0 or n % L2_TILE_ROWS or n >= 1 << 31:
        return f"N={n} is not a positive multiple of {L2_TILE_ROWS} below 2^31"
    if d <= 0 or d % L2_DEPTH:
        return f"D={d} is not a positive multiple of {L2_DEPTH}"
    return None


def l2_query_blocks(b: int) -> list[tuple[int, int, int]]:
    """The launches of ``csrc/l2_scores.cu`` for ``b`` queries:
    ``(first query, queries, compute width)`` each, at most
    ``L2_MAX_WIDTH`` queries a launch, the width the least of
    ``L2_WIDTHS`` that holds them (the kernel reads the missing queries
    as zeros and writes only the given rows)."""
    if b <= 0:
        raise ValueError(f"l2_scores takes at least one query, got {b}")
    blocks = []
    for start in range(0, b, L2_MAX_WIDTH):
        rows = min(L2_MAX_WIDTH, b - start)
        width = next(w for w in L2_WIDTHS if rows <= w)
        blocks.append((start, rows, width))
    return blocks


def l2_scores_reference(xs16: torch.Tensor, qs16: torch.Tensor,
                        sq_norms: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`l2_scores`: ``2 q.x - |x|^2`` from
    f32 sums of bf16 products, -inf at rows ``>= n_valid``."""
    n = xs16.shape[0]
    sims = 2.0 * _coarse_dot(qs16, xs16) - sq_norms[None, :]
    cols = torch.arange(n, device=xs16.device)
    return torch.where((cols < n_valid)[None, :], sims, float("-inf"))


def l2_scores(xs16: torch.Tensor, qs16: torch.Tensor, sq_norms: torch.Tensor,
              n_valid: int) -> torch.Tensor:
    """The l2 single shot's ``[B, N]`` f32 scores of ``qs16 [B, D]``
    against ``xs16 [N, D]`` (both bf16) with the squared norms
    ``sq_norms [N]`` (f32): ``2 q.x - |x|^2``, -inf at rows ``>= n_valid``.

    CUDA tensors launch ``csrc/l2_scores.cu`` through
    :func:`~helix_tpu_torch.kernels.launch`, once per block of
    :func:`l2_query_blocks`, each counted in ``l2_scores.launches``
    (``.captured`` where the stream captures a CUDA graph); CPU tensors
    run :func:`l2_scores_reference`.  Shapes the kernel does not take
    (:func:`l2_kernel_refusal`) raise on either device, and so does
    anything else the kernel does not take."""
    if (xs16.dim() != 2 or qs16.dim() != 2 or xs16.shape[1] != qs16.shape[1]
            or sq_norms.shape != (xs16.shape[0],)):
        raise ValueError(
            f"l2_scores shapes: xs [N, D], qs [B, D] and sq [N], got "
            f"{tuple(xs16.shape)}, {tuple(qs16.shape)} and "
            f"{tuple(sq_norms.shape)}"
        )
    n, d = xs16.shape
    b = qs16.shape[0]
    refusal = l2_kernel_refusal(n, d)
    if refusal is not None:
        raise ValueError(f"l2_scores: {refusal}")
    blocks = l2_query_blocks(b)
    devices = {xs16.device, qs16.device, sq_norms.device}
    if devices == {torch.device("cpu")}:
        return l2_scores_reference(xs16, qs16, sq_norms, n_valid)
    kernels.check_operands(
        "l2_scores", {"xs16": xs16, "qs16": qs16, "sq_norms": sq_norms},
        {"xs16": torch.bfloat16, "qs16": torch.bfloat16,
         "sq_norms": torch.float32},
    )
    n_valid = max(0, min(int(n_valid), n))
    out = torch.empty((b, n), dtype=torch.float32, device=xs16.device)
    entry, dev = kernels.load().hx_l2_scores, xs16.get_device()
    for start, rows, width in blocks:
        kernels.launch(
            l2_scores, entry, dev, xs16.data_ptr(),
            qs16.data_ptr() + start * d * 2, sq_norms.data_ptr(),
            out.data_ptr() + start * n * 4, n, d, rows, width, n_valid,
        )
    return out


l2_scores.launches = 0
l2_scores.captured = 0


def _scores(qs_c: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """f32 scores of ``qs_c`` against ``block`` (both bf16: f32 sums of
    bf16 products; both f32: a true f32 product, TF32 off)."""
    if block.dtype == torch.bfloat16:
        return _coarse_dot(qs_c, block)
    require_fp32_matmul()
    return qs_c.float() @ block.float().T


def chunked_topk(
    xs_c: torch.Tensor,       # [N, D] scan operand (bf16 or f32)
    qs_c: torch.Tensor,       # [B, D] queries, same dtype
    n_valid: int,
    sq_norms: torch.Tensor,   # [N] f32 (l2 only)
    *,
    k: int,
    chunk: int,
    metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan with a running top-k: ``(scores [B, k], ids [B, k])``
    descending (l2 scores are ``2 q.x - |x|^2``).  ``chunk`` is cut to a
    divisor of N (:func:`pick_chunk`); the running state starts at
    (-inf, id 0), so a row with fewer than k valid rows keeps id 0 in
    its -inf slots, as the reference's ``lax.scan`` does.  ``k`` must not
    exceed the chunk."""
    n = xs_c.shape[0]
    b = qs_c.shape[0]
    chunk = pick_chunk(n, min(chunk, n))
    best_s = torch.full((b, k), float("-inf"), device=xs_c.device)
    best_i = torch.zeros((b, k), dtype=torch.int64, device=xs_c.device)
    col_base = torch.arange(chunk, device=xs_c.device)
    for start in range(0, n, chunk):
        sims = _scores(qs_c, xs_c[start:start + chunk])
        cols = start + col_base
        if metric == "l2":
            sims = 2.0 * sims - sq_norms[start:start + chunk][None, :]
        sims = torch.where((cols < n_valid)[None, :], sims, float("-inf"))
        # ref :107/:111 (approx_max_k over bf16 operands, else top_k)
        s_chunk, i_local = _top_k(sims, k)
        cat_s = torch.cat([best_s, s_chunk], dim=1)
        cat_i = torch.cat([best_i, cols[i_local]], dim=1)
        best_s, pos = _top_k(cat_s, k)
        best_i = torch.gather(cat_i, 1, pos)
    return best_s, best_i


def topk_scores(
    xs: torch.Tensor,         # [N, D] packed vectors (rows >= n_valid junk)
    qs: torch.Tensor,         # [B, D] query batch
    n_valid: int,
    sq_norms: torch.Tensor,   # [N] squared norms of xs rows (l2)
    *,
    k: int,
    chunk: int = 131072,
    metric: str = "cosine",
    bf16: bool = True,
    rerank: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Self-contained top-k with a device-only re-rank (the reference's
    ``topk_scores``): ``(distance [B, k], indices [B, k])`` ascending.
    A single-shot scan when the ``[B, N]`` f32 scores fit
    ``SINGLE_SHOT_BYTES``, else :func:`chunked_topk`; with ``bf16`` and
    ``rerank > 1`` the ``rerank * k`` candidates re-score in f32."""
    n, _ = xs.shape
    b = qs.shape[0]
    k_scan = min(max(k, rerank * k if (bf16 and rerank > 1) else k), n)
    xs_c = xs.to(torch.bfloat16) if bf16 else xs
    qs_c = qs.to(torch.bfloat16) if bf16 else qs
    if b * n * 4 <= SINGLE_SHOT_BYTES:
        sims = _scores(qs_c, xs_c)
        if metric == "l2":
            sims = 2.0 * sims - sq_norms[None, :]
        cols = torch.arange(n, device=xs.device)
        sims = torch.where((cols < n_valid)[None, :], sims, float("-inf"))
        # ref :88 approx_max_k (bf16), :92 top_k (f32)
        best_s, best_i = _top_k(sims, k_scan)
    else:
        best_s, best_i = chunked_topk(
            xs_c, qs_c, n_valid, sq_norms, k=k_scan,
            chunk=min(chunk, n), metric=metric,
        )
    if k_scan > k:
        require_fp32_matmul()
        exact = torch.einsum("bkd,bd->bk", xs[best_i].float(), qs.float())
        if metric == "l2":
            exact = 2.0 * exact - sq_norms[best_i]
        exact = torch.where(torch.isfinite(best_s), exact, float("-inf"))
        best_s, pos = _top_k(exact, k)
        best_i = torch.gather(best_i, 1, pos)
    if metric == "cosine":
        dists = 1.0 - best_s
    else:
        q_sq = torch.sum(qs.float() ** 2, dim=1, keepdim=True)
        dists = -best_s + q_sq
    return dists, best_i


def topk_resident(
    xs16: torch.Tensor,       # [N, D] bf16 resident matrix (coarse phase)
    xs32: torch.Tensor,       # [N, D] f32 resident matrix (re-rank)
    qs: torch.Tensor,         # [B, D] f32 query batch
    n_valid: int,
    sq_norms: torch.Tensor,
    *,
    k: int,
    metric: str = "cosine",
    rerank: int = 8,
    chunk: int = 131072,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over resident device matrices: a bf16 coarse phase picks
    ``rerank * k`` candidates, then an exact f32 re-rank on the device.
    Returns ``(dists [B, k], ids [B, k])`` ascending."""
    n, _ = xs16.shape
    b = qs.shape[0]
    k_scan = min(max(k, rerank * k), n)
    qs16 = qs.to(torch.bfloat16)
    if metric == "cosine" and b * n * 2 <= SINGLE_SHOT_BYTES:
        # Selection-only coarse phase: scores rounded to bf16 (only the
        # indices matter; the f32 re-rank below re-scores them).
        cols = torch.arange(n, device=xs16.device)
        sims = _coarse_dot(qs16, xs16).to(torch.bfloat16)
        sims = torch.where((cols < n_valid)[None, :], sims, -3.0e38)
        best_s16, best_i = _top_k(sims, k_scan)   # ref :179 approx_max_k
        best_s = best_s16.float()
        best_s = torch.where(best_s <= -1.0e38, float("-inf"), best_s)
    elif b * n * 4 <= SINGLE_SHOT_BYTES:
        # l2 alone gets here (cosine takes the branch above whenever this
        # fits): csrc/l2_scores.cu on the card, its plain version on the CPU
        sims = l2_scores(xs16, qs16, sq_norms, n_valid)
        best_s, best_i = _top_k(sims, k_scan)     # ref :190 approx_max_k
    else:
        # Chunked scan with a running top-k merge: bounds the [B, chunk]
        # score buffer.
        best_s, best_i = chunked_topk(xs16, qs16, n_valid, sq_norms,
                                      k=k_scan, chunk=chunk, metric=metric)

    require_fp32_matmul()
    cand = xs32[best_i]
    exact = torch.einsum("bkd,bd->bk", cand, qs)
    if metric == "l2":
        exact = 2.0 * exact - sq_norms[best_i]
    exact = torch.where(torch.isfinite(best_s), exact, float("-inf"))
    best_s, pos = _top_k(exact, k)
    best_i = torch.gather(best_i, 1, pos)

    if metric == "cosine":
        dists = 1.0 - best_s
    else:
        q_sq = torch.sum(qs * qs, dim=1, keepdim=True)
        dists = -best_s + q_sq
    return dists, best_i


FUSED_ROW_THRESHOLD = 65536


class PackedMatrix:
    """Host-managed packed vector matrix with cached device copies.

    Rows are appended host-side (amortized growth, the reference's numpy
    code); the bf16 coarse copy and the f32 re-rank copy on ``device``
    are refreshed only when stale (version check), so repeated searches
    never re-upload.  Rows are padded to multiples of ``ROW_PAD`` (to
    the fused kernel's ``TILE`` for large cosine matrices)."""

    ROW_PAD = 512
    DIM_PAD = 128
    # Background growth: past GROW_FILL of capacity, a daemon thread
    # pre-copies rows into the doubled buffers in COPY_SLICE_ROWS slices
    # (yielding the GIL between slices), so the single-writer ingest path
    # never stalls on an O(N) copy.  Overwrites during a pending grow are
    # tracked and re-copied at swap.
    GROW_FILL_NUM = 9
    GROW_FILL_DEN = 10
    COPY_SLICE_ROWS = 65536

    def __init__(self, dim: int, metric: str = "cosine", *,
                 device: torch.device | str):
        self.dim = dim
        self.metric = metric
        self.device = torch.device(device)
        self.dim_pad = _round_up(max(dim, 1), self.DIM_PAD)
        self.capacity = self.ROW_PAD
        self.data = np.zeros((self.capacity, self.dim_pad), np.float32)
        self.sq_norms = np.zeros(self.capacity, np.float32)
        self.n = 0
        self.version = 0
        self._device: tuple[int, torch.Tensor, torch.Tensor] | None = None
        self._device32: tuple[int, torch.Tensor] | None = None
        self._grow_thread = None
        self._grow_buffers: tuple | None = None
        self._grow_dirty: list[int] = []

    # -- growth (host numpy, as the reference) ------------------------------

    def _start_background_grow(self, target_capacity: int) -> None:
        import threading

        if self._grow_thread is not None:
            return
        n0 = self.n
        grown = np.zeros((target_capacity, self.dim_pad), np.float32)
        sq = np.zeros(target_capacity, np.float32)
        src, src_sq = self.data, self.sq_norms
        slice_rows = self.COPY_SLICE_ROWS
        ok = [False]

        def copy() -> None:
            import time as _time

            for s in range(0, n0, slice_rows):
                e = min(n0, s + slice_rows)
                grown[s:e] = src[s:e]
                _time.sleep(0)  # let serving threads interleave per slice
            sq[:n0] = src_sq[:n0]
            ok[0] = True

        self._grow_buffers = (n0, grown, sq, ok)
        self._grow_dirty = []
        thread = threading.Thread(
            target=copy, daemon=True, name="packed-matrix-grow"
        )
        self._grow_thread = thread
        thread.start()

    def _swap_grown(self) -> None:
        """Join the background copy and install the grown buffers (rows
        appended or overwritten since the copy started are re-copied —
        both sets are bounded and small).  A copier that died without
        finishing is discarded: the synchronous fallback in
        ``_ensure_rows`` grows instead (incomplete buffers must never
        become the matrix)."""
        thread = self._grow_thread
        thread.join()
        n0, grown, sq, ok = self._grow_buffers
        self._grow_thread = None
        self._grow_buffers = None
        if not ok[0]:
            self._grow_dirty = []
            return
        grown[n0 : self.n] = self.data[n0 : self.n]
        sq[n0 : self.n] = self.sq_norms[n0 : self.n]
        for pos in self._grow_dirty:
            if pos < n0:
                grown[pos] = self.data[pos]
                sq[pos] = self.sq_norms[pos]
        self.data = grown
        self.sq_norms = sq
        self.capacity = len(sq)
        self._grow_dirty = []

    def _ensure_rows(self, count: int) -> None:
        """Capacity for ``count`` more rows.  Normally the background
        grow finished long before the buffer fills and the swap here is
        a pointer exchange plus a tiny delta copy; the synchronous path
        only remains for burst appends that outrun the copier."""
        need = self.n + count
        if self._grow_thread is not None and (
            need > self.capacity or not self._grow_thread.is_alive()
        ):
            self._swap_grown()
        while need > self.capacity:  # copier outrun (or disabled): grow now
            self.capacity = max(self.capacity * 2, _round_up(need, self.ROW_PAD))
            grown = np.zeros((self.capacity, self.dim_pad), np.float32)
            grown[: self.n] = self.data[: self.n]
            self.data = grown
            sq = np.zeros(self.capacity, np.float32)
            sq[: self.n] = self.sq_norms[: self.n]
            self.sq_norms = sq

    def _maybe_start_grow(self) -> None:
        """Called AFTER rows land (so the background copy covers them and
        the swap's delta stays small): start pre-growing past the fill
        threshold."""
        if (
            self._grow_thread is None
            and self.n * self.GROW_FILL_DEN > self.capacity * self.GROW_FILL_NUM
        ):
            self._start_background_grow(2 * self.capacity)

    def append(self, vec: np.ndarray) -> int:
        self._ensure_rows(1)
        row = np.zeros(self.dim_pad, np.float32)
        row[: self.dim] = vec
        if self.metric == "cosine":
            norm = float(np.linalg.norm(row))
            if norm > 0:
                row /= norm
        self.data[self.n] = row
        self.sq_norms[self.n] = float(np.dot(row, row))
        pos = self.n
        self.n += 1
        self.version += 1
        self._maybe_start_grow()
        return pos

    def extend(self, vecs: np.ndarray) -> int:
        """Bulk append; returns the first assigned position."""
        count = len(vecs)
        self._ensure_rows(count)
        block = np.zeros((count, self.dim_pad), np.float32)
        block[:, : self.dim] = vecs
        if self.metric == "cosine":
            norms = np.linalg.norm(block, axis=1, keepdims=True)
            np.divide(block, norms, out=block, where=norms > 0)
        self.data[self.n : self.n + count] = block
        self.sq_norms[self.n : self.n + count] = np.einsum("nd,nd->n", block, block)
        first = self.n
        self.n += count
        self.version += 1
        self._maybe_start_grow()
        return first

    def overwrite(self, pos: int, vec: np.ndarray | None) -> None:
        """Replace a row (None zeroes it; paired with external tombstoning)."""
        row = np.zeros(self.dim_pad, np.float32)
        if vec is not None:
            row[: self.dim] = vec
            if self.metric == "cosine":
                norm = float(np.linalg.norm(row))
                if norm > 0:
                    row /= norm
        self.data[pos] = row
        self.sq_norms[pos] = float(np.dot(row, row))
        if self._grow_thread is not None:
            self._grow_dirty.append(pos)
        self.version += 1

    # -- device copies -------------------------------------------------------

    def _device_rows(self) -> int:
        """Device row padding.  Large cosine matrices pad to the fused
        kernel's tile so its path can engage (<= 8191 junk rows)."""
        n_rows = _round_up(max(self.n, 1), self.ROW_PAD)
        if self.metric == "cosine" and self.n >= FUSED_ROW_THRESHOLD:
            from .fused_topk import pad_rows_for_fused

            n_rows = pad_rows_for_fused(self.n)
        return n_rows

    # Upload granularity: the f32 host rows go up in slices of this many
    # bytes and are cast on the device, so the transient device memory
    # is one slice, not a second full-size f32 copy.
    UPLOAD_CHUNK_BYTES = 256 << 20

    def _upload(self, host: np.ndarray, n_rows: int,
                dtype: torch.dtype) -> torch.Tensor:
        """``[n_rows, ...]`` tensor of ``dtype`` on the device holding the
        first ``min(n_rows, len(host))`` host rows, zeros past them.
        Preallocated once, filled slice by slice (cast on the device)."""
        dst = torch.empty((n_rows,) + host.shape[1:], dtype=dtype,
                          device=self.device)
        have = min(n_rows, len(host))
        row_bytes = max(host[0:1].nbytes, 1)
        rows = max(1, self.UPLOAD_CHUNK_BYTES // row_bytes)
        for s in range(0, have, rows):
            e = min(have, s + rows)
            dst[s:e].copy_(torch.from_numpy(host[s:e]).to(self.device))
        if have < n_rows:
            dst[have:].zero_()
        return dst

    def device_arrays(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(bf16 matrix, f32 squared norms) on the device, refreshed when
        stale."""
        cached = self._device
        if cached is not None and cached[0] == self.version:
            return cached[1], cached[2]
        n_rows = self._device_rows()
        valid = min(self.n, n_rows)
        xs16 = self._upload(self.data[:valid], n_rows, torch.bfloat16)
        sq = self._upload(self.sq_norms[:valid], n_rows, torch.float32)
        self._device = (self.version, xs16, sq)
        return xs16, sq

    def release_device(self) -> None:
        """Drop the cached device copies (bf16 + f32).  Device memory is
        the scarce resource when several matrices share a card, so
        callers that finished a device phase release explicitly."""
        self._device = None
        self._device32 = None

    def data_device(self) -> torch.Tensor:
        """Cached f32 device copy (re-rank operand)."""
        cached = self._device32
        if cached is not None and cached[0] == self.version:
            return cached[1]
        n_rows = _round_up(max(self.n, 1), self.ROW_PAD)
        xs32 = self._upload(self.data[: self.n], n_rows, torch.float32)
        self._device32 = (self.version, xs32)
        return xs32

    def prepare_query(self, q: np.ndarray) -> np.ndarray:
        out = np.zeros(self.dim_pad, np.float32)
        out[: self.dim] = q
        if self.metric == "cosine":
            norm = float(np.linalg.norm(out))
            if norm > 0:
                out /= norm
        return out

    def prepare_queries(self, qs: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`prepare_query` over a [B, dim] batch — the
        per-row Python loop costs ~5 ms at B=1024, visible in serving."""
        qs = np.asarray(qs, np.float32)
        if qs.ndim != 2:
            return np.stack([self.prepare_query(q) for q in qs])
        if qs.shape[1] != self.dim:
            raise ValueError(
                f"could not broadcast query batch of dim {qs.shape[1]} "
                f"into index dim {self.dim}"
            )
        out = np.zeros((qs.shape[0], self.dim_pad), np.float32)
        out[:, : self.dim] = qs
        if self.metric == "cosine":
            norms = np.linalg.norm(out, axis=1, keepdims=True)
            np.divide(out, norms, out=out, where=norms > 0)
        return out


def resident_topk_auto(
    xs16: torch.Tensor,
    xs32: torch.Tensor,
    qs: torch.Tensor,
    n_valid: int,
    sq: torch.Tensor,
    *,
    k: int,
    metric: str,
    rerank: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Route a resident search: the fused Hopper kernel (CUDA + cosine +
    fused-padded rows) or :func:`topk_resident` otherwise."""
    from .fused_topk import fused_topk, supports_fused

    if supports_fused(
        int(xs16.shape[0]), int(xs16.shape[1]), metric, xs16.device, k=k,
    ):
        return fused_topk(xs16, xs32, qs, n_valid, sq, k=k, rerank=rerank)
    return topk_resident(
        xs16, xs32, qs, n_valid, sq, k=k, metric=metric, rerank=rerank
    )


def search_packed(
    matrix: PackedMatrix,
    queries: np.ndarray,      # [B, dim] raw queries
    k: int,
    valid_mask: np.ndarray | None = None,   # [n] bool over live rows
    *,
    use_device: bool | None = None,
    rerank: int = 8,
    n_live: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k over a packed matrix.  Returns ``(dists [B, k'],
    positions [B, k'])`` with ``k' <= k`` columns, distances ascending;
    invalid rows excluded.  Small partitions run host-side."""
    return search_packed_async(
        matrix, queries, k, valid_mask,
        use_device=use_device, rerank=rerank, n_live=n_live,
    )()


def _copy_to_host_async(*tensors: torch.Tensor):
    """Start the D2H copies now: pinned host tensors filled by
    non-blocking copies, plus an event recorded after them that
    ``finalize`` waits on.  CPU tensors are already host tensors."""
    if tensors[0].device.type != "cuda":
        return tensors, None
    hosts = tuple(
        torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors
    )
    for host, t in zip(hosts, tensors):
        host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return hosts, event


def search_packed_async(
    matrix: PackedMatrix,
    queries: np.ndarray,
    k: int,
    valid_mask: np.ndarray | None = None,
    *,
    use_device: bool | None = None,
    rerank: int = 8,
    n_live: int | None = None,
):
    """Pipelined variant of :func:`search_packed`: dispatches the device
    work and returns a ``finalize()`` closure that waits for the D2H
    copies and runs the host-side cleanup, so a serving loop can issue
    the next batch before finalizing the previous one.

    ``n_live`` is the number of live rows in ``valid_mask[: matrix.n]``
    where the caller keeps it (``Partition._n_live``); when it is None
    the mask is counted, an O(n) pass.  The device path snapshots the
    mask for ``finalize()`` only when some row is dead: with none dead
    ``finalize()`` has nothing to compact.

    It records the spans of :mod:`..tracing`: ``engine.search`` over the
    dispatch and its child ``engine.live_count``; on the device path also
    the children ``engine.h2d``, ``kernel.enqueue`` (host time to launch
    the search's kernels) and ``engine.mask_copy``, and, in
    ``finalize()``, ``engine.d2h_wait`` under the dispatch's
    ``engine.search``.  The counter ``engine.mask_snapshots`` counts the
    dispatches that copy the mask."""
    if matrix.n == 0:
        b = queries.shape[0]
        empty = (np.zeros((b, 0), np.float32), np.zeros((b, 0), np.int64))
        return lambda: empty
    with tracing.span("engine.search") as search:
        qs = matrix.prepare_queries(queries)
        with tracing.span("engine.live_count"):
            if n_live is None:
                n_live = (
                    int(valid_mask[: matrix.n].sum())
                    if valid_mask is not None else matrix.n
                )
        k_eff = min(k, n_live)
        if k_eff == 0:
            b = queries.shape[0]
            empty = (np.zeros((b, 0), np.float32), np.zeros((b, 0), np.int64))
            return lambda: empty

        if use_device is None:
            use_device = matrix.n >= 4096

        if not use_device:
            data = matrix.data[: matrix.n]
            if matrix.metric == "cosine":
                dists = 1.0 - qs @ data.T
            else:
                dists = (
                    matrix.sq_norms[: matrix.n][None, :]
                    - 2.0 * (qs @ data.T)
                    + np.sum(qs * qs, axis=1, keepdims=True)
                )
            if valid_mask is not None:
                dists = np.where(valid_mask[: matrix.n][None, :], dists, np.inf)
            part = np.argpartition(dists, k_eff - 1, axis=1)[:, :k_eff]
            part_d = np.take_along_axis(dists, part, axis=1)
            order = np.argsort(part_d, axis=1, kind="stable")
            idx = np.take_along_axis(part, order, axis=1)
            host = (
                np.take_along_axis(dists, idx, axis=1).astype(np.float32),
                idx.astype(np.int64),
            )
            return lambda: host

        # Device path: one H2D (queries), the search, one D2H (top-k).
        # Tombstones widen k by the dead count; finalize compacts them out.
        dead = 0 if valid_mask is None else int(matrix.n - n_live)
        k_query = min(matrix.n, k_eff + dead)
        # Bucket the shapes as the reference does (batch to a power of two
        # >= 8, k to a power of two >= 16), so both packages search the
        # same padded problem and return the same candidates.
        b_real = qs.shape[0]
        b_pad = max(8, 1 << (b_real - 1).bit_length())
        if b_pad != b_real:
            qs = np.concatenate(
                [qs, np.zeros((b_pad - b_real, qs.shape[1]), qs.dtype)]
            )
        k_bucket = min(matrix.n, max(16, 1 << (int(k_query) - 1).bit_length()))
        if k_bucket < k_query:  # n itself not a power of two
            k_bucket = int(k_query)
        xs16, sq = matrix.device_arrays()
        xs32 = matrix.data_device()
        with tracing.span("engine.h2d"):
            qs_dev = torch.from_numpy(qs).to(matrix.device)
        with tracing.span("kernel.enqueue"):
            dists_dev, idx_dev = resident_topk_auto(
                xs16,
                xs32,
                qs_dev,
                matrix.n,
                sq,
                k=int(k_bucket),
                metric=matrix.metric,
                rerank=max(rerank, 1),
            )
        (dists_host, idx_host), copied = _copy_to_host_async(dists_dev, idx_dev)
        # Snapshot the mask now (the store can mutate between dispatch and
        # finalize); with no dead row finalize compacts nothing.
        with tracing.span("engine.mask_copy"):
            mask_snapshot = None
            if dead:
                mask_snapshot = valid_mask.copy()
                tracing.count("engine.mask_snapshots")
    search_id = search.id

    def finalize() -> tuple[np.ndarray, np.ndarray]:
        with tracing.span("engine.d2h_wait", parent=search_id):
            if copied is not None:
                copied.synchronize()
        dists = dists_host.numpy().astype(np.float32)[:b_real, :k_query]
        idx = idx_host.numpy().astype(np.int64)[:b_real, :k_query]
        if mask_snapshot is not None:
            # Compact live candidates left (stable argsort on the dead
            # mask keeps ascending-distance order among the live ones),
            # then trim to k_eff.  Ragged rows pad with position -1 /
            # +inf, the sentinel convention the Partition layer strips.
            # The fused path pads overflow with -1, so guard the lookup.
            in_range = (idx >= 0) & (idx < len(mask_snapshot))
            live = in_range & mask_snapshot[
                np.clip(idx, 0, len(mask_snapshot) - 1)
            ]
            order = np.argsort(~live, axis=1, kind="stable")
            live = np.take_along_axis(live, order, axis=1)[:, :k_eff]
            out_d = np.take_along_axis(dists, order, axis=1)[:, :k_eff]
            out_i = np.take_along_axis(idx, order, axis=1)[:, :k_eff]
            return (
                np.where(live, out_d, np.inf).astype(np.float32),
                np.where(live, out_i, -1),
            )
        return dists[:, :k_eff], idx[:, :k_eff]

    return finalize
