"""int4 quantized residency tier (PyTorch port of ``helix_tpu/ops/quant4.py``).

The rung below int8 on the residency ladder: rows quantize to 4-bit
symmetric values packed two per byte (0.5 bytes/dim plus a scale per
row).  Byte ``j`` of a packed row holds column ``j`` in its low nibble
and column ``j + D/2`` in its high nibble, so a dot product splits into
``lo . q[:, :D/2] + hi . q[:, D/2:]``.  For the fused path, cosine rows
are sorted by peak so each 64-row bucket shares one scale; the kernel
reduces in the raw-dot domain and de-scales only the bucket winners, and
its ids are sorted positions that ``perm`` maps back to rows.

On a CUDA tensor :func:`i4_bucket_scores` launches the hand-written
Hopper kernel ``csrc/i4_bucket_scores.cu`` (or raises); on a CPU tensor
it runs :func:`i4_bucket_scores_reference`, the plain version the tests
hold against the JAX kernel bit for bit.  The kernel unpacks 64 packed
bytes of a row at a time into 128 int8 columns, ``[lo | hi]``, and takes
the queries in the matching column order (:func:`chunk_ordered_queries`);
it takes whole 64-row buckets (N < 2^31), D a multiple of 128 and B of
128 or 256 (:func:`i4_kernel_refusal`), and the search routes a shape it
refuses to the unfused path.

Deliberate differences from the reference:

- ``approx_max_k`` becomes an exact top-k, as in ``ops/quant.py``.
- The fused gate is ``ops/quant.py:use_fused`` (CUDA, cosine, ``n >=
  TILE``, ``dim_pad % 128 == 0``); the TPU's VMEM working-set cap does not
  bind Hopper.
- :func:`unsort_candidates` maps an id outside ``perm`` to -1; the
  reference clips it onto a real row.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .distance import _round_up, _top_k
from .fused_topk import (
    BUCKET,
    check_launch,
    count_launch,
    descale_packed,
    kernel_refusal,
    mask_pack_reduce,
    pad_rows_for_fused,
)
from .quant import (
    I8_KERNEL_DEPTH,
    _padded_rows,
    _quantize_queries,
    _sq_device,
    check_kernel_operands,
    fused_coarse,
    fused_route,
    int_dots,
    use_fused,
)

# The widest candidate pool the int4 rung will serve at; beyond it the
# residency gate walks on to the host-IVF rung.
INT4_MAX_POOL = 16384


def recall_safe_pool_int4(n: int, k: int = 10) -> int:
    """Scale-aware candidate floor for the int4 rung: 4-bit noise is a
    fixed-width score perturbation, so the competitors near the top-k
    boundary grow ~linearly with N; the floor grows with them (N/1024,
    anchored at the reference's measured 1e6 point)."""
    return max(32 * k, 256, n // 1024)


def quantize_rows_int4(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int4, column-halves packed:
    ``(packed uint8 [N, D/2], scales f32 [N])``.  D must be even.  Zero
    rows get scale 1."""
    n, d = rows.shape
    assert d % 2 == 0, "packed int4 needs an even (padded) dim"
    peak = np.abs(rows).max(axis=1)
    scales = np.where(peak > 0, peak / 7.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(rows / scales[:, None]), -7, 7).astype(np.int8)
    h = d // 2
    lo = (q[:, :h] & 0x0F).astype(np.uint8)
    hi = (q[:, h:] & 0x0F).astype(np.uint8)
    return lo | (hi << 4), scales


def quantize_rows_int4_bucketed(
    rows: np.ndarray, n_live: int | None = None, chunk: int = 1_000_000,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Scale-sorted per-BUCKET int4 quantization for the fused kernel:
    ``(packed uint8 [N, D/2], bucket_scales f32 [N/64], row_scales f32
    [N], perm int64 [N])``.  Live rows sort by peak magnitude so each
    64-row bucket holds near-identical peaks; ``perm[sorted_pos] =
    original_pos``.  ``row_scales`` is the bucket scale per row (the
    unfused path's operand).  Rows past ``n_live`` keep their positions."""
    n, d = rows.shape
    assert d % 2 == 0, "packed int4 needs an even (padded) dim"
    assert n % 64 == 0, "bucketed int4 needs 64-row-aligned row padding"
    if n_live is None:
        n_live = n
    peaks = np.empty(n, np.float32)
    for s0 in range(0, n, chunk):
        e0 = min(n, s0 + chunk)
        peaks[s0:e0] = np.abs(rows[s0:e0]).max(axis=1)
    perm = np.arange(n, dtype=np.int64)
    perm[:n_live] = np.argsort(peaks[:n_live], kind="stable")
    bucket_peak = peaks[perm].reshape(-1, 64).max(axis=1)
    bucket_scales = np.where(
        bucket_peak > 0, bucket_peak / 7.0, 1.0
    ).astype(np.float32)
    row_scales = np.repeat(bucket_scales, 64)
    h = d // 2
    packed = np.empty((n, h), np.uint8)
    for s0 in range(0, n, chunk):
        e0 = min(n, s0 + chunk)
        block = rows[perm[s0:e0]]
        q = np.clip(
            np.rint(block / row_scales[s0:e0, None]), -7, 7
        ).astype(np.int8)
        packed[s0:e0] = (q[:, :h] & 0x0F).astype(np.uint8) | (
            (q[:, h:] & 0x0F).astype(np.uint8) << 4
        )
    return packed, bucket_scales, row_scales, perm


def unpack_int4(packed: np.ndarray | torch.Tensor):
    """Inverse of the packing layout: int8 ``[N, D]`` in original column
    order (numpy or torch, matching the input)."""
    if isinstance(packed, torch.Tensor):
        lo = (packed & 0x0F).to(torch.int8)
        hi = (packed >> 4).to(torch.int8)
        return torch.cat([torch.where(lo > 7, lo - 16, lo),
                          torch.where(hi > 7, hi - 16, hi)], dim=1)
    lo = (packed & 0x0F).astype(np.int8)
    lo = np.where(lo > 7, lo - 16, lo)
    hi = (packed >> 4).astype(np.int8)
    hi = np.where(hi > 7, hi - 16, hi)
    return np.concatenate([lo, hi], axis=1)


def int4_coarse_topk(
    packed: torch.Tensor,      # [N, D/2] uint8 resident matrix
    x_scales: torch.Tensor,    # [N] f32 per-row scales
    qs: torch.Tensor,          # [B, D] f32 query batch
    n_valid: int,
    sq_norms: torch.Tensor,    # [N] f32 squared norms (l2 only)
    *,
    k: int,
    metric: str = "cosine",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unfused coarse phase: unpack, exact integer dots (:func:`int_dots`),
    de-scale, mask, exact top-k."""
    n = packed.shape[0]
    q_i8, q_scales = _quantize_queries(qs)
    dots = int_dots(q_i8, unpack_int4(packed))          # [B, N]
    sims = dots.float() * q_scales[:, None] * x_scales[None, :]
    if metric == "l2":
        sims = 2.0 * sims - sq_norms[None, :]
    cols = torch.arange(n, device=packed.device)
    sims = torch.where((cols < n_valid)[None, :], sims, float("-inf"))
    return _top_k(sims, k)                    # ref :172 approx_max_k


# ---------------------------------------------------------------- fused


def i4_bucket_scores_reference(
    packed: torch.Tensor, bucket_scales: torch.Tensor, q_i8: torch.Tensor,
    n_valid: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: exact integer dots of the
    unpacked codes, the shared mask, pack, flush and bucket max, then
    :func:`descale_packed` by each bucket's scale."""
    sims = int_dots(unpack_int4(packed), q_i8).float()
    return descale_packed(mask_pack_reduce(sims, n_valid),
                          bucket_scales[:, None])


def i4_kernel_refusal(n: int, d: int, b: int) -> str | None:
    """Why ``csrc/i4_bucket_scores.cu`` cannot take ``packed [n, d / 2]``
    and ``q_i8 [b, d]``, or None when it can: ``d`` is the unpacked width,
    whose halves are whole 64-byte packed chunks when ``d % 128 == 0``."""
    return kernel_refusal(n, d, b, I8_KERNEL_DEPTH)


def chunk_ordered_queries(q_i8: torch.Tensor) -> torch.Tensor:
    """``q_i8 [B, D]`` with its columns in the kernel's chunk order: chunk
    k (128 columns) is ``q[:, 64k:64k+64]`` then ``q[:, h+64k:h+64k+64]``
    (h = D/2), the query columns that packed bytes ``[64k, 64k+64)`` hold
    in their low and high nibbles.  The identity at D = 128."""
    b, d = q_i8.shape
    half = I8_KERNEL_DEPTH // 2
    return q_i8.view(b, 2, d // I8_KERNEL_DEPTH, half).transpose(1, 2) \
        .reshape(b, d)


def i4_bucket_scores(
    packed: torch.Tensor, bucket_scales: torch.Tensor, q_i8: torch.Tensor,
    n_valid: int,
) -> torch.Tensor:
    """``[N / BUCKET, B]`` f32 de-scaled packed winners over packed int4.

    CUDA tensors launch ``csrc/i4_bucket_scores.cu`` on the current
    stream with the queries in chunk order (:func:`chunk_ordered_queries`)
    and count the launch in ``i4_bucket_scores.launches``; CPU tensors run
    :func:`i4_bucket_scores_reference` at any shape.  On other devices, a
    shape :func:`i4_kernel_refusal` names and anything else the kernel
    does not take raise."""
    operands = {"packed": packed, "bucket_scales": bucket_scales,
                "q_i8": q_i8}
    if all(t.device.type == "cpu" for t in operands.values()):
        return i4_bucket_scores_reference(packed, bucket_scales, q_i8,
                                          n_valid)
    if packed.dim() != 2 or q_i8.dim() != 2 \
            or q_i8.shape[1] != 2 * packed.shape[1]:
        raise ValueError(
            f"i4_bucket_scores shapes: packed [N, D/2] and q [B, D], got "
            f"{tuple(packed.shape)} and {tuple(q_i8.shape)}"
        )
    n, h = packed.shape
    d = 2 * h
    b = q_i8.shape[0]
    refusal = i4_kernel_refusal(n, d, b)
    if refusal is not None:
        raise ValueError(f"i4_bucket_scores: {refusal}")
    check_kernel_operands(
        "i4_bucket_scores", operands,
        {"packed": torch.uint8, "bucket_scales": torch.float32,
         "q_i8": torch.int8},
    )
    if tuple(bucket_scales.shape) != (n // BUCKET,):
        raise ValueError(
            f"i4_bucket_scores: bucket_scales must be [{n // BUCKET}], got "
            f"{tuple(bucket_scales.shape)}"
        )
    n_valid = max(0, min(int(n_valid), n))
    out = torch.empty((n // BUCKET, b), dtype=torch.float32,
                      device=packed.device)
    q_perm = chunk_ordered_queries(q_i8)
    lib = kernels.load()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hx_i4_bucket_scores(
            packed.data_ptr(), bucket_scales.data_ptr(), q_perm.data_ptr(),
            out.data_ptr(), n, d, b, n_valid, stream,
        )
    check_launch("i4_bucket_scores", rc)
    count_launch(i4_bucket_scores, packed.device)
    return out


i4_bucket_scores.launches = 0
i4_bucket_scores.captured = 0


def int4_fused_coarse(
    packed: torch.Tensor,         # [N, D/2] uint8, rows padded to TILE,
                                  # scale-sorted (quantize_rows_int4_bucketed)
    bucket_scales: torch.Tensor,  # [N / 64] f32
    qs: torch.Tensor,             # [B, D] f32
    n_valid: int,
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused int4 coarse candidates: (packed scores [B, k], ids).  Cosine
    only.  Ids are SORTED positions: map them through the quantizer's
    ``perm`` (:func:`unsort_candidates`) before touching original-order
    state.  The scores still carry index bits, as the reference's do."""
    best_s, q_scales, ids = fused_coarse(
        lambda q_i8: i4_bucket_scores(packed, bucket_scales, q_i8, n_valid),
        packed.shape[0], qs, k=k,
    )
    return best_s * q_scales, ids


def unsort_candidates(cand: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Map sorted positions back to original rows through ``perm``; an
    id outside ``perm`` (or negative) becomes -1 rather than another
    row."""
    cand = np.asarray(cand, np.int64)
    inside = (cand >= 0) & (cand < len(perm))
    return np.where(inside, perm[np.where(inside, cand, 0)], -1)


class Int4Resident:
    """Device-resident packed int4 copy of a packed matrix, refreshed
    by version (mirrors ``ops/quant.py`` QuantizedResident)."""

    def __init__(self):
        # (version, packed, row_scales, sq_dev, bucket_scales, perm): for
        # cosine, rows are scale-sorted and perm (host) maps sorted ->
        # original positions; l2 keeps the original order (perm identity,
        # bucket scales a dummy; the fused path is cosine-only).
        self._cached: tuple | None = None

    def arrays(self, matrix):
        cached = self._cached
        if cached is not None and cached[0] == matrix.version:
            return cached[1:]
        n_rows = _round_up(max(matrix.n, 1), matrix.ROW_PAD)
        if use_fused(matrix):
            n_rows = pad_rows_for_fused(matrix.n)
        rows = _padded_rows(matrix, n_rows)
        if matrix.metric == "cosine":
            packed, bsc, scales, perm = quantize_rows_int4_bucketed(
                np.asarray(rows), n_live=matrix.n
            )
            bsc_dev = torch.from_numpy(bsc).to(matrix.device)
        else:
            packed, scales = quantize_rows_int4(rows)
            perm = np.arange(n_rows, dtype=np.int64)
            bsc_dev = torch.ones(1, device=matrix.device)
        xs = matrix._upload(packed, n_rows, torch.uint8)
        sc = torch.from_numpy(scales).to(matrix.device)
        sq_dev = _sq_device(matrix, n_rows)
        self._cached = (matrix.version, xs, sc, sq_dev, bsc_dev, perm)
        return xs, sc, sq_dev, bsc_dev, perm

    def search(
        self, matrix, queries: np.ndarray, k: int, live_mask: np.ndarray,
        metric: str, k_cand_floor: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Coarse int4 top-k + exact f32 host re-rank over a pool of
        ``recall_safe_pool_int4`` candidates (an explicit floor wins when
        wider)."""
        from ..native import rerank as native_rerank

        n = matrix.n
        packed, scales, sq_dev, bsc, perm = self.arrays(matrix)
        qs = matrix.prepare_queries(queries)
        qs_dev = torch.from_numpy(qs).to(matrix.device)
        k_cand = min(
            max(recall_safe_pool_int4(n, k), k_cand_floor or 0), n
        )
        if fused_route(matrix, packed.shape[0], 2 * packed.shape[1], k_cand,
                       i4_kernel_refusal):
            _, cand = int4_fused_coarse(packed, bsc, qs_dev, n, k=k_cand)
        else:
            _, cand = int4_coarse_topk(
                packed, scales, qs_dev, n, sq_dev, k=k_cand, metric=metric,
            )
        cand = unsort_candidates(cand.cpu().numpy(), perm)
        cand = np.where(
            (cand < n) & live_mask[np.clip(cand, 0, n - 1)], cand, -1
        )
        return native_rerank(
            matrix.data[:n], matrix.sq_norms[:n], qs, cand, k, metric
        )
