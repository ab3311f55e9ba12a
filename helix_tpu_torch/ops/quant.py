"""int8 quantized residency tier (PyTorch port of ``helix_tpu/ops/quant.py``).

The rung of the residency ladder below the exact tier: cosine rows
quantize to int8 with one global scale (``rint(127 x)``, 1 byte/dim), l2
rows keep per-row scales.  The coarse phase picks candidates from integer
dot products; candidates then re-rank exactly in f32 against the host
matrix (the native C++ re-rank), or against an f16 device copy
(:func:`device_rerank_topk`) when the budget has room for it.

Two coarse paths, routed as the reference routes them
(:meth:`QuantizedResident.search`):

- :func:`int8_fused_coarse`, the packed bucket-max path: on a CUDA tensor
  its wrapper :func:`i8_bucket_scores` launches the hand-written Hopper
  kernel ``csrc/i8_bucket_scores.cu`` (or raises); on a CPU tensor it
  runs :func:`i8_bucket_scores_reference`, the plain version the tests
  hold against the JAX kernel bit for bit.  The kernel takes whole
  64-row buckets (N < 2^31), D a multiple of 128 (one 128-byte swizzle
  row of int8) and B of 128 or 256 (:func:`i8_kernel_refusal`); the
  search routes a shape it refuses to the unfused path.
- :func:`int8_coarse_topk`, the unfused path (l2, fewer than 8192 rows,
  or a pool wider than the bucket count).  The reference computes its
  product in XLA, outside any kernel; here it is ``torch._int_mm`` on
  CUDA and an exact float64 product on the CPU (:func:`int_dots`).

Deliberate differences from the reference:

- ``approx_max_k`` becomes an exact top-k (``distance._top_k``,
  ties to the lower position, in the unfused path and over the bucket
  winners, as ``fused_topk`` does; the selection kernel on the card).
- The fused path serves a CUDA device with cosine rows, ``n >= TILE`` and
  ``dim_pad % 128 == 0``; the TPU's VMEM tile cap does not bind Hopper.
- :class:`ShardedInt8Search` (the mesh's int8 rung) runs
  :func:`int8_coarse_topk` on each shard's device and merges on the
  mesh's merge device (``parallel/mesh.py``); like the reference's, it
  reaches no bucket-scores kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .distance import _round_up, _top_k, require_fp32_matmul
from .fused_topk import (
    BUCKET,
    BUCKET_KERNEL_QUERIES,
    MAX_QUERY_BLOCK,
    MIN_QUERY_BLOCK,
    TILE,
    kernel_refusal,
    mask_pack_reduce,
    pad_rows_for_fused,
)

# Feature columns per chunk of csrc/i8_bucket_scores.cu and
# csrc/i4_bucket_scores.cu: one 128-byte swizzle row of int8 (for int4,
# 64 packed bytes unpacked).
I8_KERNEL_DEPTH = 128




def quantize_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8: ``(values int8 [N, D], scales f32 [N])``.
    Zero rows get scale 1 (values all zero)."""
    peak = np.abs(rows).max(axis=1)
    scales = np.where(peak > 0, peak / 127.0, 1.0).astype(np.float32)
    values = np.clip(
        np.rint(rows / scales[:, None]), -127, 127
    ).astype(np.int8)
    return values, scales


# One quantization step for unit-norm rows: every |x| <= 1, so
# ``rint(127 x)`` is always a valid int8 and the de-scale is this
# single constant.
GLOBAL_SCALE = np.float32(1.0 / 127.0)


def _quantize_queries(qs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side symmetric per-query int8: ``(q_i8, scales)``.

    The reference runs this under ``jit``, where XLA rewrites its
    ``q_peak / 127.0`` (a division by a constant) into a multiply by the
    f32 reciprocal, so the scale here is that product.  The queries are
    then divided by their scale, as in the reference (a division by a
    value, which XLA keeps); ``torch.round`` rounds half to even like
    ``jnp.round``."""
    q_peak = qs.abs().amax(dim=1)
    q_scales = torch.where(q_peak > 0, q_peak * float(GLOBAL_SCALE), 1.0)
    q_i8 = torch.clamp(torch.round(qs / q_scales[:, None]), -127, 127)
    return q_i8.to(torch.int8), q_scales


def quantize_rows_unit(rows: np.ndarray) -> np.ndarray:
    """Global-scale symmetric int8 for unit-norm (cosine) rows.
    De-scale with :data:`GLOBAL_SCALE`.  Correct because ``PackedMatrix``
    normalises cosine rows (|x| <= 1) and the clip keeps a component of
    exactly +-1 at +-127."""
    return np.clip(np.rint(rows * 127.0), -127, 127).astype(np.int8)


def int_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b.T`` for int8 ``a [M, D]`` and ``b [N, D]``.

    CUDA: ``torch._int_mm``, which wants M > 16 and D, N multiples of 8;
    ``a`` is padded with zero rows to a multiple of 8 above 16.  CPU: a
    float64 product, exact since every partial sum is an integer below
    2^53 (a float32 one is exact only while 127^2 * D <= 2^24, D <= 1040).
    """
    m, d = a.shape
    if a.device.type == "cuda":
        if d % 8 or b.shape[0] % 8:
            raise ValueError(
                f"int_dots on CUDA needs D and N multiples of 8, got D={d} "
                f"N={b.shape[0]}"
            )
        m_pad = max(24, _round_up(m, 8))
        if m_pad != m:
            a = torch.nn.functional.pad(a, (0, 0, 0, m_pad - m))
        return torch._int_mm(a, b.t())[:m]
    return (a.double() @ b.double().T).to(torch.int32)


def int8_coarse_topk(
    xs_i8: torch.Tensor,       # [N, D] int8 resident matrix
    x_scales: torch.Tensor,    # [N] f32 per-row scales
    qs: torch.Tensor,          # [B, D] f32 query batch
    n_valid: int,
    sq_norms: torch.Tensor,    # [N] f32 squared norms (l2 only)
    *,
    k: int,
    metric: str = "cosine",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized coarse phase: (approx similarities [B, k], indices).

    Queries quantize per query; the exact integer dot de-scales to f32
    similarity ``~ q . x`` (l2 uses the ``2 q.x - |x|^2`` ordering
    surrogate)."""
    n = xs_i8.shape[0]
    q_i8, q_scales = _quantize_queries(qs)
    dots = int_dots(q_i8, xs_i8)                        # [B, N]
    sims = dots.float() * q_scales[:, None] * x_scales[None, :]
    if metric == "l2":
        sims = 2.0 * sims - sq_norms[None, :]
    cols = torch.arange(n, device=xs_i8.device)
    sims = torch.where((cols < n_valid)[None, :], sims, float("-inf"))
    return _top_k(sims, k)                    # ref :111 approx_max_k


def device_rerank_topk(
    xs16: torch.Tensor,        # [N16, D] f16 resident rows (re-rank operand)
    sq_norms: torch.Tensor,    # [N16] f32 squared norms (l2 only)
    qs: torch.Tensor,          # [B, D] f32 query batch
    cand: torch.Tensor,        # [B, Kc] coarse candidates (junk allowed)
    live: torch.Tensor,        # [N16] uint8 device live mask (1 = live)
    n_valid: int,
    *,
    k: int,
    metric: str = "cosine",
) -> tuple[torch.Tensor, torch.Tensor]:
    """On-device re-rank of coarse candidates against the f16 row copy:
    a gather and an f32 einsum (TF32 off).  Returns ``(dists [B, min(k,
    Kc)], positions)`` ascending, with +inf / -1 for dead or out-of-range
    candidates."""
    require_fp32_matmul()
    n16 = xs16.shape[0]
    safe = cand.clamp(0, n16 - 1)
    rows = xs16[safe].float()                           # [B, Kc, D]
    sims = torch.einsum("bkd,bd->bk", rows, qs)
    if metric == "l2":
        sims = 2.0 * sims - sq_norms[safe]
    ok = (cand >= 0) & (cand < n_valid) & (live[safe] != 0)
    sims = torch.where(ok, sims, float("-inf"))
    k_eff = min(k, cand.shape[1])
    best_s, pos = _top_k(sims, k_eff)
    best_i = torch.gather(cand, 1, pos)
    good = best_s > float("-inf")
    best_i = torch.where(good, best_i, -1)
    if metric == "cosine":
        dists = 1.0 - best_s
    else:
        q_sq = torch.sum(qs * qs, dim=1, keepdim=True)
        dists = -best_s + q_sq
    dists = torch.where(good, dists, float("inf"))
    return dists, best_i


def _padded_rows(matrix, n_rows: int) -> np.ndarray:
    """``matrix.data[:n_rows]``, zero-padded when the host buffer is
    shorter."""
    rows = matrix.data[:n_rows]
    if n_rows > len(matrix.data):
        padded = np.zeros((n_rows, matrix.data.shape[1]), np.float32)
        padded[: matrix.n] = matrix.data[: matrix.n]
        rows = padded
    return rows


def _sq_device(matrix, n_rows: int) -> torch.Tensor:
    """The l2 de-scale operand on the device; cosine never reads it, so
    a 1-element dummy avoids an N-sized upload."""
    if matrix.metric != "l2":
        return torch.zeros(1, device=matrix.device)
    sq = np.zeros(n_rows, np.float32)
    sq[: matrix.n] = matrix.sq_norms[: matrix.n]
    return torch.from_numpy(sq).to(matrix.device)


def use_fused(matrix) -> bool:
    """The fused kernels' gate (int8 and int4): a CUDA device, cosine
    rows, at least one ``TILE`` of them, and a width the kernels stage
    (``dim_pad % 128 == 0``)."""
    return (
        matrix.device.type == "cuda"
        and matrix.metric == "cosine"
        and matrix.n >= TILE
        and matrix.dim_pad % 128 == 0
    )


def fused_route(matrix, n_rows: int, d: int, k_cand: int, refusal) -> bool:
    """Whether a quantized rung's search takes its fused kernel for
    ``n_rows`` resident rows of width ``d``: the :func:`use_fused` gate,
    rows padded to ``TILE``, a bucket count that supplies the pool (one
    candidate per 64-row bucket), and a shape the kernel takes at both
    query blocks ``fused_coarse`` pads to (``refusal(n, d, b)`` is None);
    otherwise the unfused path serves."""
    return (
        use_fused(matrix)
        and n_rows % TILE == 0
        and k_cand <= n_rows // BUCKET
        and all(refusal(n_rows, d, b) is None for b in BUCKET_KERNEL_QUERIES)
    )


class QuantizedResident:
    """Device-resident int8 copy of a packed matrix, refreshed by
    version (same scheme as PackedMatrix's bf16 cache)."""

    def __init__(self):
        # (version, xs_i8, scales, sq_dev)
        self._cached: tuple | None = None
        # (matrix version, live count, device uint8 mask)
        self._live_dev: tuple | None = None
        # (version, xs_f16, sq_dev): the 2-byte/dim device re-rank copy
        self._rr16: tuple | None = None

    def arrays(self, matrix) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cached = self._cached
        if cached is not None and cached[0] == matrix.version:
            return cached[1], cached[2], cached[3]
        n_rows = _round_up(max(matrix.n, 1), matrix.ROW_PAD)
        if use_fused(matrix):
            n_rows = pad_rows_for_fused(matrix.n)
        rows = _padded_rows(matrix, n_rows)
        if matrix.metric == "cosine":
            values = quantize_rows_unit(rows)
            scales = np.full(n_rows, GLOBAL_SCALE, np.float32)
        else:
            values, scales = quantize_rows(rows)
        xs_i8 = matrix._upload(values, n_rows, torch.int8)
        sc = torch.from_numpy(scales).to(matrix.device)
        sq_dev = _sq_device(matrix, n_rows)
        self._cached = (matrix.version, xs_i8, sc, sq_dev)
        return xs_i8, sc, sq_dev

    def rerank_arrays(self, matrix) -> tuple[torch.Tensor, torch.Tensor]:
        """(f16 row copy, f32 squared norms) for the device re-rank,
        version-keyed like the int8 arrays.  The f16 cast happens on the
        host, which halves the bytes moved."""
        cached = self._rr16
        if cached is not None and cached[0] == matrix.version:
            return cached[1], cached[2]
        n_rows = _round_up(max(matrix.n, 1), matrix.ROW_PAD)
        host16 = matrix.data[: matrix.n].astype(np.float16)
        xs16 = matrix._upload(host16, n_rows, torch.float16)
        sq = _sq_device(matrix, n_rows)
        self._rr16 = (matrix.version, xs16, sq)
        return xs16, sq

    def _live_device(self, matrix, live_mask: np.ndarray,
                     n_rows: int) -> torch.Tensor:
        """Device uint8 live mask padded to ``n_rows`` (padding dead)."""
        n_live = int(live_mask.sum())
        cached = self._live_dev
        if (
            cached is not None
            and cached[0] == matrix.version
            and cached[1] == n_live
            and cached[2].shape[0] >= n_rows
        ):
            return cached[2]
        mask = np.zeros(n_rows, np.uint8)
        mask[: len(live_mask)] = live_mask
        dev = torch.from_numpy(mask).to(matrix.device)
        self._live_dev = (matrix.version, n_live, dev)
        return dev

    def search(
        self, matrix, queries: np.ndarray, k: int, live_mask: np.ndarray,
        metric: str, k_cand_floor: int | None = None,
        rerank_device: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Coarse int8 top-k + exact f32 re-rank (host or device).

        Returns (distances [B, k], positions) ascending, tombstones
        dropped via the re-rank's sentinel path.  ``k_cand_floor``
        widens the re-ranked candidate pool; ``rerank_device`` re-scores
        against the f16 device copy instead of the host f32 matrix."""
        n = matrix.n
        xs_i8, scales, sq_dev = self.arrays(matrix)
        qs = matrix.prepare_queries(queries)
        qs_dev = torch.from_numpy(qs).to(matrix.device)
        k_cand = min(max(8 * k, 64, k_cand_floor or 0), n)
        if fused_route(matrix, xs_i8.shape[0], xs_i8.shape[1], k_cand,
                       i8_kernel_refusal):
            _, cand = int8_fused_coarse(xs_i8, qs_dev, n, k=k_cand)
        else:
            _, cand = int8_coarse_topk(
                xs_i8, scales, qs_dev, n, sq_dev, k=k_cand, metric=metric,
            )
        if rerank_device:
            xs16, sq16 = self.rerank_arrays(matrix)
            live = self._live_device(matrix, live_mask, int(xs16.shape[0]))
            dists, pos = device_rerank_topk(
                xs16, sq16, qs_dev, cand, live, n, k=k, metric=metric,
            )
            return dists.cpu().numpy(), pos.cpu().numpy().astype(np.int64)
        from ..native import rerank as native_rerank

        cand = cand.cpu().numpy().astype(np.int64)
        cand = np.where(
            (cand < n) & live_mask[np.clip(cand, 0, n - 1)], cand, -1
        )
        return native_rerank(
            matrix.data[:n], matrix.sq_norms[:n], qs, cand, k, metric
        )


class ShardedInt8Search:
    """Multi-device int8 coarse phase: rows shard across the mesh, each
    shard runs the int8 product over its slice on its own device, and
    the per-shard candidates merge on the merge device (the reference's
    all-gather): the quantized rung of the residency ladder at mesh
    scale.

    With ``rerank_device=True`` each shard re-scores its own candidates
    against a local f16 row copy before the merge (the precision model
    of :func:`device_rerank_topk`), tombstones filtered by a sharded live
    mask, so the merge carries f32-accumulated f16 re-rank scores and
    the output is final ``(scores, ids)``, ids -1 where dead or ragged.
    Returns ``(scores [B, k'], global ids [B, k'])`` on the merge
    device, descending."""

    def __init__(self, mesh, k: int, metric: str = "cosine",
                 rerank_device: bool = False, k_out: int | None = None):
        self.mesh = mesh
        self.k = k                      # per-shard candidate pool width
        self.k_out = k_out or k         # merged output width (device path)
        self.metric = metric
        self.rerank_device = rerank_device
        self.n_shard = int(mesh.shape["shard"])

    def _pad_rows(self, n: int) -> int:
        rows = -(-n // self.n_shard)
        return ((rows + 127) // 128) * 128

    def shard_arrays(self, values: np.ndarray, scales: np.ndarray,
                     sq_norms: np.ndarray):
        """Pad and put each shard's rows on its device; returns
        ``(xs_i8, scales, sq, n_valid)``, the first three per shard."""
        from ..parallel.mesh import shard_rows

        n = len(values)
        total = self._pad_rows(n) * self.n_shard
        pv = np.zeros((total, values.shape[1]), np.int8)
        pv[:n] = values
        ps = np.ones(total, np.float32)
        ps[:n] = scales
        pq = np.zeros(total, np.float32)
        pq[:n] = sq_norms[:n]
        devs = self.mesh.shard_devices
        return (shard_rows(pv, self.n_shard, devs),
                shard_rows(ps, self.n_shard, devs),
                shard_rows(pq, self.n_shard, devs), n)

    def shard_rerank_arrays(self, data_f32: np.ndarray,
                            live_mask: np.ndarray):
        """Per-shard f16 re-rank copy + uint8 live mask (padding dead),
        matching :meth:`shard_arrays`'s padding."""
        from ..parallel.mesh import shard_rows

        n = len(data_f32)
        total = self._pad_rows(n) * self.n_shard
        xs16 = np.zeros((total, data_f32.shape[1]), np.float16)
        xs16[:n] = data_f32
        live = np.zeros(total, np.uint8)
        live[:n] = live_mask[:n]
        devs = self.mesh.shard_devices
        return (shard_rows(xs16, self.n_shard, devs),
                shard_rows(live, self.n_shard, devs))

    def __call__(self, xs_i8, scales, sq, qs, n_valid: int,
                 rerank_arrays: tuple | None = None):
        rr = self.rerank_device
        if rr and rerank_arrays is None:
            raise ValueError(
                "rerank_device searcher needs shard_rerank_arrays(...)"
            )
        from ..parallel.mesh import merge_topk

        qs = torch.from_numpy(np.asarray(qs, np.float32))
        scores, ids = [], []
        for s, dev in enumerate(self.mesh.shard_devices):
            rows = xs_i8[s].shape[0]
            local_valid = min(max(int(n_valid) - s * rows, 0), rows)
            q = qs.to(dev)
            sims, idx = int8_coarse_topk(
                xs_i8[s], scales[s], q, local_valid, sq[s],
                k=min(self.k, rows), metric=self.metric,
            )
            if rr:
                xs16, live = rerank_arrays[0][s], rerank_arrays[1][s]
                require_fp32_matmul()
                safe = idx.clamp(0, rows - 1)
                sims = torch.einsum("bkd,bd->bk", xs16[safe].float(), q)
                if self.metric == "l2":
                    sims = 2.0 * sims - sq[s][safe]
                ok = (idx >= 0) & (idx < local_valid) & (live[safe] != 0)
                sims = torch.where(ok, sims, float("-inf"))
            scores.append(sims)
            ids.append(idx + s * rows)
        top_s, top_i = merge_topk(self.mesh.device, scores, ids,
                                  self.k_out if rr else self.k)
        if rr:
            top_i = torch.where(top_s > float("-inf"), top_i, -1)
        return top_s, top_i


# ---------------------------------------------------------------- fused


def i8_bucket_scores_reference(
    xs_i8: torch.Tensor, q_i8: torch.Tensor, n_valid: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``[N / BUCKET, B]`` f32
    packed winners for int8 ``xs_i8 [N, D]`` and ``q_i8 [B, D]``: exact
    integer dots, converted to f32, then the shared mask, pack, flush and
    bucket max."""
    return mask_pack_reduce(int_dots(xs_i8, q_i8).float(), n_valid)


def i8_kernel_refusal(n: int, d: int, b: int) -> str | None:
    """Why ``csrc/i8_bucket_scores.cu`` cannot take ``xs_i8 [n, d]`` and
    ``q_i8 [b, d]``, or None when it can."""
    return kernel_refusal(n, d, b, I8_KERNEL_DEPTH)


def i8_bucket_scores(
    xs_i8: torch.Tensor, q_i8: torch.Tensor, n_valid: int
) -> torch.Tensor:
    """``[N / BUCKET, B]`` f32 packed winners over int8 codes.

    CUDA tensors launch ``csrc/i8_bucket_scores.cu`` through
    :func:`~helix_tpu_torch.kernels.launch`, counted in
    ``i8_bucket_scores.launches``; CPU tensors run
    :func:`i8_bucket_scores_reference` at any shape.  On other devices, a
    shape :func:`i8_kernel_refusal` names and anything else the kernel
    does not take raise."""
    if xs_i8.device.type == "cpu" and q_i8.device.type == "cpu":
        return i8_bucket_scores_reference(xs_i8, q_i8, n_valid)
    if xs_i8.dim() != 2 or q_i8.dim() != 2 or xs_i8.shape[1] != q_i8.shape[1]:
        raise ValueError(
            f"i8_bucket_scores shapes: xs [N, D] and q [B, D], got "
            f"{tuple(xs_i8.shape)} and {tuple(q_i8.shape)}"
        )
    n, d = xs_i8.shape
    b = q_i8.shape[0]
    refusal = i8_kernel_refusal(n, d, b)
    if refusal is not None:
        raise ValueError(f"i8_bucket_scores: {refusal}")
    kernels.check_operands(
        "i8_bucket_scores", {"xs_i8": xs_i8, "q_i8": q_i8},
        {"xs_i8": torch.int8, "q_i8": torch.int8},
    )
    n_valid = max(0, min(int(n_valid), n))
    out = torch.empty((n // BUCKET, b), dtype=torch.float32,
                      device=xs_i8.device)
    kernels.launch(
        i8_bucket_scores, kernels.load().hx_i8_bucket_scores,
        xs_i8.get_device(), xs_i8.data_ptr(), q_i8.data_ptr(),
        out.data_ptr(), n, d, b, n_valid,
    )
    return out


i8_bucket_scores.launches = 0
i8_bucket_scores.captured = 0


def fused_coarse(bucket_scores_fn, n_rows: int, qs: torch.Tensor, *,
                 k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The query loop the int8 and int4 fused paths share: queries in
    chunks of at most 256, padded to 128, quantized per query;
    ``bucket_scores_fn(q_i8)`` gives ``[buckets, b_pad]`` winners, whose
    top ``k`` (at most one per bucket) become row ids.  Returns
    ``(winners [B, k], per-query scales [B, 1], ids [B, k])``."""
    b_in = qs.shape[0]
    k_cand = min(k, n_rows // BUCKET)
    out_s, out_q, out_i = [], [], []
    for lo in range(0, b_in, MAX_QUERY_BLOCK):
        chunk = qs[lo:lo + MAX_QUERY_BLOCK]
        b = chunk.shape[0]
        b_pad = max(MIN_QUERY_BLOCK, ((b + 127) // 128) * 128)
        if b_pad != b:
            chunk = torch.nn.functional.pad(chunk, (0, 0, 0, b_pad - b))
        q_i8, q_scales = _quantize_queries(chunk)
        vals = bucket_scores_fn(q_i8).T                  # [b_pad, buckets]
        best_s, pos = _top_k(vals, k_cand)    # ref :654 approx_max_k
        arg = best_s.view(torch.int32) & (BUCKET - 1)
        out_s.append(best_s[:b])
        out_q.append(q_scales[:b, None])
        out_i.append((pos * BUCKET + arg)[:b])
    return torch.cat(out_s), torch.cat(out_q), torch.cat(out_i)


def int8_fused_coarse(
    xs_i8: torch.Tensor,       # [N, D] int8 (global scale), rows padded to TILE
    qs: torch.Tensor,          # [B, D] f32
    n_valid: int,
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused int8 coarse candidates: (de-scaled packed scores [B, k], row
    ids).  Cosine only; ``xs_i8`` holds :func:`quantize_rows_unit` codes.
    The scores still carry the index bits in their mantissas, as the
    reference's do; callers read only the ids."""
    best_s, q_scales, ids = fused_coarse(
        lambda q_i8: i8_bucket_scores(xs_i8, q_i8, n_valid),
        xs_i8.shape[0], qs, k=k,
    )
    return best_s * (float(GLOBAL_SCALE) * q_scales), ids
