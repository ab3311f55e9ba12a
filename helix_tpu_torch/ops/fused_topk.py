"""Fused distance + packed bucket-max top-k (PyTorch port).

Port of ``helix_tpu/ops/fused_topk.py``.  The coarse phase is one kernel
pass over the bf16 matrix that emits a single packed winner per
``BUCKET``-row window: each score's low ``log2(BUCKET)`` mantissa bits
are overwritten with its in-bucket row index before a float max over the
bucket, so the winner carries its own row index and the caller recovers
the row id as ``bucket * BUCKET + (bits & (BUCKET - 1))`` with no index
matrix.  Packing perturbs scores by <= 2^-17 relative (selection-only
noise, erased by the exact f32 re-rank).  A true top-k item is lost only
when two top-k items share a bucket (~``C(k,2)/buckets``).

:func:`bucket_scores` is the kernel wrapper.  On a CUDA tensor it
launches the hand-written Hopper kernel ``csrc/bucket_scores.cu`` or
raises; on a CPU tensor it runs :func:`bucket_scores_reference`, the
plain PyTorch version of the same arithmetic, which the tests hold
against the JAX kernel.

Deliberate differences from the reference:

- ``approx_max_k`` becomes an exact top-k (on the CPU the reference's
  ``approx_max_k`` is exact too): the bucket selection and the
  re-rank's ``lax.top_k`` both go through
  :func:`~helix_tpu_torch.ops.distance._top_k`, the selection kernel
  ``csrc/select_topk.cu`` on the card (``ops/topk.py``), ties to the
  lower position.
- The denormal rule is explicit: a packed value with |v| < FLT_MIN
  becomes a signed zero, which is what the TPU and XLA's flush do to a
  row scoring exactly 0 (a zeroed tombstone row).  PyTorch on the CPU
  does not flush, and CUDA flushes only under ``-ftz=true``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels, tracing
from .distance import _top_k, require_fp32_matmul

# Row padding granularity and bucket width (same values and meaning as
# the reference).
TILE = 8192
BUCKET = 64

# Finite "masked row" sentinel: OR-ing index bits into an -inf mantissa
# would manufacture NaNs.
NEG_SENTINEL = -3.0e38

# Queries per kernel call: padded to 128 or 256 (one or two of the
# kernels' 128-query tiles), at most 256 per call.
MIN_QUERY_BLOCK = 128
MAX_QUERY_BLOCK = 256

# What the three Hopper kernels take (csrc/hopper.cuh's pipeline): whole
# 64-row buckets (N % 64, N < 2^31), B of 128 or 256 (the N of their
# m64n128 / m64n256 tensor-core product; every caller pads its query
# chunks to one of the two), and the feature dim in chunks of one 128-byte
# swizzle row: KERNEL_DEPTH = 64 bf16 columns for csrc/bucket_scores.cu,
# 128 int8 columns for csrc/i8_bucket_scores.cu and 128 unpacked int4
# columns (64 packed bytes) for csrc/i4_bucket_scores.cu (their refusals
# are ops/quant.py:i8_kernel_refusal and ops/quant4.py:i4_kernel_refusal).
# Queries that do not fit in shared memory beside the rings stream
# through them, so unlike the TPU's VMEM tile budget there is no width
# cap.
KERNEL_DEPTH = 64
BUCKET_KERNEL_QUERIES = (MIN_QUERY_BLOCK, MAX_QUERY_BLOCK)


def kernel_refusal(n: int, d: int, b: int, depth: int) -> str | None:
    """Why a kernel of the three, whose feature-dim chunk is ``depth``
    columns, cannot take ``xs [n, d]`` and queries ``[b, d]``, or None
    when it can."""
    if n <= 0 or n % BUCKET or n >= 1 << 31:
        return f"N={n} is not a positive multiple of {BUCKET} below 2^31"
    if d <= 0 or d % depth:
        return f"D={d} is not a positive multiple of {depth}"
    if b not in BUCKET_KERNEL_QUERIES:
        return f"B={b} is not one of {BUCKET_KERNEL_QUERIES}"
    return None


def bucket_kernel_refusal(n: int, d: int, b: int) -> str | None:
    """Why ``csrc/bucket_scores.cu`` cannot take ``xs [n, d]`` and
    ``qs [b, d]``, or None when it can."""
    return kernel_refusal(n, d, b, KERNEL_DEPTH)


_EXP_MASK = 0x7F800000
_SIGN_BIT = -(1 << 31)  # 0x80000000 as int32


def _flush_denormals(bits: torch.Tensor) -> torch.Tensor:
    """The denormal rule on int32 float bits: |v| < FLT_MIN -> signed 0."""
    return torch.where((bits & _EXP_MASK) == 0, bits & _SIGN_BIT, bits)


def mask_pack_reduce(sims: torch.Tensor, n_valid: int) -> torch.Tensor:
    """The epilogue shared by the plain versions of all three kernels
    (the reference's ``bucket_reduce_packed``, with the row mask in
    front): rows ``>= n_valid`` of the f32 score tile ``sims [N, B]``
    become ``NEG_SENTINEL``, each score's low mantissa bits take its
    in-bucket row index, denormals flush, and a float max over each
    ``BUCKET``-row window gives ``[N / BUCKET, B]``."""
    n, b = sims.shape
    rows = torch.arange(n, device=sims.device, dtype=torch.int32)[:, None]
    sims = torch.where(rows < n_valid, sims, NEG_SENTINEL)
    packed = (sims.view(torch.int32) & ~(BUCKET - 1)) | (rows & (BUCKET - 1))
    packed = _flush_denormals(packed)
    return packed.view(torch.float32).view(n // BUCKET, BUCKET, b).amax(dim=1)


def descale_packed(winners: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Multiply packed winners ``[buckets, B]`` by positive per-bucket
    ``scales [buckets, 1]`` and keep the in-bucket index: split the index
    bits off, multiply the cleaned score (one f32 multiply), re-pack, and
    apply the denormal rule again (reference ``descale_packed``)."""
    mask = BUCKET - 1
    bits = winners.view(torch.int32)
    clean = (bits & ~mask).view(torch.float32)
    scaled = (clean * scales).view(torch.int32)
    return _flush_denormals((scaled & ~mask) | (bits & mask)).view(torch.float32)


def bucket_scores_reference(
    xs16: torch.Tensor, qs16: torch.Tensor, n_valid: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``[N / BUCKET, B]`` f32
    packed winners for ``xs16 [N, D]`` and ``qs16 [B, D]`` (bf16).

    A float32 product of the bf16-rounded inputs (exact products, f32
    sums), then :func:`mask_pack_reduce`."""
    return mask_pack_reduce(xs16.float() @ qs16.float().T, n_valid)


@functools.lru_cache(maxsize=None)
def bucket_plan(d: int, b: int) -> tuple[bool, int, int, int]:
    """The plan ``csrc/bucket_scores.cu`` makes for queries ``[b, d]``
    (its C entry ``hx_bucket_scores_plan``): queries resident in shared
    memory, ring stages per consumer, stage bytes, dynamic shared
    memory."""
    out = (ctypes.c_int * 4)()
    if kernels.load().hx_bucket_scores_plan(d, b, out) != 0:
        raise ValueError(f"bucket_scores takes no plan for D={d}, B={b}")
    return bool(out[0]), out[1], out[2], out[3]


def staged_bytes(n: int, d: int, b: int, resident: bool, blocks: int) -> int:
    """Bytes one launch of the kernel over ``xs [n, d]`` and ``qs [b, d]``
    stages into shared memory by TMA: every bf16 row once, and the bf16
    queries once per block where they are resident, or once per 64-row
    bucket where they stream through the ring beside the rows.  The grid
    is one block per SM, ``blocks``, or one per bucket where there are
    fewer."""
    buckets = n // BUCKET
    query_loads = min(blocks, buckets) if resident else buckets
    return 2 * d * (n + query_loads * b)


def _count_plan(n: int, d: int, b: int, device: torch.device) -> None:
    """The tracer's counters of one launch: the bytes it stages
    (``kernel.bucket_scores.staged_bytes``) and the rows' share of them
    (``.row_bytes``)."""
    blocks = torch.cuda.get_device_properties(device).multi_processor_count
    resident = bucket_plan(d, b)[0]
    tracing.count("kernel.bucket_scores.staged_bytes",
                  staged_bytes(n, d, b, resident, blocks))
    tracing.count("kernel.bucket_scores.row_bytes", 2 * n * d)


def bucket_scores(
    xs16: torch.Tensor, qs16: torch.Tensor, n_valid: int
) -> torch.Tensor:
    """``[N / BUCKET, B]`` f32 packed winners (see module docstring).

    CUDA tensors launch ``csrc/bucket_scores.cu`` through
    :func:`~helix_tpu_torch.kernels.launch`, counted in
    ``bucket_scores.launches`` (``.captured`` where the stream captures a
    CUDA graph); CPU tensors run :func:`bucket_scores_reference`.  While
    a profiler records, a launch (not a captured node) also adds to the
    tracer's counters of the bytes it stages (:func:`_count_plan`).
    Shapes the kernel does not take
    (:func:`bucket_kernel_refusal`) raise on either device, and so does
    anything else the kernel does not take."""
    if xs16.dim() != 2 or qs16.dim() != 2 or xs16.shape[1] != qs16.shape[1]:
        raise ValueError(
            f"bucket_scores shapes: xs [N, D] and qs [B, D], got "
            f"{tuple(xs16.shape)} and {tuple(qs16.shape)}"
        )
    n, d = xs16.shape
    b = qs16.shape[0]
    refusal = bucket_kernel_refusal(n, d, b)
    if refusal is not None:
        raise ValueError(f"bucket_scores: {refusal}")
    if xs16.device.type == "cpu" and qs16.device.type == "cpu":
        return bucket_scores_reference(xs16, qs16, n_valid)
    kernels.check_operands(
        "bucket_scores", {"xs16": xs16, "qs16": qs16},
        {"xs16": torch.bfloat16, "qs16": torch.bfloat16},
    )
    n_valid = max(0, min(int(n_valid), n))
    out = torch.empty((n // BUCKET, b), dtype=torch.float32,
                      device=xs16.device)
    captured = kernels.launch(
        bucket_scores, kernels.load().hx_bucket_scores, xs16.get_device(),
        xs16.data_ptr(), qs16.data_ptr(), out.data_ptr(), n, d, b, n_valid,
    )
    if not captured and tracing.recording():
        _count_plan(n, d, b, xs16.device)
    return out


bucket_scores.launches = 0
bucket_scores.captured = 0


def fused_candidates(
    xs16: torch.Tensor,       # [N, D] bf16, rows padded to TILE
    xs32: torch.Tensor,       # [N', D] f32 (re-rank operand, N' >= n_valid)
    qs: torch.Tensor,         # [B, D] f32
    n_valid: int,
    *,
    k: int,
    rerank: int = 8,
    winners=bucket_scores,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused step's core, shared by :func:`fused_topk` and the mesh's
    per-shard search (``parallel/sharded.py:_local_fused``): packed
    bucket winners from :func:`bucket_scores` in blocks of at most
    ``MAX_QUERY_BLOCK`` queries, the top ``k_cand`` buckets, and their
    exact f32 re-rank.  Returns ``(scores, ids, filled)``, each
    ``[B, min(k, k_cand)]`` and descending by score; a slot whose bucket
    held no valid row scores -inf, keeps the id its packed winner names
    and is not ``filled``.  ``winners(xs16, qs16, n_valid)`` stands in
    for :func:`bucket_scores` (the kernel sweep's variants,
    ``benchmarks/onepass_sweep.py``)."""
    require_fp32_matmul()
    b_in = qs.shape[0]
    total_buckets = xs16.shape[0] // BUCKET
    k_cand = min(max(k, min(rerank * k, 512), 64), total_buckets)
    out_s, out_i, out_f = [], [], []
    for lo in range(0, b_in, MAX_QUERY_BLOCK):
        chunk = qs[lo:lo + MAX_QUERY_BLOCK]
        b = chunk.shape[0]
        b_pad = max(MIN_QUERY_BLOCK, ((b + 127) // 128) * 128)
        if b_pad != b:
            chunk = torch.nn.functional.pad(chunk, (0, 0, 0, b_pad - b))
        qs16 = chunk.to(torch.bfloat16)
        vals = winners(xs16, qs16, n_valid).T            # [b_pad, buckets]
        best_s, pos = _top_k(vals, k_cand)    # ref :244 approx_max_k
        arg = best_s.view(torch.int32) & (BUCKET - 1)
        best_i = pos * BUCKET + arg
        # Exact f32 re-rank of the candidates (ids clipped like
        # jnp.take(mode="clip"): padding-bucket winners may point past
        # the f32 copy, and the valid mask below drops them).
        cand = xs32[best_i.clamp(max=xs32.shape[0] - 1)]
        exact = torch.einsum("bkd,bd->bk", cand, chunk)
        valid = best_s > NEG_SENTINEL / 2
        exact = torch.where(valid, exact, float("-inf"))
        # The bucket reduction yields at most k_cand candidates.
        top_s, top_pos = _top_k(exact, min(k, k_cand))
        out_s.append(top_s[:b])
        out_i.append(torch.gather(best_i, 1, top_pos)[:b])
        out_f.append(torch.gather(valid, 1, top_pos)[:b])
    if len(out_s) == 1:
        return out_s[0], out_i[0], out_f[0]
    return torch.cat(out_s), torch.cat(out_i), torch.cat(out_f)


def fused_topk(
    xs16: torch.Tensor,       # [N, D] bf16, rows padded to TILE
    xs32: torch.Tensor,       # [N', D] f32 (re-rank operand, N' >= n_valid)
    qs: torch.Tensor,         # [B, D] f32
    n_valid: int,
    sq_norms: torch.Tensor,   # unused (cosine only); kept for API parity
    *,
    k: int,
    rerank: int = 8,
    winners=bucket_scores,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``topk_resident``, cosine metric: fused packed
    candidates + exact f32 re-rank (:func:`fused_candidates`, which
    ``winners`` is passed to).  Returns ``(dists, ids)`` ascending by
    distance; overflow slots (fewer than k valid rows) carry id -1."""
    top_s, top_i, filled = fused_candidates(
        xs16, xs32, qs, n_valid, k=k, rerank=rerank, winners=winners
    )
    top_i = torch.where(filled, top_i, -1)
    k_top = top_s.shape[1]
    if k_top < k:
        # supports_fused routes k past the bucket count to
        # topk_resident; this is the backstop.
        pad = k - k_top
        top_s = torch.nn.functional.pad(top_s, (0, pad), value=float("-inf"))
        top_i = torch.nn.functional.pad(top_i, (0, pad), value=-1)
    return 1.0 - top_s, top_i


def supports_fused(n_rows_padded: int, dim_pad: int, metric: str,
                   device: torch.device, k: int | None = None) -> bool:
    """Serving-path gate: a CUDA device, cosine, fused-padded rows, a
    width of the reference's gate (``dim_pad % 128 == 0``; queries that
    do not fit in shared memory stream through the kernel's rings, so
    there is no width cap) that is not 0, fewer than 2^31 rows (the
    kernel's last limit, :func:`bucket_kernel_refusal`), and —
    when ``k`` is given — a bucket count that can supply k candidates
    (one winner per 64-row bucket; past that ``topk_resident`` serves
    the full pool instead of overflow padding)."""
    return (
        torch.device(device).type == "cuda"
        and metric == "cosine"
        and n_rows_padded % TILE == 0
        and n_rows_padded >= TILE
        and dim_pad > 0
        and dim_pad % 128 == 0
        and n_rows_padded < 1 << 31
        and (k is None or k <= n_rows_padded // BUCKET)
    )


def pad_rows_for_fused(n: int) -> int:
    """Row padding requirement for the fused kernel."""
    return ((max(n, 1) + TILE - 1) // TILE) * TILE
