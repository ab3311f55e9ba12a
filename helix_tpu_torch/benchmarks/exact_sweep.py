"""Exact-rung coarse-phase sweep (PyTorch port of
``benchmarks/exact_sweep.py``).

Times the serving batch (coarse phase + exact f32 device re-rank, the
contract of ``topk_resident``) under alternative coarse phases on one
corpus (``ladder._corpus``, the headline's):

- ``resident_topk_auto (shipped serving)``: on the card kernel 1 and its
  tail (``fused_topk``), elsewhere ``topk_resident``;
- ``single_shot_bf16``: ``topk_resident``'s single-shot bf16 selection;
- ``chunked_bf16 c=<C>``: a loop over row blocks of C (each C the
  largest divisor of the padded row count at most the target,
  ``pick_chunk``): a bf16 ``[B, C]`` product, the row mask, the block's
  top ``k_scan``, a running top-k merge in f32, then the re-rank.

With ``--int8`` the coarse phase alone on global-scale int8 codes
(``quantize_rows_unit``): the fused one (kernel 2 through
``quant.int8_fused_coarse``), ``int8_coarse_topk``'s single shot, and a
chunked one (``quant.int_dots``: ``torch._int_mm`` on the card) at each
chunk of the bf16 sweep; each row's ``coarse_recall_at_10`` counts the
oracle's top 10 among the ``k_cand`` candidates.

Usage::

    python -m helix_tpu_torch.benchmarks.exact_sweep [--n 1000000]
        [--batch 256] [--rounds 64] [--chunks 8192,...] [--int8]
    python -m helix_tpu_torch.benchmarks.exact_sweep --device cpu \\
        --n 16384 --chunks 4096,8192 --int8

Prints one JSON line: ``metric``, ``roofline_qps``, ``variants``.

Differences from the reference:

- ``--device cuda`` (the default; exits nonzero without a card) or
  ``cpu`` (the kernels' plain versions).  The fused int8 row runs where
  ``ladder.use_fused_route`` holds (the card), in place of the
  reference's ``default_backend() == "tpu"``.
- Renamed variants (the reference's names state its compiler):
  ``single_shot_bf16 (XLA path)`` -> ``single_shot_bf16 (torch ops
  path)``, ``int8_fused_pallas (shipped)`` -> ``int8_fused_cuda
  (shipped)``, ``int8_single_shot_xla`` -> ``int8_single_shot_torch``,
  ``int8_chunked_xla c=<C>`` -> ``int8_chunked_torch c=<C>``
  (:data:`RENAMES`).
- The chunked scans are Python loops over the chunks (the reference's
  ``lax.scan``), captured whole in :func:`roofline.timed_scan_qps`'s
  CUDA graph; ``approx_max_k`` is the exact ``distance._top_k`` (ties
  to the lower index), and the bf16 product with a bf16 result is a
  ``torch.matmul`` in bf16.
- The reference's classmethod ``PackedMatrix._upload(values)`` is the
  port's instance method ``matrix._upload(host, n_rows, dtype)``.
- Every variant's failure is caught: it prints ``FAILED`` on stderr,
  the line is still printed, and the script exits 1 (the reference lets
  the two shipped paths raise and skips a failed chunk or int8 row
  quietly).  A reading above the card's bound (bf16 for the exact rows,
  int8 for the coarse rows; ``roofline.apply_roofline``) fails its row.
- Each row adds ``seconds`` (its timing's wall time, the graphs'
  capture included); the line adds ``device`` and the kernel wrappers'
  launches and captured nodes over the run (``kernel_launches``,
  ``kernel_captured``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops import distance as D
from ..ops import quant as Q
from .ladder import _corpus, _oracle, _recall, kernel_counts, use_fused_route
from .roofline import apply_roofline, roofline_batch_seconds, timed_scan_qps

RENAMES = {
    "single_shot_bf16 (XLA path)": "single_shot_bf16 (torch ops path)",
    "int8_fused_pallas (shipped)": "int8_fused_cuda (shipped)",
    "int8_single_shot_xla": "int8_single_shot_torch",
    "int8_chunked_xla c={c}": "int8_chunked_torch c={c}",
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="the exact rung's coarse phase, single shot against "
                    "chunked (and int8 with --int8)")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--chunks",
                    default="8192,16384,32768,65536,131072,262144")
    ap.add_argument("--int8", action="store_true",
                    help="also sweep an int8 chunked coarse phase against "
                         "the shipped fused int8 kernel")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the kernels; cpu: their plain versions")
    return ap.parse_args(argv)


def rerank(best_s, best_i, a32, qs, k: int) -> torch.Tensor:
    """The exact f32 re-rank of the coarse candidates: top-k ids."""
    D.require_fp32_matmul()
    exact = torch.einsum("bkd,bd->bk", a32[best_i], qs)
    exact = torch.where(torch.isfinite(best_s), exact, float("-inf"))
    _, pos = D._top_k(exact, k)
    return torch.gather(best_i, 1, pos)


def chunk_bf16(chunk: int, n_pad: int, n_valid: int, k_scan: int, k: int):
    """The bf16 coarse phase over blocks of ``chunk`` rows with a running
    top-``k_scan`` merge, then :func:`rerank`: ``fn(qb, a16, a32, asq)``."""
    def fn(qb, a16, a32, asq):
        b = qb.shape[0]
        qb16 = qb.to(torch.bfloat16)
        col_base = torch.arange(chunk, device=a16.device)
        best_s = torch.full((b, k_scan), float("-inf"), device=a16.device)
        best_i = torch.zeros((b, k_scan), dtype=torch.int64,
                             device=a16.device)
        for start in range(0, n_pad, chunk):
            sims = torch.matmul(qb16, a16[start:start + chunk].T)
            cols = start + col_base
            sims = torch.where((cols < n_valid)[None, :], sims, -3.0e38)
            s16, i_local = D._top_k(sims, k_scan)
            s_chunk = s16.float()
            s_chunk = torch.where(s_chunk <= -1e38, float("-inf"), s_chunk)
            cat_s = torch.cat([best_s, s_chunk], dim=1)
            cat_i = torch.cat([best_i, cols[i_local]], dim=1)
            best_s, pos = D._top_k(cat_s, k_scan)
            best_i = torch.gather(cat_i, 1, pos)
        return rerank(best_s, best_i, a32, qb, k)
    return fn


def chunk_i8(chunk: int, n_pad: int, n_valid: int, k_cand: int):
    """The int8 coarse phase over blocks of ``chunk`` rows (exact int32
    dots, de-scaled per query and row) with a running top-``k_cand``
    merge: ``fn(qb, a_q, a_sc)`` -> candidate ids."""
    def fn(qb, a_q, a_sc):
        b = qb.shape[0]
        q_i8, q_scales = Q._quantize_queries(qb)
        col_base = torch.arange(chunk, device=a_q.device)
        best_s = torch.full((b, k_cand), float("-inf"), device=a_q.device)
        best_i = torch.zeros((b, k_cand), dtype=torch.int64,
                             device=a_q.device)
        for start in range(0, n_pad, chunk):
            dots = Q.int_dots(q_i8, a_q[start:start + chunk])
            sims = (dots.float() * q_scales[:, None]
                    * a_sc[start:start + chunk][None, :])
            cols = start + col_base
            sims = torch.where((cols < n_valid)[None, :], sims,
                               float("-inf"))
            s_chunk, i_local = D._top_k(sims, k_cand)
            cat_s = torch.cat([best_s, s_chunk], dim=1)
            cat_i = torch.cat([best_i, cols[i_local]], dim=1)
            best_s, pos = D._top_k(cat_s, k_cand)
            best_i = torch.gather(cat_i, 1, pos)
        return best_i
    return fn


def main(argv=None) -> int:
    args = parse_args(argv)
    n, d, batch, k = args.n, args.d, args.batch, args.k
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("exact_sweep: no CUDA device (use --device cpu for the plain "
            "versions)")
        return 1
    log(f"# exact sweep: N={n} d={d} batch={batch} device={device}")
    data, queries = _corpus(n, d, batch, 1)
    matrix = D.PackedMatrix(d, "cosine", device=device)
    matrix.extend(data)
    xs16, sq = matrix.device_arrays()
    xs32 = matrix.data_device()
    oracle = _oracle(data, queries[:batch], k)
    del data
    qs_pad = torch.from_numpy(matrix.prepare_queries(queries[:batch])).to(
        device)
    dim_pad = matrix.dim_pad
    n_valid = matrix.n
    n_pad = int(xs16.shape[0])
    k_scan = min(max(k, 8 * k), n)
    floor = roofline_batch_seconds(
        bytes_read=n_pad * dim_pad * 2,
        mxu_ops=2.0 * batch * n_pad * dim_pad, dtype="bf16", device=device)
    rows, failed = [], []
    counts = kernel_counts()

    def run(name, fn, ops, floor_s, recall_key, to_ids):
        t = time.perf_counter()
        try:
            qps, diag = timed_scan_qps(
                fn, batch=batch, d=d, dim_pad=dim_pad, rounds=args.rounds,
                operands=ops, device=device)
            ids = to_ids(fn(qs_pad, *ops).cpu().numpy())
            row = apply_roofline({
                "variant": name, "qps": round(qps, 1),
                recall_key: round(_recall(ids, oracle, k), 4),
                "per_batch_ms": diag["per_batch_ms_samples"],
            }, batch, floor_s)
        except Exception as exc:  # noqa: BLE001 -- the line still prints
            log(f"# {name}: FAILED {exc!r}")
            failed.append(name)
            return
        row.pop("roofline_qps", None)
        row["seconds"] = round(time.perf_counter() - t, 2)
        rows.append(row)
        log(f"# {name}: {qps:,.0f} QPS in {row['seconds']} s")

    def same(ids):
        return ids

    # -- shipped paths (reference points)
    def auto_batch(qb, a16, a32, asq):
        return D.resident_topk_auto(a16, a32, qb, n_valid, asq, k=k,
                                    metric="cosine")[1]

    def single_batch(qb, a16, a32, asq):
        return D.topk_resident(a16, a32, qb, n_valid, asq, k=k,
                               metric="cosine")[1]

    run("resident_topk_auto (shipped serving)", auto_batch,
        (xs16, xs32, sq), floor, "recall_at_10", same)
    run(RENAMES["single_shot_bf16 (XLA path)"], single_batch,
        (xs16, xs32, sq), floor, "recall_at_10", same)

    # -- chunked scan variants
    chunks = []
    for target in (int(x) for x in args.chunks.split(",") if x):
        c = D.pick_chunk(n_pad, target)
        if c in chunks or c >= n_pad:
            continue
        chunks.append(c)
        run(f"chunked_bf16 c={c}", chunk_bf16(c, n_pad, n_valid, k_scan, k),
            (xs16, xs32, sq), floor, "recall_at_10", same)

    # -- optional int8 coarse comparison
    if args.int8:
        values = Q.quantize_rows_unit(np.asarray(matrix.data[: matrix.n]))
        xs_i8 = matrix._upload(values, n_pad, torch.int8)
        del values
        sc = torch.full((n_pad,), float(Q.GLOBAL_SCALE), device=device)
        sqq = torch.zeros((1,), device=device)
        k_cand = min(max(k, 8 * k), n)
        floor8 = roofline_batch_seconds(
            bytes_read=n_pad * dim_pad, mxu_ops=2.0 * batch * n_pad * dim_pad,
            dtype="int8", device=device)

        def fused_i8(qb, a_q, a_sc):
            return Q.int8_fused_coarse(a_q, qb, n_valid, k=k_cand)[1]

        def torch_i8(qb, a_q, a_sc, a_sq):
            # a copy: the ids are a view of the full sort's [B, N] int64
            # indices, which the timed graphs' kept outputs would hold
            return Q.int8_coarse_topk(a_q, a_sc, qb, n_valid, a_sq,
                                      k=k_cand)[1].clone()

        def candidates(cand):
            return np.where(cand < matrix.n, cand, -1)

        i8_variants = []
        if use_fused_route(device):
            i8_variants.append((RENAMES["int8_fused_pallas (shipped)"],
                                fused_i8, (xs_i8, sc)))
        i8_variants.append((RENAMES["int8_single_shot_xla"], torch_i8,
                            (xs_i8, sc, sqq)))
        for c in sorted(chunks):
            i8_variants.append((
                RENAMES["int8_chunked_xla c={c}"].format(c=c),
                chunk_i8(c, n_pad, n_valid, k_cand), (xs_i8, sc)))
        for name, fn, ops in i8_variants:
            run(f"{name} (coarse-only, k_cand={k_cand})", fn, ops, floor8,
                "coarse_recall_at_10", candidates)

    after = kernel_counts()
    out = {
        "metric": f"exact coarse sweep (N={n}, d={d}, batch={batch}, "
                  f"k={k}, k_scan={k_scan})",
        "roofline_qps": round(batch / floor, 1) if floor else None,
        "variants": rows,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "kernel_launches": {name: after[name][0] - counts[name][0]
                            for name in after},
        "kernel_captured": {name: after[name][1] - counts[name][1]
                            for name in after},
    }
    print(json.dumps(out), flush=True)
    if failed:
        log(f"# failed: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
