"""int8/int4 quantized residency past the exact tier's budget (PyTorch
port of ``benchmarks/quant_demo.py``).

Workload: an N x 128 clustered corpus (seed 7) whose exact tier (bf16 +
f32, 6 bytes/dim) exceeds the declared budget while the int8 tier (1
byte/dim + 4/row) fits.  Measures coarse + host re-rank QPS and recall@10
against a blocked exact-scan oracle.

    python -m helix_tpu_torch.benchmarks.quant_demo --n 10000000 --queries 256
    python -m helix_tpu_torch.benchmarks.quant_demo --bits 4     # int4 rung
    python -m helix_tpu_torch.benchmarks.quant_demo --device cpu --n 20000

``--bits 8`` quantizes per row (``quantize_rows``) and runs
``int8_coarse_topk`` on every device, as the reference does (on the card
``torch._int_mm``; no kernel of the port).  ``--bits 4`` on the card runs
the fused route: scale-sorted per-bucket codes, kernel 3
(``int4_fused_coarse``) and ``perm``.  Prints one JSON line.

Differences from the reference:

- ``--device`` (default ``cuda``; without a card the script exits nonzero
  naming CUDA); the fused route (the reference's ``backend == "tpu"``) is
  ``ladder.use_fused_route``.
- The coarse loop's time is taken after a ``torch.cuda.synchronize``
  where the reference blocks on the last result.
- The oracle is ``ladder._oracle`` (``argpartition`` per chunk; the ids
  are the reference's wherever no two scores tie at rank k).
- int4's sorted ids map back through ``quant4.unsort_candidates``; the
  padded rows come from ``quant._padded_rows`` (the reference's
  ``_rows_view``); uploads use the port's ``matrix._upload(host, n_rows,
  dtype)``.
- The line adds ``device``, ``card`` (``nvidia-smi``'s name and power
  limit; null off the card) and ``kernel_launches`` (each kernel's
  launches during the run).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import ladder
from .ladder import _oracle, kernel_counts, log


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--bits", type=int, default=8, choices=(8, 4))
    ap.add_argument(
        "--cache", default=None,
        help="path to an .npy corpus cache (created when absent) so the "
             "expensive synthesis can run in a separate invocation; a "
             ".dat float32 memmap of unit rows is adopted as it is",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("quant_demo: torch sees no CUDA device; pass --device cpu to "
            "run on the host")
        return 1

    from ..native import rerank as native_rerank
    from ..ops.distance import PackedMatrix
    from ..ops.quant import _padded_rows, int8_coarse_topk, quantize_rows
    from ..ops.quant4 import (int4_coarse_topk, int4_fused_coarse,
                              quantize_rows_int4, unsort_candidates)

    on_card = device.type == "cuda"
    card = None
    if on_card:
        from ..card import card_line

        card = card_line()
    counts0 = kernel_counts()
    n, d, b, k = args.n, args.d, args.queries, args.k
    rng = np.random.default_rng(7)
    n_clusters = 1000
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    chunk = 1_000_000
    mat = PackedMatrix(d, "cosine", device=device)

    t_gen = time.perf_counter()
    if args.cache and os.path.exists(args.cache):
        log(f"# adopting corpus cache {args.cache}...")
        if args.cache.endswith(".dat"):
            # raw float32 memmap [n, d], rows pre-normalized: adopt it as
            # the packed matrix directly (d == dim_pad), no repack pass
            if d != mat.dim_pad:
                log("quant_demo: a .dat cache needs d == dim_pad")
                return 1
            mm = np.memmap(args.cache, dtype=np.float32, mode="r",
                           shape=(n, d))
            mat.data = mm
            mat.sq_norms = np.ones(n, np.float32)
            mat.n = n
            mat.capacity = n
            mat.version += 1
        else:
            mat.extend(np.load(args.cache, mmap_mode="r"))
    else:
        log(f"# generating {n}x{d} clustered corpus...")
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            assign = rng.integers(0, n_clusters, size=e - s)
            block = centers[assign] + 0.3 * rng.normal(
                size=(e - s, d)
            ).astype(np.float32)
            block /= np.linalg.norm(block, axis=1, keepdims=True) + 1e-9
            mat.extend(block)
        if args.cache:
            np.save(args.cache, mat.data[: mat.n, :d])
            log(f"# cached corpus at {args.cache}")
    log(f"# corpus ready in {time.perf_counter() - t_gen:.0f}s")

    qs = centers[rng.integers(0, n_clusters, size=b)] + 0.3 * rng.normal(
        size=(b, d)
    ).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    qs_pad = mat.prepare_queries(qs)

    exact_gb = mat.n * mat.dim_pad * 6 / (1 << 30)
    int8_gb = mat.n * (mat.dim_pad + 4) / (1 << 30)
    int4_gb = mat.n * (mat.dim_pad // 2 + 4) / (1 << 30)
    log(f"# residency: exact {exact_gb:.1f} GB, int8 {int8_gb:.2f} GB, "
        f"int4 {int4_gb:.2f} GB")

    use_fused = ladder.use_fused_route(device)
    log(f"# quantizing + uploading int{args.bits} matrix...")
    t0 = time.perf_counter()
    # Quantize in 1M-row chunks: one numpy pass over a 5 GB corpus churns
    # five 5 GB temporaries.
    perm = None
    rows_n = mat.n
    if args.bits == 4:
        if use_fused:
            from ..ops.fused_topk import pad_rows_for_fused

            rows_n = pad_rows_for_fused(mat.n)
        qfn = quantize_rows_int4
        k_cand = max(32 * k, 256)
    else:
        qfn = quantize_rows
        k_cand = max(8 * k, 64)
    if args.bits == 4 and use_fused:
        # serving mirror: scale-sorted per-bucket quantization
        from ..ops.quant4 import quantize_rows_int4_bucketed

        values, bsc_np, scales, perm = quantize_rows_int4_bucketed(
            _padded_rows(mat, rows_n), n_live=mat.n, chunk=chunk,
        )
        sc = torch.from_numpy(bsc_np).to(device)
    else:
        vparts, sparts = [], []
        for s0 in range(0, mat.n, chunk):
            e0 = min(mat.n, s0 + chunk)
            vp, sp = qfn(np.asarray(mat.data[s0:e0]))
            vparts.append(vp)
            sparts.append(sp)
        if rows_n > mat.n:
            pad_rows = np.zeros((rows_n - mat.n, mat.dim_pad), np.float32)
            vp, sp = qfn(pad_rows)
            vparts.append(vp)
            sparts.append(sp)
        values = np.concatenate(vparts)
        scales = np.concatenate(sparts)
        del vparts, sparts
        sc = torch.from_numpy(scales).to(device)
    xs_q = mat._upload(values, len(values),
                       torch.int8 if args.bits == 8 else torch.uint8)
    sq = torch.from_numpy(np.ascontiguousarray(
        mat.sq_norms[: len(values)])).to(device)
    if on_card:
        torch.cuda.synchronize(device)
    upload_s = time.perf_counter() - t0

    qd = torch.from_numpy(qs_pad).to(device)

    def coarse():
        if args.bits == 4:
            if use_fused:
                return int4_fused_coarse(xs_q, sc, qd, mat.n, k=k_cand)
            return int4_coarse_topk(xs_q, sc, qd, mat.n, sq, k=k_cand)
        return int8_coarse_topk(xs_q, sc, qd, mat.n, sq, k=k_cand)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    _, cand = coarse()
    sync()

    # Coarse-phase throughput: dispatch loop, one wait at the end (the
    # bench.py measurement pattern).
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        _, cand = coarse()
    sync()
    coarse_ms = (time.perf_counter() - t0) / args.rounds * 1000

    # Full tier: coarse + exact f32 host re-rank.
    t0 = time.perf_counter()
    cand_h = cand.cpu().numpy().astype(np.int64)
    if perm is not None:   # sorted positions -> original rows
        cand_h = unsort_candidates(cand_h, perm)
    cand_h = np.where(cand_h < mat.n, cand_h, -1)
    _, pos = native_rerank(
        mat.data[: mat.n], mat.sq_norms[: mat.n], qs_pad, cand_h, k, "cosine"
    )
    rerank_ms = (time.perf_counter() - t0) * 1000
    qps = b / ((coarse_ms + rerank_ms) / 1000)

    log("# oracle (blocked exact scan on host)...")
    oracle = _oracle(mat.data[: mat.n], qs_pad, k)
    recall = float(np.mean([
        len(set(pos[i][pos[i] >= 0]) & set(oracle[i])) / k for i in range(b)
    ]))

    counts = kernel_counts()
    print(json.dumps({
        "metric": f"int{args.bits} residency tier QPS (N={n}, d={d}, k={k})",
        "value": round(qps, 1),
        "unit": "QPS",
        "recall_at_10": round(recall, 4),
        "coarse_ms_per_batch": round(coarse_ms, 3),
        "rerank_ms_per_batch": round(rerank_ms, 3),
        "quantize_upload_s": round(upload_s, 2),
        "exact_residency_gb": round(exact_gb, 2),
        "int8_residency_gb": round(int8_gb, 2),
        "int4_residency_gb": round(int4_gb, 2),
        "bits": args.bits,
        "fused": bool(use_fused and args.bits == 4),
        "k_cand": k_cand,
        "batch": b,
        "device": str(device),
        "card": card,
        "kernel_launches": {name: counts[name][0] - counts0[name][0]
                            for name in counts},
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
