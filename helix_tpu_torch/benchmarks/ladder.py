"""Residency-ladder benchmark (PyTorch port of ``benchmarks/ladder.py``):
every serving rung measured on one corpus from one entry point.

    python bench_torch.py --ladder [--n 1000000] [--batch 256] [--rounds 16]
    python -m helix_tpu_torch.benchmarks.ladder --device cpu --n 20000

The rungs, each on the same corpus and the same first query batch:

- ``exact``: bf16 + f32 resident copies, ``resident_topk_auto`` (on the
  card kernel 1 through ``fused_topk``);
- ``int8_dev``: int8 codes with one global scale, the coarse phase, then
  the f16 device re-rank (``device_rerank_topk``);
- ``int8``: the same coarse phase (kernel 2 where the 64-row buckets
  supply the pool, else ``int8_coarse_topk``), then the native host
  re-rank;
- ``int4``: scale-sorted int4 codes with per-bucket scales (kernel 3)
  on the fused route, per-row codes and ``int4_coarse_topk`` otherwise,
  then the native host re-rank;
- ``host_ivf``: ``HostIVFIndex`` (corpus in host memory, centroids on
  the device), the nprobe ladder 8 ... 128.

The corpus is ``bench.py``'s headline configuration (seed-42 clustered,
cosine, unit rows; :func:`_corpus`).  The script prints one JSON line:
QPS, recall@10, resident GB and build seconds per rung.  Throughput comes
from :func:`roofline.timed_scan_qps` (on the card one CUDA graph over
fresh query buffers, each graph's ids held to an eager run).

Differences from the reference:

- ``--device`` (default ``cuda``; without a card the script exits
  nonzero naming CUDA); ``--device cpu`` runs the kernels' plain
  versions.  The reference's route switch ``use_fused = backend ==
  "tpu"`` is :func:`use_fused_route`, ``device.type == "cuda"``; the CPU
  tests patch it to take the fused route on the plain versions.
- A reading above the card's bound raises :class:`RooflineFault` where
  the reference clamps it (``clamped_to_roofline``,
  ``coarse_clamped_to_roofline`` never appear).  Where the card is known
  each quantized row also carries its coarse phase's bound
  (``coarse_roofline_qps``; ``roofline_qps`` for ``int8_dev``).
- The reference's classmethod ``PackedMatrix._upload(values)`` is the
  port's instance method ``matrix._upload(host, n_rows, dtype)``, which
  casts on the device (the f16 re-rank copy is made there, not on the
  host).  The int4 quantizer's zero-padded rows come from
  ``quant._padded_rows`` (the reference's ``_rows_view``).
- int4's sorted ids map back through ``quant4.unsort_candidates`` (an id
  outside ``perm`` becomes -1; the reference clips it onto a row).
- Between rungs the CUDA caching allocator is emptied as well, so a 10M
  run holds no exact copy next to the int8 upload.
- The CPU HNSW baseline is ``bench_torch.py``'s copy, looked up in the
  port's own record (``.bench_cache/baseline_measured_torch.json``: the
  key ``ladder:{n}x{d}``, then at n <= 1M ``bench_torch.py``'s untagged
  ``{n}x{d}``), then in the committed ``BASELINE_MEASURED.json`` (read
  only; the record says it was taken on another host), then measured
  from a cached index without a build.  Nothing here writes a record;
  ``build_ladder_baseline.py`` writes the port's.
- The line adds ``card`` (``nvidia-smi``'s name and power limit; null
  off the card) and, per kernel, the launches its wrapper counted
  (``kernel_launches``) and the nodes captured into the timed graphs
  (``kernel_captured``) during the run.
- :func:`_oracle` selects each chunk's top k with ``argpartition`` and
  sorts only those, where the reference sorts every score; the ids are
  the same wherever no two scores tie at rank k.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .roofline import (RooflineFault, apply_roofline, roofline_batch_seconds,
                       timed_scan_qps)

RECALL_FLOOR = 0.95


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _corpus(n: int, d: int, batch: int, n_batches: int):
    rng = np.random.default_rng(42)
    n_clusters = 1000
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    parts = []
    chunk = 1_000_000
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        assign = rng.integers(0, n_clusters, size=e - s)
        block = centers[assign] + 0.3 * rng.normal(size=(e - s, d)).astype(
            np.float32
        )
        block /= np.linalg.norm(block, axis=1, keepdims=True) + 1e-9
        parts.append(block)
    data = np.concatenate(parts) if len(parts) > 1 else parts[0]
    queries = centers[rng.integers(0, n_clusters, size=batch * n_batches)] + \
        0.3 * rng.normal(size=(batch * n_batches, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-9
    return data, queries


def _top(sims: np.ndarray, k: int) -> np.ndarray:
    """Column indices of each row's k largest scores, descending."""
    k = min(k, sims.shape[1])
    part = np.argpartition(-sims, k - 1, axis=1)[:, :k]
    order = np.argsort(-np.take_along_axis(sims, part, axis=1), axis=1,
                       kind="stable")
    return np.take_along_axis(part, order, axis=1)


def _oracle(data: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """Blocked exact scan (host): top-k ids per query."""
    b = len(queries)
    best = np.full((b, 0), 0.0)
    best_i = np.zeros((b, 0), np.int64)
    chunk = 1_000_000
    for s in range(0, len(data), chunk):
        e = min(len(data), s + chunk)
        sims = queries @ data[s:e].T
        ci = _top(sims, k)
        cs = np.take_along_axis(sims, ci, axis=1)
        best = np.concatenate([best, cs], axis=1)
        best_i = np.concatenate([best_i, ci + s], axis=1)
        keep = np.argsort(-best, axis=1, kind="stable")[:, :k]
        best = np.take_along_axis(best, keep, axis=1)
        best_i = np.take_along_axis(best_i, keep, axis=1)
    return best_i


def _recall(ids: np.ndarray, oracle: np.ndarray, k: int) -> float:
    return float(np.mean([
        len(set(ids[i][ids[i] >= 0]) & set(oracle[i])) / k
        for i in range(len(oracle))
    ]))


def use_fused_route(device: torch.device) -> bool:
    """The reference's ``backend == "tpu"``: the quantized rungs take the
    fused coarse kernels (2 and 3) on the card."""
    return device.type == "cuda"


def kernel_counts() -> dict:
    """Each kernel wrapper's ``(launches, captured)`` counts so far."""
    from ..ops import fused_topk as F
    from ..ops import quant as Q
    from ..ops import quant4 as Q4

    return {w.__name__: (w.launches, w.captured)
            for w in (F.bucket_scores, Q.i8_bucket_scores,
                      Q4.i4_bucket_scores)}


def release(device: torch.device) -> None:
    """Free what the last rung's dropped tensors and graphs held."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def read_baseline(data: np.ndarray, queries: np.ndarray,
                  oracle: np.ndarray, *, cache_dir: Path | None = None,
                  committed: Path | None = None, log=log) -> dict | None:
    """The CPU HNSW baseline over the ladder's corpus, read and never
    written: the port's own record (``ladder:{n}x{d}``, then at n <= 1M
    the headline's untagged ``{n}x{d}``: the two corpora are one there),
    then the committed record, then a search-only measurement from a
    cached index.  None when there is none of them."""
    import bench_torch as BT  # the checkout's root script: the HNSW copy

    cache_dir = BT.CACHE_DIR if cache_dir is None else Path(cache_dir)
    committed = BT.COMMITTED_BASELINE if committed is None else committed
    n, d = data.shape
    keys = [f"ladder:{n}x{d}"] + ([f"{n}x{d}"] if n <= 1_000_000 else [])
    for path, note in (
        (cache_dir / BT.OWN_BASELINE_NAME,
         "measured earlier by the port on this checkout's host"),
        (committed, f"{committed.name}: measured by the reference on "
                    "another host, not on this run's machine"),
    ):
        records = BT._read_records(path)
        for key in keys:
            if key in records:
                return dict(records[key], source="cached_measurement",
                            note=note)
    try:
        measured = BT.measure_baseline(data, queries, oracle, cache_dir,
                                       allow_build=False, cache_tag="ladder")
    except (OSError, RuntimeError) as exc:
        log(f"# ladder baseline unavailable: {exc!r}")
        return None
    if measured is not None:
        measured["source"] = "measured"
    return measured


def run_ladder(n: int = 1_000_000, d: int = 128, batch: int = 256,
               k: int = 10, rounds: int = 16, log=log, *,
               device: torch.device | str = "cuda",
               cache_dir: Path | None = None,
               committed: Path | None = None) -> dict:
    from ..native import rerank as native_rerank
    from ..ops.distance import PackedMatrix, resident_topk_auto
    from ..ops.ivf import HostIVFIndex
    from ..ops.quant import (GLOBAL_SCALE, _padded_rows, device_rerank_topk,
                             int8_coarse_topk, int8_fused_coarse,
                             quantize_rows_unit)
    from ..ops.quant4 import (INT4_MAX_POOL, int4_coarse_topk,
                              int4_fused_coarse, quantize_rows_int4,
                              quantize_rows_int4_bucketed,
                              recall_safe_pool_int4, unsort_candidates)

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("the ladder needs a CUDA device (torch sees none)")
    card = None
    if on_card:
        from ..card import card_line

        card = card_line()
    counts0 = kernel_counts()
    log(f"# ladder: N={n} d={d} batch={batch} device={device}"
        + (f" ({card})" if card else ""))
    log("# generating corpus...")
    n_rot = max(4, rounds)
    data, queries = _corpus(n, d, batch, n_rot)
    matrix = PackedMatrix(d, "cosine", device=device)
    matrix.extend(data)
    all_q_pad = matrix.prepare_queries(queries)
    qs_pad = all_q_pad[:batch]            # recall/rerank batch
    q0 = torch.from_numpy(qs_pad).to(device)
    log("# oracle (blocked exact host scan)...")
    oracle = _oracle(data, queries[:batch], k)
    rows: list[dict] = []
    dim_pad = matrix.dim_pad

    def timed_qps(fn_q, operands=()) -> float:
        """``fn_q(qb, *operands) -> idx [B, k]``'s throughput over fresh
        query batches (one CUDA graph on the card)."""
        qps, _ = timed_scan_qps(
            fn_q, batch=batch, d=d, dim_pad=dim_pad,
            rounds=max(rounds, 32), operands=operands, device=device,
        )
        return qps

    def check_bound(qps: float, floor_s: float | None, what: str) -> None:
        if floor_s is not None and qps > batch / floor_s:
            raise RooflineFault(
                f"timing fault: {what} {qps:.1f} QPS is above the card's "
                f"bound {batch / floor_s:.1f} QPS")

    # ---- exact rung ----------------------------------------------------
    log("# exact rung (bf16 coarse + f32 device re-rank)...")
    t0 = time.perf_counter()
    xs16, sq = matrix.device_arrays()
    xs32 = matrix.data_device()
    if on_card:
        torch.cuda.synchronize(device)
    exact_build_s = time.perf_counter() - t0

    def exact_batch(qb, a16=None, a32=None, asq=None):
        dists, idx = resident_topk_auto(
            xs16 if a16 is None else a16,
            xs32 if a32 is None else a32,
            qb, matrix.n,
            sq if asq is None else asq,
            k=k, metric="cosine",
        )
        return idx

    exact_qps = timed_qps(exact_batch, operands=(xs16, xs32, sq))
    exact_ids = exact_batch(q0).cpu().numpy()
    n_pad = int(xs16.shape[0])
    exact_rec = _recall(exact_ids, oracle, k)
    rows.append(apply_roofline({
        "tier": "exact",
        "qps": round(exact_qps, 1),
        "recall_at_10": round(exact_rec, 4),
        "serving": exact_rec >= RECALL_FLOOR,
        "resident_gb": round(n * dim_pad * 6 / (1 << 30), 3),
        "build_s": round(exact_build_s, 2),
        "detail": "bf16+f32 resident (6 B/dim), fused scan + device re-rank",
    }, batch, roofline_batch_seconds(
        bytes_read=n_pad * dim_pad * 2,
        mxu_ops=2.0 * batch * n_pad * dim_pad, dtype="bf16", device=device,
    )))
    # The quantized rungs re-rank on the host matrix or on their own f16
    # device copy; the exact tier's bf16 + f32 copies (7.7 GB at 10M x
    # 128) would sit next to the int8 upload.  Drop the locals too: they
    # would otherwise pin the released tensors through the later rungs.
    del xs16, xs32, sq, exact_batch
    matrix.release_device()
    release(device)

    # ---- quantized rungs ----------------------------------------------
    def _qfn_i8(x):
        # serving mirror: QuantizedResident.arrays quantizes cosine rows
        # with one global scale (ops/quant.py module docstring)
        return quantize_rows_unit(x), np.full(
            len(x), GLOBAL_SCALE, np.float32
        )

    use_fused = use_fused_route(device)
    for bits, qfn, coarse_kind, pool0, pool_cap, per_row in (
        (8, _qfn_i8, "int8", max(8 * k, 64), INT4_MAX_POOL,
         dim_pad + 4),
        # int4 starts at the engine's scale-aware serving floor and
        # ladders from there; the cap is the residency gate's
        # INT4_MAX_POOL, so a rung that cannot converge inside it is
        # marked non-serving, as the gate would skip it
        (4, quantize_rows_int4, "int4", recall_safe_pool_int4(n, k),
         INT4_MAX_POOL, dim_pad // 2 + 4),
    ):
        log(f"# int{bits} rung (quantize + upload)...")
        t0 = time.perf_counter()
        rows_n = matrix.n
        # Both quantized rungs time the kernels serving runs on the card:
        # int8 takes kernel 2 wherever the bucket supply covers the pool
        # (QuantizedResident.search's routing), int4 kernel 3.
        if use_fused:
            from ..ops.fused_topk import pad_rows_for_fused

            rows_n = pad_rows_for_fused(matrix.n)
        perm = None
        if bits == 4 and use_fused:
            # serving mirror: Int4Resident quantizes cosine rows
            # scale-sorted with per-bucket scales (the fused kernel takes
            # no per-row operand)
            values, bsc_np, scales, perm = quantize_rows_int4_bucketed(
                _padded_rows(matrix, rows_n), n_live=matrix.n
            )
            sc = torch.from_numpy(bsc_np).to(device)
        else:
            vparts, sparts = [], []
            for s0 in range(0, matrix.n, 1_000_000):
                e0 = min(matrix.n, s0 + 1_000_000)
                vp, sp = qfn(np.asarray(matrix.data[s0:e0]))
                vparts.append(vp)
                sparts.append(sp)
            if rows_n > matrix.n:
                vp, sp = qfn(
                    np.zeros((rows_n - matrix.n, dim_pad), np.float32)
                )
                vparts.append(vp)
                sparts.append(sp)
            values = np.concatenate(vparts)
            scales = np.concatenate(sparts)
            del vparts, sparts
            sc = torch.from_numpy(scales).to(device)
        xs_q = matrix._upload(values, len(values),
                              torch.int8 if bits == 8 else torch.uint8)
        # cosine never reads the sq-norm operand: a 1-element dummy
        sqq = torch.zeros(1, device=device)
        if on_card:
            torch.cuda.synchronize(device)
        q_build_s = time.perf_counter() - t0

        # serving-route mirror: fused whenever the 64-row bucket supply
        # covers the pool (QuantizedResident.search's gate)
        def i8_fused_ok(k_cand):
            return use_fused and k_cand <= len(values) // 64

        def coarse_batch(qb, k_cand, arrs=None):
            a_q, a_sc, a_sq = (xs_q, sc, sqq) if not arrs else arrs
            if bits == 4:
                if use_fused:
                    return int4_fused_coarse(
                        a_q, a_sc, qb, matrix.n, k=k_cand)[1]
                return int4_coarse_topk(
                    a_q, a_sc, qb, matrix.n, a_sq, k=k_cand)[1]
            if i8_fused_ok(k_cand):
                return int8_fused_coarse(a_q, qb, matrix.n, k=k_cand)[1]
            return int8_coarse_topk(
                a_q, a_sc, qb, matrix.n, a_sq, k=k_cand)[1]

        def full_recall(k_cand):
            cand = coarse_batch(q0, k_cand).cpu().numpy().astype(np.int64)
            if perm is not None:   # sorted positions -> original rows
                cand = unsort_candidates(cand, perm)
            cand = np.where(cand < matrix.n, cand, -1)
            t0 = time.perf_counter()
            _, pos = native_rerank(
                matrix.data[: matrix.n], matrix.sq_norms[: matrix.n],
                qs_pad, cand, k, "cosine",
            )
            return _recall(pos, oracle, k), time.perf_counter() - t0

        # candidate-pool ladder (the reference's ef_search analog): keep
        # doubling until the recall floor holds on this corpus or the
        # serving cap is hit; a rung that cannot converge is emitted
        # non-serving, never silently below the floor
        k_cand, rec, rerank_s = pool0, 0.0, 0.0
        pool = min(pool0, n)
        while True:
            k_cand = pool
            rec, rerank_s = full_recall(pool)
            log(f"# int{bits} pool={pool}: recall@10={rec:.4f}")
            if rec >= RECALL_FLOOR or pool >= min(pool_cap, n):
                break
            pool = min(2 * pool, pool_cap, n)
        serving = rec >= RECALL_FLOOR
        log(f"# int{bits} rung (coarse timing at pool={k_cand})...")
        coarse_qps = timed_qps(
            lambda qb, *arrs, _k=k_cand: coarse_batch(qb, _k, arrs),
            operands=(xs_q, sc, sqq),
        )
        coarse_floor = roofline_batch_seconds(
            bytes_read=len(values) * (dim_pad if bits == 8 else dim_pad / 2),
            mxu_ops=2.0 * batch * len(values) * dim_pad, dtype="int8",
            device=device,
        )
        bound_key = ({"coarse_roofline_qps": round(batch / coarse_floor, 1)}
                     if coarse_floor is not None else {})
        check_bound(coarse_qps, coarse_floor, f"int{bits} coarse")
        full_qps = batch / (batch / coarse_qps + rerank_s)
        if bits == 8:
            # -- int8_dev rung: the same coarse phase, f16 DEVICE re-rank
            # (3 B/dim resident): candidates never leave the card
            log("# int8_dev rung (int8 coarse + f16 device re-rank)...")
            t0 = time.perf_counter()
            xs16d = matrix._upload(matrix.data[: matrix.n], matrix.n,
                                   torch.float16)
            sq16d = torch.zeros(1, device=device)    # cosine: unused
            if on_card:
                torch.cuda.synchronize(device)
            dev_build_s = time.perf_counter() - t0
            live_dev = torch.ones(int(xs16d.shape[0]), dtype=torch.uint8,
                                  device=device)

            def dev_batch(qb, *arrs, _k=k_cand):
                a_q, a_sc, a_sq, a16, a_sq16, a_live = (
                    (xs_q, sc, sqq, xs16d, sq16d, live_dev)
                    if not arrs else arrs
                )
                if i8_fused_ok(_k):
                    cand = int8_fused_coarse(a_q, qb, matrix.n, k=_k)[1]
                else:
                    cand = int8_coarse_topk(
                        a_q, a_sc, qb, matrix.n, a_sq, k=_k)[1]
                return device_rerank_topk(
                    a16, a_sq16, qb, cand.to(torch.int32), a_live,
                    matrix.n, k=k,
                )[1]

            dev_qps = timed_qps(
                dev_batch, operands=(xs_q, sc, sqq, xs16d, sq16d, live_dev),
            )
            check_bound(dev_qps, coarse_floor, "int8_dev")
            dev_ids = dev_batch(q0).cpu().numpy()
            dev_rec = _recall(dev_ids, oracle, k)
            rows.append({
                "tier": "int8_dev",
                "qps": round(dev_qps, 1),
                "recall_at_10": round(dev_rec, 4),
                "serving": dev_rec >= RECALL_FLOOR,
                "resident_gb": round(n * (dim_pad * 3 + 8) / (1 << 30), 3),
                "build_s": round(q_build_s + dev_build_s, 2),
                **({"roofline_qps": bound_key["coarse_roofline_qps"]}
                   if bound_key else {}),
                "detail": (
                    f"int8 coarse k_cand={k_cand} + f16 on-device "
                    "re-rank (3 B/dim); no host round-trip"
                ),
            })
            del xs16d, sq16d, live_dev, dev_batch
        fused_here = use_fused if bits == 4 else i8_fused_ok(k_cand)
        rows.append({
            "tier": coarse_kind,
            "qps": round(full_qps, 1),
            "recall_at_10": round(rec, 4),
            "serving": serving,
            **({} if serving else {"non_serving_reason": (
                f"candidate-pool ladder hit the serving cap "
                f"({min(pool_cap, n)}) below the {RECALL_FLOOR} recall "
                "floor; the residency gate skips this rung "
                "(engine/vector.py _quant4_recall_serving)"
            )}),
            "resident_gb": round(n * per_row / (1 << 30), 3),
            "build_s": round(q_build_s, 2),
            "rerank_ms_per_batch": round(rerank_s * 1e3, 2),
            "coarse_qps": round(coarse_qps, 1),
            **bound_key,
            "detail": (
                f"coarse k_cand={k_cand} on device "
                f"({'fused kernel' if fused_here else 'unfused'}) + exact "
                f"f32 host re-rank; coarse-only {coarse_qps:,.0f} QPS"
            ),
        })
        del xs_q, sc, sqq, coarse_batch, full_recall
        release(device)

    # ---- host-IVF rung -------------------------------------------------
    log("# host-IVF rung (k-means build)...")
    ivf = HostIVFIndex.build(np.asarray(matrix.data[: matrix.n]),
                             normalize=False, device=device)
    # nprobe ladder to the recall floor, like the HNSW baseline's ef
    chosen = None
    for nprobe in (8, 16, 32, 64, 128):
        _, ids = ivf.search(qs_pad, k, nprobe=nprobe, normalize=False)
        rec = _recall(ids, oracle, k)
        log(f"#   ivf nprobe={nprobe}: recall@10={rec:.4f}")
        chosen = (nprobe, rec, ids)
        if rec >= RECALL_FLOOR:
            break
    nprobe, rec, ids = chosen
    # warm-up: the ProbeRouter bootstraps both scoring paths (the device
    # union-stream sample costs one full H2D of the union: a one-time
    # routing measurement, not steady-state serving cost)
    for r in range(3):
        ivf.search(
            np.asarray(
                all_q_pad[(r % n_rot) * batch:(r % n_rot + 1) * batch]
            ),
            k, nprobe=nprobe, normalize=False,
        )
    t0 = time.perf_counter()
    # batches disjoint from the warm-up's (0..2) and from each other;
    # reps caps at the fresh-batch supply rather than wrapping back onto
    # warmed ones
    reps = max(1, min(max(2, rounds // 4), n_rot - 3))
    for r in range(reps):
        b_i = 3 + r
        ivf.search(
            np.asarray(all_q_pad[b_i * batch:(b_i + 1) * batch]),
            k, nprobe=nprobe, normalize=False,
        )
    ivf_qps = batch * reps / (time.perf_counter() - t0)
    rows.append({
        "tier": "host_ivf",
        "qps": round(ivf_qps, 1),
        "recall_at_10": round(rec, 4),
        "serving": rec >= RECALL_FLOOR,
        "resident_gb": round(
            int(ivf.centroids.shape[0]) * dim_pad * 4 / (1 << 30), 4
        ),
        "build_s": round(ivf.build_seconds, 2),
        "scoring_path": ivf.last_path,
        "router_rates_s_per_unit": {
            p: round(v, 9) for p, v in ivf.router.rate.items()
        },
        "detail": (
            f"corpus in host RAM ({n * dim_pad * 4 / (1 << 30):.2f} GB), "
            f"centroids on device; nprobe={nprobe}; scoring routed by "
            "measured cost (ProbeRouter): union-block H2D streaming vs "
            "host probed re-rank through the native row-sorted kernel"
        ),
    })
    del ivf
    release(device)

    # ---- CPU HNSW baseline at this scale: each rung's vs_baseline
    baseline = read_baseline(data, queries[:batch], oracle,
                             cache_dir=cache_dir, committed=committed, log=log)
    if baseline is not None:
        for row in rows:
            row["vs_baseline"] = round(row["qps"] / baseline["qps"], 2)

    counts = kernel_counts()
    return {
        "metric": f"residency ladder (N={n}, d={d}, k={k}, batch={batch})",
        "backend": device.type,
        "rounds": rounds,
        "recall_floor": RECALL_FLOOR,
        **({"baseline_cpu_hnsw": baseline} if baseline is not None else {}),
        "rungs": rows,
        "card": card,
        "kernel_launches": {name: counts[name][0] - counts0[name][0]
                            for name in counts},
        "kernel_captured": {name: counts[name][1] - counts0[name][1]
                            for name in counts},
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--n", default="1000000",
        help="corpus size, or comma-separated list (e.g. 1000000,10000000)",
    )
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("ladder: torch sees no CUDA device; pass --device cpu to run "
            "the kernels' plain versions on the host")
        return 1
    scales = [int(s) for s in str(args.n).split(",") if s]
    results = []
    for n in scales:
        try:
            results.append(run_ladder(
                n=n, d=args.d, batch=args.batch, rounds=args.rounds,
                log=log, device=device,
            ))
        except RooflineFault as exc:
            log(f"ladder: {exc}")
            return 1
        # free the scale's device and host buffers before the next one
        release(device)
    result = results[0] if len(results) == 1 else {
        "metric": (
            f"residency ladder (d={args.d}, k=10, batch={args.batch}) "
            "at multiple corpus scales"
        ),
        "scales": results,
    }
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
