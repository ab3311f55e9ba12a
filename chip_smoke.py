"""Drive the PyTorch port's exact vector-search path once on one GPU.

    python3 chip_smoke.py

Needs one CUDA device (exits nonzero without one, and prints no result),
``nvcc`` for the kernel build, and the repository checkout (it imports
``helix_tpu_torch``, never JAX).  Phases, each failing the run on a bad
check:

1. Build the hand-written kernels from ``helix_tpu_torch/csrc``.
2. Kernel: ``bucket_scores`` against its plain PyTorch version at the
   main path's shapes (1M rows padded to 8192, D=128, B=256), with the
   tolerance rule of ``tests/test_torch_fused_topk.py`` at 1e-5; both
   timed with CUDA events (median over fresh query batches).
3. Engine: ``Engine(device="cuda")`` ingests 1M x 128 clustered vectors
   (``bench.py``'s generator, seed 42) through ``ForEach AddN`` write
   batches, then answers single-query reads through ``execute_stored``
   and ``execute`` and a 256-query ``Partition.search_many`` batch.  The
   answers hold recall@10 >= 0.99 and exact ``$distance`` against a
   float32 numpy oracle, a dropped top hit disappears, and the kernel's
   launch count shows that the fused path served the queries.

The last lines are a ``{"kernels": [...]}`` JSON object, the card's
name and power limit from ``nvidia-smi``, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS = 1_000_000
DIM = 128
BATCH = 256
K = 10
INGEST_CHUNK = 50_000
TOL = 1e-5
KERNEL_RUNS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- kernel


def packing_quantum(v: torch.Tensor) -> torch.Tensor:
    """64 ulp of |v|: the step of the 6 index bits the pack overwrites."""
    bits = v.abs().view(torch.int32) & 0x7F800000
    return bits.view(torch.float32) * 2.0 ** -17


def compare_packed(got: torch.Tensor, want: torch.Tensor, sims: torch.Tensor,
                   tol: float) -> float:
    """The tolerance rule of the kernel tests: unpacked winners agree
    within ``tol`` plus one packing quantum (a sum that differs by one
    rounding can land across a truncation step), and the index bits
    agree except where the bucket's top two scores lie within that
    window.  ``sims`` is the masked f32 score matrix ``[N, B]``.
    Returns the largest unpacked difference."""
    gb, wb = got.view(torch.int32), want.view(torch.int32)
    g_val = (gb & ~63).view(torch.float32)
    w_val = (wb & ~63).view(torch.float32)
    window = tol + packing_quantum(w_val)
    diff = (g_val - w_val).abs()
    check(bool((diff <= window).all()),
          f"unpacked winners differ by up to {diff.max().item()}")
    mismatch = (gb & 63) != (wb & 63)
    if bool(mismatch.any()):
        b = sims.shape[1]
        top2 = sims.view(-1, 64, b).topk(2, dim=1).values
        gap = top2[:, 0] - top2[:, 1]
        check(bool((gap[mismatch] <= window[mismatch]).all()),
              "index bits differ in a bucket without a near tie")
    return float(diff.max().item())


def kernel_phase(device: torch.device) -> dict:
    from helix_tpu_torch.ops import fused_topk as F

    n = F.pad_rows_for_fused(N_ROWS)
    gen = torch.Generator(device=device).manual_seed(7)
    xs = torch.randn((n, DIM), generator=gen, device=device)
    xs16 = (xs / xs.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    del xs
    queries = []
    for _ in range(KERNEL_RUNS):
        q = torch.randn((BATCH, DIM), generator=gen, device=device)
        queries.append((q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16))

    # Pin the FTZ rule on the card: bucket 0 scores negative for query 0
    # except a zeroed (tombstone) row, which packs to a denormal that
    # must flush to a zero with index bits 0, as in the reference.
    scale = torch.linspace(0.5, 1.0, F.BUCKET, device=device)[:, None]
    xs16[: F.BUCKET] = (-queries[0][0].float() * scale).to(torch.bfloat16)
    xs16[5] = 0
    got = F.bucket_scores(xs16, queries[0], N_ROWS)
    torch.cuda.synchronize()
    want = F.bucket_scores_reference(xs16, queries[0], N_ROWS)
    check(int(got[0, 0].view(torch.int32)) == 0 == int(
        want[0, 0].view(torch.int32)), "denormal winner was not flushed")
    rows = torch.arange(n, device=device)[:, None]
    sims = torch.where(rows < N_ROWS, xs16.float() @ queries[0].float().T,
                       F.NEG_SENTINEL)
    max_err = compare_packed(got, want, sims, TOL)
    del sims, want, got

    def timed(fn, q) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(xs16, q, N_ROWS)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    timed(F.bucket_scores_reference, queries[0])  # warm-up
    plain, kern = [], []
    for i, q in enumerate(queries):  # alternate which side runs first
        if i % 2:
            kern.append(timed(F.bucket_scores, q))
            plain.append(timed(F.bucket_scores_reference, q))
        else:
            plain.append(timed(F.bucket_scores_reference, q))
            kern.append(timed(F.bucket_scores, q))
    ms, plain_ms = float(np.median(kern)), float(np.median(plain))
    log(f"kernel bucket_scores N={n} D={DIM} B={BATCH}: {ms:.4f} ms "
        f"(plain {plain_ms:.4f} ms), max unpacked |err| {max_err:.3g}")

    # The whole fused coarse + re-rank step at the engine's k bucket (16
    # for k=10): its time less the kernel's is the top-k / re-rank tail.
    xs32 = xs16.float()
    sq = torch.ones(n, device=device)
    fused = []
    for q in queries:
        q32 = q.float()
        fused.append(timed(
            lambda a, b, c: F.fused_topk(a, xs32, b, c, sq, k=16), q32))
    fused_ms = float(np.median(fused))
    log(f"fused_topk (kernel + top-k + f32 re-rank) B={BATCH}: "
        f"{fused_ms:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "fused_ms": fused_ms}


# ---------------------------------------------------------------- engine


def make_dataset(n: int, d: int, n_queries: int, seed: int = 42):
    """``bench.py``'s clustered cosine generator (1000 centers, sigma
    0.3, rows and queries unit-normalised)."""
    rng = np.random.default_rng(seed)
    n_clusters = 1000
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    data = centers[assign] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True) + 1e-9
    queries = centers[rng.integers(0, n_clusters, size=n_queries)] \
        + 0.3 * rng.normal(size=(n_queries, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-9
    return data, queries


def write(engine, steps: list, params: dict, types: dict) -> dict:
    return engine.execute({
        "request_type": "write", "query_name": "w",
        "query": {"queries": [{"Query": {"name": "w", "steps": steps,
                                         "condition": None}}],
                  "returns": []},
        "parameters": params, "parameter_types": types,
    })


def ingest_request(first: int, rows: np.ndarray) -> dict:
    docs = [{"i": first + j, "emb": row}
            for j, row in enumerate(rows.tolist())]
    return {
        "request_type": "write", "query_name": "ingest",
        "query": {"queries": [{"ForEach": {"param": "docs", "body": [
            {"Query": {"name": "dd", "steps": [{"AddN": {
                "label": "Doc", "properties": [
                    ["i", {"Expr": {"Param": "docs.i"}}],
                    ["emb", {"Expr": {"Param": "docs.emb"}}],
                ]}}], "condition": None}}]}}], "returns": []},
        "parameters": {"docs": docs},
        "parameter_types": {"docs": {"Array": "Object"}},
    }


SEARCH_STEPS = [
    {"VectorSearchNodes": {
        "label": "Doc", "property": "emb",
        "query_vector": {"Expr": {"Param": "q"}},
        "k": {"Expr": {"Param": "k"}},
    }},
    {"ValueMap": ["$id", "$distance", "i"]},
]
SEARCH_TYPES = {"q": {"Array": "F32"}, "k": "I64"}


def search_request(q: np.ndarray) -> dict:
    return {
        "request_type": "read", "query_name": "dvs",
        "query": {"queries": [{"Query": {"name": "hits",
                                         "steps": SEARCH_STEPS,
                                         "condition": None}}],
                  "returns": ["hits"]},
        "parameters": {"q": q.tolist(), "k": K},
        "parameter_types": SEARCH_TYPES,
    }


def top_rows(sims: np.ndarray, k: int) -> np.ndarray:
    """Row indices of the k largest scores per query, descending."""
    part = np.argpartition(-sims, k, axis=1)[:, :k]
    order = np.argsort(-np.take_along_axis(sims, part, axis=1), axis=1)
    return np.take_along_axis(part, order, axis=1)


def rows_of(hits: list) -> tuple[list[int], list[float]]:
    return [h["i"] for h in hits], [h["$distance"] for h in hits]


def engine_phase(device: torch.device, n_rows: int = N_ROWS) -> dict:
    from helix_tpu_torch.engine import Engine
    from helix_tpu_torch.ops import fused_topk as F

    n_probe = 128  # p90 of the per-request latency has 12 samples past it
    n_batches = 16
    data, queries = make_dataset(n_rows, DIM, n_probe + n_batches * BATCH)
    engine = Engine(device=device)
    write(engine, [{"CreateIndex": {"spec": {"NodeVector": {
        "label": "Doc", "property": "emb", "tenant_property": None,
    }}, "if_not_exists": True}}], {}, {})
    t0 = time.perf_counter()
    for lo in range(0, n_rows, INGEST_CHUNK):
        engine.execute(ingest_request(lo, data[lo:lo + INGEST_CHUNK]))
    ingest_s = time.perf_counter() - t0
    log(f"ingest {n_rows} x {DIM}: {ingest_s:.1f} s "
        f"({n_rows / ingest_s:.0f} docs/s)")
    engine.load_bundle({
        "version": 5,
        "read_routes": {"vsearch": {"queries": [{"Query": {
            "name": "hits", "steps": SEARCH_STEPS, "condition": None}}],
            "returns": ["hits"]}},
        "read_parameters": {"vsearch": [
            {"name": "q", "ty": {"Array": "F32"}}, {"name": "k", "ty": "I64"},
        ]},
        "write_routes": {}, "write_parameters": {},
    })
    part = engine.vectors.indexes[("NodeVector", "Doc", "emb")].partitions[("",)]
    matrix = part.matrix
    check(matrix.n == n_rows, f"matrix holds {matrix.n} rows, want {n_rows}")
    stored = matrix.data[:n_rows]

    # Oracle: float32 numpy brute force over the rows the engine stores.
    probe = queries[:n_probe]
    prepared = matrix.prepare_queries(probe)
    sims = prepared @ stored.T
    oracle = top_rows(sims, K)

    F.bucket_scores.launches = 0
    t_up = time.perf_counter()
    matrix.device_arrays()
    matrix.data_device()
    torch.cuda.synchronize(device)
    upload_s = time.perf_counter() - t_up
    log(f"H2D upload (bf16 + f32 copies of {matrix.n} rows): {upload_s:.3f} s")

    got_rows: list[list[int]] = []
    got_dist: list[list[float]] = []
    latencies = []
    for j in range(n_probe):
        t = time.perf_counter()
        if j % 2:
            out = engine.execute(search_request(probe[j]))
        else:
            out = engine.execute_stored("vsearch", {"q": probe[j].tolist(),
                                                    "k": K})
        latencies.append(time.perf_counter() - t)
        rows, dists = rows_of(out["hits"])
        got_rows.append(rows)
        got_dist.append(dists)
    recall = float(np.mean([
        len(set(got_rows[j]) & set(oracle[j].tolist())) / K
        for j in range(n_probe)
    ]))
    worst = 0.0
    for j in range(n_probe):
        for row, dist in zip(got_rows[j], got_dist[j]):
            worst = max(worst, abs(dist - (1.0 - float(sims[j, row]))))
    log(f"single-query reads: recall@{K} {recall:.4f}, max |$distance - "
        f"(1 - q.x)| {worst:.3g}, latency p50 "
        f"{np.median(latencies) * 1e3:.3f} ms p90 "
        f"{np.percentile(latencies, 90) * 1e3:.3f} ms (n={n_probe})")
    check(recall >= 0.99, f"recall@{K} {recall} < 0.99")
    check(worst <= TOL, f"$distance off by {worst}")

    # The gateway's vbatch entry: one Partition.search_many of 256.
    batch_ms = []
    for b in range(n_batches):
        qb = queries[n_probe + b * BATCH:n_probe + (b + 1) * BATCH]
        t = time.perf_counter()
        ids, dists = part.search_many(qb, K)
        batch_ms.append((time.perf_counter() - t) * 1e3)
        check(ids.shape == (BATCH, K) and np.isfinite(dists).all(),
              f"search_many returned {ids.shape} / non-finite distances")
    qb = queries[n_probe:n_probe + BATCH]
    ids, _ = part.search_many(qb, K)
    batch_oracle = top_rows(matrix.prepare_queries(qb) @ stored.T, K)
    batch_rows = np.vectorize(part.pos.__getitem__)(ids.astype(np.int64))
    batch_recall = float(np.mean([
        len(set(batch_rows[j].tolist()) & set(batch_oracle[j].tolist())) / K
        for j in range(BATCH)
    ]))
    log(f"search_many B={BATCH}: median {np.median(batch_ms):.3f} ms/batch "
        f"max {max(batch_ms):.3f} (n={n_batches}), "
        f"{BATCH / np.median(batch_ms) * 1e3:.0f} QPS, recall@{K} "
        f"{batch_recall:.4f}")
    check(batch_recall >= 0.99, f"batch recall@{K} {batch_recall} < 0.99")

    # Drop the first probe's top hit; the next answer must not hold it.
    top_row = got_rows[0][0]
    top_id = int(part.id_table[top_row])
    write(engine, [{"N": {"Param": "ids"}}, "Drop"], {"ids": [top_id]},
          {"ids": {"Array": "I64"}})
    out = engine.execute_stored("vsearch", {"q": probe[0].tolist(), "k": K})
    rows, _ = rows_of(out["hits"])
    check(top_row not in rows and len(rows) == K,
          f"dropped row {top_row} still answered: {rows}")
    check(len(set(rows) & set(got_rows[0][1:])) >= K - 2,
          "answer after the drop lost the old answer's other hits")

    launches = F.bucket_scores.launches
    check(launches > 0, "the fused kernel served no query")
    log(f"engine phase: {launches} bucket_scores launches")
    return {
        "launches": launches, "recall": recall, "batch_recall": batch_recall,
        "batch_ms": float(np.median(batch_ms)),
        "p50_ms": float(np.median(latencies) * 1e3),
        "p90_ms": float(np.percentile(latencies, 90) * 1e3),
        "ingest_s": ingest_s, "upload_s": upload_s,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card_line = card()
    log(f"card: {card_line}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    from helix_tpu_torch import kernels

    t = time.perf_counter()
    kernels.load()
    log(f"kernel build + load: {time.perf_counter() - t:.1f} s "
        f"({kernels.library_path().name})")

    kern = kernel_phase(device)
    eng = engine_phase(device)
    # Derived from the two phases (kernel and fused step on the kernel
    # phase's random matrix, search_many on the engine's): where one
    # B=256 search_many goes.
    log(f"per-batch split B={BATCH} on {card_line}: kernel {kern['ms']:.3f} "
        f"ms (plain {kern['plain_ms']:.3f} ms), top-k + re-rank tail "
        f"{kern['fused_ms'] - kern['ms']:.3f} ms, host + transfers "
        f"{eng['batch_ms'] - kern['fused_ms']:.3f} ms (search_many median "
        f"{eng['batch_ms']:.3f} ms)")
    print(json.dumps({"kernels": [{
        "name": "bucket_scores",
        "route": "cuda",
        "source": "helix_tpu_torch/csrc/bucket_scores.cu",
        "replaces": "helix_tpu/ops/fused_topk.py:173",
        "launches": eng["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
