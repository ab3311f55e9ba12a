"""Drive the PyTorch port's device paths once on one GPU.

    python3 chip_smoke.py

Needs one CUDA device (exits nonzero without one, and prints no result),
``nvcc`` for the kernel build, ``g++`` for the native host library, and
the repository checkout (it imports ``helix_tpu_torch``, never JAX).
Phases, each failing the run on a bad check:

1. Build the hand-written kernels from ``helix_tpu_torch/csrc`` (printing
   ``ptxas``' registers, spills and any ``C75xx`` note that ``wgmma`` was
   serialized, for every source) and the native host library
   (``helix_tpu_torch/native``: the quantized rungs' and host IVF's
   re-rank, the traversal's native sweep).  The kernel sweeps' library
   (kernels 4 and 5) builds in a background thread during the engine
   phase's ingest; its seconds are on the ``phase seconds`` line.
2. Kernel 1: ``bucket_scores`` against its plain PyTorch version at the
   main path's shapes (1M rows padded to 8192, D=128, B=256), at B=128
   (single reads) and at D=768 (queries streamed through the rings),
   with n_valid in mid-bucket, with the tolerance rule of
   ``tests/test_torch_fused_topk.py`` at 1e-5; the kernel, its plain
   version, the product-only ``torch.matmul`` and a device copy of the
   rows timed with CUDA events (median over fresh query batches, the
   order rotating).
   Then the selection kernel (``select_phase``): ``select_topk``
   (``csrc/select_topk.cu``, the port of ``jax.lax.approx_max_k`` and
   ``jax.lax.top_k``) against its plain version bit for bit, ids and
   value bits, on kernel 1's transposed [256, 15,744] winners (k=128 and
   the int4 pool's 977), their top 128 (k=16), the l2 exact rung's
   [256, 1,000,448] f32 scores, the cosine single shot's bf16 scores,
   10M rows' [256, 156,288] buckets (k=128 and the int4 pool's 9,765),
   the traversal's compaction of 1M int32 slots to 65,536 and tie-heavy
   rows with +-0.0 and +-NaN (the warp path's rows of 1 to 512 columns,
   transposed views whose row count is no multiple of 8, k at the block
   path's limit and one past it), each with the kernel's planner held
   to the port's twin ``topk.plan``; the fused tail's and the
   re-rank's selections in a CUDA graph; timed beside its plain version
   and ``torch.topk`` at the fused tail's (on fresh inputs), the
   re-rank's, the l2, the bf16 and the 10M int4 pool's shapes, and the
   re-rank split into host time (1,000 enqueues) and device time (a
   CUDA graph of 100 calls).  Every phase counts
   its ``select_topk`` launches from 0; the engine, exact sweep,
   traversal decomp, ladder, l2 and serve phases must launch it.
3. Kernels 2 and 3: ``i8_bucket_scores`` and ``i4_bucket_scores`` against
   their plain versions at the main shape on random unit rows quantized
   by the port's own quantizers, and at B=128 and D=768 (queries streamed
   at B=256, resident at B=128) on codes drawn on the card, with n_valid
   in mid-bucket; kernel 2 also at D=256 and D=384, the last width whose
   sums take the exact add and the first that takes the rounded
   conversion: the outputs must be equal bit for bit, a bucket holding
   a zero row must flush to a zero winner, kernel 2's made ties (two
   rows of a bucket whose sums differ only in the bits the pack
   overwrites, with positive and with negative scores) must take the
   rows the plain version takes, and each wrapper must raise on a shape
   its refusal names (D=64, B=192).  Kernel 2's counter
   ``kernel.i8_bucket_scores.exact_add`` must count a profiled launch at
   D=128 and D=256 and none at D=384 and D=768.  Each kernel's plan is
   printed; the kernel, its plain version and the product-only
   ``torch._int_mm`` (on the unpacked codes for int4) are timed the same
   way, at B=256 and B=128.  Then kernel 2 at the int8 cell's shape
   (``i8_cell_phase``: 34,004,992 x 128 unit rows quantized on the card,
   B=256, n_valid 34,000,000, the made ties and a zero row), bit for bit
   against its plain version run in 1M-row slices, and timed beside its
   bound.
4. Bench (``bench_phase``): ``python bench_torch.py`` in a child process
   at its defaults (1M x 128 cosine, B=256, k=10, 128 rounds in one CUDA
   graph, the graph reads and the gateway on; the CPU HNSW baseline
   skipped): its JSON line must show recall@10 >= 0.99, kernel 1 in
   every timed graph once per search (its captured nodes, each launched
   in a profiled replay; the script holds each graph's ids to an eager
   search), ``device_batch_ms`` at or above the card's bound and only
   finite numbers; the line is printed, and the launches its wrapper
   counted in the eager windows join kernel 1's count.  Its graph-read
   keys are the card's times for the graph ops cell.
5. Ladder bench (``ladder_bench_phase``): ``python bench_torch.py
   --ladder`` in a child process at the reference ladder's defaults
   (1M x 128 cosine, B=256, k=10, 16 rounds; never an HNSW build): its
   line must hold the five rungs in order (exact, int8_dev, int8, int4,
   host_ivf), each serving at recall@10 >= 0.99 / 0.98 / 0.98 / 0.95 /
   0.95, each timed rung at or below its bound (the coarse phase's for
   int8 and int4), every number finite, and kernels 1, 2 and 3 launched
   and captured; the line is printed and its launches join the kernels'
   counts.
6. Engine (exact): ``Engine(device="cuda", data_dir=...)`` ingests 1M x
   128 clustered vectors (``bench.py``'s generator, seed 42) through
   ``ForEach AddN`` write batches with the WAL on (the one 1M ingest the
   serve phase shares), then answers single-query reads through
   ``execute_stored`` and ``execute`` and 256-query
   ``Partition.search_many`` batches.  The answers hold recall@10 >= 0.99
   and exact ``$distance`` against a float32 numpy oracle, a dropped top
   hit disappears, and the launch counts show that kernel 1 served.  A
   checkpoint before the drop, copied, is the serve phase's data dir.
   Then the same engine takes 400k labeled edges through write batches
   and answers set-reduced traversals (``N``/``NWhere`` -> ``Out`` /
   ``In`` / ``Both`` -> ``Where`` -> ``Dedup`` -> ``Count`` / ``Exists``,
   an ``OrderBy`` membership tail) and hybrid reads
   (``VectorSearchNodes`` -> ``Out`` -> ``Dedup`` -> ``Count``) with
   ``HELIX_TRAVERSAL_BACKEND`` forced to ``device``, ``native``, then
   ``auto``: equal JSON on all three.
7. Sweeps (``sweep_phase``): kernels 4 and 5, the ports of
   ``benchmarks/onepass_sweep.py`` and ``benchmarks/i8_sweep.py``, on one
   1M x 128 corpus (``_corpus``, seed 42): both entry points' sweeps
   (``helix_tpu_torch.benchmarks``), every variant (kernel 4's three at
   ring depths 2, 4 and 8, kernel 5's seventeen), their JSON lines
   printed, recall@10 >= 0.99 and equal to ``shipped``'s for kernel 4,
   containment for kernel 5's variants that return ids, every
   instantiation launched (counted from 0 around the two sweeps).  Then
   each instantiation alone against its plain version, bit for bit
   (kernel 5 on the sweep's operands, kernel 4 on rows of small integers
   where every f32 sum is exact, at n_valid 1,000,000 and 999,963),
   kernel 4 also within kernel 1's tolerance on the corpus and bit for
   bit against kernel 1, ``gscale`` against kernel 2, the bf16 forms
   against their int8 twins; each timed against its plain version and
   the library call (``torch.matmul`` bf16 or ``torch._int_mm``), kernel
   4 also at each ring depth beside kernel 1.
8. Graph ops: ``bench.py``'s traversal shape (1M nodes, degree 16, 4
   labels): ``khop_mask`` / ``khop_count`` / ``hybrid_expand`` on the
   card against ``helix_tpu_torch.native.bfs_khop``, masks and counts equal
   (the bench phase times the same reads).
9. Ladder: ``Engine(device="cuda", hbm_budget_bytes=48 MiB)`` ingests
   750,000 rows of the same generator (cut from 96 MiB and 1.5M rows: the
   ladder bench measures every rung at 1M).  At 250,000 rows the int8
   rung serves (kernel 2), with the host re-rank and then with
   ``HELIX_QUANT_RERANK=device``; at 500,000 rows the int4 rung (kernel
   3); at 750,000 rows the host-IVF rung (no kernel), with the probe
   router on auto, then ``HELIX_IVF_BACKEND=device``, then ``host``.
   Each step checks its rung, recall@10 (>= 0.98 int8, >= 0.95 int4 and
   IVF), ``$distance``, a dropped top hit, and which kernels and device
   ops ran; the IVF step also holds its probe cells to a float64
   computation.
10. Demos (``demos_phase``): the ports of ``benchmarks/quant_demo.py``
   (``--bits 8``: per-row int8 and ``torch._int_mm``, no kernel; then
   ``--bits 4``: kernel 3 with ``perm``, which must launch) and
   ``benchmarks/beyond_hbm_demo.py`` (host IVF past a budget of 2 GB
   scaled by n / 10M) through their ``main``s at ``DEMO_N`` rows, cut
   from their 10M default; their lines printed, recall@10 >= 0.95 for
   both quantized runs and ``beyond_hbm_demo``'s own gate (some nprobe
   at 0.9).
11. l2 (``l2_phase``): SIFT1M's deployment, 1M x 128 Euclidean: rows of
   the same generator mapped to SIFT's byte form (integers in [0, 255],
   median norm ~515), ingested once into the engine of
   ``NativeGateway(metric="l2")``.  The partition's ``hbm_budget_bytes``
   is lowered step by step so each rung serves in turn: exact, int8 with
   the f16 device re-rank, int8 with the host re-rank, int4, host-exact.
   Each prints the rung taken, the first search after the change,
   single-read p50 / p90 and the B=256 median and QPS, and holds recall@10
   (tie-aware against a float64 oracle) to its floor (0.99, 0.98, 0.98,
   0.95, 1.0) and ``$distance`` to a relative 1e-6.  No bucket-scores
   kernel may launch (the reference fuses cosine only); the l2 score
   kernel (``csrc/l2_scores.cu``) launches once a search on the exact
   rung and never below it.  On the exact rung that kernel is held to its
   plain version bit for bit at [256, 1,000,448, 128] and timed against
   it, and the device step is split with CUDA events: the scores, the
   selection of the candidates from [256, 1,000,448] f32 (the selection
   kernel), and ``topk_resident`` whole.  Then the gateway serves the
   exact index: 128 ``vfast`` requests on the fast path, equal to the
   in-process answers.
12. Text: a 116,969-doc BM25 index through the engine
   (``TextSearchNodes``): the device path's ids equal the host path's,
   scores within rtol 1e-5, both timed.
13. Serve: the exact cell again, from disk and over HTTP
   (``serve_phase``): the engine phase's checkpointed data dir (1M rows
   ingested with the WAL on); the native gateway recovers it in process
   (recovery and the first search after it timed), installs a bundle over
   HTTP and answers 128 single requests (p50 / p90) and 4,096 requests
   with 256 in flight (QPS) on the vector fast path into kernel 1, held
   to a numpy oracle, ``fast_requests`` and kernel 1's launch count,
   then takes a durable HTTP write that lives only in the WAL.
14. Cluster (``cluster_phase``): ``python -m helix_tpu_torch.cli`` makes a
    project of a primary and two replicas; ``start primary --disk``
    recovers the serve phase's data dir (the write from the WAL) and
    answers as the in-process gateway did, the two replicas seed from
    it, and the native HA proxy (``HAFront``) spreads the same reads over
    them, answered alike, while the card's free memory shows both
    replicas' index copies; a durable write through the front reaches
    both replicas; a replica's engine is SIGKILLed under load and its
    supervisor restarts it; ``stop`` ends every process after the
    primary's checkpoint.  Kernel 1 runs in those server processes, so
    its launch count holds only the in-process phases.

15. The last four benchmark scripts' ports, each through its ``main``:
    ``tile_sweep`` (after the sweeps; ``tile_sweep_phase``): kernel 4's
    ``shipped`` as kernel 1's fused step at ring depths 2, 4, 8 and the
    most that fit, 1M x 128, B=256, each depth at recall@10 >= 0.99, at
    or below its bound, launched and captured; ``exact_sweep --int8``
    (``exact_sweep_phase``): ``resident_topk_auto`` (kernel 1), the
    single shot and two chunk sizes at recall@10 >= 0.999, the int8
    coarse rows (kernel 2's fused one first) at coarse recall >= 0.98,
    kernels 1 and 2 launched and captured; ``traversal_decomp`` (after
    the graph ops; ``traversal_decomp_phase``) at 1M nodes, degree 16:
    every piece's time positive and finite, ``full_2hop``'s count equal
    to ``khop_count`` once and to ``native.bfs_khop``; ``soak`` (after
    the demos, a child process; ``soak_phase``): 200,000 rows, the
    reference's closed-loop search client and bulk ingest client
    through the native gateway, searches answered with finite p50 /
    p99, every acknowledged write in the store, kernel 1 launched, 16
    read-backs at recall@10 >= 0.99, RSS printed and not gated.

The mesh steps (``helix_tpu_torch.parallel``) run on a virtual mesh of
4 shards on ``cuda:0`` (over every card where there are more; every
other phase runs on a one-device mesh): at the end of the engine phase
the same engine (its ``shard_threshold`` and ``graph_shard_threshold``
set, inert on one device) answers single reads and B=256 batches
through ``Partition._search_sharded`` (kernel 1 must launch once per
shard per batch and per read; recall@10 >= 0.99, ``$distance`` within
1e-5), kernel 1 is held to its plain version at the last shard's shape
(253,952 rows, part padding), and the graph reads run through
``Executor._run_sharded_traversal`` with answers equal to the
one-device ones byte for byte; at the ladder's int8 step the rung
serves through ``ShardedInt8Search`` (host, then f16 device re-rank,
recall@10 >= 0.98, no bucket-scores kernel); the text corpus through
``ShardedBM25`` (ids equal to the host path's); then
``graft.dryrun_multichip(4)``.  The batch medians print beside the
one-device ones: a virtual mesh on one card claims no scaling.

Kernel 1's phase also checks the tie rule (rows duplicated into
different buckets come back lowest position first on 5 calls).

Every device op counts its calls on CUDA tensors (``device_counts``);
a forced device path that shows none fails the run.  The last lines are
a ``device paths:`` summary, a ``{"kernels": [...]}`` JSON object, the
card's name and power limit from ``nvidia-smi``, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

# The bound of a kernel is the larger of its bytes over the memory rate
# and its operations over the peak rate of their type (the H100 SXM data
# sheet's), each input read once and each output written once.
from helix_tpu_torch.card import (PEAK_BF16_PER_S, PEAK_INT8_PER_S, bound,
                                  card_line as card)

N_ROWS = 1_000_000
DIM = 128
BATCH = 256
K = 10
INGEST_CHUNK = 50_000
TOL = 1e-5
KERNEL_RUNS = 7
KERNEL_REPS = 10  # back-to-back calls per timed sample
N_PROBE = 128  # p90 of the per-request latency has 12 samples past it
N_BATCHES = 16
# The ladder phase's budget and rows (steps: LADDER_STEPS).
# Cut from 96 MiB and 1,500,000 rows (itself cut from 2,000,000) to keep
# the run within 900 s; the ladder bench measures every rung at 1M.
LADDER_BUDGET = 48 << 20
LADDER_ROWS = 750_000
DEVICE_RERANK_TOL = 2e-3  # f16 rows: |x| * 2^-11 per component
# The graph ops phase: bench.py's traversal shape (BASELINE configs[2]).
GRAPH_NODES = 1_000_000
GRAPH_DEGREE = 16
GRAPH_LABELS = 4
# Edges written into the exact phase's engine, ENGINE_DEGREE per source
# node: the engine's write path sustained 15,400-25,100 edges/s on the
# H100 machine's host, so 400k edges take 16-26 s (cut from 1.6M to 800k
# once the serve phase came, then to 400k with the sweep phase, to keep
# the whole run within 900 s of its 1,200 s limit).
ENGINE_DEGREE = 4
ENGINE_EDGES = 400_000
EDGE_CHUNK = 25_000
# The largest corpus of the test generator whose most common word stays
# within DevicePostings' cap of 65,536 postings.
N_TEXT_DOCS = 116_969
# Each cut of depth from the configuration a phase drives, printed on the
# ``reduced:`` line.
REDUCED = {
    "ladder phase": "48 MiB budget and 750,000 rows, from 96 MiB and "
                    "1,500,000 (itself from 2,000,000): the ladder bench "
                    "measures every rung at 1,000,000",
    "demos": "500,000 rows, from 10,000,000 (run time; quant_demo --bits "
             "4's fixed pool of 320 falls below recall 0.95 at 1M)",
    "engine edges": "400,000 labeled edges, from 1,600,000 and then "
                    "800,000",
    "exact sweep": "chunks 16384,131072 and 16 rounds, from the "
                   "reference's 8192,16384,32768,65536,131072,262144 and "
                   "64 (run time)",
    "soak": "45 s, from the reference's 180 s (run time)",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name(device: torch.device) -> str:
    return card() if device.type == "cuda" else "the CPU (a rehearsal)"


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


def cuda_ms(fn, *args, reps: int = 1, **kwargs) -> float:
    """CUDA-event time of ``fn(*args, **kwargs)`` on the current stream,
    in ms: the mean of ``reps`` calls issued back to back, so that past
    the first the host's part of a call overlaps the device's work."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args, **kwargs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_sides(sides: dict, inputs: list, reps: int = KERNEL_REPS) -> dict:
    """Median CUDA-event times of each side ``fn(*args)`` over fresh
    inputs (each a mean of ``reps`` back-to-back calls); the order of
    the sides rotates from one input to the next, so each runs first as
    often as the others."""
    names = list(sides)
    for name in names:  # warm-up
        cuda_ms(sides[name], *inputs[0])
    times: dict = {name: [] for name in names}
    for i, args in enumerate(inputs):
        r = i % len(names)
        for name in names[r:] + names[:r]:
            times[name].append(cuda_ms(sides[name], *args, reps=reps))
    return {name: float(np.median(t)) for name, t in times.items()}


def unit_rows(n: int, d: int, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    xs = torch.randn((n, d), generator=gen, device=device)
    return (xs / xs.norm(dim=1, keepdim=True)).to(torch.bfloat16)


def masked_sims(xs16: torch.Tensor, qs16: torch.Tensor,
                n_valid: int) -> torch.Tensor:
    """The f32 score matrix ``[N, B]`` with rows past ``n_valid``
    masked, as ``compare_packed`` reads it."""
    from helix_tpu_torch.ops.fused_topk import NEG_SENTINEL

    rows = torch.arange(xs16.shape[0], device=xs16.device)[:, None]
    return torch.where(rows < n_valid, xs16.float() @ qs16.float().T,
                       NEG_SENTINEL)


def kernel_phase(device: torch.device) -> dict:
    """Kernel 1 against its plain version at the main path's shapes and
    two more (B=128 single reads, a wide D whose queries stream), the
    denormal pin, the times of the kernel, its plain version and the
    product-only library call, and the fused coarse + re-rank step."""
    from helix_tpu_torch.ops import fused_topk as F

    n = F.pad_rows_for_fused(N_ROWS)
    gen = torch.Generator(device=device).manual_seed(7)
    xs16 = unit_rows(n, DIM, gen, device)
    queries = [unit_rows(BATCH, DIM, gen, device) for _ in range(KERNEL_RUNS)]

    # Pin the FTZ rule on the card: bucket 0 scores negative for query 0
    # except a zeroed (tombstone) row, which packs to a denormal that
    # must flush to a zero with index bits 0, as in the reference.
    scale = torch.linspace(0.5, 1.0, F.BUCKET, device=device)[:, None]
    saved = xs16[: F.BUCKET].clone()
    xs16[: F.BUCKET] = (-queries[0][0].float() * scale).to(torch.bfloat16)
    xs16[5] = 0
    got = F.bucket_scores(xs16, queries[0], N_ROWS)
    torch.cuda.synchronize()
    want = F.bucket_scores_reference(xs16, queries[0], N_ROWS)
    check(int(got[0, 0].view(torch.int32)) == 0 == int(
        want[0, 0].view(torch.int32)), "denormal winner was not flushed")
    max_err = compare_packed(got, want, masked_sims(xs16, queries[0], N_ROWS),
                             TOL)
    xs16[: F.BUCKET] = saved
    del got, want, saved

    # The other shapes, each with n_valid in mid-bucket.
    shapes = {}
    for d, b in ((DIM, 128), (768, BATCH)):
        xw = xs16 if d == DIM else unit_rows(n, d, gen, device)
        qw = unit_rows(b, d, gen, device)
        n_valid = N_ROWS - 37
        err = compare_packed(F.bucket_scores(xw, qw, n_valid),
                             F.bucket_scores_reference(xw, qw, n_valid),
                             masked_sims(xw, qw, n_valid), TOL)
        shapes[f"B={b} D={d}"] = err
        max_err = max(max_err, err)
        del xw, qw
    log(f"kernel bucket_scores agrees with its plain version (1e-5 + one "
        f"packing quantum) at B={BATCH} D={DIM} (denormal pinned), "
        f"{', '.join(shapes)} with n_valid={N_ROWS - 37}: max unpacked "
        f"|err| {max_err:.3g}")

    def library(xs, qs, n_valid):  # the product alone, bf16 out
        return torch.matmul(xs, qs.T)

    def copy(xs, qs, n_valid):  # what the card's memory achieves
        return xs.clone()

    inputs = [(xs16, q, N_ROWS) for q in queries]
    t = time_sides({"kernel": F.bucket_scores,
                    "plain": F.bucket_scores_reference,
                    "library": library, "copy": copy}, inputs)
    b_ms, b_by = bound(n * DIM * 2 + BATCH * DIM * 2 + n // 64 * BATCH * 4,
                       2.0 * n * DIM * BATCH, PEAK_BF16_PER_S)
    log(f"kernel bucket_scores N={n} D={DIM} B={BATCH}: {t['kernel']:.4f} ms "
        f"(plain {t['plain']:.4f} ms, torch.matmul product only "
        f"{t['library']:.4f} ms, bound {b_ms:.4f} ms by {b_by}: "
        f"{b_ms / t['kernel']:.1%} of the bound); a device copy of the "
        f"rows (read + write {2 * n * DIM * 2} bytes) {t['copy']:.4f} ms = "
        f"{2 * n * DIM * 2 / t['copy'] / 1e9:.3f} TB/s")
    q128 = [(xs16, q[:128].contiguous(), N_ROWS) for q in queries]
    t128 = time_sides({"kernel": F.bucket_scores, "library": library}, q128)
    b128, _ = bound(n * DIM * 2 + 128 * DIM * 2 + n // 64 * 128 * 4,
                    2.0 * n * DIM * 128, PEAK_BF16_PER_S)
    log(f"kernel bucket_scores N={n} D={DIM} B=128: {t128['kernel']:.4f} ms "
        f"(torch.matmul {t128['library']:.4f} ms, bound {b128:.4f} ms)")

    # The whole fused coarse + re-rank step at the engine's k bucket (16
    # for k=10): its time less the kernel's is the top-k / re-rank tail.
    xs32 = xs16.float()
    sq = torch.ones(n, device=device)
    fused_ms = float(np.median([
        cuda_ms(F.fused_topk, xs16, xs32, q.float(), N_ROWS, sq, k=16)
        for q in queries
    ]))
    log(f"fused_topk (kernel + top-k + f32 re-rank) B={BATCH}: "
        f"{fused_ms:.4f} ms")
    check_tie_order(xs16, xs32, sq, queries[0])
    return {"max_abs_err": max_err, "ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t["library"], "bound_ms": b_ms, "bound_by": b_by,
            "fused_ms": fused_ms}


# Slot 6 of these buckets takes a copy of row TIE_ROW (bucket 1, slot 6).
TIE_ROW = 70
TIE_BUCKETS = (0, 40, 100, 101, 200, 5000, 15000)


def check_tie_order(xs16, xs32, sq, queries) -> None:
    """Rows duplicated into different buckets, searched by a query that
    is that row, come back lowest position first (the reference's
    ``lax.top_k`` order) and identical on 5 repeated calls."""
    from helix_tpu_torch.ops import fused_topk as F

    dups = [b * F.BUCKET + TIE_ROW % F.BUCKET for b in TIE_BUCKETS]
    saved16, saved32 = xs16[dups].clone(), xs32[dups].clone()
    xs16[dups] = xs16[TIE_ROW].clone()
    xs32[dups] = xs32[TIE_ROW].clone()
    qs = queries.float().clone()
    qs[0] = xs32[TIE_ROW]
    try:
        want = sorted([TIE_ROW] + dups)
        first = None
        for _ in range(5):
            dists, ids = F.fused_topk(xs16, xs32, qs, N_ROWS, sq, k=16)
            check(ids[0, :len(want)].tolist() == want,
                  f"tied rows came back as {ids[0, :len(want)].tolist()}, "
                  f"want {want}")
            if first is None:
                first = (dists, ids)
            check(torch.equal(ids, first[1]) and torch.equal(dists, first[0]),
                  "fused_topk answered differently on a repeated call")
    finally:
        xs16[dups], xs32[dups] = saved16, saved32
    log(f"tie order: {len(want)} equal rows in {len(want)} buckets come back "
        f"lowest position first, identical on 5 calls of B={qs.shape[0]}")


# ---------------------------------------------------------------- select

SELECT_K = 128          # the fused step's k_cand and the l2 rung's k_scan
SELECT_RERANK_K = 16    # the engine's k bucket for k=10
INT4_POOL_1M = 977      # quant4.recall_safe_pool_int4(1,000,000)
INT4_POOL_10M = 9_765   # quant4.recall_safe_pool_int4(10,000,000)
COMPACT_K = 65_536      # traversal_decomp's widest frontier compaction
SELECT_RING = 8         # fused-tail inputs in turn: 8 x 16 MB past the L2
TEN_M_BUCKETS = 156_288  # 10M rows padded to 8192, over 64-row buckets
L2_ROWS = 1_000_448     # 1M rows padded to PackedMatrix.ROW_PAD


def tie_heavy(rows: int, width: int, seed: int) -> torch.Tensor:
    """Few distinct f32 values (ties everywhere) with +0.0 and -0.0, +-inf,
    the fused paths' sentinel and +-NaN sprinkled in (as the CPU tests'
    ``tests/test_torch_select.py``)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 4, (rows, width)).astype(np.float32) * 0.25
    roll = rng.random((rows, width))
    x[roll < 0.05] = -np.inf
    x[(roll >= 0.05) & (roll < 0.10)] = -3.0e38
    x[(roll >= 0.10) & (roll < 0.16)] = -0.0
    x[(roll >= 0.16) & (roll < 0.18)] = np.inf
    x[(roll >= 0.18) & (roll < 0.19)] = np.nan
    x.view(np.uint32)[(roll >= 0.19) & (roll < 0.20)] = 0xFFC00000
    return torch.from_numpy(x)


def check_select(name: str, x: torch.Tensor, k: int) -> None:
    """The kernel against its plain version on ``x``: equal ids, equal
    value bits."""
    from helix_tpu_torch.ops import topk as T

    got_v, got_i = T.select_topk(x, k)
    want_v, want_i = T.select_topk_reference(x, k)
    torch.cuda.synchronize()
    wide = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    same_ids = got_i == want_i
    check(bool(same_ids.all()), f"select {name}: {int((~same_ids).sum())} "
          f"of {same_ids.numel()} ids differ from the plain version")
    check(torch.equal(got_v.view(wide), want_v.view(wide)),
          f"select {name}: value bits differ from the plain version")


def check_plan(name: str, x: torch.Tensor, k: int) -> None:
    """The kernel's planner (``hx_select_topk_plan``) against the port's
    twin ``topk.plan`` at ``x``'s shape."""
    import ctypes

    from helix_tpu_torch import kernels
    from helix_tpu_torch.ops import topk as T

    rows, width = x.shape
    k = min(k, width)
    out = (ctypes.c_longlong * 64)()
    rc = kernels.load().hx_select_topk_plan(rows, width, k, out)
    p = T.plan(rows, width, k)
    want = [T.PATHS.index(p.path), p.param, len(p.stages), p.scratch]
    want += [v for stage in p.stages for v in stage]
    check(rc == 0 and list(out[:len(want)]) == want,
          f"select {name}: the kernel's plan {list(out[:len(want)])} "
          f"(rc {rc}) is not the twin's {want}")


def check_select_in_graph(winners: torch.Tensor, top: torch.Tensor) -> None:
    """The fused tail's and the re-rank's selections captured in one CUDA
    graph and replayed: equal to the plain version bit for bit, counted
    as captured, not launched."""
    from helix_tpu_torch.ops import topk as T

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        T.select_topk(winners, SELECT_K)
        T.select_topk(top, SELECT_RERANK_K)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    launched, captured = T.select_topk.launches, T.select_topk.captured
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [T.select_topk(winners, SELECT_K),
                T.select_topk(top, SELECT_RERANK_K)]
    graph.replay()
    torch.cuda.synchronize()
    check(T.select_topk.launches == launched
          and T.select_topk.captured == captured + 2,
          "select: a captured selection was counted as a launch")
    for (got_v, got_i), (x, k) in zip(outs, ((winners, SELECT_K),
                                             (top, SELECT_RERANK_K))):
        want_v, want_i = T.select_topk_reference(x, k)
        check(torch.equal(got_i, want_i)
              and torch.equal(got_v.view(torch.int32),
                              want_v.view(torch.int32)),
              "select: the graph's replay differs from the plain version")
    log("kernel select_topk in a CUDA graph (the fused tail's and the "
        "re-rank's shapes) equals its plain version bit for bit")


def host_device_split(ring: Ring, k: int, calls: int = 1000,
                      graph_calls: int = 100) -> dict:
    """The re-rank's selection split into host and device time: the host
    clock over ``calls`` enqueues with no synchronisation (the host's
    part of a call), and the CUDA-event time per call of a CUDA graph of
    ``graph_calls`` of the same calls (the device's part, no host); for
    the kernel and for ``torch.topk``, in ms per call."""
    from helix_tpu_torch.ops import topk as T

    def library(x, k):
        return torch.topk(x, k, dim=-1, sorted=True)

    out = {}
    for name, fn in (("kernel", T.select_topk), ("torch.topk", library)):
        for _ in range(10):
            fn(ring.next(), k)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn(ring.next(), k)
        host_ms = (time.perf_counter() - t) / calls * 1e3
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(ring.next(), k)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(graph_calls):
                fn(ring.next(), k)
        graph.replay()
        device_ms = cuda_ms(graph.replay, reps=5) / graph_calls
        out[name] = {"host_ms_per_enqueue": host_ms,
                     "graph_ms_per_call": device_ms}
        del graph
    return out


def select_bound(x: torch.Tensor, k: int) -> tuple[float, str]:
    """Bytes: the row read once, ``k`` values and int64 ids written."""
    rows, width = x.shape
    return bound(rows * width * x.element_size()
                 + rows * k * (x.element_size() + 8), 0.0, PEAK_BF16_PER_S)


class Ring:
    """Inputs handed out in turn, so that calls issued back to back read
    different tensors."""

    def __init__(self, items: list):
        self.items, self.i = items, 0

    def next(self) -> torch.Tensor:
        self.i = (self.i + 1) % len(self.items)
        return self.items[self.i]


def select_phase(device: torch.device) -> dict:
    """The selection kernel ``select_topk`` (``csrc/select_topk.cu``)
    against its plain version bit for bit (ids and value bits) at the
    main path's shapes: kernel 1's transposed winners [256, 15,744] at
    k=128 and at the int4 pool's k=977, their top 128 [256, 128] at
    k=16 (the re-rank), the l2 exact rung's scores [256, 1,000,448] f32
    and the cosine single shot's bf16 scores [256, 1,007,616] at k=128,
    10M rows' transposed buckets [256, 156,288] at k=128 and at 10M's
    int4 pool k=9,765, traversal_decomp's compaction of 1M int32 to
    k=65,536, and tie-heavy rows (+-0.0, +-inf, +-NaN; every path: the
    warp path's narrow rows, the block path in one and two stages, 8
    rows a block for transposed views of row counts no multiple of 8,
    k at the block path's limit and the wide path past it), each with
    the kernel's planner held to ``topk.plan``; then the fused tail's and
    the re-rank's selections captured in one CUDA graph and replayed
    (:func:`check_select_in_graph`), and the re-rank's host and device
    time apart (:func:`host_device_split`).  The kernel, its plain
    version and ``torch.topk(sorted=True)`` (the library yardstick,
    whose tie order differs) are timed against the bound at the fused
    tail's, the re-rank's, the l2, the bf16 and the 10M int4 pool's
    shapes: the fused tail's and the re-rank's on SELECT_RING fresh
    inputs taken in turn (128 MB, so each call reads its input from
    device memory, not the 50 MB L2), the others on one input each
    (0.16-1.02 GB, far past the L2)."""
    from helix_tpu_torch.ops import fused_topk as F
    from helix_tpu_torch.ops import topk as T
    from helix_tpu_torch.ops.distance import _coarse_dot

    gen = torch.Generator(device=device).manual_seed(11)
    n = F.pad_rows_for_fused(N_ROWS)
    xs16 = unit_rows(n, DIM, gen, device)
    q16 = unit_rows(BATCH, DIM, gen, device)
    winners = F.bucket_scores(xs16, q16, N_ROWS).T     # [256, buckets]
    top128, _ = T.select_topk(winners, SELECT_K)
    fresh = [winners] + [
        F.bucket_scores(xs16, unit_rows(BATCH, DIM, gen, device), N_ROWS).T
        for _ in range(SELECT_RING - 1)]
    fresh_top = [T.select_topk(w, SELECT_K)[0] for w in fresh]
    cols = torch.arange(n, device=device)
    cosine16 = torch.where((cols < N_ROWS)[None, :],
                           _coarse_dot(q16, xs16).to(torch.bfloat16),
                           -3.0e38)
    del xs16, cols
    # SIFT-shaped rows (integers in [0, 255], exact in bf16) and queries:
    # the l2 rung's single-shot scores 2 q.x - |x|^2, rows past 1M masked
    rows_l2 = torch.randint(0, 256, (L2_ROWS, DIM), generator=gen,
                            device=device).to(torch.bfloat16)
    q_l2 = torch.randint(0, 256, (BATCH, DIM), generator=gen,
                         device=device).to(torch.bfloat16)
    sq = rows_l2.float().square().sum(dim=1)
    cols = torch.arange(L2_ROWS, device=device)
    l2 = torch.where((cols < N_ROWS)[None, :],
                     2.0 * _coarse_dot(q_l2, rows_l2) - sq[None, :],
                     float("-inf"))
    del rows_l2, q_l2, sq, cols
    ten_m = torch.randn((TEN_M_BUCKETS, BATCH), generator=gen,
                        device=device).T
    # traversal_decomp's compaction: the live slots' ids, -1 elsewhere
    slots = torch.arange(N_ROWS, dtype=torch.int32, device=device)
    live = torch.rand(N_ROWS, generator=gen, device=device) < 0.1
    frontier = torch.where(live, slots, -1)[None, :]
    del slots, live
    timed_shapes = {
        "fused tail [256, 15744] f32 (transposed) k=128": (Ring(fresh),
                                                           SELECT_K),
        "re-rank [256, 128] f32 k=16": (Ring(fresh_top), SELECT_RERANK_K),
        "l2 exact [256, 1000448] f32 k=128": (Ring([l2]), SELECT_K),
        "cosine single shot [256, 1007616] bf16 k=128": (Ring([cosine16]),
                                                         SELECT_K),
        "10M int4 pool [256, 156288] f32 (transposed) k=9765": (
            Ring([ten_m]), INT4_POOL_10M),
    }
    checked = {name: (ring.items[0], k)
               for name, (ring, k) in timed_shapes.items()}
    checked.update({
        "int4 pool [256, 15744] f32 (transposed) k=977": (winners,
                                                          INT4_POOL_1M),
        "10M buckets [256, 156288] f32 (transposed) k=128": (ten_m,
                                                             SELECT_K),
        "compaction [1, 1000000] int32 k=65536": (frontier, COMPACT_K),
    })
    for rows, width, k in ((256, 15744, SELECT_K), (4, 100_000, 2048),
                           (2, L2_ROWS, INT4_POOL_1M), (3, 17, 5),
                           (1, 1, 1), (3, 40_000, 5_000),
                           (2, 30_000, 30_000), (2, 200_000, 20_000),
                           # the warp path's rows and one block's; row
                           # counts no multiple of 8 (the transposed
                           # views' row groups); k at the block path's
                           # limit and one past it (the wide path)
                           (5, 32, 7), (6, 128, 128), (9, 2048, 100),
                           (13, 15744, SELECT_K), (11, 3000, 512),
                           (2, 20_000, T.BLOCK_K_MAX),
                           (2, 20_000, T.BLOCK_K_MAX + 1)):
        x = tie_heavy(rows, width, rows + k).to(device)
        checked[f"tie-heavy [{rows}, {width}] f32 k={k}"] = (x, k)
        checked[f"tie-heavy [{rows}, {width}] f32 (transposed) k={k}"] = (
            x.T.contiguous().T, k)
        checked[f"tie-heavy [{rows}, {width}] bf16 k={k}"] = (
            x.to(torch.bfloat16), k)
    ints = torch.randint(-5, 5, (8, 40_000), generator=gen, device=device,
                         dtype=torch.int32)
    checked["int32 [8, 40000] k=300"] = (ints, 300)
    for name, (x, k) in checked.items():
        check_plan(name, x, k)
        check_select(name, x, k)
    log(f"kernel select_topk equals its plain version bit for bit (ids and "
        f"value bits) on {len(checked)} inputs, and its planner the "
        f"port's twin (topk.plan): {', '.join(checked)}")
    check_select_in_graph(winners, fresh_top[0])
    split = host_device_split(Ring(fresh_top), SELECT_RERANK_K)
    log(f"select_topk re-rank [256, 128] f32 k=16, host and device apart "
        f"on {card_name(device)}: " + json.dumps(split))

    def library(x, k):  # another tie order: the yardstick only
        return torch.topk(x, k, dim=-1, sorted=True)

    out = None
    sides = {name: (lambda ring, k, fn=fn: fn(ring.next(), k))
             for name, fn in (("kernel", T.select_topk),
                              ("plain", T.select_topk_reference),
                              ("library", library))}
    for name, (ring, k) in timed_shapes.items():
        t = time_sides(sides, [(ring, k)] * KERNEL_RUNS)
        b_ms, b_by = select_bound(ring.items[0], k)
        log(f"kernel select_topk {name}: {t['kernel']:.4f} ms (plain "
            f"{t['plain']:.4f} ms, torch.topk {t['library']:.4f} ms, bound "
            f"{b_ms:.4f} ms by {b_by}: {b_ms / t['kernel']:.1%} of the "
            "bound)")
        if out is None:  # the kernels line carries the fused tail's
            out = {"max_abs_err": 0.0, "ms": t["kernel"],
                   "plain_ms": t["plain"], "library_ms": t["library"],
                   "bound_ms": b_ms, "bound_by": b_by}
    return out


def check_bitwise(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Kernels 2-5 sum exact integers: equal bits or fail.  Returns
    the largest absolute difference (0.0 when equal)."""
    if got.is_cuda:
        torch.cuda.synchronize()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    same = got.view(torch.int32) == want.view(torch.int32)
    check(bool(same.all()), f"{name}: {int((~same).sum())} of {same.numel()}"
          " outputs differ from the plain version")
    return float((got - want).abs().max().item())


def kernel_plan(entry: str, d: int, b: int) -> str:
    """The plan a kernel's C entry ``entry`` picks for D=d, B=b."""
    import ctypes

    from helix_tpu_torch import kernels

    plan = (ctypes.c_int * 4)()
    rc = getattr(kernels.load(), entry)(d, b, plan)
    check(rc == 0, f"{entry}({d}, {b}) refused the shape: {rc}")
    resident, depth, stage, smem = plan
    return (f"D={d} B={b}: queries {'resident' if resident else 'streamed'}"
            f", {depth} stages of {stage} bytes per consumer, {smem} bytes "
            "of shared memory")


# The shapes kernels 2 and 3 are held at besides the main one (D=DIM,
# B=BATCH): B=128 single reads, and D=768, whose queries stream through
# the rings at B=256 and stay resident at B=128; n_valid in mid-bucket.
# Kernel 2 also at D=256, the widest its sums turn into f32 by the exact
# add, and D=384, the first past it (I8_SHAPES).
QUANT_SHAPES = ((DIM, 128), (768, BATCH), (768, 128))
I8_SHAPES = QUANT_SHAPES + ((256, BATCH), (384, BATCH))
QUANT_N_VALID = N_ROWS - 37
# The int8 cell's shape (hxbench's deep100m-cos.int8): 34,000,000 rows of
# int8 codes stored at D=128, padded to whole tiles, B=256.
CELL_ROWS = 34_000_000
# Rows of one call of the plain version at the cell's shape: its [rows,
# B] int32 dots and their f32 copies stay within a few GB.
CELL_CHUNK = 1 << 20
# Kernel 2's made ties (made_ties): query row 1 against buckets 1
# (positive scores) and 2 (negative) scores two sums whose f32 bits
# differ only in the 6 low bits the pack overwrites, the higher sum in
# the lower row TIE_ROWS[0]; against buckets 3 and 4, 64 equal sums, in
# [0, 2^18) and below 0.  The packed max takes the higher row among
# positive scores and the lower among negative ones (TIE_WINNERS, buckets
# 1 to 4), where an integer or an unpacked float max of the sums takes
# the other row of buckets 1 and 2.
TIE_ROWS = (9, 40)
TIE_WINNERS = (40, 9, 63, 0)


def made_ties(xs: torch.Tensor, q: torch.Tensor) -> None:
    """Write kernel 2's made ties into codes ``xs [N, D]`` (buckets 1 and
    2) and queries ``q [B, D]`` (row 1): the query is 127 but its last
    column, 1; the tie rows are 127 but column 0 (126), so their first
    D - 1 columns sum to 127 (D - 1) - 1, a multiple of 128, and their
    last columns are 5 and 2.  The sums 127 * that + 5 and + 2 lie at or
    above 2^20, where the pack drops at least their 3 low bits.  Bucket
    1's other rows are zero; bucket 2's rows are negated and its other
    rows -127, below both.  Buckets 3 and 4 hold 64 rows of 1 and of
    -1."""
    d = xs.shape[1]
    tie = torch.full((2, d), 127, dtype=torch.int8)
    tie[:, 0] = 126
    tie[:, -1] = torch.tensor([5, 2], dtype=torch.int8)
    query = torch.full((d,), 127, dtype=torch.int8)
    query[-1] = 1
    pos = torch.zeros((64, d), dtype=torch.int8)
    neg = torch.full((64, d), -127, dtype=torch.int8)
    for i, row in enumerate(TIE_ROWS):
        pos[row] = tie[i]
        neg[row] = -tie[i]
    ones = torch.ones((64, d), dtype=torch.int8)
    xs[64:320] = torch.cat([pos, neg, ones, -ones]).to(xs.device)
    q[1] = query.to(q.device)


def check_ties(name: str, want: torch.Tensor, d: int) -> None:
    """The plain version's winners of the made ties at width ``d`` (query
    row 1 of buckets 1 to 4) carry TIE_WINNERS in their index bits, and
    the ties of buckets 1 and 2 are ones of high bits: the two sums
    differ, their packed bits do not."""
    base = 127 * (127 * (d - 1) - 1)
    hi, lo = np.array([base + 5, base + 2], np.float32).view(np.int32) & ~63
    check(hi == lo, f"{name}: the made sums differ above the packed bits")
    got = [int(want[b, 1].view(torch.int32)) & 63 for b in (1, 2, 3, 4)]
    check(got == list(TIE_WINNERS),
          f"{name}: the made ties took rows {got}, not {TIE_WINNERS}")


def chunked_reference(xs: torch.Tensor, q: torch.Tensor,
                      n_valid: int) -> torch.Tensor:
    """``i8_bucket_scores_reference`` over ``xs`` in CELL_CHUNK-row
    slices (buckets are independent, and each slice starts on a bucket),
    so the cell's [34M, 256] dots never exist at once."""
    from helix_tpu_torch.ops import quant as Q

    return torch.cat([
        Q.i8_bucket_scores_reference(xs[lo:lo + CELL_CHUNK], q, n_valid - lo)
        for lo in range(0, xs.shape[0], CELL_CHUNK)])


def quant_kernel_phase(device: torch.device) -> dict:
    """Kernels 2 and 3 at the main path's shapes, on unit rows quantized
    by the port's quantizers (int8 global scale; scale-sorted int4), and
    at QUANT_SHAPES (kernel 2: I8_SHAPES) on codes drawn on the card: bit
    for bit against the plain versions, the zero-row flush, kernel 2's
    made ties (``made_ties``) and its exact-add counter, the wrappers'
    refusals, and the times of the kernels, their plain versions and
    ``torch._int_mm``."""
    from helix_tpu_torch.ops import fused_topk as F
    from helix_tpu_torch.ops import quant as Q
    from helix_tpu_torch.ops import quant4 as Q4

    n = F.pad_rows_for_fused(N_ROWS)
    rng = np.random.default_rng(11)
    rows = rng.standard_normal((n, DIM), dtype=np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    q_i8 = []
    for _ in range(KERNEL_RUNS):
        q = torch.randn((BATCH, DIM), device=device)
        q_i8.append(Q._quantize_queries(q / q.norm(dim=1, keepdim=True))[0])

    # Pin the FTZ rule: bucket 0 scores negative for query 0 except a
    # zeroed row 5, whose packed denormal must flush to a zero winner.
    neg = -torch.sign(q_i8[0][0].float()).cpu().numpy()
    t0 = time.perf_counter()
    xi = Q.quantize_rows_unit(rows)
    xi[: F.BUCKET] = (neg * 100).astype(np.int8)
    xi[5] = 0
    packed, bsc, _, _ = Q4.quantize_rows_int4_bucketed(rows, n_live=N_ROWS)
    half = DIM // 2
    nib = (neg * 7).astype(np.int8)
    packed[: F.BUCKET] = ((nib[:half] & 0x0F) | ((nib[half:] & 0x0F) << 4)
                          ).astype(np.uint8)
    packed[5] = 0
    log(f"quantize {n} x {DIM} (int8 + bucketed int4): "
        f"{time.perf_counter() - t0:.1f} s")
    del rows
    xi = torch.from_numpy(xi).to(device)
    made_ties(xi, q_i8[0])
    packed = torch.from_numpy(packed).to(device)
    bsc = torch.from_numpy(bsc).to(device)

    # The other widths: codes drawn on the card (int8 in [-127, 127],
    # nibbles in [-7, 7], positive bucket scales).
    gen = torch.Generator(device=device).manual_seed(12)
    wide = {}
    for d in sorted({d for d, _ in I8_SHAPES}):
        codes = torch.randint(-127, 128, (n, d), generator=gen,
                              device=device, dtype=torch.int8)
        lo, hi = (torch.randint(-7, 8, (n, d // 2), generator=gen,
                                device=device, dtype=torch.int8)
                  for _ in range(2))
        wide[d] = {
            "xs": xi if d == DIM else codes,
            "packed": packed if d == DIM else
            ((lo & 15) | ((hi & 15) << 4)).view(torch.uint8),
            "bsc": bsc if d == DIM else
            torch.rand(n // F.BUCKET, generator=gen, device=device) + 0.5,
            "q": q_i8[1] if d == DIM else torch.randint(
                -127, 128, (BATCH, d), generator=gen, device=device,
                dtype=torch.int8),
        }
        made_ties(wide[d]["xs"], wide[d]["q"])
        del codes, lo, hi

    codes4 = Q4.unpack_int4(packed)  # the library call's int8 operand
    buckets = n // F.BUCKET
    ops = 2.0 * n * DIM * BATCH
    out = {}
    for name, kernel, plain, entry, operands, library, in_bytes, shapes in (
        ("i8_bucket_scores", Q.i8_bucket_scores,
         Q.i8_bucket_scores_reference, "hx_i8_bucket_scores_plan",
         lambda w, q, n_valid: (w["xs"], q, n_valid),
         lambda xs, q, n_valid: torch._int_mm(xs, q.t()),
         lambda b: n * DIM + b * DIM, I8_SHAPES),
        ("i4_bucket_scores", Q4.i4_bucket_scores,
         Q4.i4_bucket_scores_reference, "hx_i4_bucket_scores_plan",
         lambda w, q, n_valid: (w["packed"], w["bsc"], q, n_valid),
         lambda p, s, q, n_valid: torch._int_mm(codes4, q.t()),
         lambda b: n * DIM // 2 + buckets * 4 + b * DIM, QUANT_SHAPES),
    ):
        ties = kernel is Q.i8_bucket_scores
        for d, b in ((DIM, BATCH),) + shapes:
            log(f"kernel {name} plan {kernel_plan(entry, d, b)}")
        at_main = wide[DIM]
        got = kernel(*operands(at_main, q_i8[0], N_ROWS))
        want = plain(*operands(at_main, q_i8[0], N_ROWS))
        err = check_bitwise(name, got, want)
        if ties:
            check_ties(name, want, DIM)
        check(int(got[0, 0].view(torch.int32)) == 0,
              f"{name}: the zero-row bucket's winner was not flushed")
        for q in q_i8[1:]:
            err = max(err, check_bitwise(name,
                                         kernel(*operands(at_main, q, N_ROWS)),
                                         plain(*operands(at_main, q, N_ROWS))))
        for d, b in shapes:
            w = wide[d]
            args = operands(w, w["q"][:b].contiguous(), QUANT_N_VALID)
            got = kernel(*args)
            want = plain(*args)
            err = max(err, check_bitwise(f"{name} D={d} B={b}", got, want))
            if ties:
                check_ties(f"{name} D={d} B={b}", want, d)
            check(float(got[QUANT_N_VALID // F.BUCKET].min()) > -1e37,
                  f"{name} D={d} B={b}: the part-live bucket lost its rows")
        del got, want
        # Each wrapper raises on a shape its refusal names: D=64 (not a
        # whole 128-column chunk) and B=192 (neither query block); a CPU
        # rehearsal runs the plain versions, which take any shape.
        for what, args in () if device.type != "cuda" else (
            ("D=64", operands({"xs": xi[:, :64].contiguous(),
                               "packed": packed[:, :32].contiguous(),
                               "bsc": bsc}, q_i8[0][:, :64].contiguous(),
                              N_ROWS)),
            ("B=192", operands(at_main, q_i8[0][:192].contiguous(), N_ROWS)),
        ):
            try:
                kernel(*args)
            except ValueError as exc:
                check(what in str(exc), f"{name}: refused {what} with {exc}")
            else:
                raise AssertionError(f"{name} took {what}")
        t = time_sides({"kernel": kernel, "plain": plain, "library": library},
                       [operands(at_main, q, N_ROWS) for q in q_i8])
        out_bytes = buckets * BATCH * 4
        b_ms, b_by = bound(in_bytes(BATCH) + out_bytes, ops, PEAK_INT8_PER_S)
        log(f"kernel {name} N={n} D={DIM} B={BATCH}: {t['kernel']:.4f} ms "
            f"(plain {t['plain']:.4f} ms, torch._int_mm product only "
            f"{t['library']:.4f} ms, bound {b_ms:.4f} ms by {b_by}: "
            f"{b_ms / t['kernel']:.1%} of the bound), bitwise equal at B="
            f"{BATCH} D={DIM} and at "
            f"{', '.join(f'B={b} D={d}' for d, b in shapes)} with "
            f"n_valid={QUANT_N_VALID}, max |err| {err:.3g}, zero-row bucket "
            f"flushed, {'made ties held, ' if ties else ''}D=64 and B=192 "
            "refused")
        t128 = time_sides({"kernel": kernel, "library": library},
                          [operands(at_main, q[:128].contiguous(), N_ROWS)
                           for q in q_i8])
        b128, _ = bound(in_bytes(128) + buckets * 128 * 4,
                        2.0 * n * DIM * 128, PEAK_INT8_PER_S)
        log(f"kernel {name} N={n} D={DIM} B=128: {t128['kernel']:.4f} ms "
            f"(torch._int_mm {t128['library']:.4f} ms, bound {b128:.4f} ms: "
            f"{b128 / t128['kernel']:.1%})")
        out[name] = {"max_abs_err": err, "ms": t["kernel"],
                     "plain_ms": t["plain"], "library_ms": t["library"],
                     "bound_ms": b_ms, "bound_by": b_by,
                     "ms_b128": t128["kernel"]}
    if device.type == "cuda":
        out["i8_bucket_scores"]["exact_add"] = exact_add_counts(
            {d: wide[d] for d in (DIM, 256, 384, 768)})
    return out


def exact_add_counts(by_d: dict) -> dict:
    """One launch of kernel 2 at each width of ``by_d`` (D -> codes and
    queries, B=BATCH) under a profiler: the tracer's counter
    ``kernel.i8_bucket_scores.exact_add`` must count it at D <= 256 and
    not above."""
    from torch.profiler import ProfilerActivity, profile

    from helix_tpu_torch import tracing
    from helix_tpu_torch.ops import quant as Q

    name = "kernel.i8_bucket_scores.exact_add"
    counts = {}
    for d, w in by_d.items():
        before = tracing.snapshot().counts.get(name, 0)
        with profile(activities=[ProfilerActivity.CPU]):
            Q.i8_bucket_scores(w["xs"], w["q"], QUANT_N_VALID)
        counts[d] = tracing.snapshot().counts.get(name, 0) - before
        check(counts[d] == (1 if d <= Q.I8_EXACT_ADD_MAX_D else 0),
              f"{name}: {counts[d]} at D={d}")
    torch.cuda.synchronize()
    log(f"kernel i8_bucket_scores {name} per launch by D: "
        f"{json.dumps(counts)}")
    return counts


def i8_cell_phase(device: torch.device, n_valid: int = CELL_ROWS) -> dict:
    """Kernel 2 at the int8 cell's shape: unit rows of width 96 quantized
    on the card as the cell's are, stored zero-padded to DIM and padded to
    whole tiles, B=BATCH; bit for bit against the plain version (in
    CELL_CHUNK-row slices) on a batch with the made ties and the zero-row
    flush of query 0 (its last K step is not zero) and on a batch of the
    cell's queries (the kernel skips their zero last K step), then timed
    over KERNEL_RUNS batches of the cell's queries beside its bound at the
    stored D and at the published D=96 (the roofline reader's)."""
    from helix_tpu_torch.ops import fused_topk as F
    from helix_tpu_torch.ops import quant as Q

    n = F.pad_rows_for_fused(n_valid)
    gen = torch.Generator(device=device).manual_seed(13)
    xs = torch.empty((n, DIM), dtype=torch.int8, device=device)
    for lo in range(0, n, CELL_CHUNK):
        rows = torch.randn((min(CELL_CHUNK, n - lo), DIM), generator=gen,
                           device=device)
        rows[:, 96:] = 0
        rows /= rows.norm(dim=1, keepdim=True)
        xs[lo:lo + rows.shape[0]] = torch.clamp(
            torch.round(rows * 127.0), -127, 127).to(torch.int8)
        del rows
    qs = []
    for _ in range(KERNEL_RUNS):
        q = torch.randn((BATCH, DIM), generator=gen, device=device)
        q[:, 96:] = 0
        qs.append(Q._quantize_queries(q / q.norm(dim=1, keepdim=True))[0])
    ties = qs[0].clone()
    made_ties(xs, ties)
    xs[: F.BUCKET] = (-torch.sign(ties[0].float()) * 100).to(torch.int8)
    xs[5] = 0
    err = 0.0
    for i, q in enumerate((ties, qs[1])):
        got = Q.i8_bucket_scores(xs, q, n_valid)
        want = chunked_reference(xs, q, n_valid)
        err = max(err, check_bitwise(f"i8_bucket_scores cell N={n}", got,
                                     want))
        if i == 0:
            check_ties("i8_bucket_scores cell", want, DIM)
            check(int(got[0, 0].view(torch.int32)) == 0,
                  "i8_bucket_scores cell: the zero-row bucket's winner was "
                  "not flushed")
        del got, want
    t = time_sides({"kernel": Q.i8_bucket_scores},
                   [(xs, q, n_valid) for q in qs])
    buckets = n // F.BUCKET
    b_ms, b_by = bound(n * DIM + BATCH * DIM + buckets * BATCH * 4,
                       2.0 * n * DIM * BATCH, PEAK_INT8_PER_S)
    pub_ms, _ = bound(n_valid * 96 + BATCH * 96
                      + -(-n_valid // F.BUCKET) * BATCH * 4,
                      2.0 * n_valid * 96 * BATCH, PEAK_INT8_PER_S)
    log(f"kernel i8_bucket_scores cell N={n} D={DIM} B={BATCH} n_valid="
        f"{n_valid}: {t['kernel']:.4f} ms (bound {b_ms:.4f} ms by {b_by}: "
        f"{b_ms / t['kernel']:.1%}; at the published D=96 {pub_ms:.4f} ms: "
        f"{pub_ms / t['kernel']:.1%}), bitwise equal on the made ties' "
        f"batch and a batch of the cell's queries, made ties held, zero-row "
        f"bucket flushed")
    del xs
    return {"cell_ms": t["kernel"], "cell_bound_ms": b_ms,
            "cell_bound_d96_ms": pub_ms, "cell_max_abs_err": err}


# ---------------------------------------------------------------- sweeps

# Kernel 4's ring depths (stages per consumer; 8 is the most that fit at
# D=128, B=256) and kernel 5's variants: every one of both sweeps.
SWEEP_DEPTHS = "2,4,8"
I8_VARIANTS = ("shipped,bf16dot,bf16dot_tail,i32pack,dot_i8,dot_bf16,"
               "scale2d,gscale,ep_astype,ep_scale,ep_pack,ep_mask,"
               "ep_full_amk,amk,xT,full_noT,dotf32")
SWEEP_RECALL = 0.99
# kernel 4's entries in the kernels line: (variant, what it replaces)
ONEPASS_REPLACES = {
    "shipped": "helix_tpu/ops/fused_topk.py:151 _make_kernel (swapped by "
               "benchmarks/onepass_sweep.py:172)",
    "onepass": "benchmarks/onepass_sweep.py:34 _make_kernel_onepass",
    "lastmask": "benchmarks/onepass_sweep.py:70 _make_kernel_lastmask",
}


def sweep_phase(device: torch.device, n_rows: int = N_ROWS) -> dict:
    """Kernels 4 and 5: the two sweeps' entry points on one shared corpus
    (``_corpus`` seed 42, the headline's), every variant, launches counted
    from 0 just before and read just after; then each instantiation alone
    against its plain version (bit for bit: kernel 5 on the sweep's own
    operands, kernel 4 on rows of small integers, where every f32 sum is
    exact; kernel 4 also within kernel 1's tolerance on the corpus and
    bit for bit against kernel 1 there, ``gscale`` against kernel 2, the
    bf16 forms against their int8 twins), at the main shape and with
    n_valid in mid-bucket, and its time against its plain version's, the
    library call's and its bound.  Returns the kernels line's entries."""
    from helix_tpu_torch.benchmarks import i8_sweep as I8
    from helix_tpu_torch.benchmarks import onepass_sweep as OP
    from helix_tpu_torch.benchmarks.ladder import _corpus, _oracle
    from helix_tpu_torch.ops import fused_topk as F
    from helix_tpu_torch.ops import quant as Q

    t = time.perf_counter()
    data, queries = _corpus(n_rows, DIM, BATCH, 1)
    oracle = _oracle(data, queries[:BATCH], K)
    ops4 = OP.operands(data, DIM, device)
    ops5 = I8.operands(data, DIM, device)
    del data
    log(f"sweeps: corpus, oracle and operands of {n_rows} x {DIM} in "
        f"{time.perf_counter() - t:.1f} s")

    # -- the main path: both entry points' sweeps
    wrappers = [*OP.KERNELS.values(), *I8.KERNELS.values(),
                Q.i8_bucket_scores]
    for w in wrappers:
        w.launches = w.captured = 0
    dev = ["--device", device.type, "--n", str(n_rows)]
    line4, failed = OP.sweep(OP.parse_args(dev + ["--tiles", SWEEP_DEPTHS]),
                             ops4, queries, oracle)
    print(json.dumps(line4), flush=True)
    check(not failed, f"onepass_sweep: {failed} failed")
    line5, failed = I8.sweep(I8.parse_args(dev + ["--variants",
                                                  I8_VARIANTS]),
                             ops5, queries, oracle)
    print(json.dumps(line5), flush=True)
    check(not failed, f"i8_sweep: {failed} failed")
    launches = {w: (w.launches, w.captured) for w in wrappers}
    for row in line4["variants"]:
        shipped = next(r for r in line4["variants"] if r["kernel"] ==
                       "shipped" and r["ring_depth"] == row["ring_depth"])
        check(row["recall_at_10"] >= SWEEP_RECALL and
              row["recall_at_10"] == shipped["recall_at_10"],
              f"onepass_sweep {row['kernel']}@{row['ring_depth']}: recall "
              f"{row['recall_at_10']} (shipped {shipped['recall_at_10']})")
    for row in line5["variants"]:
        if row["variant"] not in I8.TIMING_ONLY:
            check("containment_at_kcand" in row,
                  f"i8_sweep {row['variant']}: no containment")
    log(f"sweeps: launches (eager, captured) "
        f"{ {getattr(w, 'name', 'i8_bucket_scores'): c for w, c in launches.items()} }")
    if device.type == "cuda":
        for w, (eager, captured) in launches.items():
            check(eager > 0 and captured > 0,
                  f"{getattr(w, 'name', w)} was not launched by the sweeps")

    # -- each instantiation alone: against its plain version, then timed
    out = {"launches_i8_bucket_scores": launches[Q.i8_bucket_scores][0]}
    gen = torch.Generator(device=device).manual_seed(31)
    n_pad, xs16 = ops4["n_pad"], ops4["xs16"]
    q16 = [unit_rows(BATCH, DIM, gen, device) for _ in range(KERNEL_RUNS)]
    n_mid = n_rows - 37
    ints = torch.randint(-8, 9, (n_pad, DIM), generator=gen, device=device
                         ).to(torch.bfloat16)
    q_ints = torch.randint(-8, 9, (BATCH, DIM), generator=gen, device=device
                           ).to(torch.bfloat16)
    kernel1 = F.bucket_scores(xs16, q16[0], n_rows)
    sims = masked_sims(xs16, q16[0], n_rows)
    bound4 = OP.kernel_bound(n_pad, DIM, BATCH, device) or (None, None)
    depths = [int(d) for d in SWEEP_DEPTHS.split(",")]
    for name, kernel in OP.KERNELS.items():
        err = 0.0
        for depth in depths:
            got = kernel(xs16, q16[0], n_rows, depth=depth)
            check_bitwise(f"{name}@{depth} against kernel 1", got, kernel1)
            err = max(err, compare_packed(got, F.bucket_scores_reference(
                xs16, q16[0], n_rows), sims, TOL))
            for nv in (n_rows, n_mid):
                check_bitwise(f"{name}@{depth} n_valid={nv}",
                              kernel(ints, q_ints, nv, depth=depth),
                              kernel.reference(ints, q_ints, nv))
        t = time_sides({"kernel": kernel, "plain": kernel.reference,
                        "library": lambda xs, qs, nv: torch.matmul(xs, qs.T)},
                       [(xs16, q, n_rows) for q in q16])
        by_depth = time_sides({f"ring {d}": (lambda xs, qs, nv, d=d:
                                             kernel(xs, qs, nv, depth=d))
                               for d in depths} | {"kernel 1": F.bucket_scores},
                              [(xs16, q, n_rows) for q in q16])
        log(f"kernel onepass_sweep/{name} N={n_pad} D={DIM} B={BATCH}: "
            f"{t['kernel']:.4f} ms (plain {t['plain']:.4f} ms, torch.matmul "
            f"{t['library']:.4f} ms, bound {bound4[0]} ms by {bound4[1]}); "
            f"bitwise equal to kernel 1 and, on rows of small integers, to "
            f"its plain version at n_valid {n_rows} and {n_mid}, at ring "
            f"depths {SWEEP_DEPTHS}; max unpacked |err| {err:.3g} against the "
            f"plain version; by depth "
            f"{ {k: round(v, 4) for k, v in by_depth.items()} }")
        out[f"onepass_sweep/{name}"] = {
            "source": "helix_tpu_torch/csrc/sweep_bucket_scores.cu",
            "replaces": ONEPASS_REPLACES[name],
            "launches": launches[kernel][0], "max_abs_err": err,
            "ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t["library"], "bound_ms": bound4[0],
            "bound_by": bound4[1]}
    del ints, q_ints, kernel1, sims

    q_i8 = [Q._quantize_queries(q.float())[0] for q in q16]
    codes16 = ops5["xs_i8"].to(torch.bfloat16)  # the bf16 library operand
    operand = {"row": ops5["xscales"], "row_unused": ops5["xscales"],
               "bucket": ops5["bscales"], "none": None}
    outputs = {}
    for name, kernel in I8.KERNELS.items():
        body = kernel.body
        xs = ops5["xs_i8b" if body.scale == "bucket" else
                  "xs_i8g" if name == "gscale" else "xs_i8"]
        sc = operand[body.scale]

        def args(q, nv, xs=xs, sc=sc, bf16=body.dot == "bf16"):
            return (xs, q.to(torch.bfloat16) if bf16 else q, sc, nv)

        got = kernel(*args(q_i8[0], n_rows))
        err = check_bitwise(f"i8_sweep/{name}", got,
                            kernel.reference(*args(q_i8[0], n_rows)))
        err = max(err, check_bitwise(
            f"i8_sweep/{name} n_valid={n_mid}", kernel(*args(q_i8[1], n_mid)),
            kernel.reference(*args(q_i8[1], n_mid))))
        outputs[name] = got
        if body.dot == "bf16":
            library = lambda xs, q, sc, nv: torch.matmul(codes16, q.T)  # noqa: E731
        else:
            library = lambda xs, q, sc, nv: torch._int_mm(xs, q.t())  # noqa: E731
        t = time_sides({"kernel": kernel, "plain": kernel.reference,
                        "library": library},
                       [args(q, n_rows) for q in q_i8])
        b_ms, b_by = I8.kernel_bound(body, n_pad, DIM, BATCH, device) or (
            None, None)
        log(f"kernel i8_sweep/{name} ({body.entry}) N={n_pad} D={DIM} "
            f"B={BATCH}: {t['kernel']:.4f} ms (plain {t['plain']:.4f} ms, "
            f"{'torch.matmul bf16' if body.dot == 'bf16' else 'torch._int_mm'}"
            f" {t['library']:.4f} ms, bound {b_ms} ms by {b_by}); bitwise "
            f"equal to its plain version at n_valid {n_rows} and {n_mid}")
        out[f"i8_sweep/{name}"] = {
            "source": f"helix_tpu_torch/csrc/{body.source}",
            "replaces": body.replaces, "launches": launches[kernel][0],
            "max_abs_err": err, "ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t["library"], "bound_ms": b_ms, "bound_by": b_by}
    check_bitwise("i8_sweep/gscale against kernel 2", outputs["gscale"],
                  Q.i8_bucket_scores(ops5["xs_i8g"], q_i8[0], n_rows))
    for bf16, s8 in (("bf16dot", "scale2d"), ("bf16dot_tail", "scale2d"),
                     ("dot_bf16", "dot_i8")):
        check_bitwise(f"i8_sweep/{bf16} against {s8}", outputs[bf16],
                      outputs[s8])
    log("sweeps: gscale equals kernel 2, bf16dot and bf16dot_tail equal "
        "scale2d, dot_bf16 equals dot_i8, bit for bit")
    return out


# ---------------------------------------------------------------- bench

BENCH_TIMEOUT_S = 600
BENCH_RECALL = 0.99


def numbers(value):
    """Every number in a JSON value, depth first."""
    if isinstance(value, bool):
        return
    if isinstance(value, (int, float)):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from numbers(v)
    elif isinstance(value, list):
        for v in value:
            yield from numbers(v)


def bench_phase(device: torch.device, **env: str) -> dict:
    """``python bench_torch.py`` as a child process through its real entry
    point, at its defaults on the card (``env`` adds overrides: a CPU
    rehearsal passes a small ``BENCH_N``), with the CPU HNSW baseline
    skipped (its 1M build takes ~10 minutes).  Checks the line it prints
    and returns it with kernel 1's launches in its eager windows (the
    graphs' launches are checked per replay, not counted: the wrapper
    sees only their capture)."""
    script = Path(__file__).resolve().parent / "bench_torch.py"
    args = [sys.executable, str(script)]
    if device.type != "cuda":
        args += ["--device", "cpu"]
    else:
        torch.cuda.empty_cache()  # the child shares the card
    proc = subprocess.run(
        args, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
        cwd=script.parent,
        env=dict(os.environ, BENCH_SKIP_BASELINE="1", **env),
    )
    check(proc.returncode == 0, f"bench_torch.py exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    res = json.loads(line)
    log(f"bench_torch.py on {card_name(device)}: {line}")
    check(res["recall_at_10"] >= BENCH_RECALL,
          f"bench: recall@10 {res['recall_at_10']} < {BENCH_RECALL}")
    check(all(np.isfinite(v) for v in numbers(res)),
          "bench: a number in the line is not finite")
    if device.type == "cuda":
        rounds = res["scan_timing"]["rounds"]
        want = {"full": rounds, "half": rounds // 2, "chained": rounds}
        graphs = res["graph_kernel_launches"]
        check(graphs["captured"] == want
              and graphs["profiled_replay"] == want,
              f"bench: kernel 1 not once per search in the timed graphs: "
              f"{graphs} (want {want})")
        check("roofline_qps" in res, f"bench: no bound for {res['card']}")
        bound_ms = res["batch"] / res["roofline_qps"] * 1e3
        check(res["device_batch_ms"] >= bound_ms,
              f"bench: {res['device_batch_ms']} ms per batch is below the "
              f"bound {bound_ms} ms")
        check(res.get("e2e_gateway_fast_path_requests", 0) > 0,
              "bench: the gateway served nothing on its fast path: "
              f"{res.get('e2e_gateway_note')}")
        selects = res["launches_by_wrapper"]["select_topk"]
        check(all(selects["captured"][g] >= want[g] for g in want),
              f"bench: the selection kernel not in every search of the "
              f"timed graphs: {selects['captured']} (want at least {want})")
    selects = res["launches_by_wrapper"]["select_topk"]
    return {"launches": res["kernel_launches"], "line": res,
            "select_launches": selects["per_dispatch"] + selects["e2e"]}


# ------------------------------------------------------- ladder bench

# The rungs of ``bench_torch.py --ladder`` in order, each with its recall
# floor and the kernel it launches (host IVF: none).
LADDER_BENCH_RUNGS = (("exact", 0.99, "bucket_scores"),
                      ("int8_dev", 0.98, "i8_bucket_scores"),
                      ("int8", 0.98, "i8_bucket_scores"),
                      ("int4", 0.95, "i4_bucket_scores"),
                      ("host_ivf", 0.95, None))
# Each rung's reading and the bound it is held to (the coarse phase's for
# the host re-ranked rungs).
LADDER_BENCH_BOUNDS = {"exact": ("qps", "roofline_qps"),
                       "int8_dev": ("qps", "roofline_qps"),
                       "int8": ("coarse_qps", "coarse_roofline_qps"),
                       "int4": ("coarse_qps", "coarse_roofline_qps")}


def ladder_bench_phase(device: torch.device, *args: str) -> dict:
    """``python bench_torch.py --ladder`` as a child process, at the
    reference ladder's defaults on the card (1M x 128 cosine, B=256,
    k=10, 16 rounds; ``args`` adds overrides, a CPU rehearsal passes a
    small ``--n``).  It never builds an HNSW: its baseline is a record or
    none.  Checks the five rungs in order, each serving at its recall
    floor, at or below its bound, every number finite; returns the line
    with each kernel's launches in the child."""
    script = Path(__file__).resolve().parent / "bench_torch.py"
    argv = [sys.executable, str(script), "--ladder", *args]
    if device.type != "cuda":
        argv += ["--device", "cpu"]
    else:
        torch.cuda.empty_cache()  # the child shares the card
    t = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S, cwd=script.parent)
    seconds = time.perf_counter() - t
    check(proc.returncode == 0, f"bench_torch.py --ladder exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    res = json.loads(line)
    log(f"bench_torch.py --ladder on {card_name(device)} ({seconds:.1f} s): "
        f"{line}")
    rungs = res["rungs"]
    tiers = [r["tier"] for r in rungs]
    check(tiers == [tier for tier, _, _ in LADDER_BENCH_RUNGS],
          f"ladder bench: rungs {tiers}")
    check(all(np.isfinite(v) for v in numbers(res)),
          "ladder bench: a number in the line is not finite")
    launches = res["kernel_launches"]
    for row, (tier, floor, kernel) in zip(rungs, LADDER_BENCH_RUNGS):
        check(row["serving"] and row["recall_at_10"] >= floor,
              f"ladder bench {tier}: recall@10 {row['recall_at_10']} < "
              f"{floor} (serving {row['serving']})")
        if device.type == "cuda" and tier in LADDER_BENCH_BOUNDS:
            got, bound_key = LADDER_BENCH_BOUNDS[tier]
            check(bound_key in row and row[got] <= row[bound_key],
                  f"ladder bench {tier}: {row[got]} QPS against the bound "
                  f"{row.get(bound_key)}")
        if device.type == "cuda" and kernel is not None:
            check(launches[kernel] > 0
                  and res["kernel_captured"][kernel] > 0,
                  f"ladder bench {tier}: {kernel} launched "
                  f"{launches[kernel]}, captured "
                  f"{res['kernel_captured'][kernel]}")
    return {"launches": launches, "line": res, "seconds": seconds}


# -------------------------------------------------------------- demos

# The demos' corpus, cut from their default of 10,000,000 rows (the
# budget that keeps beyond_hbm_demo past the exact tier scales with it:
# 2 GB at 10M).  At 1,000,000 rows quant_demo --bits 4's fixed pool of
# 320 candidates holds recall@10 0.923 on this corpus, at 500,000 0.9742.
DEMO_N = 500_000
DEMO_RECALL = 0.95


def run_main(name: str, main, argv: list, device: torch.device) -> tuple:
    """``main(argv + --device)`` in process with its stdout captured:
    ``(exit code, stdout lines, seconds)``; each line is printed under
    the card's name."""
    import contextlib
    import io

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main([*argv, "--device", device.type])
    seconds = time.perf_counter() - t
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"{name} on {card_name(device)}: {line}")
    log(f"{name}: exit {rc} in {seconds:.1f} s")
    return rc, lines, seconds


def demos_phase(device: torch.device, n: int = DEMO_N) -> dict:
    """``quant_demo`` (``--bits 8``, then ``--bits 4``, which must launch
    kernel 3) and ``beyond_hbm_demo`` through their ``main``s at ``n``
    rows, each line printed: recall@10 >= 0.95 for both quantized runs,
    ``beyond_hbm_demo``'s own gate (some nprobe at 0.9).  Returns the
    lines and kernel 3's launches in the int4 run."""
    from helix_tpu_torch.benchmarks import beyond_hbm_demo, quant_demo

    out: dict = {"launches": {}}

    def run(name, main, argv) -> list:
        rc, lines, seconds = run_main(name, main, argv, device)
        out[f"{name} seconds"] = round(seconds, 1)
        check(rc == 0 and lines, f"{name} exited {rc}")
        return [json.loads(x) for x in lines]

    for bits in (8, 4):
        before = launch_counts()
        [res] = run(f"quant_demo --bits {bits}", quant_demo.main,
                    ["--n", str(n), "--bits", str(bits)])
        check(res["recall_at_10"] >= DEMO_RECALL,
              f"quant_demo --bits {bits}: recall@10 {res['recall_at_10']}")
        counts = {k: v - before[k] for k, v in launch_counts().items()}
        if bits == 4:
            check_only_launched(device, counts, "i4_bucket_scores",
                                "quant_demo --bits 4")
            check(device.type != "cuda" or res["fused"],
                  "quant_demo --bits 4 did not take the fused route")
            out["launches"]["i4_bucket_scores"] = counts["i4_bucket_scores"]
        else:
            check(not any(counts.values()),
                  f"quant_demo --bits 8 launched kernels: {counts}")
        out[f"int{bits}"] = res
    budget_gb = 2.0 * n / 10_000_000
    out["ivf"] = run("beyond_hbm_demo", beyond_hbm_demo.main,
                     ["--n", str(n), "--hbm-budget-gb", str(budget_gb)])
    return out


# ---------------------------------------------------------------- engine


# ------------------------------------------------ the last four scripts

# tile_sweep's ring depths (0: the most that fit) and the exact sweep's
# recall floors: the exact and chunked rows, the int8 coarse rows (their
# 80 candidates against the oracle's top 10: the int8 rung's floor).
TILE_DEPTHS = "2,4,8,0"
EXACT_RECALL = 0.999
EXACT_COARSE_RECALL = 0.98
# exact_sweep's chunks (C = 15,744 and 125,952 at 1,007,616 padded rows)
# and rounds, cut from the reference's six chunks and 64 rounds.
EXACT_CHUNKS = "16384,131072"
EXACT_ROUNDS = 16
# the soak's seconds, cut from the reference's 180
SOAK_SECONDS = 45
SOAK_TIMEOUT_S = 300
SOAK_RECALL = 0.99


def tile_sweep_phase(device: torch.device, n: int = N_ROWS) -> dict:
    """``tile_sweep``'s ``main`` (the port of ``benchmarks/tile_sweep.py``)
    at ``n`` x 128, B=256, ring depths 2, 4, 8 and the most that fit:
    every depth serves at recall@10 >= 0.99 and at or below the card's
    bound (the sweep fails a depth above it), and kernel 4's ``shipped``
    launched and captured at every depth (counted from 0 around the
    run).  Returns its line and ``shipped``'s eager launches."""
    from helix_tpu_torch.benchmarks import onepass_sweep as OP
    from helix_tpu_torch.benchmarks import tile_sweep

    shipped = OP.KERNELS["shipped"]
    shipped.launches = shipped.captured = 0
    rc, lines, seconds = run_main("tile_sweep", tile_sweep.main, [
        "--n", str(n), "--tiles", TILE_DEPTHS], device)
    check(rc == 0, f"tile_sweep exited {rc}")
    res = json.loads(lines[-1])
    rows = res["variants"]
    check(len(rows) == len(TILE_DEPTHS.split(",")),
          f"tile_sweep: {len(rows)} rows")
    for row in rows:
        check(row["recall_at_10"] >= SWEEP_RECALL,
              f"tile_sweep depth {row['ring_depth']}: recall@10 "
              f"{row['recall_at_10']}")
        if device.type == "cuda":
            check(row["launches"] > 0 and row["captured"] > 0,
                  f"tile_sweep depth {row['ring_depth']}: shipped launched "
                  f"{row['launches']}, captured {row['captured']}")
    return {"line": res, "launches": shipped.launches, "seconds": seconds}


def exact_sweep_phase(device: torch.device, n: int = N_ROWS) -> dict:
    """``exact_sweep``'s ``main`` (the port of ``benchmarks/exact_sweep.py``)
    with ``--int8`` at ``n`` x 128, B=256 (chunks and rounds cut:
    ``REDUCED``): ``resident_topk_auto`` and every exact and chunked row
    at recall@10 >= 0.999, every int8 coarse row (the fused one first)
    at coarse recall >= 0.98, kernels 1 and 2 launched and captured
    (counted from 0 around the run).  Returns its line and each
    kernel's eager launches."""
    from helix_tpu_torch.benchmarks import exact_sweep

    reset_launch_counts()
    rc, lines, seconds = run_main("exact_sweep", exact_sweep.main, [
        "--n", str(n), "--int8", "--chunks", EXACT_CHUNKS, "--rounds",
        str(EXACT_ROUNDS)], device)
    check(rc == 0, f"exact_sweep exited {rc}")
    res = json.loads(lines[-1])
    launches = launch_counts()
    names = [row["variant"] for row in res["variants"]]
    n_chunks = sum(1 for name in names if name.startswith("chunked_bf16"))
    check(names[0] == "resident_topk_auto (shipped serving)"
          and len(names) == 2 + 2 * n_chunks + 1 + (device.type == "cuda")
          and (n < 1 << 17 or n_chunks == len(EXACT_CHUNKS.split(","))),
          f"exact_sweep: variants {names}")
    if device.type == "cuda":
        check(names[4].startswith("int8_fused_cuda (shipped)"),
              f"exact_sweep: no fused int8 row: {names}")
    for row in res["variants"]:
        if "recall_at_10" in row:
            check(row["recall_at_10"] >= EXACT_RECALL,
                  f"exact_sweep {row['variant']}: recall@10 "
                  f"{row['recall_at_10']}")
        else:
            check(row["coarse_recall_at_10"] >= EXACT_COARSE_RECALL,
                  f"exact_sweep {row['variant']}: coarse recall@10 "
                  f"{row['coarse_recall_at_10']}")
    if device.type == "cuda":
        for kernel in ("bucket_scores", "i8_bucket_scores"):
            check(launches[kernel] > 0 and res["kernel_captured"][kernel] > 0,
                  f"exact_sweep: {kernel} launched {launches[kernel]}, "
                  f"captured {res['kernel_captured'][kernel]}")
    return {"line": res, "launches": launches, "seconds": seconds}


def traversal_decomp_phase(device: torch.device,
                           n: int = GRAPH_NODES) -> dict:
    """``traversal_decomp``'s ``main`` (the port of
    ``benchmarks/traversal_decomp.py``) at ``n`` nodes, degree 16: every
    piece timed, positive and finite; then, on the same graph built
    again, ``full_2hop``'s scalar at carry 1 equals ``khop_count`` run
    once on that carry's start mask and ``native.bfs_khop``'s count."""
    from helix_tpu_torch import native
    from helix_tpu_torch.benchmarks import traversal_decomp as TD
    from helix_tpu_torch.ops import csr as C

    rc, lines, seconds = run_main("traversal_decomp", TD.main, [
        "--n", str(n), "--deg", str(GRAPH_DEGREE)], device)
    check(rc == 0, f"traversal_decomp exited {rc}")
    res = json.loads(lines[-1])
    pieces = res["pieces_ms"]
    ctx = TD.build(n, GRAPH_DEGREE, device)
    check(list(pieces) == list(ctx["pieces"]),
          f"traversal_decomp: pieces {list(pieces)}")
    check(all(np.isfinite(v) and v > 0 for v in pieces.values()),
          f"traversal_decomp: a piece's time is not positive: {pieces}")
    graph = ctx["graph"]
    mask = ctx["mask_from"](torch.tensor(1, dtype=torch.int32,
                                         device=device))
    once = int(C.khop_count(graph.neighbors, graph.edge_labels, mask,
                            ctx["label_code"], 2, ctx["keep"]))
    indptr, dst, lab = ctx["csr"]
    host, _ = native.bfs_khop(indptr, dst, lab,
                              mask.cpu().numpy().astype(np.uint8),
                              ctx["label_code"], 2)
    want = int((host.astype(bool) & ctx["keep"].cpu().numpy()).sum())
    check(res["values"]["full_2hop"] == once == want,
          f"traversal_decomp: full_2hop {res['values']['full_2hop']}, "
          f"khop_count once {once}, bfs_khop {want}")
    log(f"traversal_decomp: full_2hop {once} nodes, equal to khop_count "
        f"once and bfs_khop; eager pieces {res['eager']}")
    return {"line": res, "seconds": seconds}


def soak_phase(device: torch.device, *args: str) -> dict:
    """``python -m helix_tpu_torch.benchmarks.soak`` (the port of
    ``benchmarks/soak.py``) as a child process at its 200,000 rows for
    ``SOAK_SECONDS`` (``args`` adds overrides; a CPU rehearsal passes a
    small ``--n``): searches answered with finite p50 / p99, every
    acknowledged write in the store (``nodes_final == ingested_docs >
    0``), kernel 1 launched in the child while the clients ran, the 16
    read-backs after the soak at recall@10 >= 0.99.  RSS is printed, not
    gated (the child's includes the CUDA context).  Returns the line."""
    root = Path(__file__).resolve().parent
    argv = [sys.executable, "-m", "helix_tpu_torch.benchmarks.soak",
            "--seconds", str(SOAK_SECONDS), "--device", device.type, *args]
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the child shares the card
    t = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True,
                          timeout=SOAK_TIMEOUT_S, cwd=root)
    seconds = time.perf_counter() - t
    check(proc.returncode == 0, f"soak exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    res = json.loads(line)
    log(f"soak on {card_name(device)} ({seconds:.1f} s): {line}")
    check(res["search_requests"] > 0
          and np.isfinite([res["p50_ms"], res["p99_ms"]]).all(),
          f"soak: {res['search_requests']} searches, p50 {res['p50_ms']}, "
          f"p99 {res['p99_ms']}")
    check(res["ingested_docs"] > 0
          and res["nodes_final"] == res["ingested_docs"],
          f"soak: {res['ingested_docs']} docs acknowledged, "
          f"{res['nodes_final']} in the store")
    check(res["post_soak_recall_at_10"] >= SOAK_RECALL,
          f"soak: read-back recall@10 {res['post_soak_recall_at_10']}")
    if device.type == "cuda":
        check(res["kernel_launches"]["bucket_scores"] > 0,
              "soak: kernel 1 never launched during the soak")
    log(f"soak RSS (not gated): start {res['rss_start_mb']} MB, peak "
        f"{res['rss_peak_mb']} MB, end {res['rss_end_mb']} MB")
    return {"line": res, "launches": res["kernel_launches"]["bucket_scores"],
            "select_launches": res["kernel_launches"]["select_topk"],
            "seconds": seconds}


def clustered(n: int, d: int, n_queries: int, seed: int = 42):
    """``bench.py``'s clustered generator (1000 centers, sigma 0.3),
    rows and queries as drawn."""
    rng = np.random.default_rng(seed)
    n_clusters = 1000
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    data = centers[assign] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, n_clusters, size=n_queries)] \
        + 0.3 * rng.normal(size=(n_queries, d)).astype(np.float32)
    return data, queries


def make_dataset(n: int, d: int, n_queries: int, seed: int = 42):
    """``bench.py``'s clustered cosine set: :func:`clustered`, rows and
    queries unit-normalised."""
    data, queries = clustered(n, d, n_queries, seed)
    data /= np.linalg.norm(data, axis=1, keepdims=True) + 1e-9
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


def launch_counts() -> dict:
    from helix_tpu_torch.ops import fused_topk as F
    from helix_tpu_torch.ops import quant as Q
    from helix_tpu_torch.ops import quant4 as Q4

    return {"bucket_scores": F.bucket_scores.launches,
            "i8_bucket_scores": Q.i8_bucket_scores.launches,
            "i4_bucket_scores": Q4.i4_bucket_scores.launches}


def reset_launch_counts() -> None:
    from helix_tpu_torch.ops import fused_topk as F
    from helix_tpu_torch.ops import quant as Q
    from helix_tpu_torch.ops import quant4 as Q4

    F.bucket_scores.launches = 0
    Q.i8_bucket_scores.launches = 0
    Q4.i4_bucket_scores.launches = 0


def check_only_launched(device: torch.device, counts: dict, kernel: str,
                        what: str) -> None:
    """``kernel`` served the step and no other kernel launched (on the
    card; a CPU rehearsal runs the plain versions and counts nothing)."""
    if device.type != "cuda":
        return
    check(counts[kernel] > 0, f"{what}: {kernel} never launched")
    others = {k: v for k, v in counts.items() if k != kernel and v}
    check(not others, f"{what}: other kernels launched: {others}")


def new_engine(device: torch.device, **knobs):
    """An engine with the Doc.emb vector index and the vsearch route."""
    from helix_tpu_torch.engine import Engine

    return with_search_route(Engine(device=device, **knobs))


def with_search_route(engine):
    """``engine`` with the Doc.emb vector index and the vsearch route."""
    write(engine, [{"CreateIndex": {"spec": {"NodeVector": {
        "label": "Doc", "property": "emb", "tenant_property": None,
    }}, "if_not_exists": True}}], {}, {})
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
    return engine


def ingest(engine, data: np.ndarray, lo: int, hi: int) -> float:
    t0 = time.perf_counter()
    for start in range(lo, hi, INGEST_CHUNK):
        engine.execute(ingest_request(start, data[start:min(hi, start +
                                                            INGEST_CHUNK)]))
    return time.perf_counter() - t0


def doc_partition(engine):
    return engine.vectors.indexes[("NodeVector", "Doc", "emb")] \
        .partitions[("",)]


class HostRerankClock:
    """Wall time spent in the quantized rungs' host re-rank
    (``helix_tpu_torch.native.rerank``, which they import at each call), so a
    batch's time splits into re-rank and the rest."""

    def __init__(self):
        self.ms = 0.0

    def __enter__(self):
        from helix_tpu_torch import native

        self._native = native
        self._rerank = native.rerank

        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return self._rerank(*args, **kwargs)
            finally:
                self.ms += (time.perf_counter() - t) * 1e3

        native.rerank = timed
        return self

    def __exit__(self, *exc):
        self._native.rerank = self._rerank


def serve_reads(engine, part, queries: np.ndarray, dead: list, *,
                recall_floor: float, dist_tol: float, what: str) -> dict:
    """Single-query reads (``execute_stored`` and ``execute`` in turn,
    N_PROBE of them) and N_BATCHES ``Partition.search_many`` batches of
    BATCH, checked against a float32 numpy oracle over the rows the
    engine stores (``dead`` rows excluded): recall@K at least
    ``recall_floor`` on both, ``$distance`` within ``dist_tol`` of
    ``1 - q.x``.  Returns the metrics and the first probe's rows."""
    matrix = part.matrix
    stored = matrix.data[: matrix.n]
    probe = queries[:N_PROBE]
    sims = matrix.prepare_queries(probe) @ stored.T
    sims[:, dead] = -np.inf
    oracle = top_rows(sims, K)

    got_rows: list[list[int]] = []
    worst = 0.0
    latencies = []
    for j in range(N_PROBE):
        t = time.perf_counter()
        if j % 2:
            out = engine.execute(search_request(probe[j]))
        else:
            out = engine.execute_stored("vsearch", {"q": probe[j].tolist(),
                                                    "k": K})
        latencies.append(time.perf_counter() - t)
        rows, dists = rows_of(out["hits"])
        got_rows.append(rows)
        for row, dist in zip(rows, dists):
            worst = max(worst, abs(dist - (1.0 - float(sims[j, row]))))
    recall = float(np.mean([
        len(set(got_rows[j]) & set(oracle[j].tolist())) / K
        for j in range(N_PROBE)
    ]))
    p50, p90 = (float(np.percentile(latencies, p) * 1e3) for p in (50, 90))
    log(f"{what} single-query reads: recall@{K} {recall:.4f}, max "
        f"|$distance - (1 - q.x)| {worst:.3g}, latency p50 {p50:.3f} ms "
        f"p90 {p90:.3f} ms (n={N_PROBE})")
    check(recall >= recall_floor, f"{what}: recall@{K} {recall} < "
          f"{recall_floor}")
    check(worst <= dist_tol, f"{what}: $distance off by {worst}")

    # The gateway's vbatch entry: Partition.search_many of BATCH.
    batch_ms = []
    rerank_ms = []
    first_ids = None
    for b in range(N_BATCHES):
        qb = queries[N_PROBE + b * BATCH:N_PROBE + (b + 1) * BATCH]
        with HostRerankClock() as clock:
            t = time.perf_counter()
            ids, dists = part.search_many(qb, K)
            batch_ms.append((time.perf_counter() - t) * 1e3)
        rerank_ms.append(clock.ms)
        check(ids.shape == (BATCH, K) and np.isfinite(dists).all(),
              f"{what}: search_many returned {ids.shape} / non-finite "
              "distances")
        if first_ids is None:
            first_ids = ids
    qb = queries[N_PROBE:N_PROBE + BATCH]
    batch_sims = matrix.prepare_queries(qb) @ stored.T
    batch_sims[:, dead] = -np.inf
    batch_oracle = top_rows(batch_sims, K)
    batch_rows = np.vectorize(part.pos.__getitem__)(first_ids.astype(np.int64))
    batch_recall = float(np.mean([
        len(set(batch_rows[j].tolist()) & set(batch_oracle[j].tolist())) / K
        for j in range(BATCH)
    ]))
    median = float(np.median(batch_ms))
    rerank = float(np.median(rerank_ms))
    log(f"{what} search_many B={BATCH}: median {median:.3f} ms/batch max "
        f"{max(batch_ms):.3f} (n={N_BATCHES}), {BATCH / median * 1e3:.0f} "
        f"QPS, recall@{K} {batch_recall:.4f}; host re-rank median "
        f"{rerank:.3f} ms/batch")
    check(batch_recall >= recall_floor, f"{what}: batch recall@{K} "
          f"{batch_recall} < {recall_floor}")
    return {"recall": recall, "batch_recall": batch_recall,
            "batch_ms": median, "qps": BATCH / median * 1e3,
            "host_rerank_ms": rerank,
            "p50_ms": p50, "p90_ms": p90, "max_dist_err": worst,
            "first_rows": got_rows[0]}


def check_drop(engine, part, q: np.ndarray, rows_before: list,
               what: str) -> int:
    """Drop the top hit of ``q``; the next answer must not hold it.
    Returns the dropped row."""
    top_row = rows_before[0]
    top_id = int(part.id_table[top_row])
    write(engine, [{"N": {"Param": "ids"}}, "Drop"], {"ids": [top_id]},
          {"ids": {"Array": "I64"}})
    out = engine.execute_stored("vsearch", {"q": q.tolist(), "k": K})
    rows, _ = rows_of(out["hits"])
    check(top_row not in rows and len(rows) == K,
          f"{what}: dropped row {top_row} still answered: {rows}")
    check(len(set(rows) & set(rows_before[1:])) >= K - 2,
          f"{what}: answer after the drop lost the old answer's other hits")
    return top_row


def engine_phase(device: torch.device, n_rows: int = N_ROWS,
                 while_ingesting=None) -> dict:
    """The exact cell: ``n_rows`` ingested once, with the WAL on, into an
    engine with a data dir (``while_ingesting()``, if given, is started
    just before: the sweep library's build), its reads, a checkpoint
    whose data dir the serve phase recovers (a copy, returned under
    ``"serve"``; the drop, the edges and the mesh step that follow write
    only to this engine's own WAL), the graph reads and the mesh step."""
    import shutil
    import tempfile

    # the serve phase's load takes these queries too
    data, queries = make_dataset(n_rows, DIM,
                                 N_PROBE + max(N_BATCHES * BATCH, N_LOAD))
    tmp = tempfile.mkdtemp(prefix="helix-engine-")
    serve_tmp = tempfile.mkdtemp(prefix="helix-serve-")
    try:
        return engine_steps(device, n_rows, data, queries,
                            os.path.join(tmp, "data"),
                            os.path.join(serve_tmp, "data"), while_ingesting)
    except BaseException:
        shutil.rmtree(serve_tmp, ignore_errors=True)
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def engine_steps(device: torch.device, n_rows: int, data: np.ndarray,
                 queries: np.ndarray, data_dir: str, serve_dir: str,
                 while_ingesting) -> dict:
    import shutil

    # The mesh knobs are inert on a one-device mesh: the mesh step below
    # sets a virtual mesh to engage them.
    engine = new_engine(device, data_dir=data_dir, shard_threshold=1,
                        graph_shard_threshold=1)
    if while_ingesting is not None:
        while_ingesting()
    ingest_s = ingest(engine, data, 0, n_rows)
    log(f"ingest {n_rows} x {DIM} with the WAL on: {ingest_s:.1f} s "
        f"({n_rows / ingest_s:.0f} docs/s)")
    part = doc_partition(engine)
    matrix = part.matrix
    check(matrix.n == n_rows, f"matrix holds {matrix.n} rows, want {n_rows}")

    reset_launch_counts()
    t_up = time.perf_counter()
    matrix.device_arrays()
    matrix.data_device()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    upload_s = time.perf_counter() - t_up
    log(f"H2D upload (bf16 + f32 copies of {matrix.n} rows): {upload_s:.3f} s")
    res = serve_reads(engine, part, queries, [], recall_floor=0.99,
                      dist_tol=TOL, what="exact")
    # The serve phase's data dir: this state (the rows as ingested, no
    # drop, no edge), checkpointed and copied.
    t = time.perf_counter()
    engine.checkpoint()
    checkpoint_s = time.perf_counter() - t
    shutil.copytree(data_dir, serve_dir)
    snapshot_bytes = os.path.getsize(os.path.join(serve_dir, "snapshot.bin"))
    log(f"engine phase: checkpoint {checkpoint_s:.2f} s, snapshot "
        f"{snapshot_bytes} bytes, copied for the serve phase in "
        f"{time.perf_counter() - t - checkpoint_s:.2f} s")
    res["serve"] = {"tmp": os.path.dirname(serve_dir), "data_dir": serve_dir,
                    "n_rows": n_rows, "queries": queries,
                    "ingest_s": ingest_s, "checkpoint_s": checkpoint_s,
                    "snapshot_bytes": snapshot_bytes}
    dead = [check_drop(engine, part, queries[0], res["first_rows"], "exact")]
    counts = launch_counts()
    check_only_launched(device, counts, "bucket_scores", "engine phase")
    log(f"engine phase: launches {counts}")
    res["graph"] = engine_graph_phase(engine, part, queries[N_PROBE:], device)
    matrix.release_device()
    res.update(launches=counts["bucket_scores"], ingest_s=ingest_s,
               upload_s=upload_s)
    t = time.perf_counter()
    res["mesh"] = mesh_engine_step(engine, part, queries, dead, device, res)
    res["mesh"]["seconds"] = time.perf_counter() - t
    engine.persistence.close()  # no checkpoint: its dir is removed
    return res


# The ladder's steps: (rows reached, rung, knob, its values).  Under the
# 48 MiB budget at dim_pad 128: 250,000 rows fit int8 codes (33 MB) but
# not the exact copies; 500,000 rows fit packed int4 (34 MB) but not
# int8; 750,000 rows fit no device rung (int4 51 MB): host IVF.
LADDER_STEPS = (
    (LADDER_ROWS // 3, "int8", "HELIX_QUANT_RERANK", ("auto", "device")),
    (2 * LADDER_ROWS // 3, "int4", None, ("auto",)),
    (LADDER_ROWS, "ivf", "HELIX_IVF_BACKEND", ("auto", "device", "host")),
)
LADDER_KERNEL = {"int8": "i8_bucket_scores", "int4": "i4_bucket_scores",
                 "ivf": None}


def check_probe_cells(part, queries: np.ndarray, what: str) -> float:
    """The IVF probe on the device against a float64 numpy computation
    over the same centroids: each chosen cell scores within 1e-5 of the
    nprobe-th best (f32 and f64 may order near ties differently).
    Returns the largest shortfall."""
    from helix_tpu_torch.ops.ivf import probe_cells

    index = part.host_ivf
    nprobe = 32
    qs = part.matrix.prepare_queries(queries)
    got = probe_cells(index.centroids, torch.from_numpy(qs).to(
        index.centroids.device), nprobe=nprobe).cpu().numpy()
    sims = qs.astype(np.float64) @ index.centroids.cpu().numpy() \
        .astype(np.float64).T
    kth = -np.sort(-sims, axis=1)[:, nprobe - 1]
    chosen = np.take_along_axis(sims, got, axis=1)
    short = float(np.max(kth[:, None] - chosen))
    check(all(len(set(row)) == nprobe for row in got.tolist())
          and short <= 1e-5, f"{what}: probe cells off the f64 top-"
          f"{nprobe} by {short}")
    return short


def ladder_phase(device: torch.device, n_rows: int = LADDER_ROWS) -> dict:
    """The residency ladder under a device-memory budget: one engine
    ingests ``n_rows`` of the engine phase's generator; at a third of
    them the int8 rung serves (host re-rank, then
    ``HELIX_QUANT_RERANK=device``), at two thirds the int4 rung, at all of
    them the host-IVF rung (probe router on auto, then
    ``HELIX_IVF_BACKEND=device``, then ``host``).  A CPU rehearsal at a
    smaller ``n_rows`` scales the budget with it."""
    budget = LADDER_BUDGET * n_rows // LADDER_ROWS
    data, queries = make_dataset(n_rows, DIM, N_PROBE + N_BATCHES * BATCH)
    engine = new_engine(device, hbm_budget_bytes=budget)
    dead: list = []
    out: dict = {"launches": {}}
    lo = 0
    for full, rung, knob, modes in LADDER_STEPS:
        rows = full * n_rows // LADDER_ROWS
        ingest_s = ingest(engine, data, lo, rows)
        lo = rows
        part = doc_partition(engine)
        log(f"ladder: ingest to {rows} rows: {ingest_s:.1f} s (budget "
            f"{budget} bytes)")
        check(part._use_host_exact() is False
              and part._use_host_ivf() == (rung == "ivf")
              and part._use_quant() == (rung == "int8")
              and part._use_quant4() == (rung == "int4"),
              f"ladder at {rows}: int8 {part._use_quant()} int4 "
              f"{part._use_quant4()} host IVF {part._use_host_ivf()}, "
              f"want {rung}")
        reset_launch_counts()
        before = device_counts()
        for mode in modes:
            what = f"{rung} ({knob} {mode})" if knob else rung
            if knob:
                os.environ[knob] = mode
            if rung == "int8":
                check(part._quant_rerank_device() == (mode == "device"),
                      f"{what}: re-rank placement")
            step = device_counts()
            t = time.perf_counter()
            engine.execute_stored("vsearch", {"q": queries[0].tolist(),
                                              "k": K})
            first_ms = (time.perf_counter() - t) * 1e3
            log(f"{what}: first search after the change (quantize / fit + "
                f"upload) {first_ms:.1f} ms")
            if rung == "ivf" and mode == "auto":
                index = part.host_ivf
                out["ivf_build_s"] = index.build_seconds
                out["ivf_probe_short"] = check_probe_cells(
                    part, queries[:BATCH], what)
                log(f"{what}: IVF build {index.build_seconds:.2f} s "
                    f"({index.centroids.shape[0]} cells over {index.n} "
                    f"rows, centroids on {index.centroids.device}); probe "
                    f"cells equal to the f64 top-32 within "
                    f"{out['ivf_probe_short']:.3g}")
                check_device_ran(device, counts_since(before),
                                 ("kmeans_fit", "probe_cells"), what)
            res = serve_reads(
                engine, part, queries, dead,
                recall_floor=0.98 if rung == "int8" else 0.95,
                dist_tol=DEVICE_RERANK_TOL if mode == "device"
                and rung == "int8" else TOL,
                what=what)
            res["first_ms"] = first_ms
            if rung == "ivf":
                ran = counts_since(step)
                if mode != "host":
                    check_device_ran(device, ran, ("score_block",), what)
                check(mode != "host" or ran["score_block"] == 0,
                      f"{what}: the union was scored on the device")
                check(mode != "device" or part.host_ivf.last_path == "device",
                      f"{what}: last path {part.host_ivf.last_path}")
                check_device_ran(device, ran, ("probe_cells",), what)
                res["device_calls"] = ran
                log(f"{what}: CUDA calls {ran}, router runs "
                    f"{part.host_ivf.router.runs}")
            out[what] = res
        if knob:
            os.environ.pop(knob)
        if rung == "int8":
            out["mesh int8"] = mesh_int8_step(engine, part, queries, dead,
                                              device)
        dead.append(check_drop(engine, part, queries[0],
                               out[what]["first_rows"], what))
        check(part.matrix._device is None and part.matrix._device32 is None,
              f"ladder at {rows}: the exact tier uploaded past the budget")
        counts = launch_counts()
        kernel = LADDER_KERNEL[rung]
        if kernel is None:
            check(not any(counts.values()),
                  f"ladder {rung}: kernels launched: {counts}")
        else:
            check_only_launched(device, counts, kernel, f"ladder {rung}")
            out["launches"][kernel] = counts[kernel]
        mem = torch.cuda.memory_allocated(device) if device.type == "cuda" \
            else 0
        log(f"ladder {rung} at {rows} rows: launches {counts}, device "
            f"memory allocated {mem} bytes")
    return out


# -------------------------------------------------------------------- l2

# SIFT1M's form: bench.py's clustered components x map to
# min(255, rint(SIFT_SCALE * max(x, 0))), integers in [0, 255]; at 62
# the median row norm is ~515, where SIFT's descriptors (unit vectors
# scaled by 512, rounded to bytes) lie.
SIFT_SCALE = 62.0
# $distance on the l2 rungs: integer rows give integer distances up to
# 128 * 255^2 < 2^24, exact in f32 on every rung (bf16 and f16 hold
# integers <= 255 exactly); the relative bound leaves room for one f32
# rounding of a sum in another order.
L2_RTOL = 1e-6
# The residency ladder over one 1M-row l2 index, walked by lowering the
# partition's budget (bytes at N_ROWS rows, scaled with a rehearsal's
# row count; per row at dim_pad 128 the exact copies take 768 B, int8
# with the f16 re-rank copy 392 B, int8 132 B, int4 68 B), with each
# rung's recall@10 floor.
L2_RUNGS = (
    ("exact", None, 0.99),
    ("int8, device re-rank", 400_000_000, 0.98),
    ("int8, host re-rank", 200_000_000, 0.98),
    ("int4", 100_000_000, 0.95),
    ("host-exact", 60_000_000, 1.0),
)
# B=256 batches per rung; a host-exact batch is a [256, N] f32 product
# and selection on the host, so that rung runs fewer.
L2_HOST_BATCHES = 3


def sift_dataset(n: int, d: int, n_queries: int, seed: int = 42):
    """SIFT-shaped l2 data: :func:`clustered`'s rows and queries mapped
    component by component to ``min(255, rint(SIFT_SCALE * max(x, 0)))``
    (float32 holding integers in [0, 255]), not normalised."""
    data, queries = clustered(n, d, n_queries, seed)
    for a in (data, queries):
        np.maximum(a, 0.0, out=a)
        a *= SIFT_SCALE
        np.rint(a, out=a)
        np.minimum(a, 255.0, out=a)
    return data, queries


def l2_kth(data: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """The exact (float64) k-th smallest squared distance of each query
    over every row."""
    x64 = data.astype(np.float64)
    sq = np.einsum("nd,nd->n", x64, x64)
    out = np.empty(len(queries))
    for s in range(0, len(queries), 64):
        q = queries[s:s + 64].astype(np.float64)
        dist = sq[None, :] - 2.0 * (q @ x64.T) \
            + np.einsum("bd,bd->b", q, q)[:, None]
        out[s:s + 64] = np.partition(dist, k - 1, axis=1)[:, k - 1]
    return out


def l2_check_hits(data: np.ndarray, q: np.ndarray, rows: list, dists: list,
                  kth: float, what: str) -> tuple[int, float]:
    """K distinct rows, each ``$distance`` within L2_RTOL of the exact
    float64 squared distance; returns how many lie within the oracle's
    k-th distance (tie-aware recall: a row at the k-th distance is a
    right answer) and the worst relative error."""
    check(len(rows) == K and len(set(rows)) == K,
          f"{what}: rows {rows}")
    exact = ((data[rows].astype(np.float64) - q.astype(np.float64)) ** 2) \
        .sum(axis=1)
    err = float(np.max(np.abs(np.asarray(dists) - exact)
                       / np.maximum(exact, 1.0)))
    check(err <= L2_RTOL, f"{what}: $distance off by {err} (relative)")
    return int(np.sum(exact <= kth)), err


def l2_rung(part) -> str:
    """The rung ``Partition.search_many_async`` takes, in its order."""
    if part._use_host_exact():
        return "host-exact"
    if part._use_quant():
        return ("int8, device re-rank" if part._quant_rerank_device()
                else "int8, host re-rank")
    if part._use_quant4():
        return "int4"
    return "exact"


def l2_reads(engine, part, data: np.ndarray, queries: np.ndarray,
             kth: np.ndarray, n_batches: int, what: str,
             floor: float) -> tuple[dict, list]:
    """N_PROBE single reads (``execute_stored`` and ``execute`` in turn)
    and ``n_batches`` B=256 ``Partition.search_many`` batches over fresh
    queries, held to the float64 oracle: recall@K tie-aware against
    ``kth`` (the probe queries', then the first batch's), ``$distance``
    within L2_RTOL; recall below ``floor`` fails.  Returns the metrics
    and the singles' hits."""
    probe = queries[:N_PROBE]
    hits, latencies, right, worst = [], [], 0, 0.0
    for j in range(N_PROBE):
        t = time.perf_counter()
        if j % 2:
            out = engine.execute(search_request(probe[j]))
        else:
            out = engine.execute_stored("vsearch", {"q": probe[j].tolist(),
                                                    "k": K})
        latencies.append((time.perf_counter() - t) * 1e3)
        rows, dists = rows_of(out["hits"])
        good, err = l2_check_hits(data, probe[j], rows, dists, kth[j],
                                  f"{what} read {j}")
        right += good
        worst = max(worst, err)
        hits.append([(h["$id"], h["$distance"]) for h in out["hits"]])
    recall = right / (N_PROBE * K)
    batch_ms, rerank_ms = [], []
    batch_right = 0
    for b in range(n_batches):
        qb = queries[N_PROBE + b * BATCH:N_PROBE + (b + 1) * BATCH]
        with HostRerankClock() as clock:
            t = time.perf_counter()
            ids, dists = part.search_many(qb, K)
            batch_ms.append((time.perf_counter() - t) * 1e3)
        rerank_ms.append(clock.ms)
        check(ids.shape == (BATCH, K) and np.isfinite(dists).all(),
              f"{what}: search_many returned {ids.shape} / non-finite "
              "distances")
        if b == 0:
            rows = np.vectorize(part.pos.__getitem__)(ids.astype(np.int64))
            for j in range(BATCH):
                good, err = l2_check_hits(
                    data, qb[j], rows[j].tolist(), dists[j].tolist(),
                    kth[N_PROBE + j], f"{what} batch row {j}")
                batch_right += good
                worst = max(worst, err)
    batch_recall = batch_right / (BATCH * K)
    median = float(np.median(batch_ms))
    p50, p90 = (float(np.percentile(latencies, p)) for p in (50, 90))
    res = {"recall": recall, "batch_recall": batch_recall,
           "batch_ms": median, "qps": BATCH / median * 1e3,
           "host_rerank_ms": float(np.median(rerank_ms)),
           "batches": n_batches, "p50_ms": p50, "p90_ms": p90,
           "max_rel_dist_err": worst}
    log(f"l2 {what}: single reads p50 {p50:.3f} ms p90 {p90:.3f} ms "
        f"(n={N_PROBE}), recall@{K} {recall:.4f}; search_many B={BATCH} "
        f"median {median:.3f} ms (n={n_batches}) {res['qps']:.0f} QPS, "
        f"recall@{K} {batch_recall:.4f}, host re-rank median "
        f"{res['host_rerank_ms']:.3f} ms; max relative $distance error "
        f"{worst:.3g}")
    check(recall >= floor and batch_recall >= floor,
          f"l2 {what}: recall@{K} {recall} / {batch_recall} < {floor}")
    return res, hits


def l2_select_split(part, qb: np.ndarray, device: torch.device) -> dict:
    """The exact rung's B=256 device step at the search's own shapes,
    timed apart with CUDA events: the single-shot scores ``2 q.x -
    |x|^2`` over every padded row (``distance.l2_scores``: the kernel
    ``csrc/l2_scores.cu``), the selection of ``rerank * k_bucket``
    candidates from them (``distance._top_k``: the selection kernel),
    and ``topk_resident`` whole (scores, selection, f32 re-rank).

    The kernel is held to its plain version bit for bit (SIFT's integer
    rows keep every sum exact in f32, whatever its order) and timed
    against it; ``kernel`` holds the ``kernels`` line's numbers.  The
    plain version is the library calls the step made before the kernel
    (the bf16 -> f32 cast, an f32 ``matmul``, three elementwise passes),
    so it is the library time too."""
    from helix_tpu_torch.ops.distance import (SINGLE_SHOT_BYTES, _top_k,
                                              l2_scores, l2_scores_reference,
                                              topk_resident)

    matrix = part.matrix
    xs16, sq = matrix.device_arrays()
    xs32 = matrix.data_device()
    qs = torch.from_numpy(matrix.prepare_queries(qb)).to(device)
    qs16 = qs.to(torch.bfloat16)
    n, rows = matrix.n, int(xs16.shape[0])
    d = int(xs16.shape[1])
    check(BATCH * rows * 4 <= SINGLE_SHOT_BYTES,
          f"l2 exact: [{BATCH}, {rows}] scores take the chunked scan")
    k_bucket = max(16, 1 << (K - 1).bit_length())  # search_packed_async's
    k_scan = 8 * k_bucket

    def scores():
        return l2_scores(xs16, qs.to(torch.bfloat16), sq, n)

    sims = scores()
    want = l2_scores_reference(xs16, qs16, sq, n)
    check(torch.equal(sims.view(torch.int32), want.view(torch.int32)),
          f"l2_scores differs from its plain version at [{BATCH}, {rows}, "
          f"{d}] with n_valid={n}")
    max_err = float((sims[:, :n] - want[:, :n]).abs().max().item())
    del want
    t = time_sides({"kernel": l2_scores, "plain": l2_scores_reference},
                   [(xs16, qs16, sq, n)] * 3)
    b_ms, b_by = bound(rows * d * 2 + rows * 4 + BATCH * d * 2
                       + BATCH * rows * 4, 2.0 * rows * d * BATCH,
                       PEAK_BF16_PER_S)
    log(f"kernel l2_scores N={rows} D={d} B={BATCH} n_valid={n}: equal to "
        f"its plain version bit for bit; {t['kernel']:.4f} ms (plain "
        f"{t['plain']:.4f} ms, bound {b_ms:.4f} ms by {b_by}: "
        f"{b_ms / t['kernel']:.1%} of the bound)")
    out = {"rows": rows, "k_scan": k_scan,
           "kernel": {"max_abs_err": max_err, "ms": t["kernel"],
                      "plain_ms": t["plain"], "library_ms": t["plain"],
                      "bound_ms": b_ms, "bound_by": b_by}}
    for name, fn, args, kw in (
            ("scores_ms", scores, (), {}),
            ("select_ms", _top_k, (sims, k_scan), {}),
            ("topk_resident_ms", topk_resident, (xs16, xs32, qs, n, sq),
             {"k": k_bucket, "metric": "l2"})):
        cuda_ms(fn, *args, **kw)  # warm-up
        out[name] = float(np.median([cuda_ms(fn, *args, **kw)
                                     for _ in range(5)]))
    return out


def l2_gateway_step(gateway, queries: np.ndarray, want: list,
                    device: torch.device) -> dict:
    """The exact l2 index served by ``NativeGateway(metric="l2")``:
    N_PROBE sequential ``vfast`` requests on one keep-alive connection,
    each riding the vector fast path (``fast_requests``, no interpreter
    fallback) and answering exactly what the engine answered in process
    (``$id`` and ``$distance``)."""
    import http.client

    gateway.start()
    port = gateway.port
    status, installed = http_json(port, "POST", "/v1/bundle", serve_bundle())
    check(status == 200 and "vfast" in installed["installed"],
          f"l2 gateway: bundle install {status} {installed}")
    fallbacks: list = []
    slow_fallback = gateway._respond_slow_fallback

    def counted_fallback(*args, **kwargs):
        fallbacks.append(args[0])
        return slow_fallback(*args, **kwargs)

    gateway._respond_slow_fallback = counted_fallback
    fast0 = gateway.stats()["fast_requests"]
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT)
    latencies = []
    try:
        for j, q in enumerate(queries[:N_PROBE]):
            t = time.perf_counter()
            status, out = http_json(port, "POST", "/v1/query/vfast",
                                    {"q": q.tolist(), "k": K}, conn=conn)
            latencies.append((time.perf_counter() - t) * 1e3)
            got = [(h["$id"], h["$distance"]) for h in out["hits"]] \
                if status == 200 else out
            check(got == want[j], f"l2 gateway request {j}: {got} != "
                  f"in process {want[j]}")
    finally:
        conn.close()
        del gateway._respond_slow_fallback
    fast = gateway.stats()["fast_requests"] - fast0
    check(fast == N_PROBE and not fallbacks,
          f"l2 gateway: fast_requests +{fast}, {len(fallbacks)} answered "
          "by the interpreter")
    p50, p90 = (float(np.percentile(latencies, p)) for p in (50, 90))
    log(f"l2 gateway (NativeGateway(metric='l2') on {device}): vfast p50 "
        f"{p50:.3f} ms p90 {p90:.3f} ms (n={N_PROBE}), answers equal to "
        f"the in-process reads, fast_requests +{fast}")
    return {"p50_ms": p50, "p90_ms": p90, "fast_requests": fast}


def l2_phase(device: torch.device, n_rows: int = N_ROWS) -> dict:
    """SIFT1M's deployment: ``n_rows`` x 128 SIFT-shaped rows
    (:func:`sift_dataset`), Euclidean, k=10, B=256 batches and B=1
    reads, served by ``NativeGateway(metric="l2")``'s engine.  One ingest;
    the rungs are walked by lowering the partition's ``hbm_budget_bytes``
    (L2_RUNGS, scaled with ``n_rows``), each checked for the rung it
    took, recall@10 (tie-aware, float64 oracle) at its floor, relative
    ``$distance``, the first search after the change, single-read p50 /
    p90 and the B=256 median.  No bucket-scores kernel may launch: the
    reference fuses cosine only.  ``csrc/l2_scores.cu`` launches once a
    search on the exact rung and never below it.  The exact rung's score
    kernel is held to its plain version and, with the selection, timed
    apart (:func:`l2_select_split`); then the gateway serves the exact
    index over HTTP (:func:`l2_gateway_step`)."""
    from helix_tpu_torch.ops import distance as D
    from helix_tpu_torch.server.native_gateway import NativeGateway

    data, queries = sift_dataset(n_rows, DIM, N_PROBE + N_BATCHES * BATCH)
    norms = np.linalg.norm(data, axis=1)
    log(f"l2: {n_rows} x {DIM} SIFT-shaped rows (integers in [0, 255]), "
        f"median row norm {np.median(norms):.1f}, zero components "
        f"{np.mean(data == 0):.3f}")
    t = time.perf_counter()
    kth = l2_kth(data, queries[:N_PROBE + BATCH], K)
    oracle_s = time.perf_counter() - t
    # the engine's batch window off, as in the other phases' engines
    # (the fast path batches in the gateway's vbatch loop either way)
    gateway = NativeGateway(host="127.0.0.1", port=0, metric="l2",
                            batch_window_ms=None, device=str(device))
    out: dict = {"oracle_s": oracle_s}
    try:
        engine = with_search_route(gateway.engine)
        out["ingest_s"] = ingest(engine, data, 0, n_rows)
        part = doc_partition(engine)
        check(part.metric == "l2" and part.matrix.n == n_rows,
              f"l2: partition {part.metric} with {part.matrix.n} rows")
        log(f"l2: ingest {n_rows} x {DIM}: {out['ingest_s']:.1f} s; oracle "
            f"(float64 k-th distances) {oracle_s:.1f} s")
        reset_launch_counts()
        exact_hits = None
        # csrc/l2_scores.cu's launches on each rung, set to 0 just before
        # it and read just after its reads: one a search on the exact
        # rung (the first search, the singles, the batches), none below
        l2_launches: dict = {}
        for rung, budget, floor in L2_RUNGS:
            D.l2_scores.launches = 0
            part.hbm_budget_bytes = None if budget is None \
                else budget * n_rows // N_ROWS
            taken = l2_rung(part)
            log(f"l2 {rung}: budget {part.hbm_budget_bytes} bytes, rung "
                f"taken {taken} (int4 recall gate admits: "
                f"{part._quant4_recall_serving()})")
            check(taken == rung, f"l2: budget {part.hbm_budget_bytes} took "
                  f"{taken}, want {rung}")
            t = time.perf_counter()
            engine.execute_stored("vsearch", {"q": queries[0].tolist(),
                                              "k": K})
            first_ms = (time.perf_counter() - t) * 1e3
            res, hits = l2_reads(
                engine, part, data, queries, kth,
                L2_HOST_BATCHES if rung == "host-exact" else N_BATCHES, rung,
                floor)
            res["first_ms"] = first_ms
            l2_launches[rung] = D.l2_scores.launches
            log(f"l2 {rung}: first search after the change {first_ms:.1f} ms"
                f", l2_scores launches {l2_launches[rung]}")
            if device.type == "cuda":
                want = 1 + N_PROBE + N_BATCHES if rung == "exact" else 0
                check(l2_launches[rung] == want,
                      f"l2 {rung}: l2_scores launched {l2_launches[rung]} "
                      f"times, want {want}")
            if rung == "exact":
                exact_hits = hits
                if device.type == "cuda":
                    split = l2_select_split(part, queries[N_PROBE:N_PROBE
                                                          + BATCH], device)
                    split["share_of_batch"] = split["select_ms"] \
                        / res["batch_ms"]
                    res["split"] = split
                    log(f"l2 exact B={BATCH} device step on "
                        f"{card_name(device)}: scores {split['scores_ms']:.3f}"
                        f" ms, selection of top-{split['k_scan']} from "
                        f"[{BATCH}, {split['rows']}] f32 "
                        f"{split['select_ms']:.3f} ms, topk_resident "
                        f"{split['topk_resident_ms']:.3f} ms; the selection "
                        f"is {split['share_of_batch']:.1%} of the "
                        f"search_many median")
            out[rung] = res
        counts = launch_counts()
        check(not any(counts.values()),
              f"l2: bucket-scores kernels launched: {counts}")
        out["launches"] = counts
        part.hbm_budget_bytes = None
        check(l2_rung(part) == "exact", "l2: the budget did not lift")
        D.l2_scores.launches = 0
        out["gateway"] = l2_gateway_step(gateway, queries, exact_hits,
                                         device)
        l2_launches["gateway"] = D.l2_scores.launches
        if device.type == "cuda":
            check(0 < l2_launches["gateway"] <= N_PROBE,
                  f"l2 gateway: {N_PROBE} requests, l2_scores launched "
                  f"{l2_launches['gateway']} times")
        out["l2_scores_launches"] = l2_launches
        counts = launch_counts()
        check(not any(counts.values()),
              f"l2 gateway: bucket-scores kernels launched: {counts}")
        log(f"l2: bucket-scores launches over the phase {counts}")
    finally:
        gateway.stop()
    return out


# ----------------------------------------------------------------- graph


def device_counts() -> dict:
    """Calls of the device ops (torch ops, no hand kernel) on CUDA
    tensors, beside the kernels' launch counts."""
    from helix_tpu_torch.ops import bm25, csr, ivf

    return {"khop_mask": csr.khop_mask.cuda_calls,
            "bm25_scores": bm25.bm25_scores.cuda_calls,
            "kmeans_fit": ivf.kmeans_fit.cuda_calls,
            "probe_cells": ivf.probe_cells.cuda_calls,
            "score_block": ivf.score_block.cuda_calls}


def counts_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in device_counts().items()}


def check_device_ran(device: torch.device, ran: dict, ops: tuple,
                     what: str) -> None:
    """Each op of ``ops`` ran on CUDA tensors in the step (on the card;
    a CPU rehearsal counts nothing)."""
    if device.type != "cuda":
        return
    missing = [op for op in ops if not ran[op]]
    check(not missing, f"{what}: no CUDA calls of {missing} ({ran})")


def graph_ops_phase(device: torch.device, seeds: list,
                    n: int = GRAPH_NODES) -> dict:
    """``bench.py``'s traversal shape (BASELINE configs[2] and [3]): a
    random graph of ``n`` nodes and degree 16 over 4 labels; labeled
    2-hop from 0.1% start masks kept by a 50% filter, and a 1-hop
    expansion of the exact search's top-k.  The port's ``khop_mask`` /
    ``khop_count`` / ``hybrid_expand`` on the device against
    ``helix_tpu_torch.native.bfs_khop``: masks and counts equal.  The
    card's times for these reads are ``bench_torch.py``'s (the bench
    phase's ``traversal_2hop_*`` and ``hybrid_seed_expand_*`` keys)."""
    from helix_tpu_torch import native
    from helix_tpu_torch.ops import csr as C

    rng = np.random.default_rng(5)
    dst = rng.integers(0, n, size=n * GRAPH_DEGREE).astype(np.int32)
    lab = rng.integers(0, GRAPH_LABELS, size=n * GRAPH_DEGREE) \
        .astype(np.int32)
    indptr = np.arange(n + 1, dtype=np.int64) * GRAPH_DEGREE
    keep_h = rng.random(n) < 0.5
    starts_h = [rng.random(n) < 0.001 for _ in range(4)]
    t = time.perf_counter()
    graph = C.PaddedGraph.from_csr(indptr, dst, lab, n, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"graph ops: {n} nodes, {n * GRAPH_DEGREE} edges, padded "
        f"[{graph.n}, {graph.p}] int32 x2 ({graph.n * graph.p * 8} bytes) "
        f"built + uploaded in {time.perf_counter() - t:.2f} s")
    keep = torch.from_numpy(keep_h).to(device)
    starts = [torch.from_numpy(s).to(device) for s in starts_h]
    before = device_counts()
    C.TIER_HOPS.update({4096: 0, 65536: 0, "dense": 0})

    def native_mask(start_h, code, hops):
        mask, _ = native.bfs_khop(indptr, dst, lab, start_h.astype(np.uint8),
                                  code, hops)
        return mask.astype(bool)

    counts = []
    for start_h, start in zip(starts_h, starts):
        for code, hops in ((-1, 3), (-1, 2), (1, 2)):
            got = C.khop_mask(graph.neighbors, graph.edge_labels, start,
                              code, hops).cpu().numpy()
            want = native_mask(start_h, code, hops)
            check(np.array_equal(got, want),
                  f"khop_mask code={code} hops={hops}: "
                  f"{int((got != want).sum())} slots differ from bfs_khop")
        count = int(C.khop_count(graph.neighbors, graph.edge_labels, start,
                                 1, 2, keep))
        want_count = int(want[keep_h].sum())   # the labeled 2-hop's mask
        check(count == want_count,
              f"khop_count {count} vs bfs_khop {want_count}")
        counts.append(count)
    seed_h = np.zeros(n, bool)
    seed_h[seeds] = True
    seed_t = torch.tensor(seeds + [n] * (16 - len(seeds)), dtype=torch.int32,
                          device=device)
    h_mask, h_count = C.hybrid_expand(graph.neighbors, graph.edge_labels,
                                      seed_t, -1, 1, keep)
    h_want = native_mask(seed_h, -1, 1) & keep_h
    check(np.array_equal(h_mask.cpu().numpy(), h_want)
          and int(h_count) == int(h_want.sum()),
          f"hybrid_expand: count {int(h_count)} vs bfs_khop "
          f"{int(h_want.sum())}")
    log(f"graph ops: labeled 2-hop counts {counts} equal to bfs_khop, masks "
        f"equal (labeled and unlabeled 2-hop); hybrid 1-hop of {len(seeds)} "
        f"seeds: {int(h_count)} nodes, equal; hop tiers {C.TIER_HOPS}")
    ran = counts_since(before)
    check_device_ran(device, ran, ("khop_mask",), "graph ops")

    return {"counts_2hop": counts, "hybrid_count": int(h_count),
            "khop_mask_calls": ran["khop_mask"]}


def edge_request(label: str, items: list) -> dict:
    """One write batch: each item links ``src`` to every id in ``dst``
    with a ``label`` edge."""
    return {
        "request_type": "write", "query_name": "edges",
        "query": {"queries": [{"ForEach": {"param": "e", "body": [
            {"Query": {"name": "x", "steps": [
                {"N": {"Param": "e.src"}},
                {"AddE": {"label": label, "to": {"Param": "e.dst"},
                          "properties": []}}], "condition": None}}]}}],
            "returns": []},
        "parameters": {"e": items},
        "parameter_types": {"e": {"Array": "Object"}},
    }


def add_edges(engine, ids: np.ndarray, src_rows: np.ndarray,
              targets: np.ndarray, rng) -> int:
    """``ENGINE_DEGREE`` edges from each source row to random target
    rows, under one of ``GRAPH_LABELS`` labels each, as one write batch
    per label.  Returns the number of edges written."""
    dst = targets[rng.integers(0, len(targets),
                               size=(len(src_rows), ENGINE_DEGREE))]
    lab = rng.integers(0, GRAPH_LABELS, size=(len(src_rows), ENGINE_DEGREE))
    src_ids = ids[src_rows].tolist()
    dst_ids = ids[dst]
    for code in range(GRAPH_LABELS):
        sel = lab == code
        items = [{"src": s, "dst": d[m].tolist()}
                 for s, d, m in zip(src_ids, dst_ids, sel) if m.any()]
        engine.execute(edge_request(f"L{code}", items))
    return int(dst.size)


def _lt(prop: str, value: int) -> dict:
    return {"Lt": [prop, {"I64": value}]}


GRAPH_QUERIES = {
    "labeled 2-hop + where": [
        {"NWhere": _lt("i", 2000)}, {"Out": "L1"}, {"Out": "L1"},
        {"Where": {"Gt": ["i", {"I64": 500_000}]}}, "Dedup", "Count"],
    "in + both (labeled)": [
        {"NWhere": _lt("i", 500)}, {"In": None}, {"Both": "L2"}, "Dedup",
        "Exists"],
    "both x2": [
        {"NWhere": _lt("i", 1000)}, {"Both": None}, {"Both": None}, "Dedup",
        "Count"],
    "order-by tail": [
        {"NWhere": _lt("i", 300)}, {"Out": "L0"}, {"Out": None}, "Dedup",
        {"OrderBy": ["i", "Desc"]}, {"Limit": 50}, {"Values": ["i"]}],
}


def hybrid_query(hops: list) -> list:
    return [{"VectorSearchNodes": {
        "label": "Doc", "property": "emb",
        "query_vector": {"Expr": {"Param": "q"}},
        "k": {"Expr": {"Param": "k"}}}}] + hops + ["Dedup", "Count"]


def read_request(steps: list, params: dict | None = None,
                 types: dict | None = None) -> dict:
    return {"request_type": "read", "query_name": "r", "query": {
        "queries": [{"Query": {"name": "r", "steps": steps,
                               "condition": None}}], "returns": ["r"]},
        "parameters": params or {}, "parameter_types": types or {}}


def engine_graph_phase(engine, part, queries: np.ndarray,
                       device: torch.device) -> dict:
    """``ENGINE_EDGES`` labeled edges into the exact phase's engine
    through write batches, then set-reduced traversals and hybrid reads
    through ``execute``, each once to warm up and then with
    ``HELIX_TRAVERSAL_BACKEND`` forced to ``device``, to ``native``,
    then ``auto``: the answers must be equal byte for byte."""
    from helix_tpu_torch.engine.exec import Executor

    rng = np.random.default_rng(6)
    ids = part.id_table.astype(np.int64)
    live = np.nonzero(part.live_mask)[0]
    n = len(live)
    n_src = min(n, ENGINE_EDGES // ENGINE_DEGREE)
    t0 = time.perf_counter()
    done = 0
    for lo in range(0, n_src, EDGE_CHUNK):
        done += add_edges(engine, ids, live[lo:min(n_src, lo + EDGE_CHUNK)],
                          live, rng)
    ingest_s = time.perf_counter() - t0
    log(f"engine graph: {done} labeled edges over {n} nodes in "
        f"{ingest_s:.1f} s ({done / ingest_s:.0f} edges/s)")
    t = time.perf_counter()
    snap = engine.snapshots.get()
    graphs = [snap.padded_graph(d) for d in ("out", "in")]
    check(all(g is not None and g.neighbors.device.type == device.type
              for g in graphs), "padded_graph: no device adjacency")
    log(f"engine graph: snapshot + padded adjacency (out [{graphs[0].n}, "
        f"{graphs[0].p}], in [{graphs[1].n}, {graphs[1].p}]) "
        f"{time.perf_counter() - t:.1f} s")

    reads = {name: read_request(steps) for name, steps in
             GRAPH_QUERIES.items()}
    for j, hops in enumerate(([{"Out": None}],
                              [{"Out": None}, {"Out": "L1"}])):
        reads[f"hybrid {len(hops)}-hop"] = read_request(
            hybrid_query(hops), {"q": queries[j].tolist(), "k": K},
            {"q": {"Array": "F32"}, "k": "I64"})
    check(Executor.device_traversal_min_nodes <= snap.n_nodes,
          "the planner's size floor would route these reads to the host")
    out = {"edges": done, "edge_ingest_s": ingest_s, "reads": {},
           "requests": reads, "answers": {}}
    for name, request in reads.items():
        engine.execute(request)  # warm-up: property columns, source index
        answers, ms = {}, {}
        for backend in ("device", "native", "auto"):
            os.environ["HELIX_TRAVERSAL_BACKEND"] = backend
            before = device_counts()
            runs = dict(engine._traversal_router.runs)
            t = time.perf_counter()
            answers[backend] = json.dumps(engine.execute(request))
            ms[backend] = (time.perf_counter() - t) * 1e3
            router = engine._traversal_router
            if backend != "auto":
                check(router.runs[backend] == runs[backend] + 1,
                      f"{name}: the {backend} path did not serve")
            if backend == "device":
                check_device_ran(device, counts_since(before),
                                 ("khop_mask",), name)
        os.environ.pop("HELIX_TRAVERSAL_BACKEND")
        check(len(set(answers.values())) == 1,
              f"{name}: answers differ across backends: {answers}")
        out["answers"][name] = answers["device"]
        log(f"engine graph {name}: {answers['device'][:60]} equal on device "
            f"/ native / auto; wall {ms['device']:.1f} / {ms['native']:.1f} "
            f"/ {ms['auto']:.1f} ms")
        out["reads"][name] = ms
    router = engine._traversal_router
    for _ in range(4):  # let auto settle on measurements of both paths
        for request in reads.values():
            engine.execute(request)
    log(f"engine graph: router runs {router.runs}, EWMA ms "
        f"{ {k: round(v, 3) for k, v in router.ewma.items()} }, settles on "
        f"{min(router.ewma, key=router.ewma.get)}")
    out["router_ewma_ms"] = dict(router.ewma)
    return out


# ------------------------------------------------------------------ text

TEXT_WORDS = (
    "graph vector database search engine tpu index query latency "
    "throughput node edge embedding text score rank shard mesh"
).split()
TEXT_QUERIES = ("graph vector", "tpu index latency", "score",
                "shard mesh rank node", "database search engine query text",
                " ".join(TEXT_WORDS[:16]))


def text_corpus(n_docs: int) -> list[str]:
    """``tests/test_bm25_device.py``'s generator (seed 4): docs of 3-29
    words drawn from 18 words, doc i+1 = entry i."""
    rng = np.random.default_rng(4)
    return [" ".join(rng.choice(TEXT_WORDS, int(rng.integers(3, 30))))
            for _ in range(n_docs)]


def text_phase(device: torch.device, n_docs: int = N_TEXT_DOCS) -> dict:
    """A text index through the engine at the largest corpus of the
    test generator whose postings still fit ``DevicePostings``' cap
    (65,536 per term), queried with ``TextSearchNodes``: the device path
    against the host path of the same partition (read by raising its
    ``device_threshold``), ids equal, scores within rtol 1e-5, both
    timed."""
    from helix_tpu_torch.engine import Engine
    from helix_tpu_torch.ops.bm25 import DevicePostings

    engine = Engine(device=device)
    write(engine, [{"CreateIndex": {"spec": {"NodeText": {
        "label": "Doc", "property": "body", "tenant_property": None,
    }}, "if_not_exists": True}}], {}, {})
    texts = text_corpus(n_docs)
    t = time.perf_counter()
    for lo in range(0, n_docs, INGEST_CHUNK):
        engine.execute({
            "request_type": "write", "query_name": "ingest",
            "query": {"queries": [{"ForEach": {"param": "docs", "body": [
                {"Query": {"name": "d", "steps": [{"AddN": {
                    "label": "Doc", "properties": [
                        ["i", {"Expr": {"Param": "docs.i"}}],
                        ["body", {"Expr": {"Param": "docs.body"}}]]}}],
                    "condition": None}}]}}], "returns": []},
            "parameters": {"docs": [
                {"i": i, "body": texts[i]}
                for i in range(lo, min(n_docs, lo + INGEST_CHUNK))]},
            "parameter_types": {"docs": {"Array": "Object"}},
        })
    ingest_s = time.perf_counter() - t
    part = engine.texts.indexes[("NodeText", "Doc", "body")] \
        .partitions[("",)]
    p = max(len(b) for b in part.postings.values())
    t_terms = len(part.postings)
    log(f"text: {n_docs} docs ingested in {ingest_s:.1f} s; T={t_terms} "
        f"terms, P={p} (cap 65536), padded postings {t_terms * p * 8} bytes")
    check(len(part.doc_len) == n_docs and n_docs >= part.device_threshold,
          "text: the corpus is below the device threshold")

    def read(query: str) -> dict:
        return read_request([
            {"TextSearchNodes": {"label": "Doc", "property": "body",
                                 "query_text": {"Expr": {"Param": "q"}},
                                 "k": {"Expr": {"Param": "k"}}}},
            {"ValueMap": ["$id", "$score", "i"]}],
            {"q": query, "k": K}, {"q": "String", "k": "I64"})

    before = device_counts()
    t = time.perf_counter()
    engine.execute(read(TEXT_QUERIES[0]))
    first_ms = (time.perf_counter() - t) * 1e3
    check(isinstance(part._device[1], DevicePostings),
          "text: DevicePostings.build returned None")
    log(f"text: first search (postings build + upload) {first_ms:.1f} ms")
    threshold = part.device_threshold
    dev_ms, host_ms = [], []
    for query in TEXT_QUERIES:
        answers = {}
        for path in ("device", "host", "device"):
            part.device_threshold = threshold if path == "device" else 10**9
            t = time.perf_counter()
            answers[path] = engine.execute(read(query))["r"]
            (dev_ms if path == "device" else host_ms).append(
                (time.perf_counter() - t) * 1e3)
        part.device_threshold = threshold
        dev, host = answers["device"], answers["host"]
        check([h["$id"] for h in dev] == [h["$id"] for h in host]
              and len(dev) == K,
              f"text {query!r}: device ids {[h['i'] for h in dev]} vs host "
              f"{[h['i'] for h in host]}")
        check(np.allclose([h["$score"] for h in dev],
                          [h["$score"] for h in host], rtol=1e-5, atol=0),
              f"text {query!r}: scores differ past rtol 1e-5")
    ran = counts_since(before)
    check_device_ran(device, ran, ("bm25_scores",), "text")
    res = {"docs": n_docs, "terms": t_terms, "postings_width": p,
           "ingest_s": ingest_s, "first_ms": first_ms,
           "device_ms": float(np.median(dev_ms)),
           "host_ms": float(np.median(host_ms)),
           "bm25_calls": ran["bm25_scores"]}
    log(f"text: {len(TEXT_QUERIES)} queries, device ids equal to the host "
        f"path's, scores within rtol 1e-5; TextSearchNodes read median: "
        f"device {res['device_ms']:.3f} ms, host {res['host_ms']:.3f} ms; "
        f"bm25_scores CUDA calls {ran['bm25_scores']}")
    res["mesh"] = mesh_text_step(engine, part, read, device)
    return res


# ------------------------------------------------------------------ mesh

# The mesh steps run on a virtual mesh of MESH_SHARDS shards on one card
# (every shard cuda:0), or over every card where there are more.  The
# mesh is a virtual one on one card, so its times claim no scaling.
MESH_SHARDS = 4


def mesh_size(device: torch.device) -> int:
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    return max(MESH_SHARDS, cards)


class CallCount:
    """Counts the calls of ``owner.name`` within the block."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.n = owner, name, 0

    def __enter__(self):
        self._original = getattr(self.owner, self.name)

        def counted(*args, **kwargs):
            self.n += 1
            return self._original(*args, **kwargs)

        setattr(self.owner, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self._original)


def mesh_engine_step(engine, part, queries: np.ndarray, dead: list,
                     device: torch.device, single: dict) -> dict:
    """The exact engine's mesh paths (its knobs are set; a virtual mesh
    engages them): single reads and B=256 ``search_many`` batches through
    ``Partition._search_sharded`` (kernel 1 once per shard per block of
    up to 256 queries), held to the numpy oracle as the one-device reads
    are; kernel 1 at one shard's shape against its plain version; the
    graph reads through ``Executor._run_sharded_traversal``, equal to
    the one-device answers byte for byte."""
    from helix_tpu_torch.ops import fused_topk as F
    from helix_tpu_torch.parallel import virtual_devices
    from helix_tpu_torch.parallel.graph import ShardedGraph

    n_mesh = mesh_size(device)
    what = f"mesh x{n_mesh} exact"
    with virtual_devices(device.type, n_mesh):
        reset_launch_counts()
        res = serve_reads(engine, part, queries, dead, recall_floor=0.99,
                          dist_tol=TOL, what=what)
        state = part._shard_state
        check(state is not None and state["kind"] == "exact",
              f"{what}: the sharded tier did not serve ({state})")
        searcher = next(iter(state["searchers"].values()))
        check(searcher.use_fused == (device.type == "cuda"),
              f"{what}: fused route {searcher.use_fused} on {device}")
        qb = queries[N_PROBE:N_PROBE + BATCH]
        per_call = {}
        for b in (BATCH, 1):
            before = F.bucket_scores.launches
            part.search_many(qb[:b], K)
            per_call[b] = F.bucket_scores.launches - before
        counts = launch_counts()
        check_only_launched(device, counts, "bucket_scores", what)
        blocks = -(-BATCH // F.MAX_QUERY_BLOCK)
        check(device.type != "cuda" or per_call == {
            BATCH: n_mesh * blocks, 1: n_mesh},
            f"{what}: kernel 1 launches per call {per_call}, want "
            f"{n_mesh * blocks} per batch and {n_mesh} per read")
        log(f"{what}: kernel 1 launches {counts['bucket_scores']} over the "
            f"step, {per_call[BATCH]} per B={BATCH} batch, {per_call[1]} "
            f"per single read; search_many median {res['batch_ms']:.3f} "
            f"ms/batch vs one device {single['batch_ms']:.3f} ms on "
            f"{card_name(device)} (a virtual mesh on one card: no scaling "
            "claimed)")

        # Kernel 1 at the last shard's shape (part padding) on a batch.
        xs, _, n_valid = state["arrays"]
        x32, x16 = xs[0][-1]
        if x16 is None:   # a CPU rehearsal's mesh scans in f32
            x16 = x32.to(torch.bfloat16)
        rows = x32.shape[0]
        local_valid = min(max(n_valid - (n_mesh - 1) * rows, 0), rows)
        q16 = torch.from_numpy(part.matrix.prepare_queries(qb)).to(
            x16.device, torch.bfloat16)
        err = compare_packed(F.bucket_scores(x16, q16, local_valid),
                             F.bucket_scores_reference(x16, q16,
                                                       local_valid),
                             masked_sims(x16, q16, local_valid), TOL)
        shard = {"rows": rows, "n_valid": local_valid, "max_abs_err": err}
        if device.type == "cuda":
            check(n_mesh != MESH_SHARDS or part.matrix.n != N_ROWS
                  or rows == 253_952, f"{what}: shard rows {rows}")
            shard.update(time_sides({
                "ms": F.bucket_scores, "plain_ms": F.bucket_scores_reference,
                "library_ms": lambda x, q, nv: torch.matmul(x, q.T)},
                [(x16, q16, local_valid)]))
            d = x16.shape[1]
            shard["bound_ms"], shard["bound_by"] = bound(
                rows * d * 2 + BATCH * d * 2 + rows // 64 * BATCH * 4,
                2.0 * rows * d * BATCH, PEAK_BF16_PER_S)
        log(f"{what}: kernel 1 at the shard shape N={rows} D={x16.shape[1]} "
            f"B={BATCH} n_valid={local_valid} agrees with its plain version "
            f"(max unpacked |err| {err:.3g}); {shard}")
        del q16, xs, x32, x16

        # The graph reads through the sharded traversal.
        graph = single["graph"]
        mesh_ms = {}
        with CallCount(ShardedGraph, "run") as runs:
            for name, request in graph["requests"].items():
                t = time.perf_counter()
                got = json.dumps(engine.execute(request))
                mesh_ms[name] = (time.perf_counter() - t) * 1e3
                check(got == graph["answers"][name],
                      f"mesh {name}: {got[:80]} vs one device "
                      f"{graph['answers'][name][:80]}")
        check(runs.n == len(graph["requests"]),
              f"mesh traversal: {runs.n} sharded runs for "
              f"{len(graph['requests'])} reads")
        log(f"mesh x{n_mesh} traversal: {runs.n} reads through "
            f"_run_sharded_traversal, answers equal to one device's; wall "
            f"ms {({k: round(v, 1) for k, v in mesh_ms.items()})} vs one "
            f"device {({k: round(v['device'], 1) for k, v in graph['reads'].items()})}")
    part._shard_state = None   # the shards' copies of the rows
    return {"shards": n_mesh, "launches": counts["bucket_scores"],
            "launches_per_batch": per_call[BATCH],
            "launches_per_read": per_call[1], "recall": res["recall"],
            "batch_recall": res["batch_recall"], "batch_ms": res["batch_ms"],
            "single_batch_ms": single["batch_ms"], "p50_ms": res["p50_ms"],
            "max_dist_err": res["max_dist_err"], "shard_kernel": shard,
            "traversal_ms": mesh_ms}


def mesh_int8_step(engine, part, queries: np.ndarray, dead: list,
                   device: torch.device) -> dict:
    """The ladder's int8 rung on the mesh: ``Partition._search_quant``
    routes to ``ShardedInt8Search`` (the int8 product per shard, no
    bucket-scores kernel, as in the reference), host re-rank then the
    per-shard f16 device re-rank, at recall@10 >= 0.98."""
    from helix_tpu_torch.parallel import virtual_devices

    n_mesh = mesh_size(device)
    before = launch_counts()
    out = {}
    start = time.perf_counter()
    with virtual_devices(device.type, n_mesh):
        for mode in ("host", "device"):
            what = f"mesh x{n_mesh} int8 (HELIX_QUANT_RERANK {mode})"
            os.environ["HELIX_QUANT_RERANK"] = mode
            check(part._use_quant() and part._quant_rerank_device_sharded(
                n_mesh) == (mode == "device"), f"{what}: rung or re-rank")
            res = serve_reads(engine, part, queries, dead, recall_floor=0.98,
                              dist_tol=TOL if mode == "host"
                              else DEVICE_RERANK_TOL, what=what)
            state = part._shard_state
            check(state is not None and state["kind"] == "int8",
                  f"{what}: sharded int8 did not serve")
            out[mode] = {k: res[k] for k in ("recall", "batch_recall",
                                             "batch_ms", "max_dist_err")}
        os.environ.pop("HELIX_QUANT_RERANK")
    check(launch_counts() == before,
          f"mesh int8: a bucket-scores kernel launched ({launch_counts()})")
    part._shard_state = None
    out["seconds"] = time.perf_counter() - start
    return out


def mesh_text_step(engine, part, read, device: torch.device) -> dict:
    """The text corpus on the mesh: the partition rebuilds its postings
    as ``ShardedBM25`` and each query's ids equal the host path's."""
    from helix_tpu_torch.ops.bm25 import ShardedBM25
    from helix_tpu_torch.parallel import virtual_devices

    n_mesh = mesh_size(device)
    threshold = part.device_threshold
    before = device_counts()
    mesh_ms = []
    start = time.perf_counter()
    with virtual_devices(device.type, n_mesh):
        part._device = None   # the one-device postings of this version
        t = time.perf_counter()
        engine.execute(read(TEXT_QUERIES[0]))
        build_ms = (time.perf_counter() - t) * 1e3
        check(isinstance(part._device[1], ShardedBM25),
              "mesh text: ShardedBM25.build did not serve")
        for query in TEXT_QUERIES:
            t = time.perf_counter()
            mesh = engine.execute(read(query))["r"]
            mesh_ms.append((time.perf_counter() - t) * 1e3)
            part.device_threshold = 10**9
            host = engine.execute(read(query))["r"]
            part.device_threshold = threshold
            check([h["$id"] for h in mesh] == [h["$id"] for h in host]
                  and len(mesh) == K, f"mesh text {query!r}: ids differ")
            check(np.allclose([h["$score"] for h in mesh],
                              [h["$score"] for h in host], rtol=1e-5, atol=0),
                  f"mesh text {query!r}: scores differ past rtol 1e-5")
    part._device = None
    ran = counts_since(before)
    check_device_ran(device, ran, ("bm25_scores",), "mesh text")
    res = {"build_ms": build_ms, "ms": float(np.median(mesh_ms)),
           "bm25_calls": ran["bm25_scores"],
           "seconds": time.perf_counter() - start}
    log(f"mesh x{n_mesh} text: ShardedBM25 ids equal to the host path's on "
        f"{len(TEXT_QUERIES)} queries; build + first query {build_ms:.1f} "
        f"ms, read median {res['ms']:.3f} ms; bm25_scores CUDA calls "
        f"{ran['bm25_scores']}")
    return res


def mesh_dryrun_step(device: torch.device) -> float:
    """``graft.dryrun_multichip`` on the device's virtual mesh."""
    from helix_tpu_torch import graft

    t = time.perf_counter()
    graft.dryrun_multichip(mesh_size(device), device)
    seconds = time.perf_counter() - t
    log(f"graft.dryrun_multichip({mesh_size(device)}) on {device}: ok in "
        f"{seconds:.1f} s")
    return seconds


# ----------------------------------------------------------------- serve

# The fast path's stored route: VectorSearchNodes -> ValueMap($id,
# $distance), which the native gateway answers from C++ after one
# search_many_async per batch.
FAST_STEPS = [SEARCH_STEPS[0], {"ValueMap": ["$id", "$distance"]}]
N_LOAD = 4096          # requests of the load step
LOAD_CONNECTIONS = 32  # keep-alive connections of the load step ...
LOAD_WINDOW = 8        # ... each with this many requests pipelined
HTTP_TIMEOUT = 120


def serve_bundle() -> dict:
    params = [{"name": "q", "ty": {"Array": "F32"}}, {"name": "k", "ty": "I64"}]
    routes = {"vsearch": SEARCH_STEPS, "vfast": FAST_STEPS}
    return {
        "version": 5,
        "read_routes": {name: {"queries": [{"Query": {
            "name": "hits", "steps": steps, "condition": None}}],
            "returns": ["hits"]} for name, steps in routes.items()},
        "read_parameters": {name: params for name in routes},
        "write_routes": {}, "write_parameters": {},
    }


def http_json(port: int, method: str, path: str, body=None,
              headers: dict | None = None, conn=None):
    """``(status, parsed JSON)`` of one request, on ``conn`` (a
    keep-alive ``http.client.HTTPConnection``) when given."""
    import http.client

    own = conn is None
    if own:
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=HTTP_TIMEOUT)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={
            "Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, json.loads(raw) if raw else None
    finally:
        if own:
            conn.close()


def http_load(port: int, bodies: list, connections: int,
              window: int) -> tuple[float, list]:
    """POST every body to ``/v1/query/vfast`` over ``connections``
    keep-alive sockets, each with up to ``window`` requests pipelined
    (``connections * window`` in flight), on one thread per socket that
    only writes, reads and splits responses.  Returns the wall seconds
    from the first write to the last response and ``(status, body
    bytes)`` per request."""
    import socket

    reqs = [b"POST /v1/query/vfast HTTP/1.1\r\nHost: x\r\nContent-Type: "
            b"application/json\r\nContent-Length: " + str(len(b)).encode()
            + b"\r\n\r\n" + b for b in (json.dumps(x).encode() for x in bodies)]
    answers: list = [None] * len(bodies)
    errors: list = []
    shares = [list(range(c, len(bodies), connections))
              for c in range(connections)]
    socks = [socket.create_connection(("127.0.0.1", port),
                                      timeout=HTTP_TIMEOUT)
             for _ in range(connections)]

    def run(sock, share):
        try:
            sent = min(window, len(share))
            sock.sendall(b"".join(reqs[i] for i in share[:sent]))
            got, buf = 0, b""
            while got < len(share):
                data = sock.recv(1 << 20)
                if not data:
                    raise ConnectionError("server closed the connection")
                buf += data
                while True:
                    head_end = buf.find(b"\r\n\r\n")
                    if head_end < 0:
                        break
                    head = buf[:head_end].lower()
                    at = head.find(b"content-length:") + 15
                    line_end = head.find(b"\r\n", at)
                    length = int(head[at:line_end if line_end >= 0 else None])
                    end = head_end + 4 + length
                    if len(buf) < end:
                        break
                    answers[share[got]] = (int(head[9:12]),
                                           buf[head_end + 4:end])
                    buf = buf[end:]
                    got += 1
                    if sent < len(share):
                        sock.sendall(reqs[share[sent]])
                        sent += 1
        except Exception as exc:  # reported after the join
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(s, share))
               for s, share in zip(socks, shares)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    for s in socks:
        s.close()
    check(not errors, f"load: {errors[:3]}")
    return seconds, answers


def check_hits(engine, queries: np.ndarray, answers: list, what: str,
               oracle_rows: int) -> dict:
    """Every answer is a 200 with K hits of finite ``$distance`` within
    TOL of ``1 - q.x`` over the stored rows; recall@K against a float32
    numpy oracle over the first ``oracle_rows`` queries."""
    part = doc_partition(engine)
    matrix = part.matrix
    stored = matrix.data[: matrix.n]
    qs = matrix.prepare_queries(queries)
    worst, rows = 0.0, []
    for j, (status, out) in enumerate(answers):
        check(status == 200 and len(out["hits"]) == K,
              f"{what}: request {j} answered {status} {str(out)[:200]}")
        pos = [part.pos[h["$id"]] for h in out["hits"]]
        dists = np.array([h["$distance"] for h in out["hits"]])
        check(np.isfinite(dists).all(), f"{what}: non-finite $distance")
        want = 1.0 - stored[pos] @ qs[j]
        worst = max(worst, float(np.max(np.abs(dists - want))))
        rows.append(pos)
    sims = qs[:oracle_rows] @ stored.T
    oracle = top_rows(sims, K)
    recall = float(np.mean([len(set(rows[j]) & set(oracle[j].tolist())) / K
                            for j in range(oracle_rows)]))
    check(recall >= 0.99, f"{what}: recall@{K} {recall} < 0.99")
    check(worst <= TOL, f"{what}: $distance off by {worst}")
    return {"recall": recall, "max_dist_err": worst}


def unit_vector(seed: int) -> list:
    v = np.random.default_rng(seed).normal(size=DIM)
    return (v / np.linalg.norm(v)).tolist()


def durable_write(port: int, i: int, vec: list) -> int:
    """One ``AddN`` of a ``Doc`` with ``i`` and ``vec`` over HTTP, acked
    once durable; returns the new node's id."""
    status, wrote = http_json(port, "POST", "/v1/query", {
        "request_type": "write", "query_name": "add",
        "query": {"queries": [{"Query": {"name": "d", "steps": [{"AddN": {
            "label": "Doc", "properties": [
                ["i", {"Expr": {"Param": "i"}}],
                ["emb", {"Expr": {"Param": "v"}}]]}}],
            "condition": None}}], "returns": ["d"]},
        "parameters": {"i": i, "v": vec},
        "parameter_types": {"i": "I64", "v": {"Array": "F32"}},
    }, headers={"x-helix-await-durable": "true"})
    check(status == 200, f"durable write: {status} {wrote}")
    return wrote["d"][0]["$id"]


def serve_phase(device: torch.device, shared: dict) -> tuple[dict, dict]:
    """The HTTP front door on the exact cell, from disk.

    1. The engine phase's engine ingested ``n_rows`` through ``ForEach
       AddN`` batches with the WAL on (default fsync), served its reads
       and checkpointed: ``shared`` holds a copy of that data dir
       (``engine_phase``'s ``"serve"``), its queries and numbers.
    2. ``NativeGateway(data_dir=...)`` recovers it (timed), answers a
       first search (timed: the device arrays are rebuilt), installs a
       bundle over HTTP whose ``vfast`` route rides the vector fast path,
       then takes 128 sequential single requests (p50 / p90) and
       ``N_LOAD`` requests with ``LOAD_CONNECTIONS * LOAD_WINDOW`` in
       flight (QPS), all checked against a numpy oracle, counted by the
       gateway's ``fast_requests`` and by kernel 1's launches (one per
       block of at most 256 rows of each batch the vbatch loop formed,
       no other kernel); no request may reach the interpreter fallback.  A durable HTTP write and a read
       that finds it close the step, which then stops the gateway
       without a checkpoint: the write lives only in the WAL.

    Returns the phase's numbers and what the cluster phase takes over:
    the data dir (not deleted), the queries and the in-process answers
    to each of them and to the new vector's read."""
    import shutil

    from helix_tpu_torch.server.native_gateway import NativeGateway

    tmp, data_dir, n_rows = (shared[key] for key in ("tmp", "data_dir",
                                                     "n_rows"))
    queries = shared["queries"]
    check(len(queries) >= N_PROBE + N_LOAD, "the shared queries are too few")
    out = {key: shared[key] for key in ("ingest_s", "checkpoint_s",
                                        "snapshot_bytes")}
    gateway = None
    try:
        log(f"serve: the engine phase's ingest of {n_rows} x {DIM} with the "
            f"WAL on {out['ingest_s']:.1f} s "
            f"({n_rows / out['ingest_s']:.0f} docs/s); checkpoint "
            f"{out['checkpoint_s']:.2f} s, snapshot {out['snapshot_bytes']} "
            "bytes")

        # -- 2. in process
        t = time.perf_counter()
        gateway = NativeGateway(host="127.0.0.1", port=0, data_dir=data_dir,
                                device=str(device))
        out["recovery_s"] = time.perf_counter() - t
        gateway.start()
        port = gateway.port
        engine = gateway.engine
        check(doc_partition(engine).matrix.n == n_rows,
              f"recovered {doc_partition(engine).matrix.n} rows")
        reset_launch_counts()
        t = time.perf_counter()
        status, first = http_json(port, "POST", "/v1/query/vsearch",
                                  {"q": queries[0].tolist(), "k": K})
        out["first_search_ms"] = (time.perf_counter() - t) * 1e3
        check(status == 200 and len(first["hits"]) == K,
              f"first search after recovery: {status} {str(first)[:200]}")
        launches = launch_counts()
        log(f"serve: recovery (snapshot + WAL replay + vector backfill) "
            f"{out['recovery_s']:.2f} s; first search after recovery "
            f"(device upload + search) {out['first_search_ms']:.1f} ms")
        status, installed = http_json(port, "POST", "/v1/bundle",
                                      serve_bundle())
        check(status == 200 and installed["installed"] == ["vfast",
                                                           "vsearch"],
              f"bundle install: {status} {installed}")

        # the batches the vbatch loop forms: one search_many_async each
        part = doc_partition(engine)
        batches: list = []
        search_async = part.search_many_async

        def counted(qs, k):
            batches.append(len(qs))
            return search_async(qs, k)

        part.search_many_async = counted
        # a request the fast path queued but the interpreter answered
        # (a dispatch or finalize exception) still comes back a 200
        fallbacks: list = []
        slow_fallback = gateway._respond_slow_fallback

        def counted_fallback(*args, **kwargs):
            fallbacks.append(args[0])
            return slow_fallback(*args, **kwargs)

        gateway._respond_slow_fallback = counted_fallback
        fast0 = gateway.stats()["fast_requests"]
        reset_launch_counts()
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=HTTP_TIMEOUT)
        singles, latencies = [], []
        for q in queries[:N_PROBE]:
            t = time.perf_counter()
            singles.append(http_json(port, "POST", "/v1/query/vfast",
                                     {"q": q.tolist(), "k": K}, conn=conn))
            latencies.append((time.perf_counter() - t) * 1e3)
        conn.close()
        out["single"] = check_hits(engine, queries[:N_PROBE], singles,
                                   "HTTP single", N_PROBE)
        out["p50_ms"], out["p90_ms"] = (float(np.percentile(latencies, p))
                                        for p in (50, 90))
        single_batches, batches[:] = list(batches), []
        load_q = queries[N_PROBE:N_PROBE + N_LOAD]
        seconds, raw = http_load(port, [{"q": q.tolist(), "k": K}
                                        for q in load_q],
                                 LOAD_CONNECTIONS, LOAD_WINDOW)
        out["qps"] = N_LOAD / seconds
        out["load"] = check_hits(engine, load_q,
                                 [(s, json.loads(b)) for s, b in raw],
                                 "HTTP load", BATCH)
        counts = launch_counts()
        del part.search_many_async, gateway._respond_slow_fallback
        out["load_batches"] = len(batches)
        out["load_batch_mean"] = float(np.mean(batches))
        out["load_batch_max"] = max(batches)
        fast = gateway.stats()["fast_requests"] - fast0
        sent = N_PROBE + N_LOAD
        check(fast == sent, f"fast_requests rose by {fast}, sent {sent}")
        check(not fallbacks, f"{len(fallbacks)} fast-path requests were "
              f"answered by the interpreter")
        check(sum(single_batches) + sum(batches) == sent,
              f"the vbatch loop searched {sum(single_batches) + sum(batches)}"
              f" rows for {sent} requests")
        if device.type == "cuda":
            # one launch per block of at most MAX_QUERY_BLOCK rows
            from helix_tpu_torch.ops.fused_topk import MAX_QUERY_BLOCK
            blocks = sum(-(-b // MAX_QUERY_BLOCK)
                         for b in single_batches + batches)
            check(counts["bucket_scores"] == blocks < sent,
                  f"kernel 1 launched {counts['bucket_scores']} times for "
                  f"{blocks} query blocks of {sent} requests")
            check_only_launched(device, counts, "bucket_scores", "serve")
        out["launches"] = counts["bucket_scores"] + launches["bucket_scores"]
        out["fast_requests"] = fast
        log(f"serve: HTTP single requests p50 {out['p50_ms']:.3f} ms p90 "
            f"{out['p90_ms']:.3f} ms (n={N_PROBE}), recall@{K} "
            f"{out['single']['recall']:.4f}; {N_LOAD} requests with "
            f"{LOAD_CONNECTIONS * LOAD_WINDOW} in flight in {seconds:.3f} s: "
            f"{out['qps']:.0f} QPS over HTTP, recall@{K} "
            f"{out['load']['recall']:.4f} (first {BATCH}), max |$distance - "
            f"(1 - q.x)| {max(out['single']['max_dist_err'], out['load']['max_dist_err']):.3g}; "
            f"fast_requests +{fast}; kernel launches {counts}; batches: "
            f"singles {len(single_batches)} of max {max(single_batches)}, "
            f"load {len(batches)} of mean {out['load_batch_mean']:.1f} max "
            f"{out['load_batch_max']}")

        new_vec = unit_vector(43)
        new_id = durable_write(port, n_rows, new_vec)
        want = http_json(port, "POST", "/v1/query/vfast",
                         {"q": new_vec, "k": K})
        check(want[1]["hits"][0]["$id"] == new_id
              and want[1]["hits"][0]["$distance"] < TOL,
              f"the written vector was not found: {want}")
        gateway.stop(close_engine=False)
        engine.persistence.close()   # no checkpoint: the write is WAL-only
        for index in engine.vectors.indexes.values():
            for part in index.partitions.values():
                if part.matrix is not None:
                    part.matrix.release_device()
        gateway = engine = None
        gc.collect()
        handoff = {
            "tmp": tmp, "data_dir": data_dir, "n_rows": n_rows,
            "queries": queries,
            "hits": [a["hits"] for _, a in singles]
            + [json.loads(body)["hits"] for _, body in raw],
            "new_vec": new_vec, "new_hits": want[1]["hits"],
            "in_process": {key: out[key] for key in ("p50_ms", "p90_ms",
                                                     "qps")},
        }
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        if gateway is not None:
            gateway.stop()
    return out, handoff


# --------------------------------------------------------------- cluster

N_REPLAY = 64       # reads the CLI-started primary must answer first
N_FAILOVER = 2048   # reads through the front around a replica's restart
READY_S = 600       # HELIX_READY_TIMEOUT_S of the cluster's starts
SEED_S = 600        # bound on a replica's seed, and on its re-seed
STOP_S = 300        # bound on the primary's exit after stop
LANDED_S = 30       # bound on a write reaching a replica, and on a probe flap
REPLICAS = ("replica1", "replica2")


def cli(proj: str, *args: str, ok: bool = True) -> tuple[int, str, float]:
    """``python -m helix_tpu_torch.cli <args>`` in the project: exit code,
    output and seconds; a nonzero exit fails the run unless ``ok`` is
    False."""
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, HELIX_READY_TIMEOUT_S=str(READY_S),
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "helix_tpu_torch.cli", *args],
                          cwd=proj, env=env, capture_output=True, text=True,
                          timeout=READY_S + 120)
    seconds = time.perf_counter() - t
    text = proc.stdout + proc.stderr
    check(not ok or proc.returncode == 0,
          f"cli {' '.join(args)} exited {proc.returncode}: {text[-3000:]}")
    return proc.returncode, text, seconds


def wait_for(pred, seconds: float, what: str, every: float = 0.2) -> float:
    t0 = time.perf_counter()
    while not pred():
        check(time.perf_counter() - t0 < seconds,
              f"{what}: not within {seconds} s")
        time.sleep(every)
    return time.perf_counter() - t0


def health(port: int) -> dict | None:
    import http.client

    try:
        status, out = http_json(port, "GET", "/v1/health")
    except (OSError, http.client.HTTPException):
        return None
    return out if status == 200 else None


def pid_in(path: Path) -> int | None:
    try:
        return int(path.read_text().strip())
    except (OSError, ValueError):
        return None


def alive(pid: int) -> bool:
    from helix_tpu_torch.cli.main import _process_gone

    return not _process_gone(pid)


def rss_gib(pid: int) -> float:
    for line in Path(f"/proc/{pid}/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / (1 << 20)
    return float("nan")


def proxy_stats(front) -> dict:
    import ctypes

    values = [ctypes.c_uint64() for _ in range(3)]
    front._native.hxha_stats(front._px, *map(ctypes.byref, values))
    return dict(zip(("proxied", "retries", "control"),
                    (v.value for v in values)))


def same_hits(got: list, want: list) -> bool:
    """Ids exact, ``$distance`` within 1e-6."""
    return ([h["$id"] for h in got] == [h["$id"] for h in want]
            and np.allclose([h["$distance"] for h in got],
                            [h["$distance"] for h in want], rtol=0, atol=1e-6))


def read_all(port: int, handoff: dict, what: str) -> dict:
    """The serve phase's reads again at ``port``: ``N_PROBE`` sequential
    ``vfast`` requests on one keep-alive connection (p50 / p90), then
    ``N_LOAD`` with ``LOAD_CONNECTIONS * LOAD_WINDOW`` in flight (QPS);
    each answer must equal the in-process answer to its query."""
    import http.client

    queries, hits = handoff["queries"], handoff["hits"]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT)
    latencies = []
    for j, q in enumerate(queries[:N_PROBE]):
        t = time.perf_counter()
        status, got = http_json(port, "POST", "/v1/query/vfast",
                                {"q": q.tolist(), "k": K}, conn=conn)
        latencies.append((time.perf_counter() - t) * 1e3)
        check(status == 200 and same_hits(got["hits"], hits[j]),
              f"{what}: single {j}: {status} {str(got)[:300]} vs in-process "
              f"{hits[j]}")
    conn.close()
    seconds = check_load(port, handoff, N_PROBE, N_LOAD, what)
    return {"p50_ms": float(np.percentile(latencies, 50)),
            "p90_ms": float(np.percentile(latencies, 90)),
            "qps": N_LOAD / seconds}


def check_load(port: int, handoff: dict, first: int, n: int,
               what: str) -> float:
    """``n`` pipelined ``vfast`` reads of the queries from ``first`` on,
    each equal to its in-process answer; returns the wall seconds."""
    queries, hits = handoff["queries"], handoff["hits"]
    seconds, raw = http_load(port, [{"q": q.tolist(), "k": K}
                                    for q in queries[first:first + n]],
                             LOAD_CONNECTIONS, LOAD_WINDOW)
    for j, (status, body) in enumerate(raw):
        check(status == 200 and same_hits(json.loads(body)["hits"],
                                           hits[first + j]),
              f"{what}: request {first + j}: {status} {body[:300]!r}")
    return seconds


def cluster_phase(device: torch.device, handoff: dict) -> dict:
    """The serve phase's data dir as the primary of a three-process
    cluster started by the CLI, behind the native HA proxy.

    1. ``python -m helix_tpu_torch.cli init`` makes a project with
       instances ``primary`` and (``add``) ``replica1``, ``replica2``;
       the serve bundle is its ``queries.json``, which ``start`` deploys;
       the serve phase's data dir becomes ``.helix/primary/data``.
    2. ``start primary --disk --restart unless-stopped`` (the default
       device; ``--device cpu`` in a CPU rehearsal) with
       ``HELIX_READY_TIMEOUT_S`` at ``READY_S``, timed: it recovers the
       1M rows (the serve phase's HTTP write from the WAL) and must
       answer ``N_REPLAY`` ``vfast`` reads and the written vector's read
       as the in-process gateway did (ids exact, ``$distance`` within
       1e-6); then the serve phase's singles and load straight to it.
    3. ``start replicaN --replica-of <primary> --restart unless-stopped``
       for both; a replica answers the readiness probe before its seed
       lands, so each is waited for until its ``/v1/health`` nodes and
       edges equal the primary's (seconds from its start).
    4. ``HAFront`` over the three, in this process, on the native proxy
       (``_px`` set: the Python fallback fails the run).  The bundle is
       deployed again through it (its broadcast arms each replica's fast
       path, which the deploy at start, before the seed, could not: the
       gateway re-checks only every 5 s).  The singles and
       the load through it answer as in process; the card's free memory
       must fall across them by at least both replicas' device copies
       (bf16 + f32 rows: no replica searched before); a durable write
       through the front must then be found first by each replica.
    5. SIGKILL ``replica1``'s engine while ``N_FAILOVER`` reads with
       ``LOAD_CONNECTIONS * LOAD_WINDOW`` in flight go through the front
       (once a quarter is answered): all answer alike and the proxy's
       retry count rises; its supervisor restarts it and it re-seeds
       (bounded).  How long the front reported it healthy before its seed
       landed is printed; no read is checked in that window.  Then
       ``N_FAILOVER`` reads answer alike, and both replicas come up
       healthy in ``/v1/ha`` (bounded: a probe that times out marks a
       replica down until the next one answers).
    6. ``stop`` each instance.  The primary's ``stop`` may return 1 while
       its 1M checkpoint runs past the CLI's 10 s wait: its pid is then
       waited for and ``stop`` called again (a second SIGTERM during the
       checkpoint is not sent).  The snapshot must be newer, no server
       may be left, no log may name the native gateway's fallback, and
       the kernel library must not have been rebuilt.

    Kernel 1 launches in the three server processes, so its launch
    count (the ``kernels`` line) holds the in-process phases only; the
    cluster's launches show in the memory check and in the answers,
    which only kernel 1's exact path gives equal to the in-process
    gateway's.  Prints each step's seconds, the card memory it added
    and each server's resident host memory with the card's name and
    power limit."""
    import shutil
    import signal

    from helix_tpu_torch import kernels
    from helix_tpu_torch.server.ha_front import HAFront

    on_card = device.type == "cuda"
    card_line = card() if on_card else "cpu"
    tmp, n_rows = handoff["tmp"], handoff["n_rows"]
    proj = os.path.join(tmp, "proj")
    names = ("primary",) + REPLICAS
    ports = dict(zip(names, free_ports(len(names))))
    dev = [] if on_card else ["--device", "cpu"]

    def state(name: str) -> Path:
        return Path(proj, ".helix", name)

    def port_of(name: str) -> int:
        return int((state(name) / "server.port").read_text())

    pids: set = set()

    def note_pids() -> dict:
        engines = {}
        for name in names:
            for file in ("server.pid", "engine.pid"):
                pid = pid_in(state(name) / file)
                if pid is not None:
                    pids.add(pid)
                    if file == "engine.pid":
                        engines[name] = pid
        return engines

    mem: list = []

    def card_free(step: str) -> None:
        if on_card:
            mem.append((step, torch.cuda.mem_get_info(device)[0]))

    out: dict = {}
    front = None
    try:
        if on_card:
            mode = subprocess.run(
                ["nvidia-smi", "--query-gpu=compute_mode",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip()
            log(f"cluster: compute mode {mode}")
            check(mode == "Default", f"compute mode {mode}: three server "
                  "processes must share the card")
            torch.cuda.empty_cache()
        # -- 1. project
        cli(tmp, "init", "--path", proj, "--instance", "primary", "--port",
            str(ports["primary"]))
        for name in REPLICAS:
            cli(proj, "add", name, "--port", str(ports[name]))
        Path(proj, "db").mkdir(exist_ok=True)
        Path(proj, "db", "queries.json").write_text(json.dumps(serve_bundle()))
        state("primary").mkdir(parents=True)
        shutil.move(handoff["data_dir"], state("primary") / "data")
        snapshot = state("primary") / "data" / "snapshot.bin"
        snap_before = snapshot.stat().st_mtime_ns
        lib = kernels.library_path()
        lib_mtime = lib.stat().st_mtime_ns if lib.exists() else None

        # -- 2. the primary through the CLI
        card_free("before")
        _, text, out["primary_start_s"] = cli(
            proj, "start", "primary", "--disk", "--restart", "unless-stopped",
            *dev)
        check("deployed query bundle" in text, f"start primary: {text}")
        note_pids()
        card_free("primary started")
        pport = port_of("primary")
        queries, hits = handoff["queries"], handoff["hits"]
        for j in range(N_REPLAY):
            status, got = http_json(pport, "POST", "/v1/query/vfast",
                                    {"q": queries[j].tolist(), "k": K})
            check(status == 200 and same_hits(got["hits"], hits[j]),
                  f"CLI primary: read {j}: {status} {str(got)[:300]}")
        status, got = http_json(pport, "POST", "/v1/query/vfast",
                                {"q": handoff["new_vec"], "k": K})
        check(status == 200 and same_hits(got["hits"], handoff["new_hits"]),
              f"CLI primary: the WAL-only write's read: {got}")
        card_free("primary searched")
        out["direct"] = read_all(pport, handoff, "CLI primary, direct")
        log(f"cluster: `start primary --disk` ready and deployed in "
            f"{out['primary_start_s']:.1f} s on {card_line}; {N_REPLAY} "
            "reads and the WAL-only write's read equal to the in-process "
            "gateway's")

        # -- 3. replicas
        primary_url = f"http://127.0.0.1:{pport}"
        size = health(pport)
        want_size = (size["nodes"], size["edges"])

        def seeded(port: int) -> bool:
            h = health(port)
            return h is not None and (h["nodes"], h["edges"]) == want_size

        started = {}
        for name in REPLICAS:
            started[name] = time.perf_counter()
            _, _, out[f"{name}_start_s"] = cli(
                proj, "start", name, "--replica-of", primary_url,
                "--restart", "unless-stopped", *dev)
        note_pids()
        for name in REPLICAS:
            wait_for(lambda: seeded(port_of(name)), SEED_S, f"{name}'s seed")
            out[f"{name}_seed_s"] = time.perf_counter() - started[name]
        card_free("replicas seeded")
        log(f"cluster: replicas started in "
            f"{out['replica1_start_s']:.1f} / {out['replica2_start_s']:.1f} "
            f"s, seeded {out['replica1_seed_s']:.1f} / "
            f"{out['replica2_seed_s']:.1f} s after their starts "
            f"({want_size[0]} nodes) on {card_line}")

        # -- 4. the HA front
        front = HAFront(primary_url, [f"http://127.0.0.1:{port_of(n)}"
                                      for n in REPLICAS],
                        host="127.0.0.1", port=0)
        front.start()
        check(front._px is not None,
              "the HA front fell back to its Python server")
        # `start` deployed the bundle before the seed brought the index,
        # so a replica's gateway has not armed the route's fast path
        # (it re-checks every 5 s); the front's broadcast arms it now
        status, deployed = http_json(front.port, "POST", "/v1/bundle",
                                     serve_bundle())
        check(status == 200 and "replica_errors" not in deployed,
              f"bundle through the front: {status} {deployed}")
        stats0 = proxy_stats(front)
        card_free("front started")
        out["front"] = read_all(front.port, handoff, "through the front")
        card_free("front load")
        stats1 = proxy_stats(front)
        check(stats1["proxied"] - stats0["proxied"] >= N_PROBE + N_LOAD,
              f"the proxy counted {stats0} -> {stats1}")
        if on_card:
            copies = 2 * n_rows * DIM * (2 + 4)
            fell = mem[-2][1] - mem[-1][1]
            check(fell >= copies, f"the card's free memory fell by {fell} "
                  f"bytes across the front's load, less than both "
                  f"replicas' copies ({copies} bytes)")
        vec = unit_vector(44)
        t = time.perf_counter()
        new_id = durable_write(front.port, n_rows + 1, vec)
        out["write_ack_ms"] = (time.perf_counter() - t) * 1e3
        for name in REPLICAS:
            port = port_of(name)
            out[f"{name}_landed_s"] = wait_for(
                lambda: http_json(port, "POST", "/v1/query/vfast",
                                  {"q": vec, "k": K})[1]["hits"][0]["$id"]
                == new_id, LANDED_S, f"the front's write on {name}", 0.02)
        want_size = (want_size[0] + 1, want_size[1])
        log(f"cluster: through the front, the write acked in "
            f"{out['write_ack_ms']:.1f} ms and read first from replica1 "
            f"{out['replica1_landed_s']:.3f} s / replica2 "
            f"{out['replica2_landed_s']:.3f} s later; proxy {stats1}")

        # -- 5. failover under the supervisor
        victim = note_pids()["replica1"]
        before = proxy_stats(front)
        failed: list = []

        def load_across_the_kill():
            try:
                check_load(front.port, handoff, 0, N_FAILOVER,
                           "through the front, replica1 killed")
            except Exception as exc:  # reported after the join
                failed.append(exc)

        loader = threading.Thread(target=load_across_the_kill)
        loader.start()
        # kill while a quarter of the load is answered: requests are in
        # flight on the victim's connections
        wait_for(lambda: proxy_stats(front)["proxied"] - before["proxied"]
                 >= N_FAILOVER // 4 or not loader.is_alive(), HTTP_TIMEOUT,
                 "the load before the kill", 0.001)
        os.kill(victim, signal.SIGKILL)
        t_kill = time.perf_counter()
        loader.join()
        check(not failed, f"reads across the kill: {failed}")
        out["retries_after_kill"] = (proxy_stats(front)["retries"]
                                     - before["retries"])
        check(out["retries_after_kill"] > 0,
              "the proxy retried nothing after the kill")
        seen = {"down": None, "healthy": None}

        def reseeded() -> bool:
            up = front.topology()["replicas"][0]["healthy"]
            if not up and seen["down"] is None:
                seen["down"] = time.perf_counter()
            if up and seen["down"] is not None and seen["healthy"] is None:
                seen["healthy"] = time.perf_counter()
            pid = pid_in(state("replica1") / "engine.pid")
            return pid not in (None, victim) and seeded(port_of("replica1"))

        wait_for(reseeded, SEED_S, "replica1's re-seed", 0.1)
        t_seeded = time.perf_counter()
        note_pids()
        out["reseed_s"] = t_seeded - t_kill
        check(seen["down"] is not None, "the front never marked replica1 "
              "down")
        out["marked_down_s"] = seen["down"] - t_kill
        out["unseeded_routed_s"] = (t_seeded - seen["healthy"]
                                    if seen["healthy"] else 0.0)
        log(f"cluster: replica1's engine SIGKILLed under load: "
            f"{N_FAILOVER} reads through the front equal, proxy retries +"
            f"{out['retries_after_kill']}; the front marked it down after "
            f"{out['marked_down_s']:.3f} s; restarted and re-seeded "
            f"{out['reseed_s']:.1f} s after the kill; the front reported "
            f"it healthy {out['unseeded_routed_s']:.1f} s before its seed "
            f"landed, on {card_line}")
        check_load(front.port, handoff, N_FAILOVER, N_FAILOVER,
                   "through the front after the re-seed")

        def both_healthy() -> bool:
            status, topo = http_json(front.port, "GET", "/v1/ha")
            return status == 200 and all(r["healthy"]
                                         for r in topo["replicas"])

        # a probe that times out (2 s) marks a replica down until the
        # next one answers
        out["both_healthy_wait_s"] = wait_for(
            both_healthy, LANDED_S, "both replicas healthy in /v1/ha")
        card_free("failover")
        log(f"cluster: {N_FAILOVER} reads through the front equal after the "
            f"re-seed; both replicas healthy in /v1/ha after "
            f"{out['both_healthy_wait_s']:.1f} s more (replica1's last probe "
            f"error: {front.replicas[0].last_error})")

        # -- 6. stop
        engines = note_pids()
        out["rss_gib"] = {name: rss_gib(pid) for name, pid in engines.items()}
        supervisor = pid_in(state("primary") / "server.pid")
        t = time.perf_counter()
        out["stop_rc"], text, _ = cli(proj, "stop", "primary", ok=False)
        check(out["stop_rc"] in (0, 1), f"stop primary: {text}")
        wait_for(lambda: not alive(supervisor), STOP_S, "the primary's exit")
        out["stop_s"] = time.perf_counter() - t
        _, again, _ = cli(proj, "stop", "primary")
        # a replica holds no data dir, but tearing down its 1M-node engine
        # can outlast the CLI's 10 s wait as the primary's checkpoint
        # does: then stop returns 1, and the process must still go
        out["replica_stop"] = {}
        for name in REPLICAS:
            supervisor = pid_in(state(name) / "server.pid")
            t = time.perf_counter()
            rc, text, _ = cli(proj, "stop", name, ok=False)
            check(rc in (0, 1), f"stop {name}: {text}")
            wait_for(lambda: not alive(supervisor), STOP_S, f"{name}'s exit")
            out["replica_stop"][name] = (rc, time.perf_counter() - t)
            if rc:
                cli(proj, "stop", name)
        left = [pid for pid in pids if alive(pid)]
        check(not left, f"server processes left after stop: {left}")
        check(snapshot.stat().st_mtime_ns > snap_before,
              "stop did not write the primary's snapshot")
        for name in names:
            text = (state(name) / "server.log").read_text()
            check("native gateway unavailable" not in text,
                  f"{name} fell back: {text[-3000:]}")
        check(lib_mtime is None or lib.stat().st_mtime_ns == lib_mtime,
              "a server process rebuilt the kernel library")
        if on_card:
            out["card_gib_added"] = {
                step: (mem[i - 1][1] - free) / (1 << 30)
                for i, (step, free) in enumerate(mem) if i}
        waited = "in time" if out["stop_rc"] == 0 else \
            "still checkpointing when the CLI's wait ended"
        log(f"cluster: stop primary exited {out['stop_rc']} ({waited}), "
            f"the primary gone {out['stop_s']:.1f} s after the stop; stop "
            f"again: {again.strip()!r}; replicas (stop's exit code, "
            f"seconds until gone) {out['replica_stop']}; snapshot written; "
            f"no process left")
        log(f"cluster on {card_line}: primary direct {out['direct']}, "
            f"through the front over two replicas {out['front']}, in-process "
            f"gateway (serve phase) {handoff['in_process']}; resident host "
            f"memory GiB {out['rss_gib']}; card memory added GiB "
            f"{out.get('card_gib_added')}")
    finally:
        if front is not None:
            front.stop()
        note_pids()
        for pid in pids:
            if alive(pid):
                os.kill(pid, signal.SIGKILL)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def free_ports(n: int) -> list[int]:
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


KERNELS = (
    ("bucket_scores", "helix_tpu_torch/csrc/bucket_scores.cu",
     "helix_tpu/ops/fused_topk.py:173"),
    ("i8_bucket_scores", "helix_tpu_torch/csrc/i8_bucket_scores.cu",
     "helix_tpu/ops/quant.py:573"),
    ("i4_bucket_scores", "helix_tpu_torch/csrc/i4_bucket_scores.cu",
     "helix_tpu/ops/quant4.py:249"),
    ("select_topk", "helix_tpu_torch/csrc/select_topk.cu",
     "helix_tpu/ops/fused_topk.py:244 jax.lax.approx_max_k and :262 "
     "jax.lax.top_k (XLA ops, no Pallas kernel)"),
    ("l2_scores", "helix_tpu_torch/csrc/l2_scores.cu",
     "helix_tpu/ops/distance.py:184-190 (XLA's dot and elementwise ops, "
     "no Pallas kernel)"),
)
# The in-process phases whose paths select (every selection the
# selection kernel: it launches in each).
SELECTING = ("engine", "exact sweep", "traversal decomp", "ladder", "l2",
             "serve")


def print_ptxas(sources) -> None:
    """``ptxas``' register, spill and ``C75xx`` (wgmma serialized) lines
    of the last build of ``sources``, each distinct line once per source
    with the number of kernels that printed it."""
    from collections import Counter

    from helix_tpu_torch import kernels

    for source in sources:
        lines = Counter(
            line.strip() for line in
            kernels.BUILD_LOG.get(source.name, "").splitlines()
            if any(key in line for key in ("registers", "spill", "C75",
                                           "warning")))
        for line, count in lines.items():
            log(f"ptxas {source.name} ({count}x): {line}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from helix_tpu_torch.parallel import virtual_devices

    # One device outside the mesh steps, which set their own mesh: on a
    # machine of several cards the engine's mesh knobs stay inert there.
    with virtual_devices("cuda", 1):
        return run_phases()


def run_phases() -> int:
    start = time.perf_counter()
    device = torch.device("cuda", 0)
    card_line = card()
    log(f"card: {card_line}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    from helix_tpu_torch import native
    from helix_tpu_torch import kernels

    t = time.perf_counter()
    kernels.load()
    log(f"kernel build + load: {time.perf_counter() - t:.1f} s "
        f"({kernels.library_path().name})")
    print_ptxas(kernels.SOURCES)
    t = time.perf_counter()
    native.load()
    log(f"native host library build + load: {time.perf_counter() - t:.1f} s")

    from helix_tpu_torch.ops.topk import select_topk

    seconds: dict = {}
    # select_topk's launches in each phase, set to 0 just before it and
    # read just after
    selects: dict = {}

    def timed(name, phase, *args):
        select_topk.launches = 0
        t = time.perf_counter()
        result = phase(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        selects[name] = select_topk.launches
        return result

    kern = {"bucket_scores": timed("kernel", kernel_phase, device)}
    kern["select_topk"] = timed("select", select_phase, device)
    kern.update(timed("quant kernels", quant_kernel_phase, device))
    kern["i8_bucket_scores"].update(timed("i8 cell shape", i8_cell_phase,
                                          device))
    gc.collect()
    torch.cuda.empty_cache()
    bench = timed("bench", bench_phase, device)
    ladder_bench = timed("ladder bench", ladder_bench_phase, device)
    # The sweep library builds in the background during the engine
    # phase's ingest (host work that nothing here times against the card).
    sweep_build: dict = {}

    def build_sweeps() -> None:
        t = time.perf_counter()
        try:
            kernels.load_sweep()
        except BaseException as exc:  # noqa: BLE001 -- raised below
            sweep_build["error"] = exc
        sweep_build["seconds"] = time.perf_counter() - t

    build_thread = threading.Thread(target=build_sweeps, daemon=True)
    eng = timed("engine", engine_phase, device, N_ROWS, build_thread.start)
    seconds["mesh exact + traversal"] = round(eng["mesh"]["seconds"], 1)
    build_thread.join()
    if "error" in sweep_build:
        raise sweep_build["error"]
    seconds["sweep build (in the engine phase)"] = round(
        sweep_build["seconds"], 1)
    log(f"sweep kernel build + load: {sweep_build['seconds']:.1f} s "
        f"({kernels.sweep_library_path().name})")
    print_ptxas(kernels.SWEEP_SOURCES)
    sweeps = timed("sweep", sweep_phase, device)
    gc.collect()
    tiles = timed("tile sweep", tile_sweep_phase, device)
    gc.collect()
    torch.cuda.empty_cache()
    exact = timed("exact sweep", exact_sweep_phase, device)
    gc.collect()
    torch.cuda.empty_cache()
    # Derived from the two phases (kernel and fused step on the kernel
    # phase's random matrix, search_many on the engine's): where one
    # B=256 search_many goes.
    k1 = kern["bucket_scores"]
    log(f"per-batch split B={BATCH} on {card_line}: kernel {k1['ms']:.3f} "
        f"ms (plain {k1['plain_ms']:.3f} ms), top-k + re-rank tail "
        f"{k1['fused_ms'] - k1['ms']:.3f} ms, host + transfers "
        f"{eng['batch_ms'] - k1['fused_ms']:.3f} ms (search_many median "
        f"{eng['batch_ms']:.3f} ms)")
    gc.collect()  # the exact engine's host rows (cycles keep them alive)
    graph_ops = timed("graph ops", graph_ops_phase, device, eng["first_rows"])
    decomp = timed("traversal decomp", traversal_decomp_phase, device)
    gc.collect()
    ladder = timed("ladder", ladder_phase, device)
    gc.collect()
    demos = timed("demos", demos_phase, device)
    gc.collect()
    soak = timed("soak", soak_phase, device)
    l2 = timed("l2", l2_phase, device)
    log(f"l2 on {card_line}: " + json.dumps(l2, default=float))
    kern["l2_scores"] = l2["exact"]["split"]["kernel"]
    gc.collect()
    text = timed("text", text_phase, device)
    gc.collect()
    timed("mesh dry run", mesh_dryrun_step, device)
    gc.collect()
    seconds["mesh int8"] = round(ladder["mesh int8"]["seconds"], 1)
    seconds["mesh text"] = round(text["mesh"]["seconds"], 1)
    serve, handoff = timed("serve", serve_phase, device, eng["serve"])
    log(f"serve on {card_line}: " + json.dumps(serve, default=float))
    gc.collect()
    cluster = timed("cluster", cluster_phase, device, handoff)
    log(f"cluster on {card_line}: " + json.dumps(cluster, default=float))
    log(f"select_topk launches per phase: {json.dumps(selects)}")
    for name in SELECTING:
        check(selects[name] > 0,
              f"{name} phase: the selection kernel never launched")
    log(f"reduced: {json.dumps(REDUCED)}")
    log(f"phase seconds: {json.dumps(seconds)}, run so far "
        f"{time.perf_counter() - start:.1f} s")
    log("device paths: " + json.dumps({
        "graph_ops": graph_ops, "traversal_decomp": decomp["line"],
        "engine_graph": {
            k: v for k, v in eng["graph"].items()
            if k not in ("requests", "answers")},
        "ivf": {k: v for k, v in ladder.items() if k.startswith("ivf")},
        "text": text}, default=float))
    log(f"mesh on {card_line}: " + json.dumps({
        "exact": eng["mesh"], "int8": ladder["mesh int8"],
        "text": text["mesh"]}, default=float))
    # kernel 1's launches on each path that runs it, counted from 0 just
    # before the path and read just after: bench_torch.py's timed windows
    # (in its own process), the exact engine, the serve phase, the mesh
    # (kernel 2 also serves i8_sweep's shipped row); kernels 1-3 in
    # bench_torch.py --ladder (its own process), kernel 3 in quant_demo
    # --bits 4; kernels 4 and 5 on the sweep phase's two entry points;
    # kernels 1 and 2 in exact_sweep, kernel 1 in the soak (its own
    # process), kernel 4's shipped in tile_sweep
    launches = {"bucket_scores": bench["launches"] + eng["launches"]
                + serve["launches"] + eng["mesh"]["launches"]
                + soak["launches"],
                **ladder["launches"]}
    launches["i8_bucket_scores"] += sweeps.pop("launches_i8_bucket_scores")
    for name in ("bucket_scores", "i8_bucket_scores", "i4_bucket_scores"):
        launches[name] += ladder_bench["launches"][name]
    launches["i4_bucket_scores"] += demos["launches"]["i4_bucket_scores"]
    for name in ("bucket_scores", "i8_bucket_scores"):
        launches[name] += exact["launches"][name]
    sweeps["onepass_sweep/shipped"]["launches"] += tiles["launches"]
    # the selection kernel on every in-process path that runs it (not
    # the phases that hold kernels to their plain versions: the bench's
    # and the soak's children report their own) and in the bench's, the
    # ladder bench's and the soak's processes; the cluster's servers are
    # not counted
    launches["select_topk"] = sum(
        count for name, count in selects.items()
        if name not in ("kernel", "select", "quant kernels"))
    launches["select_topk"] += (ladder_bench["launches"]["select_topk"]
                                + bench["select_launches"]
                                + soak["select_launches"])
    # l2_scores on the l2 phase's exact rung and its gateway
    launches["l2_scores"] = sum(l2["l2_scores_launches"].values())
    numbers = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
    entries = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                **{key: kern[name][key] for key in numbers}}
               for name, source, replaces in KERNELS]
    entries += [{"name": name, "route": "cuda",
                 **{key: entry[key] for key in ("source", "replaces",
                                                "launches") + numbers}}
                for name, entry in sweeps.items()]
    print(json.dumps({"kernels": entries}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
