"""Time the exact and int8 rungs and the three kernels of two checkouts of
the port in turns on one GPU.

    python3 chip_ab.py PARENT_ROOT CHANGE_ROOT [ROUNDS]

Each run is a process of its own that imports ``helix_tpu_torch`` from
one checkout's root (nothing of JAX) and the data generator and card
query from this script's ``chip_smoke.py``, so both sides see the same
data.  It builds the checkout's kernels, fills a ``PackedMatrix`` with
1M x 128 rows of ``chip_smoke.make_dataset`` (seed 42) and times the
device path the engine's exact rung takes below ``Partition.search_many``
(``search_packed`` with the live mask, k=10): 16 batches of 256 queries
and 128 single queries (wall time of each search, which ends in the host
copy of its answer), kernel 1 alone at B=256 and B=128 (CUDA events over
10 back-to-back launches, median of 7 query batches), the fused coarse
+ re-rank step ``fused_topk`` at B=256, k=16 (CUDA events, median and
quartile gap of 14 calls; less kernel 1's time, the top-k + re-rank
tail), and 4 more B=256 batches under ``torch.profiler``: their device busy time (the union of
the kernel and copy intervals) and their wall time, whose ratio gives
the device's idle share.  It checks recall@10 of the first batch against
a float32 numpy oracle.  Then kernels 2 and 3 alone on the same rows
quantized by the checkout's own ``QuantizedResident`` / ``Int4Resident``
(CUDA events as kernel 1, B=256 and B=128), and the int8 rung: a
``QuantizedResident.search`` with ``rerank_device=True`` over the first
500,000 rows (the f16 device re-rank; k=10, 256 queries): the median wall
time of 16 batches, recall@10 of the first against the oracle (>= 0.98),
and the device busy time of 4 profiled batches; the same rung with the
host f32 re-rank (``rerank_device=False``) and the int4 rung
(``Int4Resident.search``, kernel 3 and the host re-rank) over the same
rows, median wall time of 16 batches each (recall@10 >= 0.98 and 0.95):
the engine's int8 and int4 batches at 250k / 500k rows are these steps
plus the host's share.  The runs go parent,
change, change, parent,
ROUNDS times (default 1), each printing one JSON line; the last line is
a summary with the median of each side's runs, the number of pairs
(parent and change runs next to each other) the change won on each
metric, and the card's name and power limit.  Needs a CUDA device; exits
nonzero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N, DIM, K, BATCH, N_BATCHES, N_SINGLE, N_PROFILED = (
    1_000_000, 128, 10, 256, 16, 128, 4)
N_INT8 = 500_000  # the ladder phase's int8 step in chip_smoke.py


def child(root: str) -> None:
    """One run against the checkout at ``root``; prints one JSON line."""
    import torch

    import chip_smoke  # this script's, before ``root`` goes on the path

    sys.path.insert(0, root)
    from helix_tpu_torch import kernels
    from helix_tpu_torch.ops import distance as D
    from helix_tpu_torch.ops import fused_topk as F
    from helix_tpu_torch.ops import quant as Q
    from helix_tpu_torch.ops import quant4 as Q4

    kernels.load()
    data, queries = chip_smoke.make_dataset(
        N, DIM, BATCH * N_BATCHES + N_SINGLE)
    matrix = D.PackedMatrix(DIM, "cosine", device="cuda")
    matrix.extend(data)
    matrix.device_arrays()
    matrix.data_device()
    mask = np.ones(N, bool)
    torch.cuda.synchronize()

    def search(qs):
        return D.search_packed(matrix, qs, K, valid_mask=mask)

    def wall(qs):
        t = time.perf_counter()
        out = search(qs)
        return (time.perf_counter() - t) * 1e3, out

    for _ in range(3):  # warm-up: kernel module load, allocator, pinned pool
        search(queries[:BATCH])
        search(queries[:1])
    batch_ms, first = [], None
    for b in range(N_BATCHES):
        ms, out = wall(queries[b * BATCH:(b + 1) * BATCH])
        batch_ms.append(ms)
        first = out if first is None else first
    single = queries[BATCH * N_BATCHES:]
    single_ms = [wall(single[j:j + 1])[0] for j in range(N_SINGLE)]
    def recall_of(ids, rows):
        sims = queries[:BATCH] @ rows.T
        oracle = np.argpartition(-sims, K, axis=1)[:, :K]
        return float(np.mean([
            len(set(ids[j].tolist()) & set(oracle[j].tolist())) / K
            for j in range(BATCH)]))

    recall = recall_of(first[1], data)

    def kernel_ms(fn, operands, b):
        """Median over 7 query batches of 10 back-to-back launches of
        ``fn(*operands(q))``, q the batch's B queries on the card."""
        times = []
        for r in range(7):
            args = operands(torch.from_numpy(
                queries[r * b:(r + 1) * b]).cuda())
            fn(*args)
            times.append(chip_smoke.cuda_ms(fn, *args, reps=10))
        return float(np.median(times))

    def profiled(fn):
        """Device busy time and wall time of the same N_PROFILED B=256
        calls of ``fn`` under torch.profiler, per call (busy None when the
        profiler records no device event)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_ms = 0.0
            for _ in range(N_PROFILED):
                t = time.perf_counter()
                fn()
                wall_ms += (time.perf_counter() - t) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy, end = 0.0, float("-inf")
        for lo, hi in spans:
            if hi > end:
                busy += hi - max(lo, end)
                end = hi
        busy_ms = busy / 1e3 / N_PROFILED if spans else None
        return busy_ms, wall_ms / N_PROFILED

    busy, profiled_ms = profiled(lambda: search(queries[:BATCH]))
    xs16, _ = matrix.device_arrays()
    k1 = {b: kernel_ms(F.bucket_scores,
                       lambda q: (xs16, q.to(torch.bfloat16), N), b)
          for b in (256, 128)}
    # The fused coarse + re-rank step (the exact rung's device part) at
    # the engine's k bucket for k=10; less kernel 1's time it is the
    # top-k + re-rank tail, which holds the selections' tie rule.
    xs32, sq = matrix.data_device(), matrix.device_arrays()[1]
    fused = []
    for r in range(7):
        q = torch.from_numpy(queries[r * BATCH:(r + 1) * BATCH]).cuda()
        F.fused_topk(xs16, xs32, q, N, sq, k=16)
        fused += [chip_smoke.cuda_ms(F.fused_topk, xs16, xs32, q, N, sq,
                                     k=16) for _ in range(2)]
    q1, fused_ms, q3 = np.percentile(fused, [25, 50, 75])
    del xs32, sq
    # Kernels 2 and 3 alone, on the rows as the rungs quantize them.
    xs_i8, _, _ = Q.QuantizedResident().arrays(matrix)
    packed, _, _, bsc, _ = Q4.Int4Resident().arrays(matrix)
    k2 = {b: kernel_ms(Q.i8_bucket_scores,
                       lambda q: (xs_i8, Q._quantize_queries(q)[0], N), b)
          for b in (256, 128)}
    k3 = {b: kernel_ms(Q4.i4_bucket_scores,
                       lambda q: (packed, bsc, Q._quantize_queries(q)[0], N),
                       b)
          for b in (256, 128)}
    matrix.release_device()
    del xs_i8, packed, bsc, xs16

    # The int8 rung with the f16 device re-rank over N_INT8 rows.
    small = D.PackedMatrix(DIM, "cosine", device="cuda")
    small.extend(data[:N_INT8])
    quant = Q.QuantizedResident()
    live = np.ones(N_INT8, bool)

    def int8_search(qs):
        return quant.search(small, qs, K, live, "cosine", rerank_device=True)

    for _ in range(3):  # warm-up: quantization, uploads, module loads
        int8_search(queries[:BATCH])
    int8_ms, int8_first = [], None
    for b in range(N_BATCHES):
        qs = queries[b * BATCH:(b + 1) * BATCH]
        t = time.perf_counter()
        out = int8_search(qs)
        int8_ms.append((time.perf_counter() - t) * 1e3)
        int8_first = out if int8_first is None else int8_first
    int8_busy, int8_profiled_ms = profiled(
        lambda: int8_search(queries[:BATCH]))

    def rung_ms(fn):
        """Median wall time of N_BATCHES B=256 calls of ``fn`` after 3
        warm-ups, and the first batch's answer."""
        for _ in range(3):
            fn(queries[:BATCH])
        times, first_out = [], None
        for b in range(N_BATCHES):
            qs = queries[b * BATCH:(b + 1) * BATCH]
            t = time.perf_counter()
            out = fn(qs)
            times.append((time.perf_counter() - t) * 1e3)
            first_out = out if first_out is None else first_out
        return float(np.median(times)), first_out

    int8_host_ms, int8_host_first = rung_ms(
        lambda qs: quant.search(small, qs, K, live, "cosine"))
    int4 = Q4.Int4Resident()
    int4_ms, int4_first = rung_ms(
        lambda qs: int4.search(small, qs, K, live, "cosine"))
    print(json.dumps({
        "batch_ms": float(np.median(batch_ms)),
        "device_busy_ms": busy,
        "profiled_batch_ms": profiled_ms,
        "idle_share": None if busy is None else 1.0 - busy / profiled_ms,
        "single_p50_ms": float(np.percentile(single_ms, 50)),
        "single_p90_ms": float(np.percentile(single_ms, 90)),
        "kernel_b256_ms": k1[256], "kernel_b128_ms": k1[128],
        "fused_ms": float(fused_ms), "fused_iqr_ms": float(q3 - q1),
        "tail_ms": float(fused_ms) - k1[256],
        "i8_kernel_b256_ms": k2[256], "i8_kernel_b128_ms": k2[128],
        "i4_kernel_b256_ms": k3[256], "i4_kernel_b128_ms": k3[128],
        "int8_batch_ms": float(np.median(int8_ms)),
        "int8_device_busy_ms": int8_busy,
        "int8_profiled_batch_ms": int8_profiled_ms,
        "recall": recall,
        "int8_recall": recall_of(int8_first[1], data[:N_INT8]),
        "int8_host_batch_ms": int8_host_ms,
        "int8_host_recall": recall_of(int8_host_first[1], data[:N_INT8]),
        "int4_batch_ms": int4_ms,
        "int4_recall": recall_of(int4_first[1], data[:N_INT8]),
    }))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    if len(sys.argv) not in (3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("chip_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    sides = {"parent": sys.argv[1], "change": sys.argv[2]}
    rounds = int(sys.argv[3]) if len(sys.argv) == 4 else 1
    order = ("parent", "change", "change", "parent") * rounds
    results = []
    for side in order:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", sides[side]],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        if (result["recall"] < 0.99 or result["int8_recall"] < 0.98
                or result["int8_host_recall"] < 0.98
                or result["int4_recall"] < 0.95):
            print(f"chip_ab: {side} recall@10 {result['recall']} (exact), "
                  f"{result['int8_recall']} / {result['int8_host_recall']} "
                  f"(int8 device / host re-rank), {result['int4_recall']} "
                  "(int4)", file=sys.stderr)
            return 1
        print(json.dumps({"side": side, **result}), flush=True)
        results.append(result)
    keys = [k for k, v in results[0].items() if v is not None]
    summary: dict = {
        side: {k: float(np.median([r[k] for s_, r in zip(order, results)
                                   if s_ == side])) for k in keys}
        for side in sides
    }
    # the pairs: (parent, change) next to each other in run order
    pairs = [(results[i], results[i + 1]) if order[i] == "parent"
             else (results[i + 1], results[i])
             for i in range(0, len(order), 2)]
    summary["change_wins"] = {
        k: f"{sum(c[k] < p[k] for p, c in pairs)}/{len(pairs)}"
        for k in keys if not k.endswith("recall")
    }
    print(json.dumps(summary | {"card": chip_smoke.card()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
