"""Time the exact rung of two checkouts of the port in turns on one GPU.

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
10 back-to-back launches, median of 7 query batches), and 4 more B=256
batches under ``torch.profiler``: their device busy time (the union of
the kernel and copy intervals) and their wall time, whose ratio gives
the device's idle share.  It checks recall@10 of the first batch against
a float32 numpy oracle.  The runs go parent, change, change, parent,
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


def child(root: str) -> None:
    """One run against the checkout at ``root``; prints one JSON line."""
    import torch

    import chip_smoke  # this script's, before ``root`` goes on the path

    sys.path.insert(0, root)
    from helix_tpu_torch import kernels
    from helix_tpu_torch.ops import distance as D
    from helix_tpu_torch.ops import fused_topk as F

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
    sims = queries[:BATCH] @ data.T
    oracle = np.argpartition(-sims, K, axis=1)[:, :K]
    recall = float(np.mean([
        len(set(first[1][j].tolist()) & set(oracle[j].tolist())) / K
        for j in range(BATCH)]))

    def kernel_ms(b):
        xs16, _ = matrix.device_arrays()
        times = []
        for r in range(7):
            q = torch.from_numpy(queries[r * b:(r + 1) * b]).cuda().to(
                torch.bfloat16)
            F.bucket_scores(xs16, q, N)
            times.append(chip_smoke.cuda_ms(F.bucket_scores, xs16, q, N,
                                            reps=10))
        return float(np.median(times))

    def profiled():
        """Device busy time and wall time of the same N_PROFILED B=256
        batches under torch.profiler, per batch (busy None when the
        profiler records no device event)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        qs = queries[:BATCH]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_ms = sum(wall(qs)[0] for _ in range(N_PROFILED))
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

    busy, profiled_ms = profiled()
    print(json.dumps({
        "batch_ms": float(np.median(batch_ms)),
        "device_busy_ms": busy,
        "profiled_batch_ms": profiled_ms,
        "idle_share": None if busy is None else 1.0 - busy / profiled_ms,
        "single_p50_ms": float(np.percentile(single_ms, 50)),
        "single_p90_ms": float(np.percentile(single_ms, 90)),
        "kernel_b256_ms": kernel_ms(256), "kernel_b128_ms": kernel_ms(128),
        "recall": recall,
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
        if result["recall"] < 0.99:
            print(f"chip_ab: {side} recall@10 {result['recall']}",
                  file=sys.stderr)
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
        for k in keys if k != "recall"
    }
    print(json.dumps(summary | {"card": chip_smoke.card()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
