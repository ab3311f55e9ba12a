"""The beyond-budget tier: recall and throughput at a corpus size whose
exact copies do not fit the stated device-memory budget (PyTorch port of
``benchmarks/beyond_hbm_demo.py``).

The exact serving tier needs ~6 bytes/dim resident (f32 + bf16 copies,
``ops/distance.py`` ``PackedMatrix``); at N=10M x 128 that is ~7.7 GB,
over the 2 GB budget this demo declares, so the engine's partition gate
(``Partition._use_host_ivf``) routes search to the host-resident IVF tier
(``ops/ivf.py`` ``HostIVFIndex``): corpus in host RAM, centroids on the
device, and per batch either the union of the probed cells streamed to
the device for an exact scan, or each query's own cells re-ranked on the
host, as the probe router measures.

    python -m helix_tpu_torch.benchmarks.beyond_hbm_demo [--n 10000000]
    python -m helix_tpu_torch.benchmarks.beyond_hbm_demo --device cpu \\
        --n 20000 --hbm-budget-gb 0.01

Prints one JSON line per nprobe (4, 8, 16, 32) with its recall@10 against
an exact oracle, and exits nonzero unless one of them reaches 0.9.

Differences from the reference:

- ``--device`` (default ``cuda``; without a card the script exits
  nonzero naming CUDA) holds the centroids and the streamed union.
- Its two assertions (the exact tier exceeds ``--hbm-budget-gb``; some
  nprobe reaches recall 0.9) are checks that print the reason and exit
  nonzero, so they hold under ``python -O`` too.
- Each row adds ``device``, ``scoring_path`` (the path the router took)
  and, on the card, ``card`` (``nvidia-smi``'s name and power limit).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .ladder import log


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=10_000_000)
    parser.add_argument("--d", type=int, default=128)
    parser.add_argument("--queries", type=int, default=256)
    parser.add_argument("--hbm-budget-gb", type=float, default=2.0)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("beyond_hbm_demo: torch sees no CUDA device; pass --device cpu "
            "to run on the host")
        return 1

    from ..ops.ivf import HostIVFIndex

    card = None
    if device.type == "cuda":
        from ..card import card_line

        card = card_line()
    rng = np.random.default_rng(args.seed)
    # clustered data (mixture of gaussians): ANN structure to exploit,
    # the regime IVF exists for
    n_modes = 1024
    log(f"# generating {args.n}x{args.d} clustered corpus...")
    modes = rng.normal(size=(n_modes, args.d)).astype(np.float32)
    data = np.empty((args.n, args.d), np.float32)
    chunk = 1_000_000
    for lo in range(0, args.n, chunk):
        hi = min(args.n, lo + chunk)
        which = rng.integers(0, n_modes, hi - lo)
        data[lo:hi] = modes[which] + 0.35 * rng.normal(
            size=(hi - lo, args.d)
        ).astype(np.float32)
    data /= np.maximum(np.linalg.norm(data, axis=1, keepdims=True), 1e-9)

    resident_bytes = args.n * args.d * 6  # f32 + bf16 device copies
    budget = int(args.hbm_budget_gb * (1 << 30))
    if resident_bytes <= budget:
        log(f"beyond_hbm_demo: the exact tier's {resident_bytes} bytes fit "
            f"the budget of {budget}; the demo must exceed it to mean "
            "anything")
        return 1
    log(f"# exact tier would need {resident_bytes / 1e9:.1f} GB resident "
        f"vs budget {budget / 1e9:.1f} GB -> host-IVF tier")

    log("# building host-IVF (sampled k-means + streamed assign)...")
    index = HostIVFIndex.build(data, seed=args.seed, device=device)
    log(f"# build: {index.build_seconds:.1f}s, "
        f"{len(index.indptr) - 1} cells")

    # harder queries than the corpus: between modes (mixtures) + more
    # noise, so nearest neighbours straddle cell boundaries and nprobe
    # matters
    mix_a = modes[rng.integers(0, n_modes, args.queries)]
    mix_b = modes[rng.integers(0, n_modes, args.queries)]
    lam = rng.uniform(0.3, 0.7, (args.queries, 1)).astype(np.float32)
    queries = (
        lam * mix_a + (1 - lam) * mix_b
        + 0.5 * rng.normal(size=(args.queries, args.d)).astype(np.float32)
    )
    queries /= np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-9)
    k = 10

    log("# exact oracle (blocked host scan)...")
    best = np.full((args.queries, k), -np.inf, np.float32)
    bidx = np.zeros((args.queries, k), np.int64)
    for lo in range(0, args.n, chunk):
        hi = min(args.n, lo + chunk)
        sims = queries @ data[lo:hi].T
        merged = np.concatenate([best, sims], axis=1)
        midx = np.concatenate(
            [bidx, np.broadcast_to(np.arange(lo, hi), sims.shape)], axis=1
        )
        top = np.argpartition(merged, -k, axis=1)[:, -k:]
        best = np.take_along_axis(merged, top, axis=1)
        bidx = np.take_along_axis(midx, top, axis=1)
    order = np.argsort(-best, axis=1)
    oracle = np.take_along_axis(bidx, order, axis=1)

    results = []
    for nprobe in (4, 8, 16, 32):
        # warm with the same shapes, then measure a steady-state search
        index.search(queries, k, nprobe=nprobe)
        t0 = time.perf_counter()
        _, rows = index.search(queries, k, nprobe=nprobe)
        elapsed = time.perf_counter() - t0
        hit = np.mean([
            len(set(rows[i, :k]) & set(oracle[i])) / k
            for i in range(args.queries)
        ])
        streamed = index.last_streamed_bytes
        out = {
            "tier": "host-ivf",
            "n": args.n, "d": args.d, "batch": args.queries,
            "nprobe": nprobe,
            "recall_at_10": round(float(hit), 4),
            "qps": round(args.queries / elapsed, 1),
            "batch_ms": round(elapsed * 1000, 1),
            # the tier's cost model: bytes streamed to the device per
            # batch (0 when the router scored on the host)
            "streamed_mb_per_batch": round(streamed / 1e6, 1),
            "corpus_fraction_scanned": round(
                streamed / (args.n * args.d * 4), 4),
            "scoring_path": index.last_path,
            "device": str(device),
            **({"card": card} if card else {}),
        }
        results.append(out)
        print(json.dumps(out), flush=True)

    best_ok = [r for r in results if r["recall_at_10"] >= 0.9]
    if not best_ok:
        log(f"beyond_hbm_demo: no config reached recall 0.9: {results}")
        return 1
    log(f"# PASS: recall>=0.9 at nprobe={best_ok[0]['nprobe']} "
        f"({best_ok[0]['qps']} QPS)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
