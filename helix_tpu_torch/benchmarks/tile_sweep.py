"""Fused-kernel tile sweep (PyTorch port of ``benchmarks/tile_sweep.py``):
kernel 1's fused step at each ring depth of its plan.

The reference swaps ``fused_topk._tile_rows`` (the VMEM row tile of the
TPU kernel) and times ``fused_topk`` at each tile through the scan
harness.  The VMEM tile does not bind Hopper; the knob of kernel 1's plan
that plays its part is the ring depth (stages per consumer of the
kernel's TMA rings, ``csrc/hopper.cuh``).  Kernel 1 takes the depth its
plan derives from D and B, so the sweep runs kernel 4's ``shipped``
variant (:data:`onepass_sweep.KERNELS`, kernel 1's function bit for bit
on the card) as the fused step's winners at each depth, through
:func:`onepass_sweep.sweep`.

Usage::

    python -m helix_tpu_torch.benchmarks.tile_sweep [--n 1000000]
        [--d 128] [--batch 256] [--tiles 2,4,8,0]
    python -m helix_tpu_torch.benchmarks.tile_sweep --device cpu --n 16384

Prints the roofline line (stderr), one line per depth (``ms/batch``,
QPS, samples) and then one JSON line (:func:`onepass_sweep.sweep`'s,
``shipped`` rows only).

Differences from the reference:

- ``--tiles`` lists ring depths (default ``2,4,8,0``; 0 for the most
  that fit), not tile rows; each line names the requested depth and the
  one the plan took (``sweep_plan``; on the CPU the requested one).
- The corpus is the reference's (``default_rng(42)`` normals, unit rows
  with ``+1e-9``); the port adds ``batch`` queries drawn after it from
  the same generator, and each depth's recall@10 on them against an
  exact host oracle, where the reference reports none.
- ``--device cuda`` (the default; exits nonzero without a card) runs the
  kernel, ``--device cpu`` its plain version; ``--rounds`` (default 32,
  the reference's fixed count).
- Timing is :func:`roofline.timed_scan_qps`'s CUDA graph, and a reading
  above the card's bound fails its depth (no clamp).
- A failed depth prints ``FAILED`` as in the reference, and the script
  then exits 1.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import onepass_sweep as OP
from .ladder import _oracle

KERNEL = "shipped"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="kernel 1's fused step at each ring depth")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--tiles", default="2,4,8,0",
                    help="ring depths (stages per consumer; 0: the most "
                         "that fit), in place of the TPU's tile rows")
    ap.add_argument("--rounds", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the kernel; cpu: its plain version")
    return ap.parse_args(argv)


def corpus(n: int, d: int, batch: int) -> tuple[np.ndarray, np.ndarray]:
    """The reference's rows (seed 42 normals, unit with ``+1e-9``), then
    ``batch`` queries from the same generator, normalised alike."""
    rng = np.random.default_rng(42)
    data = rng.normal(size=(n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True) + 1e-9
    queries = rng.normal(size=(batch, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-9
    return data, queries


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        OP.log("tile_sweep: no CUDA device (use --device cpu for the plain "
               "version)")
        return 1
    OP.log(f"# corpus {args.n}x{args.d}...")
    data, queries = corpus(args.n, args.d, args.batch)
    oracle = _oracle(data, queries, args.k)
    out, failed = OP.sweep(args, OP.operands(data, args.d, device), queries,
                           oracle, variants=(KERNEL,))
    out["metric"] = (f"ring depth sweep of kernel 1's plan (N={args.n}, "
                     f"d={args.d}, batch={args.batch})")
    rows = iter(out["variants"])
    for depth in (int(t) for t in args.tiles.split(",") if t):
        if f"{KERNEL}@{depth}" in failed:
            print(f"ring_depth={depth}: FAILED", flush=True)
            continue
        row = next(rows)
        qps = row["qps"]
        print(f"ring_depth={depth} (plan {row['ring_depth']}): "
              f"{args.batch / qps * 1e3:.3f} ms/batch  {qps:,.0f} QPS  "
              f"samples={row['per_batch_ms']}", flush=True)
    print(json.dumps(out), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
