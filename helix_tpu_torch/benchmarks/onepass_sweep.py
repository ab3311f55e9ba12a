"""One-pass bucket-reduction sweep of the fused exact kernel (PyTorch port
of ``benchmarks/onepass_sweep.py``): kernel 4.

The reference swaps Pallas kernel bodies into the fused coarse phase
(``_make_kernel_onepass``: the mask as a select, each row's in-bucket
index packed into its score before one max over the bucket;
``_make_kernel_lastmask``: the select only in tiles that hold padding
rows) and times the fused step at each VMEM tile size.  Here each variant
is an instantiation of ``csrc/sweep_bucket_scores.cu`` on kernel 1's
Hopper pipeline, wrapped by :data:`KERNELS`:

- ``shipped``: kernel 1's epilogue, the row mask folded into the pack;
- ``onepass``: an explicit select before the pack;
- ``lastmask``: that select only in buckets that hold a row >= n_valid.

All three compute kernel 1's function, so each equals kernel 1's packed
winners bit for bit; their plain version is kernel 1's,
:func:`~helix_tpu_torch.ops.fused_topk.bucket_scores_reference`.

Usage::

    python -m helix_tpu_torch.benchmarks.onepass_sweep [--n 1000000]
        [--batch 256] [--tiles 2,4,8]
    python -m helix_tpu_torch.benchmarks.onepass_sweep --device cpu --n 16384

Differences from the reference:

- ``--tiles`` lists ring depths (stages per consumer of the kernel's TMA
  rings, 2 up to the most that fit; 0 for the most), the knob of
  ``csrc/hopper.cuh``'s plan that plays the TPU's VMEM tile's part; rows
  carry ``ring_depth`` in place of ``tile_rows``.
- ``--device cuda`` (the default; exits nonzero without a card) runs the
  kernels, ``--device cpu`` their plain versions (in place of
  ``--interpret``).
- The rows pad to the fused tile (8192) at any N; the reference's
  ``PackedMatrix`` pads to it only from 65,536 rows.
- The fused step is the port's ``fused_topk`` with the variant's winners
  (exact selection, ``distance._top_k``); timing is
  :func:`roofline.timed_scan_qps`'s CUDA graph.
- A failed variant is logged ``FAILED`` as in the reference, and the
  script then exits nonzero.  A reading above the card's bound fails its
  variant (no clamp).
- Each row also carries the kernel's bound (``bound_ms``, its bytes and
  operations at the card's peaks), its eager launches and its nodes
  captured into the timed graphs; the line names the device.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import kernels
from ..ops import fused_topk as F
from ..ops.quant import check_kernel_operands
from .ladder import _corpus, _oracle, _recall
from .roofline import (apply_roofline, device_specs, roofline_batch_seconds,
                       timed_scan_qps)

VARIANTS = ("shipped", "onepass", "lastmask")
# csrc/sweep.cuh's Dot kinds, as hx_sweep_plan numbers them
DOT_KINDS = {"bf16": 0, "s8": 1, "s8_as_bf16": 2}


def sweep_plan(dot: str, d: int, b: int, depth: int = 0) -> dict | None:
    """The plan a sweep kernel of ``dot`` runs on the card for D=d, B=b
    at ring ``depth`` (0: the most that fit), or None when it refuses the
    shape (queries not resident, or a depth out of range)."""
    import ctypes

    plan = (ctypes.c_int * 4)()
    if kernels.load_sweep().hx_sweep_plan(DOT_KINDS[dot], d, b, depth,
                                          plan) != 0:
        return None
    return {"ring_depth": plan[1], "stage_bytes": plan[2],
            "smem_bytes": plan[3], "queries": "resident"}


def launch_sweep(wrapper, xs: torch.Tensor, qs: torch.Tensor,
                 scales: torch.Tensor | None, out: torch.Tensor,
                 n_valid: int, depth: int) -> None:
    """Launch ``wrapper.entry`` of the sweep library on the current stream
    and count it (``fused_topk.count_launch``); raise unless it took the
    launch."""
    n, d = xs.shape
    b = qs.shape[0]
    lib = kernels.load_sweep()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, wrapper.entry)(
            xs.data_ptr(), qs.data_ptr(),
            None if scales is None else scales.data_ptr(), out.data_ptr(),
            n, d, b, max(0, min(int(n_valid), n)), depth, stream,
        )
    F.check_launch(wrapper.entry, rc)
    F.count_launch(wrapper, xs.device)


class BucketScoresVariant:
    """Kernel 4's wrapper for one variant: ``[N / 64, B]`` f32 packed
    winners of bf16 ``xs16 [N, D]`` and ``qs16 [B, D]`` (kernel 1's
    function).  CUDA tensors launch the variant's entry of
    ``csrc/sweep_bucket_scores.cu`` at ring ``depth`` (0: the most that
    fit) and count it in ``launches`` (``captured`` under graph capture);
    CPU tensors run the plain version at any depth.  A shape the kernel
    does not take raises on either device."""

    def __init__(self, name: str):
        self.name = name
        self.entry = f"hx_sweep_{name}"
        self.launches = 0
        self.captured = 0

    reference = staticmethod(F.bucket_scores_reference)

    def __call__(self, xs16: torch.Tensor, qs16: torch.Tensor, n_valid: int,
                 depth: int = 0) -> torch.Tensor:
        if xs16.dim() != 2 or qs16.dim() != 2 or \
                xs16.shape[1] != qs16.shape[1]:
            raise ValueError(
                f"{self.name}: xs [N, D] and qs [B, D], got "
                f"{tuple(xs16.shape)} and {tuple(qs16.shape)}")
        n, d = xs16.shape
        b = qs16.shape[0]
        refusal = F.bucket_kernel_refusal(n, d, b)
        if refusal is not None:
            raise ValueError(f"{self.name}: {refusal}")
        if xs16.device.type == "cpu" and qs16.device.type == "cpu":
            return self.reference(xs16, qs16, n_valid)
        check_kernel_operands(self.name, {"xs16": xs16, "qs16": qs16},
                              {"xs16": torch.bfloat16,
                               "qs16": torch.bfloat16})
        if sweep_plan("bf16", d, b, depth) is None:
            raise ValueError(f"{self.name}: D={d} B={b} at ring depth "
                             f"{depth}: queries not resident or depth out "
                             "of range")
        out = torch.empty((n // F.BUCKET, b), dtype=torch.float32,
                          device=xs16.device)
        launch_sweep(self, xs16, qs16, None, out, n_valid, depth)
        return out


KERNELS = {name: BucketScoresVariant(name) for name in VARIANTS}


def kernel_bound(n_pad: int, dim_pad: int, batch: int,
                 device: torch.device) -> tuple[float, str] | None:
    """(ms, "bytes" or "operations"): kernel 4's least time on the card:
    the bf16 rows and queries read once and the winners written once
    against 2 B N D bf16 operations; None without a known card."""
    from ..card import bound

    specs = device_specs(device)
    if specs is None:
        return None
    peak_bytes, peak_bf16, _ = specs
    return bound(n_pad * dim_pad * 2 + batch * dim_pad * 2
                 + n_pad // F.BUCKET * batch * 4,
                 2.0 * batch * n_pad * dim_pad, peak_bf16, peak_bytes)


def operands(data: np.ndarray, d: int, device: torch.device) -> dict:
    """The matrix the sweep searches: ``data`` through the port's
    ``PackedMatrix`` (normalised, D padded to 128), the bf16 copy with its
    rows padded to the fused tile, the f32 re-rank copy."""
    from ..ops.distance import PackedMatrix

    matrix = PackedMatrix(d, "cosine", device=device)
    matrix.extend(data)
    n_pad = F.pad_rows_for_fused(matrix.n)
    xs16 = matrix._upload(matrix.data[: matrix.n], n_pad, torch.bfloat16)
    return {"matrix": matrix, "xs16": xs16, "xs32": matrix.data_device(),
            "n_valid": matrix.n, "n_pad": n_pad, "dim_pad": matrix.dim_pad}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="kernel 4: the fused exact kernel's epilogue variants")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--tiles", default="2,4,8",
                    help="ring depths (stages per consumer; 0: the most "
                         "that fit), in place of the TPU's tile rows")
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the kernels; cpu: their plain versions")
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sweep(args: argparse.Namespace, ops: dict, queries: np.ndarray,
          oracle: np.ndarray, variants: tuple = VARIANTS
          ) -> tuple[dict, list]:
    """Each of ``variants`` at every ring depth of ``args.tiles``: the
    fused step's QPS (``timed_scan_qps``) and recall@k against ``oracle``
    on ``queries[:batch]``.  Returns the JSON line's object and the names
    of the variants that failed."""
    device = ops["xs16"].device
    batch, k, d = args.batch, args.k, args.d
    xs16, xs32, n_valid = ops["xs16"], ops["xs32"], ops["n_valid"]
    n_pad, dim_pad = ops["n_pad"], ops["dim_pad"]
    qs_pad = torch.from_numpy(
        ops["matrix"].prepare_queries(queries[:batch])).to(device)
    sq = torch.zeros((1,), device=device)
    floor_s = roofline_batch_seconds(
        bytes_read=n_pad * dim_pad * 2,
        mxu_ops=2.0 * batch * n_pad * dim_pad, dtype="bf16", device=device)
    if floor_s:
        log(f"# roofline: {floor_s * 1e3:.3f} ms/batch "
            f"({batch / floor_s:,.0f} QPS)")
    bound = kernel_bound(n_pad, dim_pad, batch, device)

    results, failed = [], []
    for name in variants:
        kernel = KERNELS[name]
        for depth in (int(t) for t in args.tiles.split(",") if t):
            def winners(x16, q16, nv, depth=depth, kernel=kernel):
                return kernel(x16, q16, nv, depth=depth)

            def fn(qb, a16, a32, winners=winners):
                return F.fused_topk(a16, a32, qb, n_valid, sq, k=k,
                                    winners=winners)[1]

            launched, captured = kernel.launches, kernel.captured
            try:
                qps, diag = timed_scan_qps(
                    fn, batch=batch, d=d, dim_pad=dim_pad,
                    rounds=args.rounds, operands=(xs16, xs32))
                ids = fn(qs_pad, xs16, xs32).cpu().numpy()
                rec = _recall(ids, oracle, k)
                ring = depth
                if device.type == "cuda":  # the kernel took the depth
                    ring = sweep_plan("bf16", dim_pad, batch,
                                      depth)["ring_depth"]
                row = apply_roofline({
                    "kernel": name, "ring_depth": ring,
                    "qps": round(qps, 1), "recall_at_10": round(rec, 4),
                    "per_batch_ms": diag["per_batch_ms_samples"],
                }, batch, floor_s)
            except Exception as exc:  # noqa: BLE001
                log(f"# {name} ring_depth={depth}: FAILED {exc!r}")
                failed.append(f"{name}@{depth}")
                continue
            row.pop("roofline_qps", None)
            row.update(bound_ms=bound[0] if bound else None,
                       launches=kernel.launches - launched,
                       captured=kernel.captured - captured)
            results.append(row)
            log(f"# {name} ring_depth={row['ring_depth']}: {qps:,.0f} QPS "
                f"recall {rec:.4f}")
    return {
        "metric": f"onepass kernel sweep (N={ops['n_valid']}, d={d}, "
                  f"batch={batch})",
        "roofline_qps": round(batch / floor_s, 1) if floor_s else None,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "variants": results,
    }, failed


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("onepass_sweep: no CUDA device (use --device cpu for the plain "
            "versions)")
        return 1
    log(f"# onepass sweep: N={args.n} d={args.d} batch={args.batch} "
        f"device={device}")
    data, queries = _corpus(args.n, args.d, args.batch, 1)
    oracle = _oracle(data, queries[:args.batch], args.k)
    out, failed = sweep(args, operands(data, args.d, device), queries, oracle)
    print(json.dumps(out), flush=True)
    if failed:
        log(f"# failed: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
