"""int8 coarse-kernel sweep (PyTorch port of ``benchmarks/i8_sweep.py``):
kernel 5.

The reference times variants of the int8 fused coarse kernel, each a
Pallas body, with the cache-proof scan: an int8 -> bf16 dot
(``bf16dot``, ``bf16dot_tail``), per-bucket scales with the reduction in
the int32 domain (``i32pack``), 2-D and global scale operands
(``scale2d``, ``gscale``), dot-only floor probes (``dot_i8``,
``dot_bf16``), epilogue ablations (``ep_*``, ``amk``), a transposed
output (``full_noT``), an f32 dot (``dotf32``), the transpose alone
(``xT``) and the shipped kernel (``shipped``).  Here the fifteen bodies
are instantiations of one Hopper pipeline (``csrc/sweep.cuh``: kernel 2's
ring and products, or its int8 ring converted to bf16 for kernel 1's
products; ``csrc/hopper.cuh``'s epilogue choices), in
``csrc/i8_sweep_bf16.cu``, ``csrc/i8_sweep_packed.cu`` and
``csrc/i8_sweep_probe.cu``, each wrapped by an :class:`I8SweepKernel` of
:data:`KERNELS`; ``shipped`` is ``quant.int8_fused_coarse`` (kernel 2)
and ``xT`` is ``dot_i8``'s kernel plus a transpose.  On the card
``scale2d``, ``ep_full_amk`` and ``dotf32`` run one instantiation: the
lane-dense ``[N / 128, 128]`` scale layout is a TPU layout (all three read
the same ``[N]`` scales), and Hopper has no s8 x s8 -> f32 product (the
s32 sums converted after are the f32 sums, |sum| < 2^24).

Usage::

    python -m helix_tpu_torch.benchmarks.i8_sweep [--n 1000000] [--k-cand 80]
        [--variants shipped,bf16dot,...]
    python -m helix_tpu_torch.benchmarks.i8_sweep --device cpu --n 16384

Differences from the reference:

- ``--device cuda`` (the default; exits nonzero without a card) runs the
  kernels, ``--device cpu`` their plain versions (in place of
  ``--interpret``).
- ``--tile`` is the sweep kernels' ring depth (0, the default: the most
  that fit); the line's ``tile_rows`` becomes ``plan``, the plans the
  kernels ran (``null`` on the CPU).  ``shipped`` runs kernel 2's own plan.
- Selection is exact (``distance._top_k``, ``lax.top_k``'s tie rule)
  where the reference calls ``approx_max_k`` (exact on the CPU).
- A failed variant is logged ``FAILED`` and printed as an ``error`` row,
  as in the reference, and the script then exits nonzero.  A reading
  above the card's bound fails its variant (no clamp).
- Each row also carries its kernel's bound (``bound_ms``), eager
  launches and nodes captured into the timed graphs; the line names the
  device.
- The denormal rule: ``i32pack``'s re-pack of a zero sum gives a bare
  index, a denormal bit pattern; the port flushes it to a signed zero
  after the re-pack, as ``fused_topk.descale_packed`` does, where the
  reference keeps the bits (a bitcast; XLA flushes the packed max of the
  float forms, not this): its winner names the zero row, the port's
  names in-bucket row 0.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..ops import fused_topk as F
from ..ops import quant as Q
from ..ops.distance import _top_k
from .ladder import _corpus, _oracle
from .onepass_sweep import log, sweep_plan
from .roofline import (apply_roofline, device_specs, roofline_batch_seconds,
                       timed_scan_qps)

INT32_MIN = -(2 ** 31)


def quantize_rows_bucketed(rows: np.ndarray, bucket: int):
    """Symmetric int8 with one scale per ``bucket`` consecutive rows
    (the i32pack variant's quantization; zero buckets get scale 1)."""
    n, d = rows.shape
    assert n % bucket == 0
    g = rows.reshape(n // bucket, bucket, d)
    peak = np.abs(g).max(axis=(1, 2))
    scales = np.where(peak > 0, peak / 127.0, 1.0).astype(np.float32)
    values = np.clip(
        np.rint(g / scales[:, None, None]), -127, 127
    ).astype(np.int8).reshape(n, d)
    return values, scales


@dataclass(frozen=True)
class Body:
    """One kernel body of the reference as an instantiation of
    ``csrc/sweep.cuh`` (its ``Variant``'s choices)."""

    entry: str       # the C entry
    source: str      # the .cu file under helix_tpu_torch/csrc
    dot: str         # "s8"; "bf16": rows converted in the kernel, bf16 queries
    scale: str       # "none", "row" ([N]), "row_unused", "bucket" ([N/64])
    mask: str        # "select", "tail", "none"
    reduce: str      # "packed", "max", "intmax", "i32pack"
    replaces: str    # the reference's body, benchmarks/i8_sweep.py:line
    transposed: bool = False


_BF16 = "i8_sweep_bf16.cu"
_PACKED = "i8_sweep_packed.cu"
_PROBE = "i8_sweep_probe.cu"
BODIES = {
    "bf16dot": Body("hx_i8_sweep_bf16dot", _BF16, "bf16", "row", "select",
                    "packed", "benchmarks/i8_sweep.py:176 k_bf16dot(False)"),
    "bf16dot_tail": Body("hx_i8_sweep_bf16dot_tail", _BF16, "bf16", "row",
                         "tail", "packed",
                         "benchmarks/i8_sweep.py:176 k_bf16dot(True)"),
    "i32pack": Body("hx_i8_sweep_i32pack", _PACKED, "s8", "bucket", "tail",
                    "i32pack", "benchmarks/i8_sweep.py:208 k_i32pack"),
    "scale2d": Body("hx_i8_sweep_scale2d", _PACKED, "s8", "row", "select",
                    "packed", "benchmarks/i8_sweep.py:246 k_scale2d"),
    "gscale": Body("hx_i8_sweep_gscale", _PACKED, "s8", "none", "select",
                   "packed", "benchmarks/i8_sweep.py:266 k_gscale"),
    "dot_i8": Body("hx_i8_sweep_dot_i8", _PROBE, "s8", "none", "none", "max",
                   "benchmarks/i8_sweep.py:284 k_dot(False)"),
    "dot_bf16": Body("hx_i8_sweep_dot_bf16", _BF16, "bf16", "none", "none",
                     "max", "benchmarks/i8_sweep.py:284 k_dot(True)"),
    "ep_astype": Body("hx_i8_sweep_ep_astype", _PROBE, "s8", "row_unused",
                      "none", "max",
                      "benchmarks/i8_sweep.py:304 k_epilogue(T, F, F, F)"),
    "ep_scale": Body("hx_i8_sweep_ep_scale", _PROBE, "s8", "row", "none",
                     "max",
                     "benchmarks/i8_sweep.py:304 k_epilogue(T, T, F, F)"),
    "ep_pack": Body("hx_i8_sweep_ep_pack", _PACKED, "s8", "row_unused",
                    "none", "packed",
                    "benchmarks/i8_sweep.py:304 k_epilogue(T, F, F, T)"),
    "ep_mask": Body("hx_i8_sweep_ep_mask", _PROBE, "s8", "row_unused",
                    "select", "max",
                    "benchmarks/i8_sweep.py:304 k_epilogue(T, F, T, F)"),
    "ep_full_amk": Body("hx_i8_sweep_scale2d", _PACKED, "s8", "row",
                        "select", "packed",
                        "benchmarks/i8_sweep.py:304 k_epilogue(T, T, T, T)"),
    "amk": Body("hx_i8_sweep_amk", _PROBE, "s8", "row_unused", "none",
                "intmax",
                "benchmarks/i8_sweep.py:304 k_epilogue(F, F, F, F)"),
    "full_noT": Body("hx_i8_sweep_full_t", _PACKED, "s8", "row", "select",
                     "packed", "benchmarks/i8_sweep.py:488 k_full_t",
                     transposed=True),
    "dotf32": Body("hx_i8_sweep_scale2d", _PACKED, "s8", "row", "select",
                   "packed", "benchmarks/i8_sweep.py:507 k_dotf32"),
}


def i8_sweep_reference(body: Body, xs_i8: torch.Tensor, q: torch.Tensor,
                       scales: torch.Tensor | None,
                       n_valid: int) -> torch.Tensor:
    """Plain PyTorch version of ``body``: exact int32 sums of the int8
    rows and the queries (the bf16 form's sums are the same integers),
    then the body's epilogue on the whole ``[N, B]`` score matrix, with
    the shared ``fused_topk.mask_pack_reduce`` for the packed forms.  A
    tail-only mask computes what a full one does."""
    n = xs_i8.shape[0]
    dots = Q.int_dots(xs_i8, q.to(torch.int8))                # [N, B]
    b = dots.shape[1]
    rows = torch.arange(n, device=xs_i8.device, dtype=torch.int32)[:, None]
    masked = body.mask != "none"
    if body.reduce == "i32pack":
        packed = dots * 64 | (rows & (F.BUCKET - 1))
        if masked:
            packed = torch.where(rows < n_valid, packed, INT32_MIN)
        m = packed.view(-1, F.BUCKET, b).amax(dim=1)
        s = (m >> 6).float() * scales[:, None]
        out = F._flush_denormals((s.view(torch.int32) & ~(F.BUCKET - 1))
                                 | (m & (F.BUCKET - 1))).view(torch.float32)
    elif body.reduce == "intmax":
        out = dots.view(-1, F.BUCKET, b).amax(dim=1).float()
    else:
        v = dots.float()
        if body.scale == "row":
            v = v * scales[:, None]
        if body.reduce == "packed":
            out = F.mask_pack_reduce(v, n_valid if masked else n)
        else:
            if masked:
                v = torch.where(rows < n_valid, v, F.NEG_SENTINEL)
            out = v.view(-1, F.BUCKET, b).amax(dim=1)
    return out.T.contiguous() if body.transposed else out


class I8SweepKernel:
    """Kernel 5's wrapper for one body: int8 ``xs_i8 [N, D]``, queries
    ``q [B, D]`` (int8; bf16 holding int8 values for the bf16 forms),
    ``scales`` as the body reads them (``[N]`` or ``[N / 64]`` f32, or
    None) -> ``[N / 64, B]`` f32 (``[B, N / 64]`` when transposed).  CUDA
    tensors launch the body's entry at ring ``depth`` (0: the most that
    fit) and count it in ``launches`` (``captured`` under graph capture);
    CPU tensors run :func:`i8_sweep_reference`.  A shape the kernel does
    not take raises on the card."""

    def __init__(self, name: str, body: Body):
        self.name = name
        self.body = body
        self.entry = body.entry
        self.launches = 0
        self.captured = 0

    def reference(self, xs_i8, q, scales, n_valid):
        return i8_sweep_reference(self.body, xs_i8, q, scales, n_valid)

    def __call__(self, xs_i8: torch.Tensor, q: torch.Tensor,
                 scales: torch.Tensor | None, n_valid: int,
                 depth: int = 0) -> torch.Tensor:
        if xs_i8.device.type == "cpu" and q.device.type == "cpu":
            return self.reference(xs_i8, q, scales, n_valid)
        body = self.body
        n, d = xs_i8.shape
        b = q.shape[0]
        refusal = Q.i8_kernel_refusal(n, d, b)
        if refusal is not None or q.shape[1] != d:
            raise ValueError(f"{self.name}: {refusal or 'D differs'}")
        want = {"xs_i8": torch.int8,
                "q": torch.bfloat16 if body.dot == "bf16" else torch.int8}
        ops = {"xs_i8": xs_i8, "q": q}
        if body.scale != "none":
            rows = n // F.BUCKET if body.scale == "bucket" else n
            if scales is None or scales.shape != (rows,):
                raise ValueError(f"{self.name}: scales must be [{rows}]")
            ops["scales"], want["scales"] = scales, torch.float32
        kernels.check_operands(self.name, ops, want)
        dot = "s8_as_bf16" if body.dot == "bf16" else "s8"
        if sweep_plan(dot, d, b, depth) is None:
            raise ValueError(f"{self.name}: D={d} B={b} at ring depth "
                             f"{depth}: queries not resident or depth out "
                             "of range")
        shape = (b, n // F.BUCKET) if body.transposed else (n // F.BUCKET, b)
        out = torch.empty(shape, dtype=torch.float32, device=xs_i8.device)
        kernels.launch(self, getattr(kernels.load_sweep(), self.entry),
                       xs_i8.get_device(), xs_i8.data_ptr(), q.data_ptr(),
                       ops["scales"].data_ptr() if "scales" in ops else None,
                       out.data_ptr(), n, d, b, max(0, min(int(n_valid), n)),
                       depth)
        return out


KERNELS = {name: I8SweepKernel(name, body) for name, body in BODIES.items()}
# The bodies whose variants return the bucket winners, not ids.
PROBES = ("dot_i8", "dot_bf16", "ep_astype", "ep_scale", "ep_pack",
          "ep_mask")
# Variants the reference times only (no containment): the probes, and two
# that return ids (amk's are not packed, so its "ids" carry no index).
TIMING_ONLY = PROBES + ("xT", "amk", "ep_full_amk")


def kernel_bound(body: Body | None, n_pad: int, dim_pad: int, batch: int,
                 device: torch.device) -> tuple[float, str] | None:
    """(ms, "bytes" or "operations"): a body's least time on the card (None
    for kernel 2, ``shipped``): the codes, the queries and the scales it
    reads once and its winners written once, against 2 B N D operations
    at the int8 rate (the bf16 rate for the bf16 forms); None without a
    known card."""
    from ..card import bound

    specs = device_specs(device)
    if specs is None:
        return None
    peak_bytes, peak_bf16, peak_int8 = specs
    buckets = n_pad // F.BUCKET
    bf16 = body is not None and body.dot == "bf16"
    scale_bytes = 0
    if body is not None and body.scale in ("row", "row_unused"):
        scale_bytes = n_pad * 4
    elif body is not None and body.scale == "bucket":
        scale_bytes = buckets * 4
    return bound(n_pad * dim_pad + batch * dim_pad * (2 if bf16 else 1)
                 + scale_bytes + buckets * batch * 4,
                 2.0 * batch * n_pad * dim_pad,
                 peak_bf16 if bf16 else peak_int8, peak_bytes)


def operands(data: np.ndarray, d: int, device: torch.device) -> dict:
    """The reference's operands: ``data`` through the port's
    ``PackedMatrix``, its rows padded to the fused tile and quantized
    three ways (per-row scales, per-bucket scales, one global scale)."""
    from ..ops.distance import PackedMatrix

    matrix = PackedMatrix(d, "cosine", device=device)
    matrix.extend(data)
    n_pad = F.pad_rows_for_fused(matrix.n)
    rows = np.zeros((n_pad, matrix.dim_pad), np.float32)
    rows[: matrix.n] = matrix.data[: matrix.n]
    v_row, s_row = Q.quantize_rows(rows)
    v_bkt, s_bkt = quantize_rows_bucketed(rows, F.BUCKET)
    v_g = Q.quantize_rows_unit(rows)

    def up(a):
        return torch.from_numpy(a).to(device)

    return {"matrix": matrix, "n_valid": matrix.n, "n_pad": n_pad,
            "dim_pad": matrix.dim_pad,
            "xs_i8": up(v_row), "xscales": up(s_row),
            "xs_i8b": up(v_bkt), "bscales": up(s_bkt), "xs_i8g": up(v_g)}


def variants(ops: dict, kc: int, depth: int) -> dict:
    """name -> (fn(qb, *operands), operands, has_ids): the reference's
    variant table on the port's kernels (``has_ids``: containment is
    measured; see :data:`TIMING_ONLY`)."""
    n_valid = ops["n_valid"]

    def extract(vals_t):
        best_s, pos = _top_k(vals_t, kc)
        return pos * F.BUCKET + (best_s.view(torch.int32) & (F.BUCKET - 1))

    def body_fn(name, ids: bool, transpose: bool = False):
        kernel = KERNELS[name]
        body = kernel.body

        def fn(qb, a, sc=None):
            q_i8, _ = Q._quantize_queries(qb)
            q = q_i8.to(torch.bfloat16) if body.dot == "bf16" else q_i8
            vals = kernel(a, q, sc, n_valid, depth=depth)
            if transpose:
                return vals.T.contiguous()
            if not ids:
                return vals
            return extract(vals if body.transposed else vals.T)

        return fn

    def fn_shipped(qb, a_i8g):
        return Q.int8_fused_coarse(a_i8g, qb, n_valid, k=kc)[1]

    rows = (ops["xs_i8"], ops["xscales"])
    table = {"shipped": (fn_shipped, (ops["xs_i8g"],), True),
             "xT": (body_fn("dot_i8", False, transpose=True),
                    (ops["xs_i8"],), False)}
    for name, body in BODIES.items():
        if body.scale == "bucket":
            operand = (ops["xs_i8b"], ops["bscales"])
        elif body.scale == "none":
            operand = (ops["xs_i8g"] if name == "gscale" else ops["xs_i8"],)
        else:
            operand = rows
        table[name] = (body_fn(name, name not in PROBES), operand,
                       name not in TIMING_ONLY)
    return table


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="kernel 5: the int8 coarse kernel's variants")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--k-cand", type=int, default=80)
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument(
        "--variants",
        default="shipped,bf16dot,bf16dot_tail,i32pack,dot_i8,dot_bf16",
    )
    ap.add_argument("--tile", type=int, default=0,
                    help="the sweep kernels' ring depth (0: the most that "
                         "fit), in place of the TPU's tile rows")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the kernels; cpu: their plain versions")
    return ap.parse_args(argv)


def sweep(args: argparse.Namespace, ops: dict, queries: np.ndarray,
          oracle: np.ndarray) -> tuple[dict, list]:
    """Each variant of ``args.variants``: QPS (``timed_scan_qps``) and,
    for those that return ids, containment of ``oracle`` in their top
    ``k_cand`` on ``queries[:batch]``.  Returns the JSON line's object and
    the names of the variants that failed."""
    device = ops["xs_i8"].device
    batch, d = args.batch, args.d
    n_pad, dim_pad = ops["n_pad"], ops["dim_pad"]
    kc = min(args.k_cand, n_pad // F.BUCKET)
    qs_pad = torch.from_numpy(
        ops["matrix"].prepare_queries(queries[:batch])).to(device)
    floor = {dtype: roofline_batch_seconds(
        bytes_read=n_pad * dim_pad, mxu_ops=2.0 * batch * n_pad * dim_pad,
        dtype=dtype, device=device) for dtype in ("int8", "bf16")}
    plan = None
    if device.type == "cuda":
        plan = {dot: sweep_plan(dot, dim_pad, batch, args.tile)
                for dot in ("s8", "s8_as_bf16")}
    log(f"# plan {plan}, buckets {n_pad // F.BUCKET}")
    if floor["int8"]:
        log(f"# roofline: int8 {batch / floor['int8']:,.0f} QPS, bf16 "
            f"{batch / floor['bf16']:,.0f} QPS")
    table = variants(ops, kc, args.tile)
    results, failed = [], []
    for name in (v for v in args.variants.split(",") if v):
        fn, operand, has_ids = table[name]
        kernel = KERNELS.get("dot_i8" if name == "xT" else name,
                             Q.i8_bucket_scores)
        body = getattr(kernel, "body", None)
        launched, captured = kernel.launches, kernel.captured
        try:
            if has_ids:
                ids = fn(qs_pad, *operand).cpu().numpy()
                hit = float(np.mean([
                    len(set(ids[i]) & set(oracle[i])) / oracle.shape[1]
                    for i in range(oracle.shape[0])
                ]))
            else:
                fn(qs_pad, *operand)
                hit = None
            qps, diag = timed_scan_qps(
                fn, batch=batch, d=d, dim_pad=dim_pad, rounds=args.rounds,
                operands=operand)
            row = apply_roofline(
                {"variant": name, "qps": round(qps, 1),
                 "per_batch_ms": diag["per_batch_ms_samples"]}, batch,
                floor["bf16" if body and body.dot == "bf16" else "int8"])
        except Exception as exc:  # noqa: BLE001
            log(f"# {name}: FAILED {exc!r}")
            results.append({"variant": name, "error": repr(exc)})
            failed.append(name)
            continue
        row.pop("roofline_qps", None)
        if hit is not None:
            row["containment_at_kcand"] = round(hit, 4)
        bound = kernel_bound(body, n_pad, dim_pad, batch, device)
        row.update(bound_ms=bound[0] if bound else None,
                   launches=kernel.launches - launched,
                   captured=kernel.captured - captured)
        results.append(row)
        log(f"# {name}: {qps:,.0f} QPS"
            + (f" containment {hit:.4f}" if hit is not None else ""))
    return {
        "metric": f"int8 coarse kernel sweep (N={ops['n_valid']}, d={d}, "
                  f"batch={batch}, k_cand={kc})",
        "roofline_qps_int8_mxu": round(batch / floor["int8"], 1)
        if floor["int8"] else None,
        "roofline_qps_bf16_mxu": round(batch / floor["bf16"], 1)
        if floor["bf16"] else None,
        "plan": plan,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "variants": results,
    }, failed


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("i8_sweep: no CUDA device (use --device cpu for the plain "
            "versions)")
        return 1
    log(f"# i8 sweep: N={args.n} d={args.d} batch={args.batch} "
        f"k_cand={args.k_cand} device={device}")
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
