"""Kernel 2's share of its roofline, in %: the least time of one launch
over the configuration's published shape (:func:`work`, through
:func:`hxbench.peaks.least_seconds` at the int8 peak) over the device
time per batch, which is the sum of the trace's ``device_ops`` named
``i8_bucket_scores_kernel`` (the int8 rung's coarse kernel,
``csrc/i8_bucket_scores.cu``, either query tile) over the batches
dispatched in the window.  Only for closed-loop batch cells that serve
the int8 rung: a batch there has one known size, and one launch."""

import math
import re

from hxbench.peaks import least_seconds

KERNEL = re.compile(r"(?<![A-Za-z0-9_])i8_bucket_scores_kernel")
BUCKET = 64
# NVIDIA's H100 SXM data sheet: 1,979 dense int8 tera-operations a second
# (3,958 with sparsity), at the full 700 W limit.
PEAK_INT8_PER_S = 1979e12


def work(rows: int, dim: int, batch: int) -> tuple[float, float]:
    """(bytes, operations) of kernel 2 over ``rows`` int8 codes of width
    ``dim`` and ``batch`` queries: the codes read once and the queries
    once at 1 byte an element, one f32 winner per 64-row bucket and query
    written; ``2 * batch * rows * dim`` multiply-adds as operations."""
    n_bytes = rows * dim + batch * dim + math.ceil(rows / BUCKET) * batch * 4
    return float(n_bytes), 2.0 * batch * rows * dim


def read(run):
    trace = run.trace
    batches = run.counts.get("batches", 0)
    batch = run.traffic.get("batch")
    if not trace or not batches or not batch:
        return None
    device_s = sum(s for name, s in trace["device_ops"] if KERNEL.search(name))
    if not device_s:
        return None
    least, _ = least_seconds(*work(int(run.config["rows"]),
                                   int(run.config["dim"]), int(batch)),
                             peak_ops=PEAK_INT8_PER_S)
    return 100.0 * least / (device_s / batches)
