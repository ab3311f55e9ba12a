"""Kernel 1's share of its roofline, in %: the least time of one launch
over the configuration's published shape (:func:`work`, through
:func:`hxbench.peaks.least_seconds`) over the device time per batch,
which is the sum of the trace's ``device_ops`` named
``bucket_scores_kernel`` (either plan, either query tile; not kernels 2
and 3, ``i8_`` / ``i4_bucket_scores_kernel``) over the batches dispatched
in the window.  Only for closed-loop batch cells that run kernel 1: a
batch there has one known size, and one launch."""

import math
import re

from hxbench.peaks import least_seconds

KERNEL = re.compile(r"(?<![A-Za-z0-9_])bucket_scores_kernel")
BUCKET = 64


def work(rows: int, dim: int, batch: int) -> tuple[float, float]:
    """(bytes, operations) of kernel 1 over ``rows`` vectors of width
    ``dim`` and ``batch`` queries: the rows read once and the queries once
    at 2 bytes an element, one f32 winner per 64-row bucket and query
    written; ``2 * batch * rows * dim`` multiply-adds as operations."""
    n_bytes = rows * dim * 2 + batch * dim * 2 + \
        math.ceil(rows / BUCKET) * batch * 4
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
                                   int(run.config["dim"]), int(batch)))
    return 100.0 * least / (device_s / batches)
