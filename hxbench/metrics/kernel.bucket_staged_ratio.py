"""Bytes kernel 1 staged into shared memory in the traced window over
the bytes of the rows it read: the program's counters
``kernel.bucket_scores.staged_bytes`` over ``kernel.bucket_scores.row_bytes``
(:mod:`hxbench.program_spans`).  About 1.0 where the queries stay
resident in shared memory; 1 + B / 256 where each 256-row cluster tile
stages its B queries again beside the rows (the streamed plan, wide D:
2.0 at B = 256)."""

from hxbench.program_spans import snapshot


def read(run):
    snap = snapshot(run)
    if snap is None:
        return None
    staged = snap.counts.get("kernel.bucket_scores.staged_bytes")
    rows = snap.counts.get("kernel.bucket_scores.row_bytes")
    return staged / rows if staged and rows else None
