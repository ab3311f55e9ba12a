"""Mean queries in one batch that the native gateway's vbatch loop pulled
from its C++ queue: the ``server.vbatch_queries`` counter over the
``server.vbatch`` spans, in the HTTP cells.  Read from the program's own
spans and counter (:mod:`hxbench.program_spans`)."""

from hxbench.program_spans import snapshot


def read(run):
    snap = snapshot(run, entry="http")
    if snap is None:
        return None
    batches = sum(1 for r in snap.spans if r[0] == "server.vbatch")
    queries = snap.counts.get("server.vbatch_queries")
    return queries / batches if batches and queries else None
