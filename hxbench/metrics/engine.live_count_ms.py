"""Mean host time, in ms, of the live-row count in one dispatch of the exact
search (``engine.live_count``: ``valid_mask[: n].sum()`` in
``ops/distance.py:search_packed_async``).
Read from the program's own spans (:mod:`hxbench.program_spans`)."""

from hxbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "engine.live_count")
