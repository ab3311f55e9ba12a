"""Mean host time, in ms, of the copy of the live mask that one dispatch
of the exact search keeps for its ``finalize()`` (``engine.mask_copy``).
Read from the program's own spans (:mod:`hxbench.program_spans`)."""

from hxbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "engine.mask_copy")
