"""Mean host time, in ms, that one ``finalize()`` of the exact search
waited for the device to finish the batch and copy its top-k back
(``engine.d2h_wait``).
Read from the program's own spans (:mod:`hxbench.program_spans`)."""

from hxbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "engine.d2h_wait")
