"""Mean host time, in ms, to enqueue one dispatch's search on the device
(``kernel.enqueue``: the ``resident_topk_auto`` call, launching kernel 1
or the score step, the selection and the re-rank).
Read from the program's own spans (:mod:`hxbench.program_spans`)."""

from hxbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "kernel.enqueue")
