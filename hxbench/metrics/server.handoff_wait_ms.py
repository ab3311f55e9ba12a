"""Mean time, in ms, that one dispatched group of the native gateway's
vbatch loop waited in the hand-off queue for a finalizer
(``server.handoff_wait``), in the HTTP cells.
Read from the program's own spans (:mod:`hxbench.program_spans`)."""

from hxbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "server.handoff_wait", entry="http")
