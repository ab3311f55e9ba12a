"""Mean host time, in ms, in which the native gateway's C++ formatted and
queued the responses of one dispatched group (``server.respond``:
``hxgw_respond_vbatch``), in the HTTP cells.
Read from the program's own spans (:mod:`hxbench.program_spans`)."""

from hxbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "server.respond", entry="http")
