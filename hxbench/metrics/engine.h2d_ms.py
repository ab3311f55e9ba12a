"""Mean host time, in ms, of one dispatch's query upload
(``engine.h2d``: ``torch.from_numpy(qs).to(device)`` from pageable
memory, which waits behind the device work queued before it).
Read from the program's own spans (:mod:`hxbench.program_spans`)."""

from hxbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "engine.h2d")
