"""Mean queries per engine dispatch that the gateway's vbatch loop
formed: queries over calls of the served partition's
``search_many_async`` from the window's start until its last request was
answered (:class:`hxbench.loops.Counted`)."""


def read(run):
    n = run.counts.get("dispatches", 0)
    if run.traffic.get("entry") != "http" or not n:
        return None
    return run.counts["queries_dispatched"] / n
