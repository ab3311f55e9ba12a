"""Share of the traced window, in %, in which the card ran no kernel and
no copy (the union of the profiler's device intervals), in the
closed-loop batch cells."""


def read(run):
    trace = run.trace
    if not trace or not trace["busy_s"] or run.traffic.get("entry") != "engine":
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
