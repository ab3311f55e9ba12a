"""As ``device.idle_pct.batch``, in the HTTP cells."""


def read(run):
    trace = run.trace
    if not trace or not trace["busy_s"] or run.traffic.get("entry") != "http":
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
