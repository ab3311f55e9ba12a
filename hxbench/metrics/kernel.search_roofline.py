"""The search's share of its roofline, in %: the least time of one
batch's search from the configuration's published shapes
(:func:`hxbench.peaks.search_work`, :func:`hxbench.peaks.least_seconds`)
over the device time per batch, which is the sum of the profiler's CUDA
kernel durations in the window over the batches dispatched in it.  Only
for closed-loop batch cells: a batch there has one known size."""

from hxbench import peaks


def read(run):
    trace = run.trace
    batches = run.counts.get("batches", 0)
    batch = run.traffic.get("batch")
    if not trace or not trace["kernel_s"] or not batches or not batch:
        return None
    n_bytes, ops = peaks.search_work(int(run.config["rows"]),
                                     int(run.config["dim"]), int(batch),
                                     int(run.traffic["k"]))
    least, _ = peaks.least_seconds(n_bytes, ops)
    return 100.0 * least / (trace["kernel_s"] / batches)
