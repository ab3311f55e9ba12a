"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m hxbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (the rows made on the card from the seed, the engine filled
through ``Partition.add_bulk``, the harness's own copy of the rows
dropped, the query pool and, for a write mix, the rows to insert drawn,
the cell's shapes warmed, for HTTP cells the gateway and its clients
started) is timed from the process's start as ``setup_s``; then the
window runs for ``--seconds``.  Before the window, standard error
names the rung of the residency ladder that serves
(``hxbench: rung <name>``) and the process's resident set
(``hxbench: rss_bytes <n>``).  With ``--trace 1`` the window runs under
``torch.profiler`` and the line holds the cell's per-layer metrics
instead of its end-to-end ones.  Once the window has closed and the
device's peak memory is read, the program is freed, the rows are made
again from the seed (bit-equal: the rows' stream and the centres depend
on the seed alone) and a sample of the answers is compared with the
plain reference (:mod:`hxbench.check`).  Under a write mix the newest
acknowledged inserts are searched once more before the program is
freed, and those answers are compared with the sample's.  The last line
of standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error and the last key of the
result.

Exits 2 without printing a result where there is no card or fewer cards
than the cell asks for, and 3 where a module of ``jax``, ``jaxlib``,
``flax``, ``helix_tpu`` or ``benchmarks`` is loaded once the window has
closed."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

from . import check, loops, spec
from .data import Corpus
from .record import Record, Spans
from .trace import traced

FORBIDDEN = ("jax", "jaxlib", "flax", "helix_tpu", "benchmarks")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``: its start in clock
    ticks since boot against the boot-time clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def resident_bytes() -> int:
    """The process's resident set in bytes: ``VmRSS`` of
    ``/proc/self/status``, else the resident pages of
    ``/proc/self/statm`` times the page size."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(
                    torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run_cell(bench: dict, cell: dict, config: dict, mix: dict, seed: int,
             seconds: float, trace: bool, device: torch.device,
             age=process_age_s, min_batches: int = 0) -> dict:
    """One run of one cell; returns the result object.  ``min_batches``
    (rehearsals on a loaded CPU) keeps an engine window open until that
    many batches are answered."""
    from . import system

    record = Record(cell=cell, config=config, traffic=mix)
    spans = Spans(record, traced=trace)
    dim, n_rows = int(config["dim"]), int(config["rows"])
    corpus = Corpus(config["generator"], dim, seed, device)
    # no name holds the rows: the program copies them, and the check
    # makes them again after the window
    engine, part = system.build(config, corpus.rows(n_rows), device)
    if mix["entry"] == "engine":
        loop = loops.EngineLoop(part, mix, corpus, seconds, min_batches)
    elif mix["entry"] == "http":
        loop = loops.HttpLoop(engine, part, mix, config, corpus, seconds,
                              seed)
    else:
        raise spec.SpecError(f"unknown entry {mix['entry']!r}")
    try:
        system.warm(part, loop.warm_batches(), dim, int(mix["k"]), seed)
        print(f"hxbench: rung {system.rung(part)}", file=sys.stderr)
        if mix["entry"] == "http":
            loop.start_clients()
        setup_s = age()
        print(f"hxbench: rss_bytes {resident_bytes()}", file=sys.stderr,
              flush=True)
        out: dict = {}
        with traced(out, trace):
            result = loop.window(seconds, spans)
        dev = device_info(device)
        if mix["entry"] == "http":
            result.update(loop.collect(result, spans))
        record.trace = out.get("trace")
        answers = loops.joined(loop.sample(result, check.SAMPLE, seed),
                               loop.read_back())
    finally:
        loop.close()
    del engine, part, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    limit = check.limits(config, writes=answers is not None and
                         answers[3] is not None)
    if answers is None:
        found = {"bad_answers": 1, "dist_err": float("inf"),
                 "recall_miss": 1.0}
    else:
        rows = Corpus(config["generator"], dim, seed, device).rows(n_rows)
        found = check.numbers(answers[1], answers[2], answers[0], rows,
                              config, device, writes=answers[3])
    found["failed"] = result["failed"]
    correct, checked = check.verdict(found, limit)

    values = dict(result["e2e"], setup_s=setup_s)
    metrics = {}
    if not trace:
        for m in spec.metrics_of(bench, cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in spec.metrics_of(bench, cell["name"], "per_layer"):
            v = spec.reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if record.trace is not None:
            dev["busy_s"] = record.trace["busy_s"]
            dev["window_s"] = record.trace["window_s"]
    line = {"correct": correct, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": dev}
    if trace and record.trace is not None:
        line["breakdown"] = {"device_ops": record.trace["device_ops"],
                             "idle_gaps": record.trace["idle_gaps"]}
    if trace:
        print(json.dumps({"spans_mean_ms": {
            k: float(np.mean(v) * 1e3) for k, v in record.spans.items()},
            "counts": record.counts}), file=sys.stderr)
    line["checked"] = checked
    return line


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m hxbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"hxbench: {args.workload} needs {cell['chips']} CUDA "
              "device(s); none or too few are visible", file=sys.stderr)
        return 2
    config = spec.config(bench, cell["config"])
    mix = spec.traffic(cell)
    line = run_cell(bench, cell, config, mix, args.seed, args.seconds,
                    bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"hxbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, (value, lim) in line["checked"].items():
        print(f"check {name} = {value!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
