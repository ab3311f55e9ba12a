"""Find the knee of an HTTP cell: the highest offered rate at which the
completed rate keeps up with the offered one and the backlog does not
grow over the window.  One set-up, then one window per rate::

    python3 -m hxbench.sweep --workload deep10m-cos.http1 --seed 5 \\
        --seconds 10 --rates 2000,4000,8000

Prints one JSON line per rate: offered and completed rates, p50 / p95,
the mean latency of the window's first and last quarter of requests, and
the generator's lateness.  The cell's rate (``cells/<cell>.json``) is
set at about four fifths of the knee; the runs of the benchmark never
sweep."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import loops, record, spec, system
from .data import Corpus


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m hxbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--clients", type=int, default=None,
                    help="client processes (default: the mix's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hxbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    config = spec.config(bench, cell["config"])
    mix = spec.traffic(cell)
    if args.clients:
        mix["clients"] = args.clients
    device = torch.device("cuda", 0)
    corpus = Corpus(config["generator"], int(config["dim"]), args.seed, device)
    # the program copies the rows; nothing here checks answers, so no
    # name holds them
    engine, part = system.build(config, corpus.rows(int(config["rows"])),
                                device)
    gw = system.serve(engine)
    try:
        warmed = False
        for i, rate in enumerate(int(r) for r in args.rates.split(",")):
            run_mix = dict(mix, rate_per_s=rate)
            loop = loops.HttpLoop(engine, part, run_mix, config, corpus,
                                  args.seconds, args.seed + i, gw=gw)
            if not warmed:
                system.warm(part, loop.warm_batches(), int(config["dim"]),
                            int(mix["k"]), args.seed)
                warmed = True
            rec = record.Record(cell=cell, config=config, traffic=run_mix)
            spans = record.Spans(rec, traced=False)
            loop.start_clients()
            try:
                result = loop.window(args.seconds, spans)
                result.update(loop.collect(result, spans))
            finally:
                loop.close()
            lat = loop.latencies
            q = max(1, len(lat) // 4)
            done_in_window = np.sum(loop.due + lat <= args.seconds)
            print(json.dumps({
                "rate_per_s": rate,
                "completed_per_s": float(done_in_window / args.seconds),
                "failed": result["failed"],
                "p50_ms": result["e2e"]["p50_ms"],
                "p95_ms": result["e2e"]["p95_ms"],
                "first_quarter_mean_ms": float(np.mean(lat[:q]) * 1e3),
                "last_quarter_mean_ms": float(np.mean(lat[-q:]) * 1e3),
                "clients": run_mix["clients"],
                "queries_per_dispatch": rec.counts.get("queries_dispatched", 0)
                / max(1, rec.counts.get("dispatches", 0)),
            }), flush=True)
    finally:
        gw.stop(close_engine=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
