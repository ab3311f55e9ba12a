"""The control of the comparison: the plain reference put in the
program's place and computed one precision below the configuration's
float32, in bfloat16.  Its answers go through the same comparison as a
run's (:func:`hxbench.check.numbers`) and have to come out not correct;
the benchmark's own runs never run it.  One process, one configuration,
several seeds (the rows made as a run makes them, and as many queries as
a run compares)::

    python3 -m hxbench.control --config deep10m-cos --seeds 11,12,13

prints one JSON line per seed: the numbers, their limits and whether
they pass."""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check, reference, spec
from .data import Corpus


def control_numbers(config: dict, seed: int, device: torch.device,
                    n_queries: int = check.SAMPLE) -> dict:
    corpus = Corpus(config["generator"], int(config["dim"]), seed, device)
    rows = corpus.rows(int(config["rows"]))
    queries = corpus.queries(n_queries)
    k, metric = int(config["k"]), config["metric"]
    low_d, low_i = reference.exact_topk(rows, queries, k, metric, device,
                                        dtype=torch.bfloat16)
    found = check.numbers(low_i + 1, low_d, queries, rows, config, device)
    found["failed"] = 0
    return found


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m hxbench.control")
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hxbench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    config = spec.config(spec.load_benchmark(), args.config)
    limit = check.limits(config)
    for seed in (int(s) for s in args.seeds.split(",")):
        found = control_numbers(config, seed, device)
        correct, checked = check.verdict(found, limit)
        print(json.dumps({"config": args.config, "seed": seed,
                          "correct": correct, "checked": checked}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
