"""Shared fixtures of the harness's tests: tiny configurations on the CPU,
and a fixture that decides at run time whether a card is present."""

from __future__ import annotations

import time

import pytest
import torch

from hxbench import run, spec

TINY_ROWS = 20_000
# The HTTP cell swept and measured on the card but left out of
# BENCHMARK.json (PERF.md, Open questions): its machinery stays tested.
HTTP_CELL = {"name": "deep10m-cos.http1", "config": "deep10m-cos",
             "traffic": "http1", "chips": 1}
# The write mix's cell, which a later change adds to BENCHMARK.json
# (PERF.md, Open questions): YCSB D's 95% searches / 5% inserts.
WRITE_CELL = {"name": "deep10m-cos.ycsb-d", "config": "deep10m-cos",
              "traffic": "ycsb-d", "chips": 1}
LEFT_OUT = {c["name"]: c for c in (HTTP_CELL, WRITE_CELL)}


def cell_of(bench, name: str) -> dict:
    return LEFT_OUT.get(name) or spec.workload(bench, name)


@pytest.fixture
def bench():
    return spec.load_benchmark()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest hxbench/tests -m cuda)")
    return torch.device("cuda", 0)


def tiny(bench, name: str, rows: int = TINY_ROWS):
    """``(cell, config, mix)`` of a cell cut to ``rows`` rows and a small
    load, for a rehearsal.  The query pool starts small: it grows in the
    window where the run outpaces it."""
    cell = cell_of(bench, name)
    config = spec.config(bench, cell["config"])
    config["rows"] = rows
    mix = spec.traffic(cell)
    if mix["entry"] == "engine":
        mix["pool_qps"] = 2_000
    else:
        mix["rate_per_s"] = 150
    return cell, config, mix


def rehearse(bench, name: str, *, trace: bool = False, seconds: float = 1.0,
             seed: int = 2**31 + 11, device=torch.device("cpu"),
             rows: int = TINY_ROWS):
    cell, config, mix = tiny(bench, name, rows)
    t0 = time.perf_counter()
    # a loaded CPU may answer no batch inside 1 s: the window then closes
    # at the first answer
    return run.run_cell(bench, cell, config, mix, seed, seconds, trace,
                        device, age=lambda: time.perf_counter() - t0,
                        min_batches=1)
