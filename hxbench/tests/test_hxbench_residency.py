"""The residency ladder's knobs reach the engine from a configuration's
``deployment``, ``system.rung`` names the rung that serves, a budgeted
rehearsal serves an int8 rung and comes out correct, and the rows the
check compares against are made again from the seed, bit for bit the
ones the engine was given."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hxbench import check, run, spec, system
from hxbench.data import Corpus
from helix_tpu_torch.engine import vector
from helix_tpu_torch.ops.quant import QuantizedResident

from .conftest import TINY_ROWS, rehearse, tiny

CPU = torch.device("cpu")
CONFIGS = ["deep10m-cos", "sift1m-l2", "openai5m-cos"]
CELL_OF = {"deep10m-cos": "deep10m-cos.batch256",
           "sift1m-l2": "sift1m-l2.batch256",
           "openai5m-cos": "openai5m-cos.batch256"}
# The int8 rung's device re-rank scores unit rows rounded to float16
# against float32 queries: each component is off by at most 2**-11 of
# itself, so |q.x - q.x16| <= 2**-11 * |q| * |x| = 2**-11 (4.9e-4), where
# the exact rung's f32 re-rank keeps deep's 1e-5.  The recall floor stays
# the configuration's 0.99.
F16_DIST_LIMIT = 2.0 ** -11


def ladder_bytes(config: dict, rows: np.ndarray) -> dict:
    """The partition's own residency accounting for ``rows``, read from
    an unbudgeted build."""
    _, part = system.build(dict(config, deployment=None), rows, CPU)
    return {"exact": part._exact_resident_bytes(),
            "int8_device": part._quant_dev_resident_bytes(),
            "int8_host": part._quant_resident_bytes(),
            "int4": part._quant4_resident_bytes()}


def between(lo: int, hi: int) -> int:
    assert lo < hi
    return (lo + hi) // 2


def budgets(b: dict) -> dict:
    """A budget inside each rung's range, by rung name."""
    return {"int8.device_rerank": between(b["int8_device"], b["exact"]),
            "int8.host_rerank": between(b["int8_host"], b["int8_device"]),
            "int4": between(b["int4"], b["int8_host"]),
            "below_int4": b["int4"] // 2}


def deep_rows(n: int, seed: int = 2**31 + 5) -> tuple[dict, np.ndarray]:
    config = spec.config(spec.load_benchmark(), "deep10m-cos")
    config["rows"] = n
    return config, Corpus(config["generator"], 96, seed, CPU).rows(n)


@pytest.mark.parametrize("name", CONFIGS)
def test_benchmark_configurations_serve_the_exact_rung(bench, name):
    cell, config, _ = tiny(bench, CELL_OF[name], rows=2_048)
    assert config["deployment"]["hbm_budget_bytes"] is None
    rows = Corpus(config["generator"], int(config["dim"]), 2**31 + 9,
                  CPU).rows(2_048)
    engine, part = system.build(config, rows, CPU)
    assert engine.vectors.hbm_budget_bytes is None
    assert part.hbm_budget_bytes is None and part.quant_candidates is None
    assert system.rung(part) == "exact"


def test_the_deployment_knobs_reach_the_partition():
    config, rows = deep_rows(1_024)
    config["deployment"] = dict(config["deployment"],
                                hbm_budget_bytes=123_456_789,
                                quant_candidates=300)
    _, part = system.build(config, rows, CPU)
    assert part.hbm_budget_bytes == 123_456_789
    assert part.quant_candidates == 300
    _, part = system.build({"metric": "cosine"}, rows, CPU)
    assert part.hbm_budget_bytes is None and part.quant_candidates is None


def _spy(monkeypatch) -> list:
    """Record which of ``search_many_async``'s paths served a search."""
    seen: list = []

    def wrap(owner, attr, name):
        real = getattr(owner, attr)

        def spy(*args, **kwargs):
            seen.append(name(kwargs) if callable(name) else name)
            return real(*args, **kwargs)

        monkeypatch.setattr(owner, attr, spy)

    P = vector.Partition
    wrap(P, "_search_host_ivf", "host_ivf")
    wrap(P, "_search_host_exact", "host_exact")
    wrap(QuantizedResident, "search",
         lambda kw: "int8." + ("device" if kw["rerank_device"] else "host")
         + "_rerank")
    wrap(P, "_search_quant4", "int4")
    wrap(P, "_search_sharded", "sharded")
    wrap(vector, "search_packed_async", "exact")
    return seen


@pytest.mark.parametrize("metric,budget,env,want", [
    ("cosine", None, None, "exact"),
    ("cosine", "int8.device_rerank", None, "int8.device_rerank"),
    ("cosine", "int8.device_rerank", "host", "int8.host_rerank"),
    ("cosine", "int8.host_rerank", None, "int8.host_rerank"),
    ("cosine", "int8.host_rerank", "device", "int8.device_rerank"),
    ("cosine", "int4", None, "int4"),
    ("cosine", "below_int4", None, "host_ivf"),
    ("l2", "int8.device_rerank", None, "int8.device_rerank"),
    ("l2", "below_int4", None, "host_exact"),
])
def test_rung_names_the_path_that_serves(monkeypatch, metric, budget, env,
                                         want):
    if env is None:
        monkeypatch.delenv("HELIX_QUANT_RERANK", raising=False)
    else:
        monkeypatch.setenv("HELIX_QUANT_RERANK", env)
    config, rows = deep_rows(4_096)
    config["metric"] = metric
    if budget is not None:
        config["deployment"] = dict(config["deployment"], hbm_budget_bytes=
                                    budgets(ladder_bytes(config, rows))[budget])
    _, part = system.build(config, rows, CPU)
    seen = _spy(monkeypatch)
    part.search_many(rows[:8], 10)
    assert seen == [want]
    assert system.rung(part) == want


@pytest.mark.parametrize("rerank,limit", [
    ("device", F16_DIST_LIMIT),
    ("host", None),            # the f32 host re-rank keeps deep's 1e-5
])
def test_a_budgeted_rehearsal_serves_int8_and_is_correct(
        bench, monkeypatch, capsys, rerank, limit):
    monkeypatch.delenv("HELIX_QUANT_RERANK", raising=False)
    cell, config, mix = tiny(bench, "deep10m-cos.batch256")
    rows = Corpus(config["generator"], 96, 0, CPU).rows(TINY_ROWS)
    config["deployment"] = dict(config["deployment"], hbm_budget_bytes=
                                budgets(ladder_bytes(config, rows))
                                [f"int8.{rerank}_rerank"])
    if limit is not None:
        config["guarantees"] = dict(config["guarantees"], distance=dict(
            config["guarantees"]["distance"], limit=limit))
    line = run.run_cell(bench, cell, config, mix, 2**31 + 17, 1.0, False,
                        CPU, age=lambda: 1.0)
    err = capsys.readouterr().err
    assert f"hxbench: rung int8.{rerank}_rerank\n" in err
    assert line["correct"], line["checked"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["checked"]["dist_err"][1] == (limit or 1e-5)


def test_the_check_gets_the_rows_made_again(bench, monkeypatch, capsys):
    given, got = [], []
    real_build, real_numbers = system.build, check.numbers

    def build(config, rows, device):
        given.append(rows)
        return real_build(config, rows, device)

    def numbers(ids, dists, queries, rows, *args, **kwargs):
        got.append(rows)
        return real_numbers(ids, dists, queries, rows, *args, **kwargs)

    monkeypatch.setattr(system, "build", build)
    monkeypatch.setattr(check, "numbers", numbers)
    line = rehearse(bench, "deep10m-cos.batch256")
    assert line["correct"], line["checked"]
    (a,), (b,) = given, got
    assert b is not a
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert a.tobytes() == b.tobytes()
    err = capsys.readouterr().err.splitlines()
    assert "hxbench: rung exact" in err
    rss = [ln for ln in err if ln.startswith("hxbench: rss_bytes ")]
    assert len(rss) == 1 and int(rss[0].split()[-1]) > 0
    assert err.index(rss[0]) > err.index("hxbench: rung exact")


def test_resident_bytes_without_vmrss_reads_statm(monkeypatch):
    """A ``/proc/self/status`` without ``VmRSS`` falls back to the
    resident pages of ``/proc/self/statm``."""
    import io

    real_open = open

    def fake_open(path, *args, **kwargs):
        if path == "/proc/self/status":
            return io.StringIO("Name:\tpython3\nVmSize:\t1 kB\n")
        return real_open(path, *args, **kwargs)

    with_vmrss = run.resident_bytes()
    monkeypatch.setattr(run, "open", fake_open, raising=False)
    from_statm = run.resident_bytes()
    with real_open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    page = run.os.sysconf("SC_PAGE_SIZE")
    # the readings of one process a moment apart
    assert abs(from_statm - pages * page) < 1 << 26
    assert abs(from_statm - with_vmrss) < 1 << 26
