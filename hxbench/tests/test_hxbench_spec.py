"""Discovery by name, and the shape of ``BENCHMARK.json``."""

from __future__ import annotations

import json
import re

import pytest

from hxbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_config_mix_and_metrics(bench):
    for cell in bench["workloads"]:
        config = spec.config(bench, cell["config"])
        assert {"rows", "dim", "metric", "k", "generator",
                "guarantees", "reduced", "assumed"} <= set(config)
        mix = spec.traffic(cell)
        assert mix["entry"] in ("engine", "http")
        assert int(mix["k"]) == int(config["k"])
        e2e = {m["name"] for m in spec.metrics_of(bench, cell["name"],
                                                  "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.metrics_of(bench, cell["name"], "per_layer")
        assert layer
        for m in layer:
            assert callable(spec.reader(m["name"]))


def test_names_units_and_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    layers = set()
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        layers.add(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert layers <= {"server", "engine", "kernel", "device"}
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert c["reduced"] == json.loads(
            (spec.ROOT / c["file"]).read_text())["reduced"]
    for w in bench["workloads"]:
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200


def test_cell_file_overrides_its_mix(tmp_path):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "cells").mkdir()
    (tmp_path / "traffic" / "m.json").write_text('{"rate_per_s": 10, "k": 5}')
    (tmp_path / "cells" / "c.m.json").write_text('{"rate_per_s": 7}')
    mix = spec.traffic({"name": "c.m", "traffic": "m"}, here=tmp_path)
    assert mix == {"rate_per_s": 7, "k": 5, "name": "m"}
    other = spec.traffic({"name": "d.m", "traffic": "m"}, here=tmp_path)
    assert other["rate_per_s"] == 10


def test_the_left_out_http_cell_finds_its_files(bench):
    from .conftest import HTTP_CELL

    mix = spec.traffic(HTTP_CELL)
    assert mix["entry"] == "http" and mix["rate_per_s"] > 0
    for name in ("server.queries_per_dispatch", "device.idle_pct.http"):
        assert callable(spec.reader(name))


def test_unknown_names_raise(bench):
    with pytest.raises(spec.SpecError):
        spec.workload(bench, "no-such.cell")
    with pytest.raises(spec.SpecError):
        spec.config(bench, "no-such-config")
    with pytest.raises(spec.SpecError):
        spec.reader("no.such_metric")


def test_a_reader_that_finds_nothing_returns_none(bench):
    from hxbench.record import Record

    for m in bench["per_layer"]:
        empty = Record(cell={}, config={"rows": 1, "dim": 1},
                       traffic={"entry": "engine", "batch": 1, "k": 1})
        assert spec.reader(m["name"])(empty) is None
