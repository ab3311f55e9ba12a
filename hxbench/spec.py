"""Find what a cell needs by the names ``BENCHMARK.json`` gives: its
configuration file, its traffic mix (with the cell's own overrides), and
the readers of its per-layer metrics."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class SpecError(RuntimeError):
    pass


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise SpecError(f"{path} not found")
    return json.loads(path.read_text())


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            cfg = json.loads((root / entry["file"]).read_text())
            cfg["name"] = name
            return cfg
    raise SpecError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(cell: dict, here: Path = HERE) -> dict:
    """The mix's parameters, then the cell's own file over them."""
    path = here / "traffic" / f"{cell['traffic']}.json"
    if not path.exists():
        raise SpecError(f"no traffic mix file {path}")
    mix = json.loads(path.read_text())
    mix["name"] = cell["traffic"]
    own = here / "cells" / f"{cell['name']}.json"
    if own.exists():
        mix.update(json.loads(own.read_text()))
    return mix


def metrics_of(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports:
    those that list it under ``workloads``, and those with no list."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str, here: Path = HERE):
    """``read(run)`` of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    if not path.exists():
        raise SpecError(f"no reader {path} for per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"hxbench_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
