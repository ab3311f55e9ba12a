"""The port runs where JAX is absent (the GPU machine has none), and
loads nothing of the JAX package.

A subprocess blocks ``jax`` in ``sys.modules`` before anything else is
imported, then imports every module of ``helix_tpu_torch`` (and
``chip_smoke``) and runs a small engine write and read on the CPU, then
the same under device-memory budgets that put the index on the int8
rung (its host re-rank is the port's ``native``) and on the host-IVF
rung, then a traversal on the device path, a BM25 search on device
postings, a parse through the port's ``fastjson``, and the serving
slice: an engine on a data dir writes and closes (checkpoint + WAL), a
``NativeGateway`` recovers it, installs a bundle over HTTP and answers a
stored vector route on the fast path.  At the end no ``helix_tpu``
module (the package or any of its submodules) may be in
``sys.modules``.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys
for name in [m for m in sys.modules if m == "jax" or m.startswith("jax.")]:
    del sys.modules[name]
sys.modules["jax"] = None

import importlib
import importlib.util
import pkgutil

import numpy as np
import torch

torch.set_num_threads(2)
import helix_tpu_torch

for info in pkgutil.walk_packages(helix_tpu_torch.__path__, "helix_tpu_torch."):
    # the Python modules; native/ also holds its g++ build outputs (*.so)
    if importlib.util.find_spec(info.name).origin.endswith(".py"):
        importlib.import_module(info.name)
import chip_smoke  # noqa: F401

from helix_tpu_torch.engine import Engine

rng = np.random.default_rng(0)
rows = rng.normal(size=(5000, 32)).astype(np.float32)


def request(kind, steps, params, types, returns=()):
    return {"request_type": kind, "query_name": "q",
            "query": {"queries": [{"Query": {"name": "r", "steps": steps,
                                             "condition": None}}],
                      "returns": list(returns)},
            "parameters": params, "parameter_types": types}


def write_and_read(engine):
    engine.execute(request("write", [{"CreateIndex": {"spec": {"NodeVector": {
        "label": "Doc", "property": "emb", "tenant_property": None}},
        "if_not_exists": True}}], {}, {}))
    engine.execute({
        "request_type": "write", "query_name": "ingest",
        "query": {"queries": [{"ForEach": {"param": "docs", "body": [
            {"Query": {"name": "d", "steps": [{"AddN": {"label": "Doc",
                "properties": [["emb", {"Expr": {"Param": "docs.emb"}}]]}}],
                "condition": None}}]}}], "returns": []},
        "parameters": {"docs": [{"emb": r} for r in rows.tolist()]},
        "parameter_types": {"docs": {"Array": "Object"}},
    })
    out = engine.execute(request("read", [
        {"VectorSearchNodes": {"label": "Doc", "property": "emb",
                               "query_vector": {"Expr": {"Param": "q"}},
                               "k": {"Expr": {"Param": "k"}}}},
        {"ValueMap": ["$id", "$distance"]}],
        {"q": rows[42].tolist(), "k": 5}, {"q": {"Array": "F32"}, "k": "I64"},
        returns=["r"]))
    hits = out["r"]
    assert len(hits) == 5 and hits[0]["$id"] == 43, hits
    assert abs(hits[0]["$distance"]) < 1e-6, hits
    return engine.vectors.indexes[("NodeVector", "Doc", "emb")].partitions[("",)]


write_and_read(Engine(device="cpu"))
# 5000 rows at dim_pad 128: int8 codes (660 kB) fit, exact copies do not
part = write_and_read(Engine(device="cpu", hbm_budget_bytes=1_000_000))
assert part._use_quant() and part.quant is not None
# int4 (340 kB) does not fit either: the host-IVF rung serves
part = write_and_read(Engine(device="cpu", hbm_budget_bytes=200_000))
assert part._use_host_ivf() and part.host_ivf is not None

import os

from helix_tpu_torch.engine.exec import Executor

Executor.device_traversal_min_nodes = 0
os.environ["HELIX_TRAVERSAL_BACKEND"] = "device"
engine = Engine(device="cpu")
engine.execute(request("write", [{"CreateIndex": {"spec": {"NodeText": {
    "label": "P", "property": "body", "tenant_property": None}},
    "if_not_exists": True}}], {}, {}))
for x in range(4):
    engine.execute(request("write", [{"AddN": {"label": "P", "properties": [
        ["x", {"Value": {"I64": x}}],
        ["body", {"Value": {"String": f"node {x} of a chain"}}]]}}], {}, {}))
engine.execute(request("write", [{"N": {"Ids": [1, 2, 3]}}, {"AddE": {
    "label": "next", "to": {"Ids": [4]}, "properties": []}}], {}, {}))
out = engine.execute(request("read", [{"N": {"Ids": [1]}}, {"Out": "next"},
                                      "Dedup", "Count"], {}, {}, returns=["r"]))
assert out["r"] == 1 and engine._traversal_router.runs["device"] == 1, out
part = engine.texts.indexes[("NodeText", "P", "body")].partitions[("",)]
part.device_threshold = 1
out = engine.execute(request("read", [{"TextSearchNodes": {
    "label": "P", "property": "body", "query_text": {"Expr": {"Param": "q"}},
    "k": {"Expr": {"Param": "k"}}}}, {"ValueMap": ["$id", "x"]}],
    {"q": "node 2", "k": 2}, {"q": "String", "k": "I64"}, returns=["r"]))
assert out["r"][0]["x"] == 2 and part._device[1] is not None, out
from helix_tpu_torch import fastjson

parsed = fastjson.loads(b'{"v": [' + b", ".join([b"0.5"] * 40) + b"]}",
                        fast_arrays=True)
assert list(parsed["v"]) == [0.5] * 40, parsed

import json
import shutil
import tempfile
import urllib.request

from helix_tpu_torch.server.native_gateway import NativeGateway

data_dir = tempfile.mkdtemp()
try:
    disk = Engine(device="cpu", data_dir=data_dir)
    write_and_read(disk)
    disk.close()
    gw = NativeGateway(host="127.0.0.1", port=0, data_dir=data_dir,
                       device="cpu")
    gw.start()
    try:
        def post(path, body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{gw.port}{path}",
                data=json.dumps(body).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.loads(resp.read())

        post("/v1/bundle", {"version": 5, "read_routes": {"vs": {
            "queries": [{"Query": {"name": "r", "steps": [
                {"VectorSearchNodes": {"label": "Doc", "property": "emb",
                                       "query_vector": {"Expr": {"Param": "q"}},
                                       "k": {"Expr": {"Param": "k"}}}},
                {"ValueMap": ["$id", "$distance"]}], "condition": None}}],
            "returns": ["r"]}}, "read_parameters": {"vs": [
                {"name": "q", "ty": {"Array": "F32"}}, {"name": "k", "ty": "I64"}]},
            "write_routes": {}, "write_parameters": {}})
        hits = post("/v1/query/vs", {"q": rows[42].tolist(), "k": 5})["r"]
        assert hits[0]["$id"] == 43 and len(hits) == 5, hits
        assert gw.stats()["fast_requests"] == 1, gw.stats()
    finally:
        gw.stop()
finally:
    shutil.rmtree(data_dir)
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.startswith("jax.")]
loaded = [m for m in sys.modules
          if m == "helix_tpu" or m.startswith("helix_tpu.")]
assert not loaded, loaded
print("NOJAX-OK")
"""


def test_port_imports_and_serves_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX-OK" in proc.stdout
