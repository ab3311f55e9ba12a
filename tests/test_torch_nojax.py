"""The port runs where JAX is absent (the GPU machine has none), and
loads nothing of the JAX package.

A subprocess blocks ``jax`` in ``sys.modules`` before anything else is
imported, then imports every module of ``helix_tpu_torch`` (and
``chip_smoke``) and runs a small engine write and read on the CPU, then
the same under device-memory budgets that put the index on the int8
rung (its host re-rank is the port's ``native``) and on the host-IVF
rung, then a traversal on the device path, a BM25 search on device
postings, a parse through the port's ``fastjson``, the mesh paths on a
virtual mesh of 4 CPU devices (a sharded engine's exact and int8 reads,
a sharded traversal and BM25 search, ``graft.dryrun_multichip(4)``), and
the serving
slice: an engine on a data dir writes and closes (checkpoint + WAL), a
``NativeGateway`` recovers it, installs a bundle over HTTP and answers a
stored vector route on the fast path, then the kernel sweeps' entry
points (``benchmarks.onepass_sweep``, ``benchmarks.i8_sweep``) on the
CPU at 12,000 rows, and the ladder's (``benchmarks.ladder``,
``quant_demo``, ``beyond_hbm_demo`` at 8,192 rows,
``build_ladder_baseline`` at 2,000 into a temporary cache), and the
last four scripts' (``tile_sweep``, ``exact_sweep``,
``traversal_decomp`` at 8,192, ``soak`` at 1,024 rows for 1 s).  At the
end
no ``helix_tpu``
module (the package or any of its submodules) may be in
``sys.modules``.

A second run blocks ``jax`` and ``helix_tpu`` in every process it
starts: a ``sitecustomize.py`` on a temporary ``PYTHONPATH`` entry
installs a meta-path finder that refuses both (and records any attempt
on ``helix_tpu``) and, at exit, records any such module loaded.  Under
it the port's CLI runs a lifecycle (``init``, a supervised ``start
--device cpu``, ``query``, ``stop``) and the port's HA front serves a
write and reads over a primary and a replica of the port's server.
Nothing may be recorded.
"""

import os
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

from helix_tpu_torch import graft
from helix_tpu_torch.ops.bm25 import ShardedBM25
from helix_tpu_torch.parallel import graph as sharded_graph
from helix_tpu_torch.parallel import virtual_devices

with virtual_devices("cpu", 4):
    part = write_and_read(Engine(device="cpu", shard_threshold=1))
    assert part._shard_state["kind"] == "exact", part._shard_state
    # host re-rank: the exact $distance write_and_read checks (per shard
    # the f16 copy fits, so auto would re-rank on the device in f16)
    os.environ["HELIX_QUANT_RERANK"] = "host"
    part = write_and_read(Engine(device="cpu", hbm_budget_bytes=1_000_000))
    del os.environ["HELIX_QUANT_RERANK"]
    assert part._shard_state["kind"] == "int8" and part.quant is None
    engine.graph_shard_threshold = 1
    part = engine.texts.indexes[("NodeText", "P", "body")].partitions[("",)]
    part._device = None
    out = engine.execute(request("read", [{"N": {"Ids": [1]}},
                                          {"Out": "next"}, "Dedup", "Count"],
                                 {}, {}, returns=["r"]))
    assert out["r"] == 1, out
    out = engine.execute(request("read", [{"TextSearchNodes": {
        "label": "P", "property": "body",
        "query_text": {"Expr": {"Param": "q"}},
        "k": {"Expr": {"Param": "k"}}}}, {"ValueMap": ["$id", "x"]}],
        {"q": "node 2", "k": 2}, {"q": "String", "k": "I64"}, returns=["r"]))
    assert out["r"][0]["x"] == 2 and isinstance(part._device[1], ShardedBM25)
    snap = engine.snapshots.get()
    assert isinstance(snap.sharded_graph(("out",)), sharded_graph.ShardedGraph)
graft.dryrun_multichip(4, "cpu")

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

from helix_tpu_torch.benchmarks import i8_sweep, onepass_sweep

assert onepass_sweep.main(["--device", "cpu", "--n", "12000", "--rounds",
                           "2", "--tiles", "2"]) == 0
assert i8_sweep.main(["--device", "cpu", "--n", "12000", "--rounds", "2",
                      "--variants", "shipped,i32pack,bf16dot,xT"]) == 0

from helix_tpu_torch.benchmarks import (beyond_hbm_demo,
                                        build_ladder_baseline, ladder,
                                        quant_demo)

assert ladder.main(["--device", "cpu", "--n", "8192", "--batch", "64",
                    "--rounds", "2"]) == 0
assert quant_demo.main(["--device", "cpu", "--n", "8192", "--queries", "64",
                        "--rounds", "2", "--bits", "4"]) == 0
assert beyond_hbm_demo.main(["--device", "cpu", "--n", "8192", "--queries",
                             "64", "--hbm-budget-gb", "0.001"]) == 0
baseline_dir = tempfile.mkdtemp()
try:
    assert build_ladder_baseline.main(
        ["--n", "2000", "--batch", "32", "--rounds", "1",
         "--cache-dir", baseline_dir]) == 0
finally:
    shutil.rmtree(baseline_dir)

from helix_tpu_torch.benchmarks import (exact_sweep, soak, tile_sweep,
                                        traversal_decomp)

assert tile_sweep.main(["--device", "cpu", "--n", "8192", "--tiles", "2",
                        "--rounds", "2"]) == 0
assert exact_sweep.main(["--device", "cpu", "--n", "8192", "--chunks",
                         "4096", "--int8", "--rounds", "2"]) == 0
assert traversal_decomp.main(["--device", "cpu", "--n", "8192", "--deg",
                              "2", "--rounds", "2"]) == 0
assert soak.main(["--device", "cpu", "--n", "1024", "--seconds", "1"]) == 0
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


SITECUSTOMIZE = r"""
import atexit
import os
import sys

BLOCKED = ("jax", "helix_tpu")
LOG = os.environ["HELIX_REFUSED_LOG"]


def _note(line):
    with open(LOG, "a") as fh:
        fh.write(line + "\n")


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            if name.split(".")[0] == "helix_tpu":
                _note(f"{os.getpid()} tried {name}")
            raise ModuleNotFoundError(f"{name} is blocked", name=name)
        return None


sys.meta_path.insert(0, _Refuse())


@atexit.register
def _loaded():
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED and sys.modules[name] is not None:
            _note(f"{os.getpid()} loaded {name}")
"""

CLI_AND_FRONT = r"""
import contextlib
import io
import json
import os
import socket
import sys
import time
import urllib.request

from helix_tpu_torch.cli.main import main

proj = sys.argv[1]
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]


def cli(*args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = main(list(args))
    assert code == 0, (args, code, out.getvalue())
    return out.getvalue()


cli("init", "--path", proj, "--port", str(port))
os.chdir(proj)
cli("start", "dev", "--device", "cpu", "--restart", "unless-stopped")
try:
    got = json.loads(cli("query", "dev", "--file", "examples/request.json",
                         "--compact"))
    assert got == {"node_count": 0}, got
    assert "running" in cli("status")
finally:
    cli("stop", "dev")
assert "stopped" in cli("status")

from helix_tpu_torch.server import HelixHTTPServer
from helix_tpu_torch.server.ha_front import HAFront


def post(path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{front.port}{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def query(kind, steps, returns=()):
    return {"request_type": kind, "query_name": None, "parameters": {},
            "query": {"queries": [{"Query": {"name": "r", "steps": steps,
                                             "condition": None}}],
                      "returns": list(returns)}}


primary = HelixHTTPServer(host="127.0.0.1", port=0, device="cpu")
primary.start()
replica = HelixHTTPServer(host="127.0.0.1", port=0, device="cpu",
                          replica_of=f"http://127.0.0.1:{primary.port}")
replica.start()
front = HAFront(f"http://127.0.0.1:{primary.port}",
                [f"http://127.0.0.1:{replica.port}"], host="127.0.0.1",
                probe_s=0.2)
front.start()
try:
    assert front._px is not None, "the native proxy did not start"
    post("/v1/query", query("write", [{"AddN": {"label": "U",
                                                "properties": []}}]))
    count = query("read", [{"NWhere": {"Eq": ["$label", {"String": "U"}]}},
                           "Count"], returns=["r"])
    deadline = time.time() + 30
    while replica.follower.applied_seq < 0 and time.time() < deadline:
        time.sleep(0.05)
    assert [post("/v1/query", count)["r"] for _ in range(4)] == [1] * 4
finally:
    front.stop()
    replica.stop()
    primary.stop()
print("BLOCKED-OK")
"""


def test_cli_and_ha_front_run_with_the_reference_blocked(tmp_path):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    log = tmp_path / "refused.log"
    env = dict(os.environ, HELIX_REFUSED_LOG=str(log),
               PYTHONPATH=os.pathsep.join([str(site), str(ROOT)]),
               HELIX_SUPERVISOR_BACKOFF_BASE="0.1")
    proc = subprocess.run(
        [sys.executable, "-c", CLI_AND_FRONT, str(tmp_path / "proj")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED-OK" in proc.stdout
    assert log.exists() is False or log.read_text() == "", log.read_text()
    server_log = tmp_path / "proj" / ".helix" / "dev" / "server.log"
    assert "Traceback" not in server_log.read_text()
