"""The port runs where JAX is absent (the GPU machine has none).

A subprocess blocks ``jax`` in ``sys.modules`` before anything else is
imported, then imports every module of ``helix_tpu_torch`` (and
``chip_smoke``) and runs a small engine write and read on the CPU, then
the same under a device-memory budget that puts the index on the int8
rung (its host re-rank is ``helix_tpu.native``).
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
import pkgutil

import numpy as np
import torch

torch.set_num_threads(2)
import helix_tpu_torch

for info in pkgutil.walk_packages(helix_tpu_torch.__path__, "helix_tpu_torch."):
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
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.startswith("jax.")]
assert not [m for m in sys.modules if m.startswith("helix_tpu.engine")]
assert not [m for m in sys.modules if m.startswith("helix_tpu.ops")]
print("NOJAX-OK")
"""


def test_port_imports_and_serves_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX-OK" in proc.stdout
