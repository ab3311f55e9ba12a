"""The residency ladder of the port's ``Partition`` and ``Engine`` against
the JAX reference's, on one device.

The reference's CPU tests run on 8 virtual devices, where its
``Partition`` routes the int8 and int4 rungs to the mesh search; these
tests pin it to one device (``jax.devices`` patched, as
``tests/test_quant4_gate.py`` does), which is what the port serves.

Tolerances: rung predicates equal; hits equal by id; ``$distance`` equal
after the host re-rank (the same native f32 code on both sides) and
within 1e-6 after the f16 device re-rank (f32 sums in another order).
"""

import json

import numpy as np
import pytest
import torch

import helix_tpu.ops.quant4 as JQ4
from helix_tpu.engine import Engine as RefEngine
from helix_tpu.engine.vector import Partition as RefPartition
from helix_tpu_torch.engine import Engine as PortEngine
from helix_tpu_torch.engine.vector import Partition as PortPartition
from helix_tpu_torch.ops import quant4 as TQ4

from tests.test_torch_engine import (
    BUNDLE,
    create_index,
    drop,
    gaussian_vectors,
    ingest,
    search,
)

torch.set_num_threads(2)

RERANK_TOL = 1e-6


@pytest.fixture
def single_device(monkeypatch):
    import jax

    dev = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: [dev])


def partitions(metric, n=4096, d=16, seed=3, **knobs):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, d)).astype(np.float32)
    ref = RefPartition(metric, **knobs)
    port = PortPartition(metric, device=torch.device("cpu"), **knobs)
    for part in (ref, port):
        part.add_bulk(list(range(1, n + 1)), data)
    return ref, port


def rung_state(part):
    state = (part._use_quant(), part._use_quant4(), part._use_host_exact(),
             part._use_host_ivf())
    if part.hbm_budget_bytes is not None:
        state += (part._quant_rerank_device(),)
    return state


# Per row at dim_pad 128: exact 768 B, f16 re-rank set 392 B, int8 132 B,
# int4 68 B.  n = 4096 rows.
BUDGETS = {
    "exact": 4_000_000,
    "int8+device re-rank": 2_000_000,
    "int8": 1_000_000,
    "int4": 400_000,
    "host": 200_000,
}


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("budget", [None, *BUDGETS.values()],
                         ids=["none", *BUDGETS])
def test_rung_gating_matches_reference(metric, budget, single_device):
    ref, port = partitions(metric, hbm_budget_bytes=budget)
    assert rung_state(port) == rung_state(ref)
    for method in ("_exact_resident_bytes", "_quant_resident_bytes",
                   "_quant4_resident_bytes", "_quant_dev_resident_bytes"):
        assert getattr(port, method)() == getattr(ref, method)()


@pytest.mark.parametrize("mode", ["auto", "host", "device"])
def test_rerank_override_matches_reference(mode, monkeypatch):
    monkeypatch.setenv("HELIX_QUANT_RERANK", mode)
    for budget in (BUDGETS["int8"], BUDGETS["int8+device re-rank"]):
        ref, port = partitions("cosine", hbm_budget_bytes=budget)
        assert port._quant_rerank_device() == ref._quant_rerank_device()


def test_int4_pool_cap_walks_past_the_rung_like_the_reference(
        single_device, monkeypatch):
    monkeypatch.setattr(JQ4, "INT4_MAX_POOL", 64)
    monkeypatch.setattr(TQ4, "INT4_MAX_POOL", 64)
    ref, port = partitions("cosine", hbm_budget_bytes=BUDGETS["int4"])
    assert rung_state(port) == rung_state(ref)
    assert not port._use_quant4() and port._use_host_ivf()
    # an explicit pool at least as wide as the safe pool re-enables int4
    for part in (ref, port):
        part.quant_candidates = TQ4.recall_safe_pool_int4(part.matrix.n)
    assert rung_state(port) == rung_state(ref)
    assert port._use_quant4() and not port._use_host_ivf()


def test_host_ivf_rung_raises_not_implemented():
    """The host-IVF rung, which raised NotImplementedError before the
    port had ``ops/ivf.py``, now serves: a read finds its own row."""
    _, port = partitions("cosine", hbm_budget_bytes=BUDGETS["host"])
    assert port._use_host_ivf()
    ids, dists = port.search_many(port.matrix.data[[7, 99], :16], 5)
    assert port.host_ivf is not None and ids.shape == (2, 5)
    assert ids[:, 0].tolist() == [8, 100] and np.all(dists[:, 0] < 1e-6)


def unit_data(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(48, d)).astype(np.float32)
    return centers[rng.integers(0, 48, size=n)] \
        + 0.3 * rng.normal(size=(n, d)).astype(np.float32)


# Rung budgets for 16,384 rows at dim_pad 128.
SEARCH_CASES = [
    ("cosine", 16_384 * 200, "host"),    # int8, host re-rank
    ("cosine", 16_384 * 200, "device"),  # int8, f16 device re-rank
    ("cosine", 16_384 * 100, "auto"),    # int4
    ("l2", 16_384 * 200, "host"),        # int8 (per-row scales)
    ("l2", 16_384 * 100, "auto"),        # int4 (per-row scales)
    ("l2", 16_384 * 50, "auto"),         # host-exact
]


@pytest.mark.parametrize("metric,budget,mode", SEARCH_CASES)
def test_partition_search_at_each_rung_matches_reference(
        metric, budget, mode, single_device, monkeypatch):
    monkeypatch.setenv("HELIX_QUANT_RERANK", mode)
    n, d = 16_384, 64
    data = unit_data(n, d, seed=5)
    ref = RefPartition(metric, hbm_budget_bytes=budget)
    port = PortPartition(metric, hbm_budget_bytes=budget,
                         device=torch.device("cpu"))
    for part in (ref, port):
        part.add_bulk(list(range(1, n + 1)), data)
        for element_id in (2, 77, 5000):
            part.remove(element_id)
    assert rung_state(port) == rung_state(ref)
    queries = unit_data(32, d, seed=6)
    want_ids, want_d = ref.search_many(queries, 10)
    got_ids, got_d = port.search_many(queries, 10)
    np.testing.assert_array_equal(got_ids, want_ids)
    tol = RERANK_TOL if mode == "device" else 0.0
    assert np.max(np.abs(got_d - want_d)) <= tol
    assert not np.isin(got_ids, [2, 77, 5000]).any()
    assert port.matrix._device is None  # the exact tier never uploaded


def engines(budget):
    ref = RefEngine(hbm_budget_bytes=budget)
    port = PortEngine(device="cpu", hbm_budget_bytes=budget)
    return ref, port


@pytest.mark.parametrize("budget,mode,rung", [
    (20_000 * 200, "auto", "int8"),
    (20_000 * 200, "device", "int8"),
    (20_000 * 100, "auto", "int4"),
])
def test_budgeted_engine_answers_like_the_reference(budget, mode, rung,
                                                    single_device,
                                                    monkeypatch):
    """``Engine(device="cpu", hbm_budget_bytes=...)``: the same writes,
    then reads through ``execute`` and ``execute_stored``, answer as the
    reference engine does on the rung the budget selects."""
    monkeypatch.setenv("HELIX_QUANT_RERANK", mode)
    data = gaussian_vectors(20_000, seed=7)
    queries = gaussian_vectors(16, seed=8)
    ref, port = engines(budget)
    requests = [create_index(), ingest(0, data[:12_000]),
                ingest(12_000, data[12_000:]), drop([5, 55, 555])]
    for request in requests:
        assert json.dumps(ref.execute(request), sort_keys=True) \
            == json.dumps(port.execute(request), sort_keys=True)
    for engine in (ref, port):
        engine.load_bundle(BUNDLE)
    part = port.vectors.indexes[("NodeVector", "Doc", "emb")] \
        .partitions[("",)]
    assert part._use_quant() == (rung == "int8")
    assert part._use_quant4() == (rung == "int4")
    tol = RERANK_TOL if mode == "device" else 0.0
    for q in queries:
        for a, b in (
            (ref.execute(search(q, 10)), port.execute(search(q, 10))),
            (ref.execute_stored("vsearch", {"q": q.tolist(), "k": 10}),
             port.execute_stored("vsearch", {"q": q.tolist(), "k": 10})),
        ):
            assert [h["$id"] for h in a["hits"]] \
                == [h["$id"] for h in b["hits"]]
            assert [h["i"] for h in a["hits"]] == [h["i"] for h in b["hits"]]
            for ha, hb in zip(a["hits"], b["hits"]):
                assert abs(ha["$distance"] - hb["$distance"]) <= tol
            assert not {5, 55, 555} & {h["$id"] for h in b["hits"]}
    assert (part.quant is not None) == (rung == "int8")
    assert (part.quant4 is not None) == (rung == "int4")
