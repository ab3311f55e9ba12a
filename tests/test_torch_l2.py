"""The l2 deployment (SIFT1M's Euclidean metric) on the port against the
reference, on every rung.

Both packages take the same SIFT-shaped rows: ``bench.py``'s clustered
generator mapped to integers in [0, 255] (``min(255, rint(62 max(x,
0)))``, the form of SIFT's byte descriptors), 128 wide.  Integer rows
make every score on the path exact: bf16 and f16 hold integers <= 255,
and ``2 q.x - |x|^2`` and the squared distance stay below 2^24, so the
f32 sums are exact in any order.  Hence:

- ids are compared exactly; each seed is first checked to have no tie
  at rank k (``assert_no_boundary_tie``), where the reference's
  ``approx_max_k`` leaves the order to its implementation;
- ``$distance`` within a relative 1e-6 (``RTOL``) of the reference's and
  of the float64 squared distance (it comes out equal: the bound leaves
  room for one f32 rounding).

Rungs: the exact tier through ``topk_resident``'s single-shot and
chunked scans (the latter forced by a small ``SINGLE_SHOT_BYTES`` in
both packages), int8 with the host and with the f16 device re-rank,
int4 and host-exact (each chosen by ``hbm_budget_bytes``); then
``Engine(metric="l2", device="cpu")`` through ``execute`` and
``execute_stored`` at each rung, ``NativeGateway(metric="l2")``'s
``vfast`` route against the reference's gateway, and ``helix.toml``'s
``metric = "l2"`` reaching the server ``cli start`` spawns.  The
reference is pinned to one device (as in ``tests/test_torch_ladder.py``):
on its 8 virtual devices it would route int8 and int4 to the mesh
search.
"""

import json

import numpy as np
import pytest
import torch

import helix_tpu.ops.distance as JD
from helix_tpu.engine import Engine as RefEngine
from helix_tpu.engine.vector import Partition as RefPartition
from helix_tpu_torch.engine import Engine as PortEngine
from helix_tpu_torch.engine.vector import Partition as PortPartition
from helix_tpu_torch.ops import distance as TD

from tests.test_torch_engine import (create_index, ingest, search,
                                     search_steps, write)

torch.set_num_threads(2)

DIM = 128
K = 10
RTOL = 1e-6
N_ROWS = 16_384
CPU = torch.device("cpu")

# Per row at dim_pad 128: exact copies 768 B, int8 + f16 re-rank copy
# 392 B, int8 132 B, int4 68 B.
RUNG_BUDGETS = {
    "exact": None,
    "int8, device re-rank": N_ROWS * 400,
    "int8, host re-rank": N_ROWS * 200,
    "int4": N_ROWS * 100,
    "host-exact": N_ROWS * 60,
}


def sift_rows(n, seed, centers=64):
    """SIFT-shaped rows: clustered Gaussian components (sigma 0.3 about
    the centers), mapped to integers in [0, 255]."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, DIM)).astype(np.float32)
    x = c[rng.integers(0, centers, size=n)] \
        + 0.3 * rng.normal(size=(n, DIM)).astype(np.float32)
    return np.minimum(np.rint(62.0 * np.maximum(x, 0.0)), 255.0) \
        .astype(np.float32)


def exact_sq_dists(data, queries):
    x = data.astype(np.float64)
    q = queries.astype(np.float64)
    return (x * x).sum(1)[None, :] - 2.0 * q @ x.T + (q * q).sum(1)[:, None]


def assert_no_boundary_tie(data, queries, k=K, dead=()):
    d = exact_sq_dists(data, queries)
    if dead:
        d[:, list(dead)] = np.inf
    part = np.sort(d, axis=1)[:, : k + 1]
    assert np.all(part[:, k - 1] < part[:, k]), "the seed ties at rank k"


def rung_of(part):
    if part._use_host_exact():
        return "host-exact"
    if part._use_quant():
        return ("int8, device re-rank" if part._quant_rerank_device()
                else "int8, host re-rank")
    if part._use_quant4():
        return "int4"
    return "exact"


@pytest.fixture
def single_device(monkeypatch):
    import jax

    dev = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: [dev])


@pytest.fixture(scope="module")
def sift():
    data = sift_rows(N_ROWS, seed=11)
    queries = sift_rows(48, seed=12)
    assert_no_boundary_tie(data, queries)
    return data, queries


@pytest.fixture
def small_single_shot(monkeypatch):
    """Both packages' single-shot limit below one [B, N] f32 score
    buffer, so ``topk_resident`` takes its chunked scan.  The
    reference's jit reads the limit when it traces, so its caches are
    cleared around the test."""
    import jax

    jax.clear_caches()
    monkeypatch.setattr(JD, "SINGLE_SHOT_BYTES", 1 << 16)
    monkeypatch.setattr(TD, "SINGLE_SHOT_BYTES", 1 << 16)
    yield
    jax.clear_caches()


def both_topk(data, queries, n_valid, k, chunk=131072):
    """``topk_resident`` (l2) of both packages on the same arrays."""
    import jax.numpy as jnp

    n = len(data)
    sq = np.einsum("nd,nd->n", data, data).astype(np.float32)
    sq[n_valid:] = 0.0
    want = JD.topk_resident(
        jnp.asarray(data, jnp.bfloat16), jnp.asarray(data),
        jnp.asarray(queries), jnp.int32(n_valid), jnp.asarray(sq),
        k=k, metric="l2", chunk=chunk)
    got = TD.topk_resident(
        torch.from_numpy(data).to(torch.bfloat16), torch.from_numpy(data),
        torch.from_numpy(queries), n_valid, torch.from_numpy(sq),
        k=k, metric="l2", chunk=chunk)
    return ((np.asarray(want[0]), np.asarray(want[1])),
            (got[0].numpy(), got[1].numpy()))


def assert_same(got, want, data, queries):
    (gd, gi), (wd, wi) = got, want
    np.testing.assert_array_equal(gi, wi)
    assert np.max(np.abs(gd - wd) / np.maximum(np.abs(wd), 1.0)) <= RTOL
    exact = np.take_along_axis(exact_sq_dists(data, queries), gi, axis=1)
    assert np.max(np.abs(gd - exact) / np.maximum(exact, 1.0)) <= RTOL


@pytest.mark.parametrize("scan", ["single-shot", "chunked"])
def test_topk_resident_l2_matches_reference(scan, sift, request,
                                            monkeypatch):
    data, queries = sift
    n_valid = N_ROWS - 300   # rows past n_valid are junk, never answered
    data = data.copy()
    data[n_valid:] = 255.0
    chunk = 131072
    if scan == "chunked":
        request.getfixturevalue("small_single_shot")
        chunk = 2048
        calls = []
        chunked = TD.chunked_topk

        def spy(*args, **kwargs):
            calls.append(kwargs["chunk"])
            return chunked(*args, **kwargs)

        monkeypatch.setattr(TD, "chunked_topk", spy)
    assert_no_boundary_tie(data[:n_valid], queries, k=16)
    want, got = both_topk(data, queries, n_valid, k=16, chunk=chunk)
    assert_same(got, want, data, queries)
    assert got[1].max() < n_valid
    if scan == "chunked":
        assert calls == [chunk]


@pytest.mark.parametrize("rung", list(RUNG_BUDGETS))
def test_partition_l2_rungs_match_reference(rung, sift, single_device,
                                            monkeypatch):
    """``Partition.search_many`` on the rung the budget selects, with
    three rows dropped: ids equal, distances equal to the reference's
    and to float64 within RTOL, the dropped rows never answered, and
    the exact tier not uploaded past a budget."""
    data, queries = sift
    budget = RUNG_BUDGETS[rung]
    ref = RefPartition("l2", hbm_budget_bytes=budget)
    port = PortPartition("l2", hbm_budget_bytes=budget, device=CPU)
    dead_ids = (2, 77, 5000)
    for part in (ref, port):
        part.add_bulk(list(range(1, N_ROWS + 1)), data)
        for element_id in dead_ids:
            part.remove(element_id)
    assert rung_of(port) == rung_of(ref) == rung
    assert_no_boundary_tie(data, queries, dead=[i - 1 for i in dead_ids])
    want_ids, want_d = ref.search_many(queries, K)
    got_ids, got_d = port.search_many(queries, K)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert np.max(np.abs(got_d - want_d) / np.maximum(want_d, 1.0)) <= RTOL
    rows = got_ids.astype(np.int64) - 1
    exact = np.take_along_axis(exact_sq_dists(data, queries), rows, axis=1)
    assert np.max(np.abs(got_d - exact) / np.maximum(exact, 1.0)) <= RTOL
    assert not np.isin(got_ids, dead_ids).any()
    assert (port.matrix._device is None) == (budget is not None)


def test_partition_l2_chunked_exact_rung_matches_reference(
        sift, single_device, small_single_shot):
    """The exact rung's chunked scan through ``search_packed_async``."""
    data, queries = sift
    ref = RefPartition("l2")
    port = PortPartition("l2", device=CPU)
    for part in (ref, port):
        part.add_bulk(list(range(1, N_ROWS + 1)), data)
    want_ids, want_d = ref.search_many(queries, K)
    got_ids, got_d = port.search_many(queries, K)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert np.max(np.abs(got_d - want_d) / np.maximum(want_d, 1.0)) <= RTOL


STORED = {
    "version": 5,
    "read_routes": {name: {"queries": [{"Query": {
        "name": "hits", "steps": steps, "condition": None}}],
        "returns": ["hits"]} for name, steps in (
            ("vsearch", search_steps()),
            ("vfast", [search_steps()[0],
                       {"ValueMap": ["$id", "$distance"]}]))},
    "read_parameters": {name: [{"name": "q", "ty": {"Array": "F32"}},
                               {"name": "k", "ty": "I64"}]
                        for name in ("vsearch", "vfast")},
    "write_routes": {}, "write_parameters": {},
}


def l2_writes(data):
    half = len(data) // 2
    return [create_index(), ingest(0, data[:half]),
            ingest(half, data[half:]),
            write([{"N": {"Param": "ids"}}, "Drop"], {"ids": [3, 333]},
                  {"ids": {"Array": "I64"}})]


@pytest.mark.parametrize("rung", list(RUNG_BUDGETS))
def test_l2_engine_answers_like_the_reference(rung, sift, single_device):
    """``Engine(metric="l2", device="cpu")`` and the reference's engine
    take the same writes and answer every read (``execute`` and
    ``execute_stored``) with the same JSON, ``$distance`` included."""
    data, queries = sift
    budget = RUNG_BUDGETS[rung]
    ref = RefEngine(metric="l2", hbm_budget_bytes=budget)
    port = PortEngine(metric="l2", hbm_budget_bytes=budget, device="cpu")
    for request in l2_writes(data):
        assert json.dumps(ref.execute(request), sort_keys=True) \
            == json.dumps(port.execute(request), sort_keys=True)
    part = port.vectors.indexes[("NodeVector", "Doc", "emb")] \
        .partitions[("",)]
    assert rung_of(part) == rung
    assert_no_boundary_tie(data, queries[:12], dead=[2, 332])
    for engine in (ref, port):
        engine.load_bundle(STORED)
    for q in queries[:12]:
        params = {"q": q.tolist(), "k": K}
        a = json.dumps(ref.execute(search(q, K)), sort_keys=True)
        assert a == json.dumps(port.execute(search(q, K)), sort_keys=True)
        a = json.dumps(ref.execute_stored("vsearch", params), sort_keys=True)
        assert a == json.dumps(port.execute_stored("vsearch", params),
                               sort_keys=True)
        hits = json.loads(a)["hits"]
        assert len(hits) == K and not {3, 333} & {h["$id"] for h in hits}


def http_post(port, path, body):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_l2_gateway_vfast_answers_like_the_reference(sift, single_device):
    """``NativeGateway(metric="l2", device="cpu")`` (the port) and the
    reference's ``NativeGateway(metric="l2")`` take the same writes over
    HTTP; the ``vfast`` route rides the vector fast path on both and
    answers the same JSON."""
    from helix_tpu.server.native_gateway import NativeGateway as RefGateway
    from helix_tpu_torch.server.native_gateway import NativeGateway

    data, queries = sift
    ref = RefGateway(host="127.0.0.1", port=0, metric="l2")
    port = NativeGateway(host="127.0.0.1", port=0, metric="l2",
                         device="cpu")
    servers = (ref, port)
    try:
        for server in servers:
            server.start()
            for request in l2_writes(data[:6000]):
                status, _ = http_post(server.port, "/v1/query", request)
                assert status == 200
            status, _ = http_post(server.port, "/v1/bundle", STORED)
            assert status == 200
        assert port.engine.vectors.metric == "l2"
        before = port.stats()["fast_requests"]
        assert_no_boundary_tie(data[:6000], queries[:16], dead=[2, 332])
        for q in queries[:16]:
            body = {"q": q.tolist(), "k": K}
            want = http_post(ref.port, "/v1/query/vfast", body)
            got = http_post(port.port, "/v1/query/vfast", body)
            assert got == want and len(got[1]["hits"]) == K
        assert port.stats()["fast_requests"] - before == 16
    finally:
        for server in servers:
            server.stop()


def test_helix_toml_metric_l2_reaches_the_spawned_server(tmp_path,
                                                        monkeypatch):
    """``metric = "l2"`` in ``helix.toml``'s ``[local.dev.vector]`` table:
    ``cli start dev`` hands the port's server ``--metric l2``, which its
    argparse takes, on the default device (the spawn and the readiness
    wait stubbed out)."""
    import importlib

    from helix_tpu_torch.server.http_server import build_arg_parser

    from tests.test_torch_cli import _Spawned, _free_port, run_cli

    cli_main = importlib.import_module("helix_tpu_torch.cli.main")
    root = tmp_path / "proj"
    assert run_cli(["init", "--path", str(root), "--port",
                    str(_free_port())])[0] == 0
    toml = root / "helix.toml"
    toml.write_text(toml.read_text() + '\n[local.dev.vector]\nmetric = "l2"\n')
    seen = []
    monkeypatch.setattr(cli_main.subprocess, "Popen",
                        lambda argv, **kw: seen.append(argv) or _Spawned())
    monkeypatch.setattr(cli_main, "_wait_ready", lambda port: True)
    code, _, err = run_cli(["start", "dev"], cwd=root)
    assert code == 0, err
    (argv,) = seen
    assert argv[1:3] == ["-m", "helix_tpu_torch.server.http_server"]
    args = build_arg_parser().parse_args(argv[3:])
    assert args.metric == "l2" and args.device == "cuda"


@pytest.mark.cuda
def test_l2_rungs_on_the_card_answer_as_on_the_cpu(sift):
    """Each l2 rung on CUDA (``torch.matmul``, ``torch._int_mm`` and the
    stable sort; no bucket-scores kernel) answers as the port does on
    the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the l2 rungs' CUDA branches run "
                    "only on the card")
    from helix_tpu_torch.ops import fused_topk, quant, quant4

    data, queries = sift
    launches = (fused_topk.bucket_scores.launches,
                quant.i8_bucket_scores.launches,
                quant4.i4_bucket_scores.launches)
    for rung, budget in RUNG_BUDGETS.items():
        answers = []
        for device in ("cuda", "cpu"):
            part = PortPartition("l2", hbm_budget_bytes=budget,
                                 device=torch.device(device))
            part.add_bulk(list(range(1, N_ROWS + 1)), data)
            assert rung_of(part) == rung
            answers.append(part.search_many(queries, K))
        np.testing.assert_array_equal(answers[0][0], answers[1][0])
        assert np.max(np.abs(answers[0][1] - answers[1][1])
                      / np.maximum(answers[1][1], 1.0)) <= RTOL
    assert (fused_topk.bucket_scores.launches,
            quant.i8_bucket_scores.launches,
            quant4.i4_bucket_scores.launches) == launches
