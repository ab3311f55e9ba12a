"""The IVF rung: the port's ``ops/ivf.py`` against the JAX reference's,
and the port's ``Partition``/``Engine`` on the host-IVF rung against the
reference's.

The two k-means fits sum bf16 products and centroid updates in other
orders, so their centroids drift apart near ties: the search parity
tests install the reference's fitted state in the port
(``helix_tpu_torch.convert.host_ivf_from_reference``) and compare
answers exactly (ids equal, distances within 1e-6: f32 dot products
summed in another order), and the port's own k-means is held to the
reference's by quality (inertia within 1%, recall within 0.02).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helix_tpu.ops.ivf as J
import helix_tpu_torch.ops.ivf as T
from helix_tpu.engine import Engine as RefEngine
from helix_tpu.engine.vector import Partition as RefPartition
from helix_tpu_torch.convert import host_ivf_from_reference
from helix_tpu_torch.engine import Engine as PortEngine
from helix_tpu_torch.engine.vector import Partition as PortPartition
from helix_tpu_torch.ops.distance import _top_k

from tests.test_torch_engine import create_index, drop, ingest, search
from tests.test_torch_ladder import single_device, unit_data  # noqa: F401

torch.set_num_threads(2)
CPU = torch.device("cpu")
DIST_TOL = 1e-6


def normalized(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def clustered(n, d, seed, n_centers=48):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    return (centers[rng.integers(0, n_centers, n)]
            + 0.3 * rng.normal(size=(n, d)).astype(np.float32))


def installed(ref):
    return host_ivf_from_reference(
        np.asarray(ref.centroids), ref.packed, ref.indptr,
        ref.row_to_original, device=CPU)


@pytest.fixture(scope="module")
def fitted():
    data = clustered(6000, 24, seed=11)
    ref = J.HostIVFIndex.build(data, n_clusters=64, iters=4)
    queries = normalized(clustered(16, 24, seed=12))
    return data, ref, installed(ref), queries


def test_top_k_breaks_ties_like_lax_top_k():
    import jax

    rng = np.random.default_rng(0)
    x = rng.integers(-3, 4, size=(6, 500)).astype(np.float32)
    x[:, ::7] = -np.inf
    for k in (1, 10, 499):
        w_s, w_i = jax.lax.top_k(jnp.asarray(x), k)
        g_s, g_i = _top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(g_i.numpy(), np.asarray(w_i))
        np.testing.assert_array_equal(g_s.numpy(), np.asarray(w_s))


@pytest.mark.parametrize("nprobe", [1, 8, 64])
def test_probe_cells_match_reference(fitted, nprobe):
    _, ref, port, queries = fitted
    want = np.asarray(J.probe_cells(ref.centroids, jnp.asarray(queries),
                                    nprobe=nprobe))
    got = T.probe_cells(port.centroids, torch.from_numpy(queries),
                        nprobe=nprobe)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 10, 100])
def test_score_block_matches_reference(k):
    rng = np.random.default_rng(3)
    block = normalized(rng.normal(size=(2048, 32)).astype(np.float32))
    block[1500:] = 0.0               # padding past n_valid
    qs = normalized(rng.normal(size=(8, 32)).astype(np.float32))
    w_d, w_i = J.score_block(jnp.asarray(block), jnp.asarray(qs),
                             jnp.int32(1500), k=k)
    g_d, g_i = T.score_block(torch.from_numpy(block), torch.from_numpy(qs),
                             1500, k=k)
    np.testing.assert_array_equal(g_i.numpy(), np.asarray(w_i))
    assert np.max(np.abs(g_d.numpy() - np.asarray(w_d))) <= DIST_TOL


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("k,nprobe", [(10, 8), (40, 3), (5, 64)])
def test_host_ivf_search_matches_reference(fitted, backend, k, nprobe,
                                           monkeypatch):
    _, ref, port, queries = fitted
    monkeypatch.setenv("HELIX_IVF_BACKEND", backend)
    w_d, w_i = ref.search(queries, k, nprobe=nprobe, normalize=False)
    g_d, g_i = port.search(queries, k, nprobe=nprobe, normalize=False)
    assert ref.last_path == port.last_path == backend
    assert port.last_streamed_bytes == ref.last_streamed_bytes
    np.testing.assert_array_equal(g_i, w_i)
    assert np.max(np.abs(g_d - w_d)) <= DIST_TOL


def test_union_streams_in_chunks_like_the_reference(fitted, monkeypatch):
    """A union larger than one streamed chunk: per-chunk top-k, merged on
    the host, as in the reference."""
    _, ref, port, queries = fitted
    monkeypatch.setenv("HELIX_IVF_BACKEND", "device")
    for index in (ref, port):
        monkeypatch.setattr(index, "STREAM_BYTES", 24 * 4 * 1024)
    w_d, w_i = ref.search(queries, 10, nprobe=64, normalize=False)
    g_d, g_i = port.search(queries, 10, nprobe=64, normalize=False)
    np.testing.assert_array_equal(g_i, w_i)
    assert np.max(np.abs(g_d - w_d)) <= DIST_TOL


def test_ivf_index_search_matches_reference():
    data = clustered(5000, 32, seed=3)
    ref = J.IVFIndex.build(data, n_clusters=64, iters=4)
    port = T.IVFIndex(
        torch.from_numpy(np.asarray(ref.packed)),
        torch.from_numpy(np.asarray(ref.centroids)),
        torch.from_numpy(np.asarray(ref.cell_rows)),
        ref.row_to_original, ref.pad, 0.0)
    queries = clustered(16, 32, seed=4)
    for k, nprobe in ((10, 4), (30, 16)):
        w_d, w_i = ref.search(queries, k, nprobe=nprobe)
        g_d, g_i = port.search(queries, k, nprobe=nprobe)
        np.testing.assert_array_equal(g_i, w_i)
        assert np.max(np.abs(g_d - w_d)) <= DIST_TOL


def brute(data, queries, k):
    return np.argsort(-(normalized(queries) @ normalized(data).T),
                      axis=1)[:, :k]


def recall(got, want):
    return np.mean([len(set(g[g >= 0]) & set(w)) / len(w)
                    for g, w in zip(got, want)])


def test_kmeans_fit_quality_matches_reference():
    data = normalized(clustered(8000, 32, seed=5, n_centers=96))
    init = data[np.random.default_rng(0).choice(len(data), 128,
                                                replace=False)]
    w_c, w_a = J.kmeans_fit(jnp.asarray(data), jnp.asarray(init),
                            n_clusters=128, iters=6)
    g_c, g_a = T.kmeans_fit(torch.from_numpy(data), torch.from_numpy(init),
                            n_clusters=128, iters=6)
    g_c, g_a = g_c.numpy(), g_a.numpy()

    def inertia(c, a):
        return float(np.sum(1.0 - np.sum(data * c[a], axis=1)))

    want = inertia(np.asarray(w_c), np.asarray(w_a))
    got = inertia(g_c, g_a)
    assert abs(got - want) <= 0.01 * want, (got, want)
    assert np.allclose(np.linalg.norm(g_c, axis=1), 1.0, atol=1e-5)
    # the assignment is each row's best centroid by the f32 oracle,
    # except where bf16 scoring leaves a near tie
    sims = data @ g_c.T
    best = sims.max(axis=1)
    assert np.all(best - sims[np.arange(len(data)), g_a] <= 2e-2)
    assert np.mean(sims.argmax(axis=1) == g_a) >= 0.97


def test_port_build_recall_matches_reference():
    data = clustered(6000, 24, seed=13)
    queries = clustered(32, 24, seed=14)
    oracle = brute(data, queries, 10)
    ref = J.HostIVFIndex.build(data, n_clusters=64, iters=4)
    port = T.HostIVFIndex.build(data, n_clusters=64, iters=4, device=CPU)
    assert port.n == ref.n and port.centroids.device == CPU
    assert sorted(port.row_to_original.tolist()) == list(range(len(data)))
    assert np.all(np.diff(port.indptr) >= 0) and port.indptr[-1] == len(data)
    for nprobe in (2, 8):
        _, w_i = ref.search(queries, 10, nprobe=nprobe)
        _, g_i = port.search(queries, 10, nprobe=nprobe)
        assert recall(g_i, oracle) >= recall(w_i, oracle) - 0.02, nprobe
    assert recall(g_i, oracle) >= 0.9


def test_sampled_build_streamed_assign():
    data = clustered(4000, 32, seed=3)
    idx = T.HostIVFIndex.build(data, n_clusters=64, iters=4, sample_cap=1000,
                               assign_chunk=700, device=CPU)
    assert idx.n == len(data)
    _, ids = idx.search(clustered(4, 32, seed=4), 5, nprobe=8)
    assert ids.shape == (4, 5)


def test_auto_routing_samples_both_then_converges(fitted, monkeypatch):
    _, ref, _, queries = fitted
    port = installed(ref)
    monkeypatch.delenv("HELIX_IVF_BACKEND", raising=False)
    paths = []
    for _ in range(6):
        port.search(queries, 5, nprobe=8, normalize=False)
        paths.append(port.last_path)
    assert paths[:3] == ["host", "device", "device"]
    assert set(port.router.rate) == {"host", "device"}


def test_empty_probe_union_refreshes_last_path(fitted, monkeypatch):
    _, ref, _, queries = fitted
    port = installed(ref)
    port.indptr = port.indptr.copy()
    port.indptr[4:] = port.indptr[-1]       # cells 3.. hold no rows
    monkeypatch.setattr(T, "probe_cells", lambda *a, **k: torch.full(
        (len(queries), 1), 10, dtype=torch.int64))
    d, i = port.search(queries, 3, nprobe=1, normalize=False)
    assert i.shape == (len(queries), 0) and port.last_path == "empty"


def test_f32_scoring_runs_with_tf32_off(fitted, monkeypatch):
    """Every IVF matmul turns TF32 off first (the reference's
    ``Precision.HIGHEST``), through the port's one policy for the flag."""
    _, ref, port, queries = fitted
    qs = torch.from_numpy(queries)
    calls = [
        lambda: T.probe_cells(port.centroids, qs, nprobe=4),
        lambda: T.score_block(torch.from_numpy(ref.packed[:1024]), qs, 1000,
                              k=5),
        lambda: T._assign_rows(torch.from_numpy(ref.packed[:64]),
                               port.centroids),
        lambda: T.kmeans_fit(torch.from_numpy(ref.packed[:500]),
                             port.centroids[:8], n_clusters=8, iters=1),
        lambda: T.ivf_search(qs, port.centroids[:4],
                             torch.zeros((4, 1), dtype=torch.int64), qs,
                             k=2, nprobe=2, pad=1),
    ]
    for call in calls:
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        call()
        assert torch.backends.cuda.matmul.allow_tf32 is False


def test_concurrent_device_scorer_searches_keep_their_own_rows(
        fitted, monkeypatch):
    """Reads search one index from several threads at once: each union
    chunk is staged apart, so no search scores another's rows."""
    import threading

    _, ref, port, _ = fitted
    monkeypatch.setenv("HELIX_IVF_BACKEND", "device")
    batches = [normalized(clustered(8, 24, seed=40 + t)) for t in range(4)]
    want = [ref.search(q, 10, nprobe=4, normalize=False) for q in batches]
    errors = []

    def reader(t):
        for _ in range(30):
            d, i = port.search(batches[t], 10, nprobe=4, normalize=False)
            if not (np.array_equal(i, want[t][1])
                    and np.max(np.abs(d - want[t][0])) <= DIST_TOL):
                errors.append(t)

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    assert port.last_path == "device"


def test_convert_rejects_inconsistent_state(fitted):
    _, ref, _, _ = fitted
    c = np.asarray(ref.centroids)
    with pytest.raises(ValueError, match="shape"):
        host_ivf_from_reference(c, ref.packed[:, :8], ref.indptr,
                                ref.row_to_original, device=CPU)
    with pytest.raises(ValueError, match="indptr"):
        host_ivf_from_reference(c, ref.packed, ref.indptr[:-1],
                                ref.row_to_original, device=CPU)
    with pytest.raises(ValueError, match="row_to_original"):
        host_ivf_from_reference(c, ref.packed, ref.indptr,
                                ref.row_to_original[1:], device=CPU)


# ------------------------------------------------------- the ladder's rung


def install_rung(ref_part, port_part):
    port_part.host_ivf = installed(ref_part.host_ivf)
    port_part.host_ivf_rows = ref_part.host_ivf_rows


@pytest.mark.parametrize("backend", ["device", "host"])
def test_partition_ivf_rung_matches_reference(backend, single_device,  # noqa: F811
                                              monkeypatch):
    monkeypatch.setenv("HELIX_IVF_BACKEND", backend)
    n, d = 4096, 16
    data = unit_data(n, d, seed=5)
    ref = RefPartition("cosine", hbm_budget_bytes=200_000)
    port = PortPartition("cosine", hbm_budget_bytes=200_000, device=CPU)
    for part in (ref, port):
        part.add_bulk(list(range(1, n + 1)), data)
    assert ref._use_host_ivf() and port._use_host_ivf()
    queries = unit_data(24, d, seed=6)
    ref.search_many(queries, 10)          # fits the reference's IVF
    install_rung(ref, port)
    # delta rows past the build and tombstones, on both sides
    extra = unit_data(300, d, seed=7)
    for part in (ref, port):
        part.add_bulk(list(range(n + 1, n + 301)), extra)
        for element_id in (2, 77, n + 5):
            part.remove(element_id)
    for k in (1, 10, 50):
        want_ids, want_d = ref.search_many(queries, k)
        got_ids, got_d = port.search_many(queries, k)
        np.testing.assert_array_equal(got_ids, want_ids)
        assert np.max(np.abs(got_d - want_d)) <= DIST_TOL
        assert not np.isin(got_ids, [2, 77, n + 5]).any()
    assert port.host_ivf.last_path == backend
    assert port.matrix._device is None      # no device rung uploaded


def test_budgeted_engine_on_the_ivf_rung_answers_like_the_reference(
        single_device, monkeypatch):  # noqa: F811
    """``Engine(hbm_budget_bytes=...)`` past int4: the same writes, the
    reference's fitted IVF installed in the port after the first read,
    then reads through ``execute`` answer alike."""
    from tests.test_torch_engine import gaussian_vectors

    monkeypatch.delenv("HELIX_IVF_BACKEND", raising=False)
    data = gaussian_vectors(8000, seed=7)
    queries = gaussian_vectors(12, seed=8)
    ref = RefEngine(hbm_budget_bytes=400_000)
    port = PortEngine(device="cpu", hbm_budget_bytes=400_000)
    for request in [create_index(), ingest(0, data), drop([5, 55])]:
        assert json.dumps(ref.execute(request), sort_keys=True) \
            == json.dumps(port.execute(request), sort_keys=True)
    ref.execute(search(queries[0], 10))
    parts = [e.vectors.indexes[("NodeVector", "Doc", "emb")]
             .partitions[("",)] for e in (ref, port)]
    assert parts[1]._use_host_ivf() and parts[0].host_ivf is not None
    install_rung(*parts)
    for q in queries:
        a = ref.execute(search(q, 10))["hits"]
        b = port.execute(search(q, 10))["hits"]
        assert [h["$id"] for h in a] == [h["$id"] for h in b]
        for ha, hb in zip(a, b):
            assert abs(ha["$distance"] - hb["$distance"]) <= DIST_TOL
        assert not {5, 55} & {h["$id"] for h in b}
