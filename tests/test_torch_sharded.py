"""The port's mesh search (``helix_tpu_torch.parallel``) against the JAX
reference's ``helix_tpu.parallel`` on the CPU.

The reference runs on its 8 virtual CPU devices (``tests/conftest.py``);
the port runs on a virtual mesh of 8 CPU devices
(``parallel.virtual_devices``), of the same shape: 8-way, or 2 x 4 with
``data=2``.  Both get the same numpy inputs, made from a seed.

Tolerances: ids equal (the seeds have no f32 near-tie at rank k; both
sides break exact ties toward the lower position); distances within
1e-5 (f32 dot products summed in another order, ~1e-7).  The fused path
(kernel 1's plain version on the CPU) is held to the reference's
``_local_fused`` with ``pallas_call`` in interpret mode: ids equal,
scores within 1e-5 after the f32 re-rank.  ``ShardedKMeans`` follows the
settled k-means rule (inertia within 1%, probe recall within 0.02): the
two fits sum their centroid updates in other orders.
"""

import numpy as np
import pytest
import torch

import helix_tpu.ops.distance as JD
import helix_tpu.parallel.sharded as JS
from helix_tpu.parallel import ShardedKMeans as RefKMeans
from helix_tpu.parallel import ShardedVectorSearch as RefSearch
from helix_tpu.parallel import make_mesh as ref_mesh
from helix_tpu_torch import graft
from helix_tpu_torch.ops import distance as TD
from helix_tpu_torch.ops import fused_topk as TF
from helix_tpu_torch.parallel import (
    ShardedKMeans, ShardedVectorSearch, device_count, make_mesh,
    virtual_devices,
)
from helix_tpu_torch.parallel import sharded as TS

torch.set_num_threads(2)

CPU = torch.device("cpu")
DIST_TOL = 1e-5


@pytest.fixture
def mesh8():
    """The port's 8-device virtual CPU mesh, for the test's duration."""
    with virtual_devices("cpu", 8):
        yield


def unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def both(data, queries, metric, k, chunk, data_axis=1, **kw):
    """(reference (dists, ids), port (dists, ids)) as numpy."""
    sq = np.sum(data * data, axis=1).astype(np.float32)
    ref = RefSearch(ref_mesh(data=data_axis), k=k, metric=metric,
                    chunk=chunk, bf16=False, **kw)
    xs, sqd, n_valid = ref.shard_arrays(data, sq)
    r_d, r_i = ref(xs, queries, n_valid, sqd)
    port = ShardedVectorSearch(make_mesh(data=data_axis, device=CPU), k=k,
                               metric=metric, chunk=chunk, bf16=False, **kw)
    xs, sqd, n_valid = port.shard_arrays(data, sq)
    p_d, p_i = port(xs, queries, n_valid, sqd)
    return ((np.asarray(r_d), np.asarray(r_i)),
            (p_d.numpy(), p_i.numpy()))


def assert_same(ref, port):
    (r_d, r_i), (p_d, p_i) = ref, port
    assert p_d.shape == r_d.shape and p_i.shape == r_i.shape
    finite = np.isfinite(r_d)
    np.testing.assert_array_equal(np.isfinite(p_d), finite)
    np.testing.assert_array_equal(p_i, r_i)
    np.testing.assert_allclose(p_d[finite], r_d[finite], atol=DIST_TOL,
                               rtol=0)


def test_virtual_mesh_shape_and_restore():
    assert device_count(CPU) == 1
    with virtual_devices("cpu", 8) as devs:
        assert len(devs) == 8 and device_count("cpu") == 8
        mesh = make_mesh(data=2, device=CPU)
        assert mesh.shape == {"data": 2, "shard": 4}
        with virtual_devices("cpu", 2):
            assert device_count(CPU) == 2
        assert device_count(CPU) == 8
        with pytest.raises(ValueError, match="data=3"):
            make_mesh(data=3, device=CPU)
    assert device_count(CPU) == 1


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("data_axis", [1, 2], ids=["8-way", "2x4"])
def test_sharded_search_matches_reference(mesh8, metric, data_axis):
    rng = np.random.default_rng(0)
    data = unit(rng, 4000, 64)
    if metric == "l2":
        data = data * rng.uniform(0.5, 2.0, size=(4000, 1)).astype(np.float32)
    queries = unit(rng, 16, 64)
    ref, port = both(data, queries, metric, 10, 512, data_axis)
    assert_same(ref, port)
    sims = queries @ data.T if metric == "cosine" else -(
        (queries[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    oracle = np.argsort(-sims, axis=1)[:, :10]
    np.testing.assert_array_equal(np.sort(port[1], axis=1),
                                  np.sort(oracle, axis=1))


@pytest.mark.parametrize("n_rows,k", [
    (4001, 10),    # every shard split pads
    (3999, 10),
    (37, 16),      # k > per-shard row count
    (7, 12),       # k > total rows: short result, no padded-row leakage
    (1000, 800),   # k wider than the per-shard chunk: locals clamp
    (100, 640),    # k wider than the whole corpus: overflow slots pad
])
def test_ragged_rows_and_wide_k_match_reference(mesh8, n_rows, k):
    rng = np.random.default_rng(n_rows + k)
    data = unit(rng, n_rows, 32)
    queries = unit(rng, 8, 32)
    ref, port = both(data, queries, "cosine", k, 256)
    assert_same(ref, port)
    p_d, p_i = port
    finite = np.isfinite(p_d)
    assert np.all((p_i[finite] >= 0) & (p_i[finite] < n_rows))
    assert finite[:, :min(k, n_rows)].all()


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    import helix_tpu.ops.fused_topk as JF

    original = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return original(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    JF._bucket_scores.clear_cache()
    yield
    JF._bucket_scores.clear_cache()


@pytest.mark.parametrize("b,n_valid,k", [
    (16, 8192 - 300, 10),   # queries pad to one block; tail rows masked
    (300, 8192, 80),        # two query blocks in the port
    (4, 0, 10),             # an empty shard: -inf candidates, no crash
])
def test_local_fused_matches_reference(interpret_mode, b, n_valid, k):
    import jax.numpy as jnp

    rng = np.random.default_rng(b + n_valid)
    xs = unit(rng, 8192, 128)
    qs = unit(rng, b, 128)
    r_s, r_i = JS._local_fused(
        jnp.asarray(xs, jnp.bfloat16), jnp.asarray(xs),
        jnp.asarray(qs, jnp.bfloat16), jnp.asarray(qs), n_valid, k)
    x32 = torch.from_numpy(xs)
    p_s, p_i = TS._local_fused(x32.to(torch.bfloat16), x32,
                               torch.from_numpy(qs), n_valid, k)
    r_s, r_i = np.asarray(r_s), np.asarray(r_i)
    p_s, p_i = p_s.numpy(), p_i.numpy()
    assert p_s.shape == r_s.shape
    finite = np.isfinite(r_s)
    np.testing.assert_array_equal(np.isfinite(p_s), finite)
    np.testing.assert_array_equal(p_i[finite], r_i[finite])
    np.testing.assert_allclose(p_s[finite], r_s[finite], atol=DIST_TOL,
                               rtol=0)
    if n_valid == 0:
        # a -inf candidate keeps its packed winner's id (not -1); the
        # engine's native re-rank then scores that row
        assert not finite.any() and (p_i >= 0).all()
        np.testing.assert_array_equal(p_i, r_i)


def test_fused_mesh_search_matches_reference(mesh8, interpret_mode):
    """Kernel 1's route through the whole searcher (plain version on the
    CPU, interpret-mode Pallas in the reference) on a 2-shard mesh."""
    rng = np.random.default_rng(3)
    data = unit(rng, 9000, 128)     # ragged: shard 1 is part padding
    queries = unit(rng, 12, 128)
    sq = np.sum(data * data, axis=1).astype(np.float32)
    ref = RefSearch(ref_mesh(2), k=10, bf16=True, use_fused=True)
    xs, sqd, n_valid = ref.shard_arrays(data, sq)
    r_d, r_i = (np.asarray(a) for a in ref(xs, queries, n_valid, sqd))
    port = ShardedVectorSearch(make_mesh(2, device=CPU), k=10, bf16=True,
                               use_fused=True)
    xs, sqd, n_valid = port.shard_arrays(data, sq)
    assert xs[0][0][0].shape[0] % TF.TILE == 0
    p_d, p_i = (a.numpy() for a in port(xs, queries, n_valid, sqd))
    np.testing.assert_array_equal(p_i, r_i)
    np.testing.assert_allclose(p_d, r_d, atol=DIST_TOL, rtol=0)


def test_cuda_mesh_defaults():
    """bf16 and the fused route default on where the mesh is CUDA (the
    reference's TPU backend), cosine only for fused."""
    with virtual_devices("cpu", 2):
        cpu = ShardedVectorSearch(make_mesh(device=CPU), k=5)
    assert not cpu.bf16 and not cpu.use_fused
    fake = make_mesh(device=CPU)
    fake.device = torch.device("cuda")
    assert ShardedVectorSearch(fake, k=5).use_fused
    assert ShardedVectorSearch(fake, k=5).bf16
    assert not ShardedVectorSearch(fake, k=5, metric="l2").use_fused
    assert ShardedKMeans(fake, 4).bf16


@pytest.mark.parametrize("metric,bf16", [("cosine", True), ("cosine", False),
                                         ("l2", False)])
@pytest.mark.parametrize("n,chunk", [(2048, 1024), (6000, 1000)])
def test_topk_scores_matches_reference(metric, bf16, n, chunk):
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    xs = unit(rng, n, 64)
    qs = unit(rng, 8, 64)
    sq = np.sum(xs * xs, axis=1).astype(np.float32)
    n_valid = n - 37
    kw = dict(k=10, chunk=chunk, metric=metric, bf16=bf16)
    if n > 4096:
        # force the chunked scan on both sides
        JD.SINGLE_SHOT_BYTES, saved = 1, JD.SINGLE_SHOT_BYTES
        TD.SINGLE_SHOT_BYTES = 1
        JD.topk_scores.clear_cache()
    try:
        r_d, r_i = JD.topk_scores(jnp.asarray(xs), jnp.asarray(qs),
                                  jnp.int32(n_valid), jnp.asarray(sq), **kw)
        p_d, p_i = TD.topk_scores(torch.from_numpy(xs), torch.from_numpy(qs),
                                  n_valid, torch.from_numpy(sq), **kw)
    finally:
        if n > 4096:
            JD.SINGLE_SHOT_BYTES = saved
            TD.SINGLE_SHOT_BYTES = saved
            JD.topk_scores.clear_cache()
    np.testing.assert_array_equal(p_i.numpy(), np.asarray(r_i))
    np.testing.assert_allclose(p_d.numpy(), np.asarray(r_d), atol=DIST_TOL,
                               rtol=0)
    assert (p_i.numpy() < n_valid).all()


def test_graft_entry_runs_on_the_cpu():
    fn, args = graft.entry("cpu")
    dists, ids = fn(*args)
    assert dists.shape == ids.shape == (64, 10)
    assert torch.all(dists[:, 1:] >= dists[:, :-1] - 1e-6)


def probe_recall(data, centroids, queries, nprobe=4, k=10):
    """Recall@k of an IVF probe over ``centroids``'s cells."""
    cells = np.argmax(data @ centroids.T, axis=1)
    probe = np.argsort(-(queries @ centroids.T), axis=1)[:, :nprobe]
    truth = np.argsort(-(queries @ data.T), axis=1)[:, :k]
    return np.mean([len(set(truth[i]) & set(np.nonzero(
        np.isin(cells, probe[i]))[0])) / k for i in range(len(queries))])


@pytest.mark.parametrize("bf16", [False, True])
def test_sharded_kmeans_matches_reference_quality(mesh8, bf16):
    rng = np.random.default_rng(12)
    centers = rng.normal(size=(24, 32)).astype(np.float32)
    data = centers[rng.integers(0, 24, 5003)] \
        + 0.3 * rng.normal(size=(5003, 32)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    queries = unit(rng, 32, 32)
    want = RefKMeans(ref_mesh(), 16, bf16=bf16).fit(data, iters=4)
    got = ShardedKMeans(make_mesh(device=CPU), 16, bf16=bf16).fit(
        data, iters=4)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)

    def inertia(c):
        return float(np.sum(1.0 - np.max(data @ c.T, axis=1)))

    assert inertia(got) <= inertia(want) * 1.01
    assert probe_recall(data, got, queries) >= \
        probe_recall(data, want, queries) - 0.02


@pytest.mark.parametrize("n_devices", [4, 8])
def test_dryrun_multichip_on_the_cpu(n_devices):
    graft.dryrun_multichip(n_devices, "cpu")
    assert device_count(CPU) == 1   # the virtual mesh is gone again


@pytest.mark.cuda
def test_sharded_search_runs_kernel_1_per_shard_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel 1 runs only on the card")
    rng = np.random.default_rng(5)
    data = unit(rng, 3 * TF.TILE + 100, 128)
    queries = unit(rng, 300, 128)
    sq = np.sum(data * data, axis=1).astype(np.float32)
    answers = {}
    for dev in ("cuda", "cpu"):
        with virtual_devices(dev, 4):
            search = ShardedVectorSearch(
                make_mesh(device=dev), k=10, bf16=True, use_fused=True)
            xs, sqd, n_valid = search.shard_arrays(data, sq)
            before = TF.bucket_scores.launches
            d, i = search(xs, queries, n_valid, sqd)
            launched = TF.bucket_scores.launches - before
        answers[dev] = (d.cpu().numpy(), i.cpu().numpy())
        if dev == "cuda":
            assert launched == 4 * 2   # 4 shards x 2 query blocks
    # the kernel's f32 sums run in another order than the plain
    # version's: the same hits, distances within DIST_TOL (near ties may
    # swap places)
    np.testing.assert_array_equal(np.sort(answers["cuda"][1], axis=1),
                                  np.sort(answers["cpu"][1], axis=1))
    np.testing.assert_allclose(answers["cuda"][0], answers["cpu"][0],
                               atol=DIST_TOL, rtol=0)
