"""The port's ``PackedMatrix`` growth: background grow, overwrites during
a pending grow, appends after the grow starts, a burst that outruns the
copier, a copier that dies.  Each scenario runs on the port's matrix
and the reference's with the same rows, and the two must hold equal
host rows, squared norms and capacity (the port's host code is the
reference's, held by ``tests/test_torch_engine_copy.py``).  A pending
grow is installed only if its copier still exists: an ``extend`` may
already have swapped it in.
"""

import numpy as np
import pytest
import torch

from helix_tpu.ops.distance import PackedMatrix as RefMatrix
from helix_tpu_torch.ops.distance import PackedMatrix


def pair(dim: int, metric: str):
    return PackedMatrix(dim, metric, device="cpu"), RefMatrix(dim, metric)


def land(mat) -> None:
    """Install a pending grow, if a copier exists."""
    mat._ensure_rows(0)
    if mat._grow_thread is not None:
        mat._swap_grown()


def assert_same(port, ref) -> None:
    assert (port.n, port.capacity, port.version) \
        == (ref.n, ref.capacity, ref.version)
    np.testing.assert_array_equal(port.data[: port.n], ref.data[: ref.n])
    np.testing.assert_array_equal(port.sq_norms[: port.n],
                                  ref.sq_norms[: ref.n])


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_background_grow_preserves_rows(metric):
    rows = np.random.default_rng(0).normal(size=(4000, 16)).astype(np.float32)
    port, ref = pair(16, metric)
    for mat in (port, ref):
        for i in range(0, len(rows), 100):
            mat.extend(rows[i:i + 100])
        land(mat)
    assert_same(port, ref)
    if metric == "l2":
        np.testing.assert_array_equal(port.data[: port.n, :16], rows)
    assert port.capacity >= 4000


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_overwrite_during_pending_grow_is_not_lost(metric):
    rows = np.random.default_rng(1).normal(size=(470, 8)).astype(np.float32)
    patch = np.arange(8, dtype=np.float32)
    port, ref = pair(8, metric)
    for mat in (port, ref):
        mat.extend(rows)                       # 470 / 512: past 90%
        assert mat._grow_thread is not None    # the grow started
        mat.overwrite(3, patch)
        mat.overwrite(100, None)               # a tombstone
        land(mat)
    assert_same(port, ref)
    assert np.all(port.data[100] == 0.0) and port.capacity == 1024
    want = patch / np.linalg.norm(patch) if metric == "cosine" else patch
    np.testing.assert_allclose(port.data[3, :8], want, rtol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_appends_after_grow_start_survive_swap(metric):
    rng = np.random.default_rng(2)
    base = rng.normal(size=(470, 8)).astype(np.float32)
    late = rng.normal(size=(30, 8)).astype(np.float32)
    port, ref = pair(8, metric)
    for mat in (port, ref):
        mat.extend(base)
        assert mat._grow_thread is not None    # the grow started
        late_first = mat.extend(late)   # while (or after) the copier runs
        land(mat)
        assert late_first == 470 and mat.capacity == 1024
    assert_same(port, ref)
    if metric == "l2":
        np.testing.assert_array_equal(port.data[470:500, :8], late)
        np.testing.assert_array_equal(port.data[:470, :8], base)


@pytest.mark.parametrize("n", [10_000, 513])
def test_burst_outrunning_copier_grows_synchronously(n):
    big = np.random.default_rng(3).normal(size=(n, 8)).astype(np.float32)
    port, ref = pair(8, "l2")
    for mat in (port, ref):
        mat.extend(big[:1])
        mat.extend(big[1:])
        assert mat.n == n and mat.capacity >= n
        land(mat)
    assert_same(port, ref)
    np.testing.assert_array_equal(port.data[n - 1, :8], big[-1])


def test_failed_copier_falls_back_to_synchronous_growth():
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(470, 8)).astype(np.float32)
    late = rng.normal(size=(200, 8)).astype(np.float32)
    port, ref = pair(8, "l2")
    for mat in (port, ref):
        mat.extend(rows)
        thread = mat._grow_thread
        assert thread is not None
        thread.join()
        mat._grow_buffers[3][0] = False      # the copier "died" unfinished
        mat.extend(late)                     # swap discards, grows in place
        assert mat._grow_thread is None or mat._grow_buffers[3][0]
        land(mat)
    assert_same(port, ref)
    np.testing.assert_array_equal(port.data[:470, :8], rows)
    np.testing.assert_array_equal(port.data[470:670, :8], late)


def test_single_appends_grow_like_the_reference():
    rows = np.random.default_rng(5).normal(size=(1200, 8)).astype(np.float32)
    port, ref = pair(8, "cosine")
    for mat in (port, ref):
        for r in rows:
            mat.append(r)
        land(mat)
    assert_same(port, ref)
    qs = rows[:4] * 2.0
    np.testing.assert_array_equal(port.prepare_queries(qs),
                                  ref.prepare_queries(qs))


def test_device_copies_after_growth_hold_every_row():
    rows = np.random.default_rng(6).normal(size=(3000, 8)).astype(np.float32)
    mat = PackedMatrix(8, "l2", device="cpu")
    for i in range(0, 3000, 250):
        mat.extend(rows[i:i + 250])
        mat.device_arrays()                  # a search between writes
    land(mat)
    xs16, sq = mat.device_arrays()
    assert xs16.shape[0] >= 3000 and xs16.dtype == torch.bfloat16
    np.testing.assert_array_equal(mat.data_device()[:3000, :8].numpy(), rows)
    np.testing.assert_allclose(sq[:3000].numpy(), (rows * rows).sum(1),
                               rtol=1e-5)
