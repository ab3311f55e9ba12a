"""The port's resident top-k and packed-matrix search against the JAX
reference on the CPU.

Both coarse phases score bf16 operands with f32 sums (bit-identical on
this backend) and pick candidates with the same tie rule; the exact f32
re-rank sums in another order, so distances agree within 1e-6 and ids
are equal on these seeds (no f32 near-tie among the top k).
"""

import numpy as np
import pytest
import torch

import helix_tpu.ops.distance as JD
import helix_tpu_torch.ops.distance as TD
from helix_tpu_torch.convert import packed_matrix_from_reference

torch.set_num_threads(2)

TOL = 1e-6


def make_data(n, d, b, seed, metric):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(50, d)).astype(np.float32)
    data = centers[rng.integers(0, 50, size=n)] \
        + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 50, size=b)] \
        + 0.3 * rng.normal(size=(b, d)).astype(np.float32)
    if metric == "cosine":
        data /= np.linalg.norm(data, axis=1, keepdims=True)
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    else:
        # l2's surrogate |q|^2 - (2 q.x - |x|^2) cancels terms of size
        # |x|^2, so its rounding scales with them: keep them near 1.
        data /= np.sqrt(d)
        queries /= np.sqrt(d)
    return data, queries


def matrices(data, metric):
    ref = JD.PackedMatrix(data.shape[1], metric)
    ref.extend(data)
    port = packed_matrix_from_reference(
        ref.data, ref.sq_norms, ref.n, ref.dim, ref.metric, device="cpu"
    )
    return ref, port


def resident_both(ref, port, queries, k, chunk=131072):
    import jax.numpy as jnp

    x16, sq = ref.device_arrays()
    jd, ji = JD.topk_resident(
        x16, ref.data_device(), jnp.asarray(ref.prepare_queries(queries)),
        jnp.int32(ref.n), sq, k=k, metric=ref.metric, chunk=chunk,
    )
    p16, psq = port.device_arrays()
    pd, pi = TD.topk_resident(
        p16, port.data_device(),
        torch.from_numpy(port.prepare_queries(queries)), port.n, psq,
        k=k, metric=port.metric, chunk=chunk,
    )
    return (np.asarray(jd), np.asarray(ji)), (pd.numpy(), pi.numpy())


def assert_same(ref_out, port_out):
    (jd, ji), (pd, pi) = ref_out, port_out
    np.testing.assert_array_equal(pi, ji)
    assert np.all(np.abs(pd - jd) <= TOL * np.maximum(1.0, np.abs(jd)))


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_topk_resident_single_shot_matches_reference(metric):
    data, queries = make_data(6000, 64, 16, seed=0, metric=metric)
    ref, port = matrices(data, metric)
    assert_same(*resident_both(ref, port, queries, 16))


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_topk_resident_chunked_branch_matches_reference(metric, monkeypatch):
    """Past SINGLE_SHOT_BYTES both packages scan in chunks with a running
    top-k merge; shrink the budget to reach that branch at test size."""
    data, queries = make_data(6000, 64, 8, seed=1, metric=metric)
    ref, port = matrices(data, metric)
    single = resident_both(ref, port, queries, 10)[1]
    monkeypatch.setattr(JD, "SINGLE_SHOT_BYTES", 1024)
    monkeypatch.setattr(TD, "SINGLE_SHOT_BYTES", 1024)
    JD.topk_resident.clear_cache()
    try:
        # 1000 does not divide the 6144 padded rows: pick_chunk takes 768,
        # so the scan merges eight chunks
        jax_out, port_out = resident_both(ref, port, queries, 10, chunk=1000)
    finally:
        JD.topk_resident.clear_cache()
    assert_same(jax_out, port_out)
    np.testing.assert_array_equal(port_out[1], single[1])


def search_both(ref, port, queries, k, mask):
    jd, ji = JD.search_packed(ref, queries, k, mask)
    pd, pi = TD.search_packed(port, queries, k, mask)
    return (jd, ji), (pd, pi)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("n", [3000, 6000])   # host path, device path
def test_search_packed_matches_reference(metric, n):
    data, queries = make_data(n, 64, 5, seed=2, metric=metric)
    ref, port = matrices(data, metric)
    (jd, ji), (pd, pi) = search_both(ref, port, queries, 10, None)
    assert pi.shape == (5, 10) and pd.dtype == np.float32
    assert_same((jd, ji), (pd, pi))


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_search_packed_tombstones_match_reference(metric):
    """Tombstones through valid_mask: dead rows are zeroed (as the
    engine does) and compacted out in finalize."""
    data, queries = make_data(6000, 64, 6, seed=3, metric=metric)
    ref, port = matrices(data, metric)
    mask = np.ones(6000, bool)
    first = JD.search_packed(ref, queries, 10)[1]
    dead = np.unique(first[:, :4].ravel())  # kill most of the true hits
    mask[dead] = False
    for pos in dead:
        ref.overwrite(int(pos), None)
        port.overwrite(int(pos), None)
    (jd, ji), (pd, pi) = search_both(ref, port, queries, 10, mask)
    assert not set(pi.ravel().tolist()) & set(dead.tolist())
    assert_same((jd, ji), (pd, pi))


def test_search_packed_short_results_pad_like_reference():
    data, queries = make_data(4500, 64, 3, seed=4, metric="cosine")
    ref, port = matrices(data, "cosine")
    mask = np.zeros(4500, bool)
    mask[[10, 20, 30]] = True
    (jd, ji), (pd, pi) = search_both(ref, port, queries, 10, mask)
    np.testing.assert_array_equal(pi, ji)
    assert pi.shape == (3, 3)
    assert set(pi.ravel().tolist()) == {10, 20, 30}


def test_packed_matrix_device_copies_follow_the_version():
    data, _ = make_data(700, 64, 1, seed=5, metric="cosine")
    _, port = matrices(data, "cosine")
    x16, sq = port.device_arrays()
    assert x16.dtype == torch.bfloat16 and x16.shape == (1024, 128)
    assert torch.equal(x16[:700].float(),
                       torch.from_numpy(port.data[:700]).bfloat16().float())
    assert torch.all(x16[700:] == 0) and sq.shape == (1024,)
    assert port.device_arrays()[0] is x16            # cached
    port.append(np.ones(64, np.float32))
    assert port.device_arrays()[0] is not x16        # stale: re-uploaded
    x32 = port.data_device()
    assert x32.dtype == torch.float32 and torch.equal(
        x32[:701], torch.from_numpy(port.data[:701])
    )
    port.release_device()
    assert port._device is None and port._device32 is None


def test_packed_matrix_upload_in_slices(monkeypatch):
    data, _ = make_data(1500, 64, 1, seed=6, metric="cosine")
    _, port = matrices(data, "cosine")
    monkeypatch.setattr(TD.PackedMatrix, "UPLOAD_CHUNK_BYTES", 512 * 100)
    x16, _ = port.device_arrays()
    assert torch.equal(x16[:1500].float(),
                       torch.from_numpy(port.data[:1500]).bfloat16().float())
    assert torch.equal(port.data_device()[:1500],
                       torch.from_numpy(port.data[:1500]))


def test_convert_refuses_inconsistent_state():
    ref = JD.PackedMatrix(64, "cosine")
    with pytest.raises(ValueError):
        packed_matrix_from_reference(ref.data[:, :64], ref.sq_norms, 0, 64,
                                     "cosine", device="cpu")
    with pytest.raises(ValueError):
        packed_matrix_from_reference(ref.data, ref.sq_norms, 10**6, 64,
                                     "cosine", device="cpu")
