"""The port's int4 rung (``helix_tpu_torch/ops/quant4.py``) against the JAX
reference (``helix_tpu/ops/quant4.py``).

Inputs come from numpy seeds and go through both packages; the Pallas
kernel runs in interpret mode, on one device.

Tolerances:

- quantizers (codes, bucket scales, row scales, ``perm``), unpacking, the
  plain kernel version and the unfused coarse scores: equal bit for bit
  (exact integer dots, then the same f32 operations);
- candidate ids: equal as sets, leaving out entries tied with the k-th
  value (integer scores tie often; the top-k implementations order ties
  differently);
- final hits: equal positions and equal distances (the same native host
  re-rank) on seeds with no boundary tie.
"""

import numpy as np
import pytest
import torch

import helix_tpu.ops.quant4 as JQ4
from helix_tpu.ops.distance import PackedMatrix as RefMatrix
from helix_tpu_torch.convert import (
    int4_resident_from_reference,
    packed_matrix_from_reference,
)
from helix_tpu_torch.ops import quant as TQ
from helix_tpu_torch.ops import quant4 as TQ4

from tests.test_torch_quant import (
    CARD_SHAPES,
    FakeMatrix,
    bits,
    boundary_ids,
    jax_q,
    unit_rows,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    original = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return original(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    fns = (JQ4._i4_bucket_scores, JQ4.int4_fused_coarse)
    for fn in fns:
        fn.clear_cache()
    yield
    for fn in fns:
        fn.clear_cache()


@pytest.fixture
def single_device(monkeypatch):
    import jax

    dev = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: [dev])


@pytest.mark.parametrize("d", [64, 128])
def test_quantizers_match_reference(d):
    rows = unit_rows(4096, d, seed=d)
    rows[100] = 0.0  # zero row: scale 1
    for got, want in zip(TQ4.quantize_rows_int4(rows),
                         JQ4.quantize_rows_int4(rows)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    n_live = 4096 - 200
    got = TQ4.quantize_rows_int4_bucketed(rows, n_live=n_live, chunk=1000)
    want = JQ4.quantize_rows_int4_bucketed(rows, n_live=n_live, chunk=1000)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    packed = got[0]
    unpacked = TQ4.unpack_int4(packed)
    np.testing.assert_array_equal(unpacked, JQ4.unpack_int4(packed))
    np.testing.assert_array_equal(
        TQ4.unpack_int4(torch.from_numpy(packed)).numpy(), unpacked)
    assert unpacked.min() >= -7 and unpacked.max() <= 7
    for n in (10_000, 1_000_000, 10_000_000):
        assert TQ4.recall_safe_pool_int4(n) == JQ4.recall_safe_pool_int4(n)
    assert TQ4.INT4_MAX_POOL == JQ4.INT4_MAX_POOL


def jax_i4_bucket_scores(packed, bsc, q_i8, n_valid):
    import jax.numpy as jnp

    return np.asarray(JQ4._i4_bucket_scores(
        jnp.asarray(packed), jnp.asarray(bsc).reshape(-1, 1),
        jnp.asarray(q_i8), jnp.int32(n_valid)))


def port_i4_bucket_scores(packed, bsc, q_i8, n_valid):
    return TQ4.i4_bucket_scores(
        torch.from_numpy(packed), torch.from_numpy(bsc),
        torch.from_numpy(q_i8), n_valid).numpy()


@pytest.mark.parametrize("n,n_valid,d,seed", [
    (16384, 16384 - 300, 128, 0),
    (24576, 24576 - 8192 - 64, 64, 1),
])
def test_i4_bucket_scores_reference_matches_pallas_bitwise(n, n_valid, d,
                                                           seed):
    packed, bsc, _, _ = TQ4.quantize_rows_int4_bucketed(
        unit_rows(n, d, seed), n_live=n_valid)
    q_i8, _ = jax_q(unit_rows(128, d, seed + 10))
    want = jax_i4_bucket_scores(packed, bsc, q_i8, n_valid)
    got = port_i4_bucket_scores(packed, bsc, q_i8, n_valid)
    assert got.shape == want.shape == (n // 64, 128)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert np.all(got[(n_valid + 63) // 64:] < -1e37)


def test_i4_bucket_scores_flushes_a_zero_row_like_the_reference():
    """Bucket 0 scores negative for query 0 except a zeroed (tombstone)
    row: the winner flushes to +0 with index bits 0 and stays +0 through
    the de-scale."""
    packed, bsc, _, _ = TQ4.quantize_rows_int4_bucketed(
        unit_rows(16384, 128, seed=5))
    q_i8, _ = jax_q(unit_rows(128, 128, seed=6))
    nib = (-np.sign(q_i8[0]) * 6).astype(np.int8)
    packed[:64] = ((nib[:64] & 0x0F) | ((nib[64:] & 0x0F) << 4)
                   ).astype(np.uint8)
    packed[9] = 0
    want = jax_i4_bucket_scores(packed, bsc, q_i8, 16384)
    got = port_i4_bucket_scores(packed, bsc, q_i8, 16384)
    assert bits(want)[0, 0] == 0
    np.testing.assert_array_equal(bits(got), bits(want))


def test_i4_bucket_scores_counts_only_kernel_launches():
    before = TQ4.i4_bucket_scores.launches
    port_i4_bucket_scores(np.zeros((8192, 64), np.uint8),
                          np.ones(128, np.float32),
                          np.zeros((128, 128), np.int8), 8192)
    assert TQ4.i4_bucket_scores.launches == before


def test_i4_bucket_scores_refuses_other_devices():
    packed = torch.empty((8192, 64), dtype=torch.uint8, device="meta")
    bsc = torch.empty(128, dtype=torch.float32, device="meta")
    q = torch.empty((128, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TQ4.i4_bucket_scores(packed, bsc, q, 8192)


def test_int4_fused_coarse_matches_reference():
    import jax.numpy as jnp

    n, d, k, n_valid = 16384, 128, 96, 16000
    packed, bsc, _, _ = TQ4.quantize_rows_int4_bucketed(
        unit_rows(n, d, seed=7), n_live=n_valid)
    qs = unit_rows(130, d, seed=8)  # two query chunks
    _, want = JQ4.int4_fused_coarse(
        jnp.asarray(packed), jnp.asarray(bsc), jnp.asarray(qs),
        jnp.int32(n_valid), k=k, interpret=True)
    _, got = TQ4.int4_fused_coarse(
        torch.from_numpy(packed), torch.from_numpy(bsc),
        torch.from_numpy(qs), n_valid, k=k)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (130, k)
    q_i8, _ = jax_q(np.pad(qs, ((0, 126), (0, 0))))
    vals = np.concatenate([
        jax_i4_bucket_scores(packed, bsc, q_i8[:128], n_valid).T,
        jax_i4_bucket_scores(packed, bsc, q_i8[128:], n_valid).T,
    ])[:130]
    strict_got, ok_got = boundary_ids(got, vals, k)
    strict_want, ok_want = boundary_ids(want, vals, k)
    assert all(ok_got) and all(ok_want)
    assert strict_got == strict_want
    assert np.all(got < n_valid)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("d", [64, 128])
def test_int4_coarse_topk_matches_reference(metric, d):
    import jax.numpy as jnp

    n, n_valid, k = 16384, 16000, 96
    rows = unit_rows(n, d, seed=d)
    if metric == "l2":
        rows = rows * np.random.default_rng(1).uniform(
            0.5, 2.0, size=(n, 1)).astype(np.float32)
    packed, scales = JQ4.quantize_rows_int4(rows)
    sq = np.einsum("nd,nd->n", rows, rows).astype(np.float32)
    qs = unit_rows(128, d, seed=d + 3)
    ws, wi = JQ4.int4_coarse_topk(
        jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(qs),
        jnp.int32(n_valid), jnp.asarray(sq), k=k, metric=metric)
    ws, wi = np.asarray(ws), np.asarray(wi)
    gs, gi = TQ4.int4_coarse_topk(
        torch.from_numpy(packed), torch.from_numpy(scales),
        torch.from_numpy(qs), n_valid, torch.from_numpy(sq), k=k,
        metric=metric)
    gs, gi = gs.numpy(), gi.numpy()
    np.testing.assert_array_equal(bits(gs), bits(ws))
    kth = gs[:, -1:]
    for j in range(len(qs)):
        assert set(gi[j][gs[j] > kth[j]].tolist()) \
            == set(wi[j][ws[j] > kth[j]].tolist())
    assert np.all(gi < n_valid)


def test_unsort_maps_out_of_range_ids_to_minus_one():
    """The reference clips an id past ``perm`` onto a real row
    (``quant4.py:454``); the port answers -1, which the re-rank drops."""
    perm = np.array([3, 0, 2, 1, 4, 5, 6, 7], np.int64)
    cand = np.array([[0, 1, 8, 100, -1, 7]], np.int64)
    got = TQ4.unsort_candidates(cand, perm)
    np.testing.assert_array_equal(got, [[3, 0, -1, -1, -1, 7]])
    # the reference's mapping of the same ids lands on row 7 twice
    ref = perm[np.clip(cand, 0, len(perm) - 1)]
    assert list(ref[0, 2:4]) == [7, 7]


def both_matrices(rows, metric):
    ref = RefMatrix(rows.shape[1], metric)
    ref.extend(rows)
    port = packed_matrix_from_reference(
        ref.data, ref.sq_norms, ref.n, ref.dim, ref.metric, device="cpu")
    return ref, port


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_int4_resident_search_matches_reference(metric, single_device):
    n, d = 24576, 64
    rows = unit_rows(n, d, seed=21)
    if metric == "l2":
        rows *= 2.0
    ref, port = both_matrices(rows, metric)
    live = np.ones(n, bool)
    live[[3, 500, 9000]] = False
    qs = unit_rows(128, d, seed=22)
    wd, wi = JQ4.Int4Resident().search(ref, qs, 10, live, metric)
    gd, gi = TQ4.Int4Resident().search(port, qs, 10, live, metric)
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_array_equal(gd, np.asarray(wd))
    assert not np.isin(gi, [3, 500, 9000]).any()


def test_reference_int4_state_installs_into_the_port(single_device):
    """One quantized state, made by the reference (scale-sorted, with its
    ``perm``), fed to both packages through
    ``int4_resident_from_reference``."""
    n, d = 16384, 128
    ref, port = both_matrices(unit_rows(n, d, seed=31), "cosine")
    ref_q = JQ4.Int4Resident()
    packed, row_scales, _, bsc, perm = ref_q.arrays(ref)
    port_q = int4_resident_from_reference(
        port, np.asarray(packed), np.asarray(bsc), np.asarray(row_scales),
        perm)
    got = port_q.arrays(port)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(packed))
    np.testing.assert_array_equal(got[4], perm)
    live = np.ones(n, bool)
    live[perm[:5]] = False  # tombstones at sorted positions 0..4
    qs = unit_rows(64, d, seed=32)
    wd, wi = ref_q.search(ref, qs, 10, live, "cosine")
    gd, gi = port_q.search(port, qs, 10, live, "cosine")
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_array_equal(gd, np.asarray(wd))


@pytest.mark.parametrize("n,d,b,why", [
    (8192, 64, 128, "D=64"),        # halves of 32 packed bytes
    (8192, 192, 256, "D=192"),
    (8192 + 32, 128, 128, "N=8224"),
    (0, 128, 128, "N=0"),
    (1 << 31, 128, 128, "N=2147483648"),
    (8192, 128, 64, "B=64"),
    (8192, 128, 192, "B=192"),
])
def test_i4_bucket_scores_refuses_shapes_the_kernel_does_not_take(n, d, b,
                                                                  why):
    """Off the CPU, the wrapper raises with the refusal's reason before it
    looks at the device (meta tensors reach the shape checks)."""
    assert why in TQ4.i4_kernel_refusal(n, d, b)
    packed = torch.empty((n, d // 2), dtype=torch.uint8, device="meta")
    bsc = torch.empty(max(n // 64, 1), dtype=torch.float32, device="meta")
    q = torch.empty((b, d), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match=f"i4_bucket_scores: {why}"):
        TQ4.i4_bucket_scores(packed, bsc, q, n)


def test_i4_search_routing_hands_the_kernel_only_shapes_it_takes():
    """``Int4Resident.search`` routes through ``fused_route`` with the
    unpacked width: it never admits a shape the kernel refuses."""
    for n in (TQ.TILE, 3 * TQ.TILE, 1 << 31):
        for d in range(64, 2049, 64):
            m = FakeMatrix("cuda", "cosine", n, d)
            route = TQ.fused_route(m, n, d, 64, TQ4.i4_kernel_refusal)
            takes = all(TQ4.i4_kernel_refusal(n, d, b) is None
                        for b in TQ.BUCKET_KERNEL_QUERIES)
            assert not route or takes, (n, d)
            assert route == (takes and d % 128 == 0), (n, d)


def chunk_ordered_codes(packed):
    """The kernel's unpack order: packed chunk k (64 bytes) becomes the
    sign-extended low nibbles, then the high nibbles."""
    lo = (packed.astype(np.int16) << 12).astype(np.int16) >> 12
    hi = (packed.astype(np.int16) << 8).astype(np.int16) >> 12
    n, h = packed.shape
    chunks = [np.concatenate([lo[:, c:c + 64], hi[:, c:c + 64]], axis=1)
              for c in range(0, h, 64)]
    return np.concatenate(chunks, axis=1).astype(np.int8)


@pytest.mark.parametrize("d", [128, 256])
def test_chunk_ordered_queries_pair_with_the_unpacked_chunks(d):
    """The plain dots of the unpacked codes against q equal those of the
    kernel's chunk-ordered codes against ``chunk_ordered_queries(q)``
    (the identity at D=128)."""
    packed, _, _, _ = TQ4.quantize_rows_int4_bucketed(unit_rows(4096, d, d))
    q_i8, _ = TQ._quantize_queries(torch.from_numpy(unit_rows(128, d, 3)))
    q_perm = TQ4.chunk_ordered_queries(q_i8)
    assert q_perm.is_contiguous() and q_perm.shape == q_i8.shape
    if d == 128:
        assert torch.equal(q_perm, q_i8)
    else:
        assert not torch.equal(q_perm, q_i8)
    want = TQ.int_dots(torch.from_numpy(TQ4.unpack_int4(packed)), q_i8)
    got = TQ.int_dots(torch.from_numpy(chunk_ordered_codes(packed)), q_perm)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_i4_bucket_scores_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda")
    for seed, (n, d, b, n_valid) in enumerate(CARD_SHAPES):
        packed, bsc, _, _ = TQ4.quantize_rows_int4_bucketed(
            unit_rows(n, d, 41 + seed), n_live=n_valid)
        q_i8, _ = TQ._quantize_queries(
            torch.from_numpy(unit_rows(b, d, 50 + seed)))
        packed, bsc = torch.from_numpy(packed), torch.from_numpy(bsc)
        before = TQ4.i4_bucket_scores.launches
        got = TQ4.i4_bucket_scores(packed.to(dev), bsc.to(dev), q_i8.to(dev),
                                   n_valid).cpu()
        assert TQ4.i4_bucket_scores.launches == before + 1
        want = TQ4.i4_bucket_scores_reference(packed, bsc, q_i8, n_valid)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError):
        TQ4.i4_bucket_scores(packed.to(dev), bsc[:5].to(dev), q_i8.to(dev),
                             n_valid)
