"""The port's int8 rung (``helix_tpu_torch/ops/quant.py``) against the JAX
reference (``helix_tpu/ops/quant.py``).

Inputs come from numpy seeds and go through both packages; the Pallas
kernel runs in interpret mode, on one device.

Tolerances:

- quantizers, the plain kernel version and the unfused coarse scores:
  equal bit for bit (exact integer dots, the same f32 operations);
- candidate ids of the fused and unfused coarse paths: equal as sets,
  leaving out entries tied with the k-th value (integer scores tie often;
  the two top-k implementations order ties differently);
- final hits: equal positions on seeds with no boundary tie; distances
  equal after the host re-rank (the same native code) and within 1e-6
  after the f16 device re-rank (f32 sums in another order).
"""

import re

import numpy as np
import pytest
import torch

import helix_tpu.ops.quant as JQ
from helix_tpu.ops.distance import PackedMatrix as RefMatrix
from helix_tpu_torch.convert import (
    packed_matrix_from_reference,
    quantized_resident_from_reference,
)
from helix_tpu_torch.ops import quant as TQ

torch.set_num_threads(2)

RERANK_TOL = 1e-6


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    original = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return original(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    fns = (JQ._i8_bucket_scores, JQ.int8_fused_coarse)
    for fn in fns:
        fn.clear_cache()
    yield
    for fn in fns:
        fn.clear_cache()


def unit_rows(n, d, seed, clusters=64):
    """Clustered unit rows (``bench.py``'s generator at test size)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)).astype(np.float32)
    rows = centers[rng.integers(0, clusters, size=n)] \
        + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def jax_q(qs):
    """The reference's query quantizer as it runs, under ``jit``."""
    import jax
    import jax.numpy as jnp

    q_i8, q_scales = jax.jit(JQ._quantize_queries)(jnp.asarray(qs))
    return np.asarray(q_i8), np.asarray(q_scales)


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("d", [64, 128])
def test_quantizers_match_reference(d):
    rows = unit_rows(2048, d, seed=d)
    rng = np.random.default_rng(d + 1)
    raw = rng.normal(size=(512, d)).astype(np.float32) * 3.0
    raw[7] = 0.0  # zero row: scale 1
    np.testing.assert_array_equal(TQ.quantize_rows_unit(rows),
                                  JQ.quantize_rows_unit(rows))
    for got, want in zip(TQ.quantize_rows(raw), JQ.quantize_rows(raw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    qs = rng.normal(size=(130, d)).astype(np.float32)
    qs[3] = 0.0
    q_i8, q_scales = TQ._quantize_queries(torch.from_numpy(qs))
    want_i8, want_scales = jax_q(qs)
    np.testing.assert_array_equal(q_i8.numpy(), want_i8)
    np.testing.assert_array_equal(bits(q_scales.numpy()), bits(want_scales))
    assert TQ.GLOBAL_SCALE == JQ.GLOBAL_SCALE


def test_unit_row_with_a_component_of_one():
    """A normalised row can hold a component of exactly +-1: the global
    scale maps it to +-127 (the clip keeps it in range), as in the
    reference."""
    rows = np.zeros((4, 128), np.float32)
    rows[0, 3] = 1.0
    rows[1, 100] = -1.0
    rows[2, :2] = np.float32(np.sqrt(0.5))
    codes = TQ.quantize_rows_unit(rows)
    np.testing.assert_array_equal(codes, JQ.quantize_rows_unit(rows))
    assert codes[0, 3] == 127 and codes[1, 100] == -127
    assert np.abs(codes.astype(np.int32)).max() == 127


def jax_i8_bucket_scores(xi, q_i8, n_valid):
    import jax.numpy as jnp

    return np.asarray(JQ._i8_bucket_scores(
        jnp.asarray(xi), jnp.asarray(q_i8), jnp.int32(n_valid)))


# Rows of bucket 1 (positive scores) and bucket 2 (negative) whose sums
# for query 1 share every f32 bit the pack keeps, and buckets 3 and 4 of
# 64 equal sums, positive and negative (made_ties); the rows the packed
# max takes: the higher among positive scores, the lower among negative
# ones, where an integer max (or an unpacked float max) of the sums takes
# the other row of buckets 1 and 2.
TIE_ROWS = (9, 40)
TIE_WINNERS = (40, 9, 63, 0)


def made_ties(xi, q_i8):
    """chip_smoke.py's made ties, in numpy: query 1 is 127 but its last
    column (1); the tie rows are 127 but column 0 (126) and their last
    column (5, then 2), so their sums are 127 (127 (D - 1) - 1) + 5 and
    + 2, at or above 2^20 where the pack drops at least 3 low bits;
    bucket 1's other rows are 0, bucket 2's rows are negated and its
    other rows -127; buckets 3 and 4 hold 64 rows of 1 and of -1."""
    d = xi.shape[1]
    tie = np.full((2, d), 127, np.int8)
    tie[:, 0] = 126
    tie[:, -1] = (5, 2)
    pos = np.zeros((64, d), np.int8)
    neg = np.full((64, d), -127, np.int8)
    pos[list(TIE_ROWS)] = tie
    neg[list(TIE_ROWS)] = -tie
    ones = np.ones((64, d), np.int8)
    xi[64:320] = np.concatenate([pos, neg, ones, -ones])
    q_i8[1] = 127
    q_i8[1, -1] = 1


@pytest.mark.parametrize("n,n_valid,d,seed,ties", [
    pytest.param(16384, 16384 - 300, 128, 0, False, id="16384-16084-128-0"),
    pytest.param(24576, 24576 - 8192 - 64, 64, 1, False,
                 id="24576-16320-64-1"),
    pytest.param(16384, 16384 - 300, 128, 2, True, id="ties-128"),
    pytest.param(16384, 16384 - 300, 256, 3, True, id="ties-256"),
    pytest.param(16384, 16384 - 300, 384, 4, True, id="ties-384"),
])
def test_i8_bucket_scores_reference_matches_pallas_bitwise(n, n_valid, d,
                                                           seed, ties):
    xi = TQ.quantize_rows_unit(unit_rows(n, d, seed))
    q_i8, _ = jax_q(unit_rows(128, d, seed + 10))
    if ties:
        q_i8 = q_i8.copy()
        made_ties(xi, q_i8)
    want = jax_i8_bucket_scores(xi, q_i8, n_valid)
    got = TQ.i8_bucket_scores(torch.from_numpy(xi), torch.from_numpy(q_i8),
                              n_valid).numpy()
    assert got.shape == want.shape == (n // 64, 128)
    np.testing.assert_array_equal(bits(got), bits(want))
    # buckets past the masked tail carry the sentinel on both sides
    assert np.all(got[(n_valid + 63) // 64:] < -1e38)
    if ties:
        sums = xi[64:192].astype(np.int64) @ q_i8[1].astype(np.int64)
        for b, sign in ((0, 1), (1, -1)):
            a, c = sums[64 * b + np.array(TIE_ROWS)]
            # row 9's sum is the larger in magnitude
            assert a != c and sign * a > sign * c
            assert bits(float(a)) & ~63 == bits(float(c)) & ~63
        assert [bits(want)[b, 1] & 63 for b in (1, 2, 3, 4)] == \
            list(TIE_WINNERS)


def test_i8_bucket_scores_flushes_a_zero_row_like_the_reference():
    """Bucket 0 scores negative for query 0 except a zeroed (tombstone)
    row, whose packed denormal flushes to +0 with index bits 0."""
    xi = TQ.quantize_rows_unit(unit_rows(16384, 128, seed=5))
    q_i8, _ = jax_q(unit_rows(128, 128, seed=6))
    xi[:64] = (-np.sign(q_i8[0]) * 90).astype(np.int8)
    xi[9] = 0
    want = jax_i8_bucket_scores(xi, q_i8, 16384)
    got = TQ.i8_bucket_scores(torch.from_numpy(xi), torch.from_numpy(q_i8),
                              16384).numpy()
    assert bits(want)[0, 0] == 0
    np.testing.assert_array_equal(bits(got), bits(want))


def test_i8_bucket_scores_counts_only_kernel_launches():
    xi = torch.zeros((8192, 128), dtype=torch.int8)
    q = torch.zeros((128, 128), dtype=torch.int8)
    before = TQ.i8_bucket_scores.launches
    TQ.i8_bucket_scores(xi, q, 8192)
    assert TQ.i8_bucket_scores.launches == before  # CPU: the plain version


def test_i8_bucket_scores_refuses_other_devices():
    xs = torch.empty((8192, 128), dtype=torch.int8, device="meta")
    q = torch.empty((128, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TQ.i8_bucket_scores(xs, q, 8192)


def test_the_exact_add_is_the_f32_of_every_sum_within_2_22():
    """Kernel 2's int -> f32 step up to D = 256: bits(1.5 * 2^23) + v,
    read as f32, less 1.5 * 2^23, is f32(v) bit for bit for every
    |v| <= 2^22, and not one past it.  Any int8 codes keep |v| within
    128 * 128 * D <= 2^22 at D <= 256; at D = 384 codes of +-127 do not,
    so the kernel converts there with the rounded conversion."""
    v = np.arange(-(1 << 22), (1 << 22) + 1, dtype=np.int32)
    got = (v + np.int32(0x4B400000)).view(np.float32) - np.float32(12582912)
    np.testing.assert_array_equal(got.view(np.int32),
                                  v.astype(np.float32).view(np.int32))
    past = np.int32((1 << 22) + 1)
    assert (past + np.int32(0x4B400000)).view(np.float32) \
        - np.float32(12582912) != np.float32(past)
    assert 128 * 128 * TQ.I8_EXACT_ADD_MAX_D <= 1 << 22
    assert 127 * 127 * 384 > 1 << 22


def test_the_exact_add_bound_is_the_kernels():
    from helix_tpu_torch import kernels

    src = (kernels._HERE / "csrc" / "i8_bucket_scores.cu").read_text()
    found = re.search(r"constexpr int EXACT_ADD_MAX_D = (\d+);", src)
    assert found and int(found.group(1)) == TQ.I8_EXACT_ADD_MAX_D


@pytest.mark.parametrize("d, counted", [(128, 1), (256, 1), (384, 0),
                                        (768, 0)])
def test_a_profiled_launch_counts_the_exact_add_up_to_d256(monkeypatch, d,
                                                           counted):
    """The wrapper's counter ``kernel.i8_bucket_scores.exact_add``: one
    per launch at D <= 256 while a profiler records, none above, none
    for a captured node and none without a profiler (the C entry is
    replaced by a stub that launches nothing)."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    from helix_tpu_torch import kernels, tracing

    captured = []
    monkeypatch.setattr(kernels, "check_operands", lambda *a: None)
    monkeypatch.setattr(kernels, "load", lambda: SimpleNamespace(
        hx_i8_bucket_scores=None))
    monkeypatch.setattr(kernels, "launch", lambda *a: bool(captured))
    xs = torch.empty((8192, d), dtype=torch.int8, device="meta")
    q = torch.empty((256, d), dtype=torch.int8, device="meta")
    name = "kernel.i8_bucket_scores.exact_add"

    def count():
        return tracing.snapshot().counts.get(name, 0)

    before = count()
    TQ.i8_bucket_scores(xs, q, 8192)
    assert count() == before
    with profile(activities=[ProfilerActivity.CPU]):
        TQ.i8_bucket_scores(xs, q, 8192)
        captured.append(True)
        TQ.i8_bucket_scores(xs, q, 8192)
    assert count() - before == counted


def boundary_ids(ids, vals_t, k):
    """Split each query's candidate ids into those strictly above the
    k-th bucket winner (must match exactly) and those tied with it."""
    kth = -np.sort(-vals_t, axis=1)[:, k - 1:k]
    win = np.take_along_axis(vals_t, ids // 64, axis=1)
    return [set(ids[j][win[j] > kth[j]].tolist()) for j in range(len(ids))], \
        [bool(np.all(win[j] >= kth[j])) for j in range(len(ids))]


def test_int8_fused_coarse_matches_reference():
    import jax.numpy as jnp

    n, d, k, n_valid = 16384, 128, 80, 16000
    xi = TQ.quantize_rows_unit(unit_rows(n, d, seed=7))
    qs = unit_rows(130, d, seed=8)  # two query chunks
    _, want = JQ.int8_fused_coarse(jnp.asarray(xi), jnp.asarray(qs),
                                   jnp.int32(n_valid), k=k, interpret=True)
    _, got = TQ.int8_fused_coarse(torch.from_numpy(xi), torch.from_numpy(qs),
                                  n_valid, k=k)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (130, k)
    q_i8, _ = jax_q(np.pad(qs, ((0, 126), (0, 0))))
    vals = np.concatenate([
        jax_i8_bucket_scores(xi, q_i8[:128], n_valid).T,
        jax_i8_bucket_scores(xi, q_i8[128:], n_valid).T,
    ])[:130]
    strict_got, ok_got = boundary_ids(got, vals, k)
    strict_want, ok_want = boundary_ids(want, vals, k)
    assert all(ok_got) and all(ok_want)
    assert strict_got == strict_want
    assert all(len(set(r.tolist())) == k for r in got)
    assert np.all(got < n_valid)


def jax_coarse(xi, scales, qs, n_valid, sq, k, metric):
    import jax.numpy as jnp

    s, i = JQ.int8_coarse_topk(jnp.asarray(xi), jnp.asarray(scales),
                               jnp.asarray(qs), jnp.int32(n_valid),
                               jnp.asarray(sq), k=k, metric=metric)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("d", [64, 128])
def test_int8_coarse_topk_matches_reference(metric, d):
    n, n_valid, k = 16384, 16000, 64
    rows = unit_rows(n, d, seed=d)
    if metric == "l2":
        rows = rows * np.random.default_rng(1).uniform(
            0.5, 2.0, size=(n, 1)).astype(np.float32)
        xi, scales = JQ.quantize_rows(rows)
    else:
        xi = JQ.quantize_rows_unit(rows)
        scales = np.full(n, JQ.GLOBAL_SCALE, np.float32)
    sq = np.einsum("nd,nd->n", rows, rows).astype(np.float32)
    qs = unit_rows(128, d, seed=d + 3)
    ws, wi = jax_coarse(xi, scales, qs, n_valid, sq, k, metric)
    gs, gi = TQ.int8_coarse_topk(
        torch.from_numpy(xi), torch.from_numpy(scales), torch.from_numpy(qs),
        n_valid, torch.from_numpy(sq), k=k, metric=metric)
    gs, gi = gs.numpy(), gi.numpy()
    # the scores are the same f32 values in the same order
    np.testing.assert_array_equal(bits(gs), bits(ws))
    kth = gs[:, -1:]
    for j in range(len(qs)):
        above = gs[j] > kth[j]
        assert set(gi[j][above].tolist()) == set(wi[j][ws[j] > kth[j]].tolist())
    assert np.all(gi < n_valid)


def jax_device_rerank(xs16, sq, qs, cand, live, n_valid, k, metric):
    import jax.numpy as jnp

    d, i = JQ.device_rerank_topk(
        jnp.asarray(xs16), jnp.asarray(sq), jnp.asarray(qs),
        jnp.asarray(cand, jnp.int32), jnp.asarray(live), jnp.int32(n_valid),
        k=k, metric=metric)
    return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_device_rerank_topk_matches_reference(metric):
    rng = np.random.default_rng(11)
    n16, n_valid, d, b, kc, k = 4096, 4000, 128, 16, 48, 10
    rows = unit_rows(n16, d, seed=12)
    xs16 = rows.astype(np.float16)
    sq = np.einsum("nd,nd->n", rows, rows).astype(np.float32)
    qs = unit_rows(b, d, seed=13)
    cand = rng.integers(0, n16, size=(b, kc)).astype(np.int64)
    cand[:, 0] = -1               # junk slot
    cand[:, 1] = n_valid + 5      # past n_valid
    cand[0, :] = -1               # a query with no candidate at all
    cand[1, :3] = [7, 7, 7]       # a dead row, repeated
    live = np.ones(n16, np.uint8)
    live[7] = 0
    live[n_valid:] = 0
    wd, wi = jax_device_rerank(xs16, sq, qs, cand, live, n_valid, k, metric)
    gd, gi = TQ.device_rerank_topk(
        torch.from_numpy(xs16), torch.from_numpy(sq), torch.from_numpy(qs),
        torch.from_numpy(cand), torch.from_numpy(live), n_valid, k=k,
        metric=metric)
    gd, gi = gd.numpy(), gi.numpy()
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    assert np.all(gi[0] == -1) and np.all(np.isposinf(gd[0]))
    assert 7 not in gi
    fin = np.isfinite(wd)
    assert np.all(np.abs(gd[fin] - wd[fin]) <= RERANK_TOL * 4)


def both_matrices(rows, metric):
    ref = RefMatrix(rows.shape[1], metric)
    ref.extend(rows)
    port = packed_matrix_from_reference(
        ref.data, ref.sq_norms, ref.n, ref.dim, ref.metric, device="cpu")
    return ref, port


@pytest.fixture
def single_device(monkeypatch):
    import jax

    dev = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: [dev])


@pytest.mark.parametrize("metric,rerank_device", [
    ("cosine", False), ("cosine", True), ("l2", False), ("l2", True),
])
def test_quantized_resident_search_matches_reference(metric, rerank_device,
                                                     single_device):
    n, d = 24576, 64
    rows = unit_rows(n, d, seed=21)
    if metric == "l2":
        rows *= 2.0
    ref, port = both_matrices(rows, metric)
    live = np.ones(n, bool)
    live[[3, 500, 9000]] = False
    qs = unit_rows(128, d, seed=22)
    wd, wi = JQ.QuantizedResident().search(
        ref, qs, 10, live, metric, rerank_device=rerank_device)
    gd, gi = TQ.QuantizedResident().search(
        port, qs, 10, live, metric, rerank_device=rerank_device)
    np.testing.assert_array_equal(gi, np.asarray(wi))
    tol = RERANK_TOL * (8 if metric == "l2" else 1) if rerank_device else 0.0
    assert np.max(np.abs(gd - np.asarray(wd))) <= tol
    assert not np.isin(gi, [3, 500, 9000]).any()


def test_reference_int8_state_installs_into_the_port(single_device):
    """One quantized state, made by the reference, fed to both packages
    through ``quantized_resident_from_reference``."""
    n, d = 16384, 128
    ref, port = both_matrices(unit_rows(n, d, seed=31), "cosine")
    ref_q = JQ.QuantizedResident()
    codes, scales, _ = ref_q.arrays(ref)
    # mark the state so a re-quantization on the port side would show
    codes = np.asarray(codes).copy()
    codes[:, -1] = 0
    ref_q._cached = (ref.version, ref_q._cached[1].at[:, -1].set(0),
                     ref_q._cached[2], ref_q._cached[3])
    port_q = quantized_resident_from_reference(port, codes,
                                               np.asarray(scales))
    xs_i8, _, _ = port_q.arrays(port)
    np.testing.assert_array_equal(xs_i8.numpy(), codes)
    live = np.ones(n, bool)
    qs = unit_rows(64, d, seed=32)
    wd, wi = ref_q.search(ref, qs, 10, live, "cosine")
    gd, gi = port_q.search(port, qs, 10, live, "cosine")
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_array_equal(gd, np.asarray(wd))


def test_use_fused_gate():
    M = FakeMatrix
    assert TQ.use_fused(M("cuda", "cosine", 8192, 128))
    assert TQ.use_fused(M("cuda", "cosine", 10**6, 4096))  # no width cap
    assert not TQ.use_fused(M("cuda", "cosine", 8191, 128))
    assert not TQ.use_fused(M("cuda", "l2", 8192, 128))
    assert not TQ.use_fused(M("cpu", "cosine", 8192, 128))
    assert not TQ.use_fused(M("cuda", "cosine", 8192, 192))


class FakeMatrix:
    """What ``use_fused`` and ``fused_route`` read of a ``PackedMatrix``."""
    ROW_PAD = 512

    def __init__(self, device, metric, n, dim_pad):
        self.device = torch.device(device)
        self.metric, self.n, self.dim_pad = metric, n, dim_pad


@pytest.mark.parametrize("n,d,b,why", [
    (8192, 64, 128, "D=64"),        # not a whole 128-column int8 chunk
    (8192, 192, 256, "D=192"),
    (8192, 0, 128, "D=0"),
    (8192 + 32, 128, 128, "N=8224"),  # a part bucket
    (0, 128, 128, "N=0"),
    (1 << 31, 128, 128, "N=2147483648"),
    (8192, 128, 64, "B=64"),        # neither query block
    (8192, 128, 192, "B=192"),
    (8192, 128, 384, "B=384"),
])
def test_i8_bucket_scores_refuses_shapes_the_kernel_does_not_take(n, d, b,
                                                                  why):
    """Off the CPU, the wrapper raises with the refusal's reason before it
    looks at the device (meta tensors reach the shape checks)."""
    assert why in TQ.i8_kernel_refusal(n, d, b)
    xs = torch.empty((n, d), dtype=torch.int8, device="meta")
    q = torch.empty((b, d), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match=f"i8_bucket_scores: {why}"):
        TQ.i8_bucket_scores(xs, q, n)


@pytest.mark.parametrize("n,d,b", [
    (8192, 128, 128), (8192, 128, 256), (3 * 8192, 768, 256),
    (64, 4096, 128),
])
def test_i8_kernel_refusal_admits_the_kernel_shapes(n, d, b):
    assert TQ.i8_kernel_refusal(n, d, b) is None
    xs = torch.empty((n, d), dtype=torch.int8, device="meta")
    q = torch.empty((b, d), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):  # past the shape checks
        TQ.i8_bucket_scores(xs, q, n)


def test_search_routing_hands_the_kernel_only_shapes_it_takes():
    """``QuantizedResident.search`` takes the fused kernel exactly when
    ``fused_route`` says so, and that never admits a shape the kernel
    refuses at either query block ``fused_coarse`` pads to."""
    for n in (TQ.TILE, 3 * TQ.TILE, 1 << 31):
        for d in range(64, 2049, 64):
            m = FakeMatrix("cuda", "cosine", n, d)
            route = TQ.fused_route(m, n, d, 64, TQ.i8_kernel_refusal)
            takes = all(TQ.i8_kernel_refusal(n, d, b) is None
                        for b in TQ.BUCKET_KERNEL_QUERIES)
            assert not route or takes, (n, d)
            assert route == (takes and d % 128 == 0), (n, d)
    m = FakeMatrix("cuda", "cosine", TQ.TILE, 128)
    assert TQ.fused_route(m, TQ.TILE, 128, TQ.TILE // 64, TQ.i8_kernel_refusal)
    assert not TQ.fused_route(m, TQ.TILE, 128, TQ.TILE // 64 + 1,
                              TQ.i8_kernel_refusal)
    assert not TQ.fused_route(m, TQ.TILE + 512, 128, 64, TQ.i8_kernel_refusal)
    cpu = FakeMatrix("cpu", "cosine", TQ.TILE, 128)
    assert not TQ.fused_route(cpu, TQ.TILE, 128, 64, TQ.i8_kernel_refusal)


# (rows, width, queries, rows live): the main path's D=128 at both query
# blocks, a width whose queries fit in shared memory (D=256), and D=768,
# whose queries stream through the rings at B=256 and stay resident at
# B=128; n_valid in mid-bucket.
CARD_SHAPES = [
    (3 * 8192, 256, 256, 3 * 8192 - 77),
    (3 * 8192, 128, 256, 3 * 8192 - 4000),
    (2 * 8192, 128, 128, 2 * 8192 - 33),
    (8192, 768, 256, 8192 - 100),
    (8192, 768, 128, 5000),
]


@pytest.mark.cuda
def test_i8_bucket_scores_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda")
    for seed, (n, d, b, n_valid) in enumerate(CARD_SHAPES):
        rows = unit_rows(n, d, 41 + seed)
        xi = torch.from_numpy(TQ.quantize_rows_unit(rows))
        q_i8, _ = TQ._quantize_queries(
            torch.from_numpy(unit_rows(b, d, 50 + seed)))
        before = TQ.i8_bucket_scores.launches
        got = TQ.i8_bucket_scores(xi.to(dev), q_i8.to(dev), n_valid).cpu()
        assert TQ.i8_bucket_scores.launches == before + 1
        want = TQ.i8_bucket_scores_reference(xi, q_i8, n_valid)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError):
        TQ.i8_bucket_scores(xi.to(dev), q_i8[:100].to(dev), n_valid)
