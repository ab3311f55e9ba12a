"""The port's one-pass sweep (kernel 4, ``helix_tpu_torch.benchmarks
.onepass_sweep``) against the reference's ``benchmarks/onepass_sweep.py``,
with the copies it imports (``ladder``'s corpus, oracle and recall) and
the port's ``roofline``.

Kernel 4's variants are the reference's kernel bodies swapped into
``helix_tpu.ops.fused_topk._make_kernel`` and run in Pallas interpret
mode, as the sweep's ``--interpret`` runs them; the port's side is each
variant's wrapper on CPU tensors (its plain version).  On rows and
queries that hold small integers every f32 sum is exact in any order, so
the packed winners must agree bit for bit (apart from the documented
denormal rule, applied to the reference's side); on unit rows the sums
differ by a rounding, and the kernel tests' tolerance rule applies
(1e-6 plus one packing quantum; index bits may differ only at a near
tie).  ``n_valid`` = 12,000 in 16,384 padded rows gives an interior tile,
a tile holding padding rows, a bucket that straddles ``n_valid`` and
wholly dead buckets.
"""

import json
import time

import numpy as np
import pytest
import torch

import benchmarks.ladder as ref_ladder
import benchmarks.onepass_sweep as ref_sweep
import helix_tpu.ops.fused_topk as JF
from helix_tpu_torch.benchmarks import ladder, onepass_sweep, roofline
from helix_tpu_torch.ops import fused_topk as TF

torch.set_num_threads(2)

TOL = 1e-6
MAKERS = {"shipped": lambda: JF._make_kernel,
          "onepass": lambda: ref_sweep._make_kernel_onepass,
          "lastmask": lambda: ref_sweep._make_kernel_lastmask}


@pytest.fixture
def reference(monkeypatch):
    """``run(variant, xs, qs, n_valid)``: the reference's ``[buckets, B]``
    winners with the variant's body in ``_bucket_scores`` (interpret
    mode); the patches are undone at teardown."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    original = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call",
        lambda *a, **kw: original(*a, **{**kw, "interpret": True}))

    def run(variant, xs, qs, n_valid):
        monkeypatch.setattr(JF, "_make_kernel", MAKERS[variant]())
        JF._bucket_scores.clear_cache()
        return np.asarray(JF._bucket_scores(
            jnp.asarray(xs, jnp.bfloat16), jnp.asarray(qs, jnp.bfloat16),
            jnp.int32(n_valid)))

    yield run
    JF._bucket_scores.clear_cache()


def flush(v: np.ndarray) -> np.ndarray:
    """The port's denormal rule on f32 values: |v| < FLT_MIN -> signed 0."""
    bits = v.view(np.int32)
    return np.where((bits & 0x7F800000) == 0, bits & np.int32(-2 ** 31),
                    bits).view(np.float32)


def integer_data(n, d, b, seed):
    """Rows and queries of small integers: bf16 holds them exactly and
    every sum (|s| <= 64 * d) is exact in f32."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, size=(n, d)).astype(np.float32),
            rng.integers(-8, 9, size=(b, d)).astype(np.float32))


def unit_data(n, d, b, seed):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    qs = rng.normal(size=(b, d)).astype(np.float32)
    return (xs / np.linalg.norm(xs, axis=1, keepdims=True),
            qs / np.linalg.norm(qs, axis=1, keepdims=True))


def port(variant, xs, qs, n_valid, depth=0):
    return onepass_sweep.KERNELS[variant](
        torch.from_numpy(xs).to(torch.bfloat16),
        torch.from_numpy(qs).to(torch.bfloat16), n_valid, depth=depth,
    ).numpy()


@pytest.mark.parametrize("variant", onepass_sweep.VARIANTS)
@pytest.mark.parametrize("n_valid,b", [(12_000, 128), (12_000, 256),
                                       (16_384, 128), (16_384, 256)])
def test_variant_equals_the_reference_bit_for_bit(reference, variant,
                                                  n_valid, b):
    xs, qs = integer_data(16_384, 128, b, seed=n_valid + b)
    want = reference(variant, xs, qs, n_valid)
    got = port(variant, xs, qs, n_valid, depth=2)
    assert got.shape == want.shape == (256, b) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32),
                                  flush(want).view(np.int32))


def test_dead_buckets_and_the_straddling_bucket(reference):
    """Past n_valid = 12,000 (bucket 187 holds rows 11,968-12,031) the
    wholly dead buckets carry NEG_SENTINEL with their index bits, and the
    straddling bucket's winner is one of its live rows."""
    xs, qs = integer_data(16_384, 128, 128, seed=3)
    for variant in onepass_sweep.VARIANTS:
        got = port(variant, xs, qs, 12_000)
        want = flush(reference(variant, xs, qs, 12_000))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        dead = got[188:].view(np.int32) & ~63
        assert np.all(dead == (np.float32(JF.NEG_SENTINEL).view(np.int32)
                               & ~63))
        assert np.all(got[187] > JF.NEG_SENTINEL / 2)
        assert np.all((got[187].view(np.int32) & 63) < 12_000 - 187 * 64)


@pytest.mark.parametrize("variant", ("onepass", "lastmask"))
def test_variant_on_unit_rows_within_the_kernel_tolerance(reference,
                                                          variant):
    xs, qs = unit_data(16_384, 128, 256, seed=5)
    want = reference(variant, xs, qs, 12_000)
    got = port(variant, xs, qs, 12_000)
    x16 = torch.from_numpy(xs).to(torch.bfloat16).double().numpy()
    q16 = torch.from_numpy(qs).to(torch.bfloat16).double().numpy()
    sims = x16 @ q16.T
    sims[12_000:] = JF.NEG_SENTINEL
    gb, wb = got.view(np.int32), want.view(np.int32)
    g_val = (gb & ~63).view(np.float32)
    w_val = (wb & ~63).view(np.float32)
    quantum = (np.abs(w_val).view(np.int32) & 0x7F800000).view(
        np.float32) * np.float32(2.0 ** -17)
    window = TOL + quantum
    assert np.all(np.abs(g_val - w_val) <= window)
    mismatch = (gb & 63) != (wb & 63)
    top2 = -np.sort(-sims.reshape(-1, 64, 256), axis=1)[:, :2]
    assert np.all((top2[:, 0] - top2[:, 1])[mismatch] <= window[mismatch])


def test_fused_topk_takes_a_variant_as_its_winners():
    xs, qs = unit_data(16_384, 128, 64, seed=9)
    xs16 = torch.from_numpy(xs).to(torch.bfloat16)
    xs32 = torch.from_numpy(xs)
    q = torch.from_numpy(qs)
    sq = torch.zeros(1)
    want = TF.fused_topk(xs16, xs32, q, 12_000, sq, k=10)
    for variant in onepass_sweep.VARIANTS:
        got = TF.fused_topk(xs16, xs32, q, 12_000, sq, k=10,
                            winners=onepass_sweep.KERNELS[variant])
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    kernel = onepass_sweep.KERNELS["onepass"]
    with pytest.raises(ValueError, match="multiple of 64"):
        kernel(torch.zeros((100, 128), dtype=torch.bfloat16),
               torch.zeros((128, 128), dtype=torch.bfloat16), 100)
    with pytest.raises(ValueError, match="B=100"):
        kernel(torch.zeros((128, 128), dtype=torch.bfloat16),
               torch.zeros((100, 128), dtype=torch.bfloat16), 100)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", onepass_sweep.VARIANTS)
def test_kernel_4_matches_its_plain_version_and_kernel_1_on_the_card(
        variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda")
    xs, qs = integer_data(65_536, 128, 256, seed=11)
    x16 = torch.from_numpy(xs).to(torch.bfloat16)
    q16 = torch.from_numpy(qs).to(torch.bfloat16)
    want = TF.bucket_scores_reference(x16, q16, 60_000)
    kernel1 = TF.bucket_scores(x16.to(dev), q16.to(dev), 60_000)
    kernel = onepass_sweep.KERNELS[variant]
    for depth in (2, 4, 8):
        before = kernel.launches
        got = kernel(x16.to(dev), q16.to(dev), 60_000, depth=depth)
        assert kernel.launches == before + 1
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
        assert torch.equal(got.view(torch.int32), kernel1.view(torch.int32))


# ------------------------------------------------------------ the sweep


def run_main(module, argv, capsys):
    rc = module.main(argv)
    out = capsys.readouterr()
    lines = [ln for ln in out.out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out.out
    return rc, json.loads(lines[0]), out.err


def test_sweep_runs_on_the_cpu_with_the_reference_keys(capsys):
    rc, line, _ = run_main(onepass_sweep, [
        "--device", "cpu", "--n", "12000", "--rounds", "2",
        "--tiles", "2,8"], capsys)
    assert rc == 0
    assert set(line) == {"metric", "roofline_qps", "device", "variants"}
    assert line["metric"] == ("onepass kernel sweep (N=12000, d=128, "
                              "batch=256)")
    assert line["roofline_qps"] is None and line["device"] == "cpu"
    rows = line["variants"]
    assert [(r["kernel"], r["ring_depth"]) for r in rows] == [
        (v, t) for v in onepass_sweep.VARIANTS for t in (2, 8)]
    for row in rows:
        assert set(row) == {"kernel", "ring_depth", "qps", "recall_at_10",
                            "per_batch_ms", "bound_ms", "launches",
                            "captured"}
        assert row["qps"] > 0 and len(row["per_batch_ms"]) == 3
        assert row["bound_ms"] is None and row["launches"] == 0
        assert row["recall_at_10"] == rows[0]["recall_at_10"] >= 0.95


def test_a_failed_variant_fails_the_sweep(capsys, monkeypatch):
    def fail(*args, **kwargs):
        raise RuntimeError("no graph")

    monkeypatch.setattr(onepass_sweep, "timed_scan_qps", fail)
    rc, line, err = run_main(onepass_sweep, [
        "--device", "cpu", "--n", "12000", "--tiles", "2"], capsys)
    assert rc == 1 and line["variants"] == []
    assert err.count("FAILED") == 3


def test_sweep_refuses_to_run_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert onepass_sweep.main(["--n", "12000"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


# ------------------------------------------------------------ the copies


@pytest.mark.parametrize("n,d,batch,n_batches", [(20_000, 32, 16, 2),
                                                 (3_000, 128, 64, 1)])
def test_corpus_equals_the_reference(n, d, batch, n_batches):
    got = ladder._corpus(n, d, batch, n_batches)
    want = ref_ladder._corpus(n, d, batch, n_batches)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [1, 10, 80])
def test_oracle_equals_the_reference_without_ties(k):
    data, queries = ref_ladder._corpus(30_000, 32, 48, 1)
    sims = queries @ data.T
    kth = -np.sort(-sims, axis=1)[:, k - 1:k + 1]
    assert np.all(kth[:, 0] > kth[:, 1])  # no tie at rank k on this seed
    np.testing.assert_array_equal(ladder._oracle(data, queries, k),
                                  ref_ladder._oracle(data, queries, k))


def test_recall_equals_the_reference():
    rng = np.random.default_rng(4)
    oracle = rng.integers(0, 50, size=(20, 10))
    ids = rng.integers(-1, 50, size=(20, 12))
    assert ladder._recall(ids, oracle, 10) == ref_ladder._recall(
        ids, oracle, 10)


# ------------------------------------------------------------ roofline


def test_roofline_has_no_bound_without_a_known_card():
    assert roofline.roofline_batch_seconds(
        bytes_read=1e9, mxu_ops=1e12, device="cpu") is None
    row = {"qps": 5.0}
    assert roofline.apply_roofline(row, 256, None) == {"qps": 5.0}


def test_roofline_bound_is_the_larger_of_bytes_and_operations(monkeypatch):
    from helix_tpu_torch import card

    monkeypatch.setattr(roofline, "device_specs", lambda device=None: (
        card.PEAK_BYTES_PER_S, card.PEAK_BF16_PER_S, card.PEAK_INT8_PER_S))
    by_bytes = roofline.roofline_batch_seconds(
        bytes_read=3.35e9, mxu_ops=1e12, dtype="int8")
    assert by_bytes == pytest.approx(1e-3)
    by_ops = roofline.roofline_batch_seconds(
        bytes_read=1.0, mxu_ops=989e9, dtype="bf16")
    assert by_ops == pytest.approx(1e-3)


def test_a_reading_above_the_bound_raises_instead_of_clamping():
    assert roofline.apply_roofline({"qps": 40.0}, 10, 0.2) == {
        "qps": 40.0, "roofline_qps": 50.0}
    with pytest.raises(roofline.RooflineFault, match="above the card's"):
        roofline.apply_roofline({"qps": 100.0}, 10, 0.2)


def test_timed_scan_is_a_two_point_difference_over_fresh_batches():
    seen = []

    def fn(qb, xs):
        # a fixed host wait per call: the full - half difference stays
        # clearly positive however busy the host's other workers keep it
        time.sleep(0.002)
        seen.append(qb.clone())
        return (qb @ xs.T).topk(3, dim=1).indices

    xs = torch.randn(500, 128)
    qps, diag = roofline.timed_scan_qps(fn, batch=16, d=100, dim_pad=128,
                                        rounds=8, operands=(xs,))
    assert qps > 0 and diag["rounds"] == 8
    assert len(diag["per_batch_ms_samples"]) == 3
    # warm-up 4, then 3 x (4 + 8) calls; each batch unit rows, padded
    assert len(seen) == 4 + 3 * 12
    last = seen[-8:]
    assert all(torch.allclose(q[:, :100].norm(dim=1), torch.ones(16),
                              atol=1e-5) and not q[:, 100:].any()
               for q in last)
    assert not torch.equal(seen[-1], seen[-9])
