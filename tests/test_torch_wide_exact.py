"""The exact rung at an embedding model's width: D=1536 and k=100, the
``openai5m-cos`` configuration of ``BENCHMARK.json`` (VectorDBBench's
OpenAI 5M case, ``text-embedding-ada-002``, HelixDB's default model).

On the CPU: ``Partition.search_many_async`` / ``finalize`` on the host
path and on ``topk_resident`` against the harness's plain float64
reference (:mod:`hxbench.reference`); the fused step's core
(``fused_candidates``) with kernel 1's plain version at B=256, where it
re-ranks 512 bucket winners; the bytes kernel 1 stages under either of
its plans.  On the card (``cuda``): kernel 1 bit for bit against its
plain version at D=384 to 3072 under either plan, the streamed plan's
ring at D=1536, and its staged-bytes counters in a profiled launch.
The module imports no JAX, so its ``cuda`` tests run on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_wide_exact.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helix_tpu_torch import tracing
from helix_tpu_torch.ops import distance
from helix_tpu_torch.ops import fused_topk as TF
from hxbench import check, reference, spec, system
from hxbench.data import Corpus

D, K = 1536, 100
CPU = torch.device("cpu")
SEED = 2**31 + 20


def openai_config() -> dict:
    return spec.config(spec.load_benchmark(), "openai5m-cos")


def unit(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_the_configuration_is_the_wide_one():
    cfg = openai_config()
    assert (cfg["dim"], cfg["k"], cfg["metric"]) == (D, K, "cosine")


@pytest.mark.parametrize("n, resident", [(4_000, False), (20_000, True)])
def test_partition_answers_k100_at_d1536_as_the_reference(monkeypatch, n,
                                                          resident):
    """Below 4,096 rows the host path, above it ``topk_resident``: every
    id the reference's top 100 holds, up to ties, each distance within
    the configuration's 1e-5."""
    calls = []
    real = distance.topk_resident

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(distance, "topk_resident", counted)
    cfg = openai_config()
    corpus = Corpus(cfg["generator"], D, SEED + n, CPU)
    rows = corpus.rows(n)
    queries = corpus.queries(64)
    _, part = system.build(cfg, rows, CPU)
    ids, dists = part.search_many_async(queries, K)()
    assert bool(calls) == resident
    assert np.asarray(ids).shape == (64, K)
    found = check.numbers(ids, dists, queries, rows, cfg, CPU)
    assert found["bad_answers"] == 0
    assert found["recall_miss"] == 0.0
    assert found["dist_err"] <= cfg["guarantees"]["distance"]["limit"]


def test_fused_candidates_k100_at_d1536_b256_against_the_reference(
        monkeypatch):
    """Kernel 1's plain version, 512 candidates of 640 buckets, and the
    f32 re-rank: the answer is the exact top 100 of the bucket winners,
    so every id of the reference's top 100 it leaves out lost its bucket
    to another row (two near rows in one 64-row bucket), and every
    distance is within 1e-5 of the float64 one."""
    n, b = 40_000, 256
    cfg = openai_config()
    corpus = Corpus(cfg["generator"], D, SEED, CPU)
    rows = corpus.rows(n)
    queries = corpus.queries(b)
    n_pad = TF.pad_rows_for_fused(n)
    x = np.zeros((n_pad, D), np.float32)
    x[:n] = unit(rows)
    xs32 = torch.from_numpy(x)
    xs16 = xs32.to(torch.bfloat16)
    q = torch.from_numpy(unit(queries).astype(np.float32))
    asked = []
    real_top_k = TF._top_k

    def top_k(values, k):
        asked.append(k)
        return real_top_k(values, k)

    monkeypatch.setattr(TF, "_top_k", top_k)
    scores, ids, filled = TF.fused_candidates(
        xs16, xs32, q, n, k=K, winners=TF.bucket_scores_reference)
    assert asked == [512, K]
    ids = ids.numpy()
    assert ids.shape == (b, K) and bool(filled.all())
    assert ((ids >= 0) & (ids < n)).all()
    assert all(len(set(r)) == K for r in ids)

    exact = reference.distances_of(rows, queries, ids, "cosine")
    assert np.abs((1.0 - scores.double().numpy()) - exact).max() <= 1e-5

    packed = TF.bucket_scores_reference(xs16, q.to(torch.bfloat16), n)
    bits = packed.T.contiguous().view(torch.int32).numpy()    # [b, buckets]
    winners = np.arange(bits.shape[1]) * TF.BUCKET + (bits & (TF.BUCKET - 1))
    winners = winners[:, :n // TF.BUCKET]      # the buckets of live rows
    sims = unit(queries.astype(np.float64)) @ unit(
        rows.astype(np.float64)).T                              # [b, n]
    _, ref_pos = reference.exact_topk(rows, queries, K, "cosine", CPU)
    for j in range(b):
        on_winners = np.sort(sims[j, winners[j]])[::-1]
        kth = on_winners[K - 1]
        assert sims[j, ids[j]].min() >= kth - 1e-6
        lost = np.setdiff1d(ref_pos[j], ids[j])
        not_winner = ~np.isin(lost, winners[j])
        assert (not_winner | (sims[j, lost] <= kth + 1e-6)).all()


@pytest.mark.parametrize("n, d, b, resident, blocks, want", [
    # deep10m-cos: 9,990,000 rows padded to 8,192, D 96 padded to 128
    (9_994_240, 128, 256, True, 132, 2 * 128 * (9_994_240 + 132 * 256)),
    # openai5m-cos: each 256-row cluster tile reads its 256 queries once
    (4_005_888, 1536, 256, False, 132, 2 * 2 * 1536 * 4_005_888),
    (8_192, 1536, 128, False, 132, 3 * 1536 * 8_192),
    # 129 buckets: the last cluster tile holds one, and reads the queries
    (8_256, 1536, 256, False, 132, 2 * 1536 * (8_256 + 33 * 256)),
    # fewer buckets than SMs: one block per bucket
    (640, 128, 128, True, 132, 2 * 128 * (640 + 10 * 128)),
])
def test_staged_bytes_of_either_plan(n, d, b, resident, blocks, want):
    assert TF.staged_bytes(n, d, b, resident, blocks) == want


def test_a_plain_version_launch_counts_no_plan():
    """On CPU tensors nothing launches, so nothing is counted, even under
    a profiler; ``tracing.recording`` follows the profiler."""
    xs = torch.zeros((TF.TILE, 128), dtype=torch.bfloat16)
    qs = torch.zeros((128, 128), dtype=torch.bfloat16)
    assert not tracing.recording()
    before = tracing.snapshot().counts
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.recording()
        TF.bucket_scores(xs, qs, TF.TILE)
    assert not tracing.recording()
    after = tracing.snapshot().counts
    assert {k: v for k, v in after.items()
            if k.startswith("kernel.bucket_scores.")} == \
        {k: v for k, v in before.items()
         if k.startswith("kernel.bucket_scores.")}


# ------------------------------------------------------------------ card


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel 1 runs only on the card")
    return torch.device("cuda")


# (d, b, n, n_valid): every streamed pair of D and B at two tiles of rows
# less 77, and D=384 at B=128, which the plan keeps resident; then at
# D=1536 an odd bucket count (33: the last cluster tile holds one bucket,
# and a block of it none), rows below one cluster tile, n_valid inside
# the last tile and n_valid = 0.
WIDE_CASES = [
    *[(d, b, 2 * TF.TILE, 2 * TF.TILE - 77)
      for d in (384, 1024, 1536, 3072) for b in (128, 256)],
    (1536, 256, 64 * 33, 64 * 33 - 5),
    (1536, 128, 64 * 33, 64 * 32 + 7),
    (1536, 256, 64 * 33, 0),
    (1536, 256, 64, 64),
    (1536, 128, 192, 100),
    (3072, 256, 64 * 5, 64 * 4 + 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d, b, n, n_valid", WIDE_CASES)
def test_kernel_bit_for_bit_at_d384_to_d3072(d, b, n, n_valid):
    """Small integers in bf16: every partial sum is exact in f32 whatever
    the order, so the kernel's packed winners equal the plain version's
    bits.  The queries stream but at D=384, B=128, where they fit in
    shared memory beside the rings."""
    dev = card()
    assert TF.bucket_plan(d, b)[0] is (d == 384 and b == 128)
    rng = np.random.default_rng(d * b + n + n_valid)
    xs = torch.from_numpy(rng.integers(-3, 4, (n, d)).astype(np.float32))
    qs = torch.from_numpy(rng.integers(-3, 4, (b, d)).astype(np.float32))
    x16 = xs.to(dev, torch.bfloat16)
    q16 = qs.to(dev, torch.bfloat16)
    got = TF.bucket_scores(x16, q16, n_valid)
    want = TF.bucket_scores_reference(x16, q16, n_valid)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_the_openai_shape_streams_through_a_ring_of_four():
    """At D=1536, B=256 the queries stream, and the shared ring holds at
    least 4 stages of 128 rows and a 256-query K-chunk (48 KB)."""
    card()
    resident, depth, stage_bytes, smem = TF.bucket_plan(D, 256)
    assert resident is False
    assert depth >= 4
    assert stage_bytes == 128 * 128 + 256 * 128
    assert depth * stage_bytes < smem <= 232_448


@pytest.mark.cuda
def test_plan_counters_in_a_profiled_launch():
    """Under a profiler each launch counts the bytes it stages and its
    rows' bytes, by its plan: streamed at D=1536, resident at D=128.
    Without one nothing is counted, and no counter names the plan (the
    staged bytes tell the two apart)."""
    dev = card()
    n, b = TF.TILE, 256
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    names = ("staged_bytes", "row_bytes")

    def counts():
        got = tracing.snapshot().counts
        return {k: got.get(f"kernel.bucket_scores.{k}", 0) for k in names}

    def launch(d):
        TF.bucket_scores(torch.zeros((n, d), dtype=torch.bfloat16, device=dev),
                         torch.zeros((b, d), dtype=torch.bfloat16, device=dev),
                         n)

    assert TF.bucket_plan(128, b)[0] is True
    before = counts()
    launch(D)
    assert counts() == before
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        launch(D)
        launch(128)
        torch.cuda.synchronize(dev)
    after = counts()
    assert after["staged_bytes"] - before["staged_bytes"] == \
        TF.staged_bytes(n, D, b, False, sms) + \
        TF.staged_bytes(n, 128, b, True, sms)
    assert after["row_bytes"] - before["row_bytes"] == 2 * n * (D + 128)
    # the streamed launch reads the queries once per 256 rows
    assert TF.staged_bytes(n, D, b, False, sms) == 2 * n * D * (1 + b / 256)
    plans = {"kernel.bucket_scores.resident", "kernel.bucket_scores.streamed"}
    assert not plans & set(tracing.snapshot().counts)
