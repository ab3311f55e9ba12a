"""The l2 exact rung's score step, ``ops/distance.py:l2_scores``: the
single shot's ``[B, N]`` f32 scores ``2 q.x - |x|^2`` (-inf past
``n_valid``), from ``csrc/l2_scores.cu`` on the card and its plain
version on the CPU.

On the CPU: the plain version is the expression ``topk_resident`` used
before the kernel, and on integer rows (SIFT's byte descriptors) each
score is the float64 value rounded once to f32; the shape gate and the
launches a batch splits into; ``topk_resident`` running the plain version
on CPU tensors.  The reference's own l2 coarse scores are held to the
plain version in ``tests/test_torch_l2.py``, which imports JAX.  On the
card (``cuda``): the kernel bit for bit against the plain version on
integer rows at SIFT1M's 1,000,448 padded rows, within a stated
tolerance on normal bf16 rows, its launch counters, and ``topk_resident``
answering as on the CPU.  The module imports no JAX, so its ``cuda``
tests run on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_l2_scores.py``.
"""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helix_tpu_torch import tracing
from helix_tpu_torch.ops import distance as D
from helix_tpu_torch.ops import topk

CPU = torch.device("cpu")
SIFT_ROWS = 1_000_448     # SIFT1M's 1,000,000 rows padded to ROW_PAD


def sift_like(n: int, d: int, seed: int, device=CPU) -> torch.Tensor:
    """Integer rows in [0, 255] (SIFT's byte descriptors), as f32."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (n, d), generator=g, device=device,
                         dtype=torch.int32).float()


def sq_norms_of(xs: torch.Tensor, n_valid: int) -> torch.Tensor:
    sq = (xs.double() ** 2).sum(1).float()
    sq[n_valid:] = 0.0   # PackedMatrix's rows past n are zero
    return sq


def todays_expression(xs16, qs16, sq, n_valid):
    """The l2 single shot's score step as ``topk_resident`` wrote it
    before ``l2_scores``."""
    n = xs16.shape[0]
    cols = torch.arange(n, device=xs16.device)
    sims = D._coarse_dot(qs16, xs16)
    sims = 2.0 * sims - sq[None, :]
    return torch.where((cols < n_valid)[None, :], sims, float("-inf"))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# ------------------------------------------------------------------- CPU


@pytest.mark.parametrize("b", [8, 16, 128, 256, 512])
def test_plain_version_is_todays_expression_and_exact_on_integer_rows(b):
    """Ragged ``n_valid``: bit for bit the old expression, and every live
    score is the float64 ``2 q.x - |x|^2`` rounded once (the sums of
    integer products stay below 2^24, so they are exact)."""
    n, d = 4096, 128
    n_valid = n - 333
    xs = sift_like(n, d, seed=b)
    qs = sift_like(b, d, seed=b + 1)
    sq = sq_norms_of(xs, n_valid)
    xs16, qs16 = xs.to(torch.bfloat16), qs.to(torch.bfloat16)
    got = D.l2_scores(xs16, qs16, sq, n_valid)
    assert got.shape == (b, n) and got.dtype == torch.float32
    assert same_bits(got, todays_expression(xs16, qs16, sq, n_valid))
    exact = 2.0 * qs.double() @ xs.double().T - sq.double()[None, :]
    assert same_bits(got[:, :n_valid], exact[:, :n_valid].float())
    assert bool((got[:, n_valid:] == float("-inf")).all())


@pytest.mark.parametrize("n, d, refusal", [
    (SIFT_ROWS, 128, None),
    (64, 64, None),
    ((1 << 31) - 64, 1536, None),
    (1_000_100, 128, "N=1000100 is not a positive multiple of 64"),
    (0, 128, "N=0"),
    (1 << 31, 128, "below 2^31"),
    (4096, 96, "D=96 is not a positive multiple of 64"),
    (4096, 0, "D=0"),
])
def test_shape_gate(n, d, refusal):
    got = D.l2_kernel_refusal(n, d)
    if refusal is None:
        assert got is None
    else:
        assert got is not None and refusal in got


@pytest.mark.parametrize("b, blocks", [
    (1, [(0, 1, 128)]),
    (8, [(0, 8, 128)]),
    (128, [(0, 128, 128)]),
    (129, [(0, 129, 256)]),
    (256, [(0, 256, 256)]),
    (257, [(0, 256, 256), (256, 1, 128)]),
    (512, [(0, 256, 256), (256, 256, 256)]),
    (1024, [(s, 256, 256) for s in range(0, 1024, 256)]),
])
def test_query_blocks_split_above_256(b, blocks):
    assert D.l2_query_blocks(b) == blocks


def test_refused_shapes_raise_on_the_cpu_too():
    xs = torch.zeros((1000, 128), dtype=torch.bfloat16)
    qs = torch.zeros((8, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        D.l2_scores(xs, qs, torch.zeros(1000), 1000)
    with pytest.raises(ValueError, match="shapes"):
        D.l2_scores(xs[:960], qs, torch.zeros(1000), 960)
    with pytest.raises(ValueError, match="at least one query"):
        D.l2_scores(xs[:960], qs[:0], torch.zeros(960), 960)


@pytest.mark.parametrize("metric, calls", [("l2", 1), ("cosine", 0)])
def test_topk_resident_on_cpu_tensors_runs_the_plain_version(monkeypatch,
                                                             metric, calls):
    """The l2 single shot goes through ``l2_scores``, which on CPU tensors
    runs the plain version and launches nothing; the cosine path never
    reaches it.  Under a profiler nothing is counted."""
    n, d, b = 8192, 128, 16
    seen = []
    plain = D.l2_scores_reference

    def spy(xs16, qs16, sq, n_valid):
        seen.append((tuple(xs16.shape), tuple(qs16.shape), n_valid))
        return plain(xs16, qs16, sq, n_valid)

    monkeypatch.setattr(D, "l2_scores_reference", spy)
    xs = sift_like(n, d, seed=5)
    qs = sift_like(b, d, seed=6)
    n_valid = n - 100
    sq = sq_norms_of(xs, n_valid)
    launches = (D.l2_scores.launches, D.l2_scores.captured)
    before = tracing.snapshot().counts.get("kernel.l2_scores", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        dists, ids = D.topk_resident(xs.to(torch.bfloat16), xs, qs, n_valid,
                                     sq, k=10, metric=metric)
    assert seen == [((n, d), (b, d), n_valid)] * calls
    assert (D.l2_scores.launches, D.l2_scores.captured) == launches
    assert tracing.snapshot().counts.get("kernel.l2_scores", 0) == before
    assert ids.shape == (b, 10) and int(ids.max()) < n_valid
    if metric == "l2":
        exact = ((qs.double()[:, None, :] - xs.double()[None, :n_valid]) ** 2
                 ).sum(-1)
        want = torch.sort(exact, dim=1).values[:, :10]
        assert torch.equal(exact.gather(1, ids), want)
        assert bool(((dists.double() - want).abs() <= 1e-6 * want).all())


# ------------------------------------------------------------------ card


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/l2_scores.cu runs only on "
                    "the card")
    D.require_fp32_matmul()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("b", [8, 128, 200, 256, 512])
def test_kernel_bit_for_bit_on_integer_rows(d, b):
    """SIFT-range integers at 1,000,448 rows, a masked tail: every sum is
    exact in f32 whatever its order (below 2^24 at D=256 too), so the
    kernel's scores are the plain version's bits, in every written row
    and only there."""
    dev = card()
    n_valid = SIFT_ROWS - 448 - 77
    xs = sift_like(SIFT_ROWS, d, seed=d, device=dev)
    qs = sift_like(b, d, seed=d + b, device=dev)
    sq = sq_norms_of(xs, n_valid)
    xs16, qs16 = xs.to(torch.bfloat16), qs.to(torch.bfloat16)
    del xs
    got = D.l2_scores(xs16, qs16, sq, n_valid)
    want = D.l2_scores_reference(xs16, qs16, sq, n_valid)
    torch.cuda.synchronize(dev)
    assert got.shape == want.shape == (b, SIFT_ROWS)
    assert same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [16, 256])
def test_kernel_bit_for_bit_with_queries_streamed_at_d1536(b):
    """At D=1536 the queries do not fit in shared memory beside the
    staging buffers, so each ring stage carries its K-chunk of them.
    Small integers keep every sum exact in f32 (below 2^24 in
    magnitude), so the scores are the plain version's bits."""
    dev = card()
    n, d = 65_536, 1536
    n_valid = n - 100
    g = torch.Generator(device=dev).manual_seed(1536 + b)
    xs = torch.randint(-3, 4, (n, d), generator=g, device=dev).float()
    qs = torch.randint(-3, 4, (b, d), generator=g, device=dev).float()
    sq = sq_norms_of(xs, n_valid)
    xs16, qs16 = xs.to(torch.bfloat16), qs.to(torch.bfloat16)
    got = D.l2_scores(xs16, qs16, sq, n_valid)
    want = D.l2_scores_reference(xs16, qs16, sq, n_valid)
    assert same_bits(got, want)


@pytest.mark.cuda
def test_kernel_on_normal_rows_within_the_f32_bound():
    """Normal bf16 rows: the kernel and the plain version sum the same
    exact products in other orders, so each ``s`` is within D · eps ·
    sum |x||q| of the other (each within half that of the exact sum),
    ``2 s`` twice that, and the last rounding adds eps · |score|.  The
    top 10 ids agree for every query whose 10th and 11th scores (the
    plain version's) are further apart than their two bounds, at least
    nine in ten of them on this seed."""
    dev = card()
    n, d, b, k = 262_144, 128, 256, 10
    g = torch.Generator(device=dev).manual_seed(2**31 + 21)
    xs16 = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
    qs16 = torch.randn((b, d), generator=g, device=dev).to(torch.bfloat16)
    n_valid = n - 1000
    sq = sq_norms_of(xs16.float(), n_valid)
    got = D.l2_scores(xs16, qs16, sq, n_valid)
    want = D.l2_scores_reference(xs16, qs16, sq, n_valid)
    eps = torch.finfo(torch.float32).eps
    mass = qs16.float().abs() @ xs16.float().abs().T
    bound = 2.0 * d * eps * mass + eps * want.abs()
    live = slice(0, n_valid)
    assert bool((got[:, live] - want[:, live]).abs().le(bound[:, live]).all())
    assert bool((got[:, n_valid:] == float("-inf")).all())
    top, pos = torch.topk(want, k + 1, dim=1)
    gap = top[:, k - 1] - top[:, k]
    apart = gap > bound.gather(1, pos[:, k - 1:k + 1]).sum(1)
    assert int(apart.sum()) >= 0.9 * b, "the seed ties near rank k too often"
    got_ids = topk.select_topk(got, k)[1].sort(dim=1).values
    want_ids = pos[:, :k].sort(dim=1).values
    assert torch.equal(got_ids[apart], want_ids[apart])


@pytest.mark.cuda
def test_launch_counters_equal_the_calls():
    """One launch per 256 queries: ``launches`` counts each, and under a
    profiler so does the tracer's ``kernel.l2_scores``; without one the
    tracer counts nothing."""
    dev = card()
    n, d = 8192, 128
    xs16 = torch.zeros((n, d), dtype=torch.bfloat16, device=dev)
    sq = torch.zeros(n, device=dev)

    def calls(b):
        D.l2_scores(xs16, torch.zeros((b, d), dtype=torch.bfloat16,
                                      device=dev), sq, n)

    def traced():
        return tracing.snapshot().counts.get("kernel.l2_scores", 0)

    launches, before = D.l2_scores.launches, traced()
    calls(256)
    assert (D.l2_scores.launches - launches, traced() - before) == (1, 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        calls(16)
        calls(512)
        torch.cuda.synchronize(dev)
    assert D.l2_scores.launches - launches == 4
    assert traced() - before == 3


@pytest.mark.cuda
@pytest.mark.parametrize("b", [16, 256])
def test_topk_resident_l2_on_the_card_answers_as_on_the_cpu(b):
    """Integer rows keep every score exact, so the card's ids and
    distances equal the CPU's; the card's coarse phase launched the
    kernel once."""
    dev = card()
    n, d, k = 65_536, 128, 10
    n_valid = n - 300
    xs = sift_like(n, d, seed=31 + b)
    qs = sift_like(b, d, seed=32 + b)
    sq = sq_norms_of(xs, n_valid)
    answers = []
    launches = D.l2_scores.launches
    for device in (dev, CPU):
        x, q, s = xs.to(device), qs.to(device), sq.to(device)
        dists, ids = D.topk_resident(x.to(torch.bfloat16), x, q, n_valid, s,
                                     k=k, metric="l2")
        answers.append((dists.cpu(), ids.cpu()))
    assert D.l2_scores.launches - launches == 1
    assert torch.equal(answers[0][1], answers[1][1])
    assert torch.equal(answers[0][0], answers[1][0])
