"""The port's fused bucket-scores path against the JAX reference.

``bucket_scores_reference`` (plain PyTorch, what the wrapper runs on a
CPU tensor) is held against the Pallas kernel ``_bucket_scores`` in
interpret mode, and the port's ``fused_topk`` against the JAX
``fused_topk`` on the same resident matrix.

Tolerances: both sides take f32 sums of exact bf16 products, in
different orders, so sums differ by a rounding or two (~1e-7).  The pack
truncates the low 6 mantissa bits, so such a difference can land a value
across a truncation step: unpacked winners agree within 1e-6 plus one
packing quantum (64 ulp of the value).  Index bits agree except in a
bucket whose top two scores lie within that same window.
"""

import numpy as np
import pytest
import torch

import helix_tpu.ops.fused_topk as JF
from helix_tpu.ops.distance import PackedMatrix as RefMatrix
from helix_tpu_torch.convert import packed_matrix_from_reference
from helix_tpu_torch.ops import fused_topk as TF

torch.set_num_threads(2)

TOL = 1e-6


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    original = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return original(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    for fn in (JF._bucket_scores, JF.fused_topk):
        fn.clear_cache()
    yield
    for fn in (JF._bucket_scores, JF.fused_topk):
        fn.clear_cache()


def make_data(n, d, b, seed):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    queries = rng.normal(size=(b, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return data, queries


def jax_bucket_scores(xs, qs, n_valid):
    import jax.numpy as jnp

    return np.asarray(JF._bucket_scores(
        jnp.asarray(xs, jnp.bfloat16), jnp.asarray(qs, jnp.bfloat16),
        jnp.int32(n_valid),
    ))


def port_bucket_scores(xs, qs, n_valid):
    return TF.bucket_scores(
        torch.from_numpy(xs).to(torch.bfloat16),
        torch.from_numpy(qs).to(torch.bfloat16), n_valid,
    ).numpy()


def quantum(v):
    """64 ulp of |v|: the step the pack truncates to."""
    exp = np.abs(v).view(np.int32) & 0x7F800000
    return exp.view(np.float32) * np.float32(2.0 ** -17)


def masked_scores(xs, qs, n_valid):
    """f32 scores of the bf16-rounded operands, padding rows masked."""
    x16 = torch.from_numpy(xs).to(torch.bfloat16).float().numpy()
    q16 = torch.from_numpy(qs).to(torch.bfloat16).float().numpy()
    sims = x16.astype(np.float64) @ q16.astype(np.float64).T
    sims[n_valid:] = JF.NEG_SENTINEL
    return sims


def assert_packed_close(got, want, sims, tol):
    gb, wb = got.view(np.int32), want.view(np.int32)
    g_val = (gb & ~63).view(np.float32)
    w_val = (wb & ~63).view(np.float32)
    window = tol + quantum(w_val)
    assert np.all(np.abs(g_val - w_val) <= window)
    mismatch = (gb & 63) != (wb & 63)
    if mismatch.any():
        top2 = -np.sort(-sims.reshape(-1, 64, sims.shape[1]), axis=1)[:, :2]
        gap = top2[:, 0] - top2[:, 1]
        assert np.all(gap[mismatch] <= window[mismatch]), \
            "index bits differ in a bucket without a near tie"


@pytest.mark.parametrize("n,n_valid,seed", [
    (8192, 8192 - 100, 0),
    (16384, 16384 - 4000, 1),
])
def test_bucket_scores_reference_matches_pallas(n, n_valid, seed):
    xs, qs = make_data(n, 128, 128, seed)
    want = jax_bucket_scores(xs, qs, n_valid)
    got = port_bucket_scores(xs, qs, n_valid)
    assert got.shape == want.shape == (n // 64, 128)
    assert got.dtype == np.float32
    assert_packed_close(got, want, masked_scores(xs, qs, n_valid), TOL)
    # padding buckets carry the sentinel on both sides
    assert np.all(got[n_valid // 64 + 1:] < JF.NEG_SENTINEL / 2)


def test_bucket_scores_flushes_denormal_winners_like_the_reference():
    """A zeroed (tombstoned) row scores exactly 0, which packs to a
    denormal.  The reference flushes it: the bucket reports a zero with
    index bits 0, not the zero row's index."""
    xs, qs = make_data(8192, 128, 128, seed=3)
    zero_row = 5
    xs[:64] = -qs[0] * np.linspace(0.5, 1.0, 64, dtype=np.float32)[:, None]
    xs[zero_row] = 0.0
    want = jax_bucket_scores(xs, qs, 8192)
    got = port_bucket_scores(xs, qs, 8192)
    assert want[0, 0].view(np.int32) == 0
    assert got[0, 0].view(np.int32) == want[0, 0].view(np.int32)
    assert_packed_close(got, want, masked_scores(xs, qs, 8192), TOL)


def test_bucket_scores_counts_only_kernel_launches():
    xs, qs = make_data(8192, 128, 128, seed=4)
    before = TF.bucket_scores.launches
    port_bucket_scores(xs, qs, 8192)
    assert TF.bucket_scores.launches == before  # CPU: the plain version


def test_bucket_scores_refuses_other_devices():
    xs = torch.empty((8192, 128), dtype=torch.bfloat16, device="meta")
    qs = torch.empty((128, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TF.bucket_scores(xs, qs, 8192)


def resident(data, n_valid):
    """The same resident state for both packages: the reference's
    PackedMatrix, carried into the port by packed_matrix_from_reference,
    laid out as each package's fused path reads it."""
    import jax.numpy as jnp

    ref = RefMatrix(data.shape[1], "cosine")
    ref.extend(data)
    port = packed_matrix_from_reference(
        ref.data, ref.sq_norms, ref.n, ref.dim, ref.metric, device="cpu"
    )
    n_pad = JF.pad_rows_for_fused(ref.n)
    rows = np.zeros((n_pad, ref.dim_pad), np.float32)
    rows[: ref.n] = ref.data[: ref.n]
    jax_args = (
        jnp.asarray(rows, jnp.bfloat16), jnp.asarray(rows),
        jnp.int32(n_valid), jnp.asarray(ref.sq_norms[:n_pad]),
    )
    prows = np.zeros((n_pad, port.dim_pad), np.float32)
    prows[: port.n] = port.data[: port.n]
    port_args = (
        torch.from_numpy(prows).to(torch.bfloat16), torch.from_numpy(prows),
        n_valid, torch.zeros(n_pad),
    )
    return jax_args, port_args


def run_both(data, queries, n_valid, k):
    import jax.numpy as jnp

    jax_args, port_args = resident(data, n_valid)
    j16, j32, jn, jsq = jax_args
    jd, ji = JF.fused_topk(j16, j32, jnp.asarray(queries), jn, jsq, k=k)
    p16, p32, pn, psq = port_args
    pd, pi = TF.fused_topk(p16, p32, torch.from_numpy(queries), pn, psq, k=k)
    return (np.asarray(jd), np.asarray(ji)), (pd.numpy(), pi.numpy())


@pytest.mark.parametrize("n,n_valid,b,k,seed", [
    (8192, 8192, 4, 10, 0),
    (16384, 16000, 130, 10, 1),     # two query chunks of the padded block
    (8192, 8000, 8, 200, 2),        # k > buckets: overflow padding
])
def test_fused_topk_matches_reference(n, n_valid, b, k, seed):
    data, queries = make_data(n, 128, b, seed)
    (jd, ji), (pd, pi) = run_both(data, queries, n_valid, k)
    assert pi.shape == ji.shape == (b, k)
    np.testing.assert_array_equal(pi, ji)
    finite = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(pd), finite)
    assert np.all(np.abs(pd[finite] - jd[finite]) <= TOL)
    if k > n // 64:
        assert np.all(pi[:, n // 64:] == -1)
        assert np.all(np.isinf(pd[:, n // 64:]))


def test_fused_topk_masks_padding_rows():
    n_valid, b, k = JF.TILE - 100, 4, 5
    data, queries = make_data(JF.TILE, 128, b, seed=1)
    data[n_valid:] = queries[0]  # perfect matches in the padding region
    (_, ji), (_, pi) = run_both(data, queries, n_valid, k)
    assert np.all(pi < n_valid)
    np.testing.assert_array_equal(pi, ji)


def test_packed_index_bits_recover_row_ids():
    data, queries = make_data(JF.TILE, 128, 4, seed=2)
    target = 5431
    data[target] = queries[0]
    (_, ji), (pd, pi) = run_both(data, queries, JF.TILE, 1)
    assert int(pi[0, 0]) == target == int(ji[0, 0])
    assert float(pd[0, 0]) < 1e-2


def test_supports_fused_gates():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    n = 8 * TF.TILE
    assert TF.supports_fused(n, 128, "cosine", cuda)
    assert TF.supports_fused(n, 128, "cosine", cuda, k=n // TF.BUCKET)
    assert not TF.supports_fused(n, 128, "cosine", cuda, k=n // TF.BUCKET + 1)
    # the Hopper kernel stages D through shared memory: no width cap
    assert TF.supports_fused(n, 8192, "cosine", cuda)
    assert not TF.supports_fused(n, 192, "cosine", cuda)
    assert not TF.supports_fused(n, 128, "cosine", cpu)
    assert not TF.supports_fused(n, 128, "l2", cuda)
    assert not TF.supports_fused(n + 64, 128, "cosine", cuda)
    assert not TF.supports_fused(TF.TILE // 2, 128, "cosine", cuda)
    assert TF.pad_rows_for_fused(1) == TF.TILE
    assert TF.pad_rows_for_fused(TF.TILE + 1) == 2 * TF.TILE


def test_constants_keep_the_reference_values():
    assert (TF.TILE, TF.BUCKET, TF.NEG_SENTINEL, TF.MIN_QUERY_BLOCK) == (
        JF.TILE, JF.BUCKET, JF.NEG_SENTINEL, JF.MIN_QUERY_BLOCK
    )


@pytest.mark.parametrize("n,d,b", [
    (8192, 128, 64),        # B below the kernel's 128-query tile
    (8192, 128, 192),       # B between the two tiles
    (8192, 128, 384),       # B past the 256 the kernel keeps in registers
    (8192, 96, 128),        # D not a whole 64-column chunk
    (8192, 0, 128),
    (8192 + 32, 128, 128),  # a part bucket
    (0, 128, 128),
])
def test_bucket_scores_refuses_shapes_the_kernel_does_not_take(n, d, b):
    """The wrapper holds CPU tensors to the kernel's shapes too, and the
    serving gate never admits a matrix the kernel would refuse."""
    xs = torch.zeros((n, d), dtype=torch.bfloat16)
    qs = torch.zeros((b, d), dtype=torch.bfloat16)
    assert TF.bucket_kernel_refusal(n, d, b) is not None
    with pytest.raises(ValueError, match="bucket_scores"):
        TF.bucket_scores(xs, qs, n)
    cuda = torch.device("cuda")
    if b in TF.BUCKET_KERNEL_QUERIES:
        assert not TF.supports_fused(n, d, "cosine", cuda)


def test_supports_fused_admits_only_shapes_the_kernel_takes():
    cuda = torch.device("cuda")
    for n in (TF.TILE, 3 * TF.TILE, 1 << 31):
        for d in range(64, 2049, 64):
            gate = TF.supports_fused(n, d, "cosine", cuda)
            takes = all(TF.bucket_kernel_refusal(n, d, b) is None
                        for b in TF.BUCKET_KERNEL_QUERIES)
            assert not gate or takes, (n, d)
            assert gate == (takes and d % 128 == 0), (n, d)
    # both query blocks fused_topk pads to, at widths either side of the
    # ones whose queries fit in shared memory, run (here: the plain version)
    xs, qs = make_data(128, 1024, 256, seed=6)
    for b in TF.BUCKET_KERNEL_QUERIES:
        got = port_bucket_scores(xs, qs[:b], 100)
        assert got.shape == (2, b)


# (rows, width, queries, rows live): the main path's D=128 at both query
# blocks, a width whose queries fit in shared memory (D=256), two whose
# queries stream through the ring (D=768 at B=256, D=1280 at B=128), and
# row counts whose bucket count is no multiple of the card's 132 SMs.
CARD_SHAPES = [
    (3 * 8192, 256, 256, 3 * 8192 - 77),
    (3 * 8192, 128, 256, 3 * 8192 - 4000),
    (2 * 8192, 128, 128, 2 * 8192 - 33),
    (8192, 768, 256, 8192 - 100),
    (8192, 1280, 128, 5000),
]


@pytest.mark.cuda
def test_bucket_scores_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda")
    for seed, (n, d, b, n_valid) in enumerate(CARD_SHAPES):
        xs, qs = make_data(n, d, b, seed=5 + seed)
        x16 = torch.from_numpy(xs).to(dev, torch.bfloat16)
        q16 = torch.from_numpy(qs).to(dev, torch.bfloat16)
        before = TF.bucket_scores.launches
        got = TF.bucket_scores(x16, q16, n_valid).cpu().numpy()
        assert TF.bucket_scores.launches == before + 1
        want = TF.bucket_scores_reference(x16, q16, n_valid).cpu().numpy()
        assert_packed_close(got, want, masked_scores(xs, qs, n_valid), 1e-5)
        # the bucket that holds n_valid is part live, part padding
        live = n_valid % 64
        assert live == 0 or got[n_valid // 64].min() > JF.NEG_SENTINEL / 2
    with pytest.raises(ValueError):
        TF.bucket_scores(x16, q16[:100], n_valid)
