"""The port's row-wise selection (``helix_tpu_torch/ops/topk.py``) against
the reference's two selections on the CPU.

``distance._top_k`` is ``jax.lax.top_k``'s counterpart (its total order:
+NaN, +inf, ..., +0.0, -0.0, ..., -inf, -NaN, ties to the lower
position) and ``jax.lax.approx_max_k``'s, which on the CPU is exact
and, for f32 rows and ``1 < k < width``, is XLA's TopK call in that same
order.  It is held to both JAX ops
themselves on tie-heavy rows made with numpy from a seed, ids and value
bits exactly, on contiguous and strided views.  Where XLA's
``approx_max_k`` has no tie rule (an unstable sort at ``k == width`` and
for bf16, the last maximum at ``k == 1``) the values are held equal and
the difference is pinned.  The kernel (``csrc/select_topk.cu``) runs
only on the card: its test is marked ``cuda`` and holds it to the plain
version bit for bit, below and past its one-block k, as
``chip_smoke.py``'s ``select`` phase does at the main path's shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helix_tpu_torch.ops import topk as T
from helix_tpu_torch.ops.distance import _top_k

torch.set_num_threads(2)

NEG_SENTINEL = -3.0e38   # the fused paths' masked-row value
NEG_NAN = 0xFFC00000     # a NaN with the sign bit set

SHAPES = [(1, 1, 1, 0), (3, 17, 5, 1), (8, 64, 64, 2), (256, 512, 16, 3),
          (2, 4096, 512, 4), (2, 20000, 2048, 5), (2, 20000, 5000, 6)]


def tie_heavy(rows: int, width: int, seed: int, nan: bool) -> np.ndarray:
    """Few distinct values (ties everywhere) with +0.0 and -0.0, +-inf and
    the sentinel sprinkled in, and +-NaN where ``nan``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 4, (rows, width)).astype(np.float32) * 0.25
    roll = rng.random((rows, width))
    x[roll < 0.05] = -np.inf
    x[(roll >= 0.05) & (roll < 0.10)] = NEG_SENTINEL
    x[(roll >= 0.10) & (roll < 0.16)] = -0.0
    x[(roll >= 0.16) & (roll < 0.18)] = np.inf
    if nan:
        x[(roll >= 0.18) & (roll < 0.19)] = np.nan
        x.view(np.uint32)[(roll >= 0.19) & (roll < 0.20)] = NEG_NAN
    return x


def views(x: np.ndarray):
    t = torch.from_numpy(x)
    return {"contiguous": t, "strided": t.T.contiguous().T}


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def same_bits(got: torch.Tensor, want) -> bool:
    """Equal value bits: ``want`` a torch tensor or a JAX array."""
    if isinstance(want, torch.Tensor):
        return torch.equal(bits(got), bits(want))
    wide = np.int16 if got.dtype == torch.bfloat16 else np.int32
    return np.array_equal(bits(got).numpy(), np.asarray(want).view(wide))


@pytest.mark.parametrize("rows,width,k,seed", SHAPES)
def test_top_k_equals_lax_top_k_with_signed_zeros_and_nans(rows, width, k,
                                                           seed):
    x = tie_heavy(rows, width, seed, nan=True)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    for name, view in views(x).items():
        got_v, got_i = _top_k(view, k)
        assert got_i.dtype == torch.int64, name
        assert np.array_equal(got_i.numpy(), np.asarray(want_i)), name
        assert same_bits(got_v, want_v), name


@pytest.mark.parametrize("rows,width,k,seed", SHAPES)
def test_approx_top_k_equals_approx_max_k(rows, width, k, seed):
    """At ``k == width`` (8 x 64 here) XLA sorts the whole row with an
    unstable sort, so the full-width case selects one fewer, where its
    TopK call decides, and :func:`test_approx_max_k_without_a_tie_rule`
    holds the full width."""
    if 1 < k == width:
        k -= 1
    x = tie_heavy(rows, width, seed + 100, nan=False)
    want_v, want_i = jax.lax.approx_max_k(jnp.asarray(x), k)
    for name, view in views(x).items():
        got_v, got_i = _top_k(view, k)
        assert np.array_equal(got_i.numpy(), np.asarray(want_i)), name
        assert same_bits(got_v, want_v), name


def test_approx_max_k_orders_signed_zeros_as_lax_top_k():
    """+0.0 above -0.0 where ``1 < k < width``: the order the port keeps
    for both selections."""
    x = np.array([[-0.0, 1.0, 0.0, -0.0, 0.0, -1.0]], np.float32)
    for k in (2, 3, 4, 5):
        want = np.asarray(jax.lax.approx_max_k(jnp.asarray(x), k)[1])
        assert want.tolist() == [[1, 2, 4, 0, 3][:k]]
        assert _top_k(torch.from_numpy(x), k)[1].tolist() == \
            want.tolist()


@pytest.mark.parametrize("rows,width,k,seed,dtype", [
    (8, 64, 64, 2, jnp.float32), (2, 300, 300, 6, jnp.float32),
    (3, 17, 5, 1, jnp.bfloat16), (256, 512, 16, 3, jnp.bfloat16),
    (2, 4096, 512, 4, jnp.bfloat16), (5, 200, 1, 7, jnp.float32)])
def test_approx_max_k_without_a_tie_rule(rows, width, k, seed, dtype):
    """XLA's ``approx_max_k`` has no tie rule at ``k == width`` and for
    bf16 rows (an unstable sort whose comparator holds +0.0 and -0.0
    equal) and takes the last maximum at ``k == 1``: the port's values
    equal its values as floats there, its ids name those values, and its
    order is ``lax.top_k``'s."""
    x = tie_heavy(rows, width, seed + 100, nan=False)
    want_v, _ = jax.lax.approx_max_k(jnp.asarray(x, dtype), k)
    xt = torch.from_numpy(x)
    if dtype == jnp.bfloat16:
        xt = xt.to(torch.bfloat16)
    got_v, got_i = _top_k(xt, k)
    assert np.array_equal(got_v.float().numpy(),
                          np.asarray(want_v).astype(np.float32))
    assert torch.equal(torch.gather(xt, 1, got_i).view(torch.int16
                       if xt.dtype == torch.bfloat16 else torch.int32),
                       bits(got_v))
    assert torch.equal(got_i, _top_k(xt, k)[1])


@pytest.mark.parametrize("rows,width,k,seed", SHAPES)
def test_bf16_rows_match_lax_top_k(rows, width, k, seed):
    x = tie_heavy(rows, width, seed + 200, nan=False)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x, jnp.bfloat16), k)
    for name, view in {"contiguous": xb, "strided": xb.T.contiguous().T
                       }.items():
        got_v, got_i = _top_k(view, k)
        assert got_v.dtype == torch.bfloat16, name
        assert np.array_equal(got_i.numpy(), np.asarray(want_i)), name
        assert same_bits(got_v, want_v), name


@pytest.mark.parametrize("rows,width,k,seed", SHAPES)
def test_int32_rows_match_lax_top_k(rows, width, k, seed):
    rng = np.random.default_rng(seed + 300)
    x = rng.integers(-3, 4, (rows, width)).astype(np.int32)
    x[rng.random((rows, width)) < 0.05] = np.iinfo(np.int32).min
    x[rng.random((rows, width)) < 0.05] = np.iinfo(np.int32).max
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    for name, view in views(x).items():
        got_v, got_i = _top_k(view, k)
        assert np.array_equal(got_i.numpy(), np.asarray(want_i)), name
        assert np.array_equal(got_v.numpy(), np.asarray(want_v)), name


def test_one_dimensional_and_batched_rows_keep_their_shape():
    x = tie_heavy(6, 40, 7, nan=True)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 9)
    got_v, got_i = _top_k(torch.from_numpy(x[2]), 9)
    assert got_i.shape == (9,)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i)[2])
    got_v, got_i = _top_k(torch.from_numpy(x.reshape(2, 3, 40)), 9)
    assert got_i.shape == (2, 3, 9)
    assert np.array_equal(got_i.numpy().reshape(6, 9), np.asarray(want_i))
    empty_v, empty_i = _top_k(torch.zeros(0), 0)
    assert empty_v.shape == empty_i.shape == (0,)
    # past the width the whole row comes back, as the sort's slice did
    got_v, got_i = _top_k(torch.from_numpy(x[2]), 100)
    assert np.array_equal(got_i.numpy(),
                          np.asarray(jax.lax.top_k(jnp.asarray(x[2]),
                                                   40)[1]))


def test_order_keys_follow_the_total_order():
    vals = [float("-inf"), -2.5, -1e-40, -0.0, 0.0, 1e-40, 2.5,
            float("inf")]
    nan, neg_nan = (torch.tensor([b], dtype=torch.int64).to(torch.int32)
                    .view(torch.float32) for b in (0x7FC00000, NEG_NAN))
    keys = T.order_keys(torch.cat([neg_nan, torch.tensor(vals), nan]))
    assert torch.all(keys[1:] > keys[:-1])  # -NaN last, -0.0 below +0.0
    assert keys[4] == -1 and keys[5] == 0   # -0.0 and +0.0


def test_bf16_keys_are_the_f32_keys_of_the_exact_upcast():
    x = torch.from_numpy(tie_heavy(4, 300, 8, nan=True))
    xb = x.to(torch.bfloat16)
    assert torch.equal(T.order_keys(xb), T.order_keys(xb.float()))
    # every bf16 bit pattern orders as its f32 value does
    every = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32) \
        .to(torch.int16).view(torch.bfloat16)
    keys = T.order_keys(every)
    assert keys.unique().numel() == every.numel()
    finite = ~torch.isnan(every.float())
    f = every.float()[finite]
    order = torch.argsort(keys[finite], stable=True)
    assert torch.all(f[order][1:] >= f[order][:-1])


def test_int32_keys_are_the_values():
    x = torch.tensor([[5, -7, 0, 2 ** 31 - 1, -2 ** 31]], dtype=torch.int32)
    assert T.order_keys(x) is x
    with pytest.raises(TypeError, match="f32, bf16 or int32"):
        T.order_keys(torch.zeros(3, dtype=torch.float16))


def test_gate():
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        assert T.supports_select(1, 1, dtype)
        assert T.supports_select(15744, 128, dtype)
        assert T.supports_select(1_000_448, T.BLOCK_K_MAX, dtype)
        assert T.supports_select((1 << 31) - 1, 977, dtype)
        assert T.supports_select(1 << 20, T.BLOCK_K_MAX + 1, dtype)
        assert T.supports_select(1 << 20, 65536, dtype)
        assert T.supports_select(156_288, 9_765, dtype)
        assert T.supports_select(3000, 3000, dtype)
        assert not T.supports_select(1 << 31, 977, dtype)
        assert not T.supports_select(100, 0, dtype)
        assert not T.supports_select(100, 101, dtype)
    for dtype in (torch.float16, torch.float64, torch.int64, torch.bool):
        assert not T.supports_select(1000, 10, dtype)


def test_scratch_holds_the_first_two_passes():
    # one pass (the fused tail's winners, the re-rank, the 10M int4 pool)
    # needs none
    assert T.scratch_bytes(256, 15744, 128) == 0
    assert T.scratch_bytes(256, 128, 16) == 0
    assert T.scratch_bytes(256, 156_288, 9_765) == 0
    # [256, 1,000,448] at k=128: 8 chunks of 131,072, 128 words of 8
    # bytes each a row, then one
    assert T.scratch_bytes(256, 1_000_448, 128) == 256 * 8 * (8 * 128)
    # 31 chunks of 32,768 at k=2048 -> 63,488, then one
    assert T.scratch_bytes(2, 1_000_448, 2048) == 2 * 8 * 63_488
    # past the block path's k: two regions of k packed pairs, 8 bytes per
    # chunk of SLICE columns, 256 bins and 4 ints of state, per row
    assert T.scratch_bytes(256, 156_288, T.BLOCK_K_MAX + 1) == 256 * (
        16 * (T.BLOCK_K_MAX + 1) + 8 * 10 + 4 * 260)
    assert T.scratch_bytes(1, 1_000_000, 65_536) == (16 * 65_536
                                                     + 8 * 62 + 4 * 260)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Off the CPU the wrapper launches the kernel or raises: the gate
    first, then the device (a meta tensor stands in for a card here).
    Past the width it takes the whole row, as the sort's slice does."""
    before = (T.select_topk.launches, T.select_topk.captured)
    meta = torch.empty((4, 3000), device="meta")
    with pytest.raises(ValueError, match="does not take k=20"):
        T.select_topk(meta.to(torch.float16), 20)
    with pytest.raises(ValueError, match="does not take k=20 of 2147483648"):
        T.select_topk(torch.empty((1, 1 << 31), device="meta"), 20)
    with pytest.raises(ValueError, match="k=-1 is negative"):
        T.select_topk(meta, -1)
    for k in (20, 2049, 3000, 3001):     # taken; no card
        with pytest.raises(ValueError, match="runs on CPU or CUDA"):
            T.select_topk(meta, k)
    with pytest.raises(ValueError, match="at least one axis"):
        T.select_topk(torch.tensor(1.0), 1)
    # the CPU runs the plain version and counts nothing
    x = torch.from_numpy(tie_heavy(3, 70, 9, nan=True))
    got = T.select_topk(x, 30)
    want = T.select_topk_reference(x, 30)
    assert torch.equal(got[1], want[1])
    assert T.select_topk(x, 80)[1].shape == (3, 70)
    assert (T.select_topk.launches, T.select_topk.captured) == before


@pytest.mark.cuda
def test_kernel_matches_its_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/select_topk.cu runs only "
                    "on the card")
    cases = [(256, 15744, 128), (256, 128, 16), (4, 100_000, 2048),
             (2, 1_000_448, 977), (3, 17, 5), (1, 1, 1), (3, 40_000, 5000),
             (2, 30_000, 30_000), (2, 200_000, 20_000), (4, 156_288, 9765),
             # narrow rows (the warp path, then one block), transposed
             # views of rows no multiple of 8, k at the block path's
             # limit and one past it
             (5, 1, 1), (9, 32, 7), (6, 128, 128), (6, 2048, 100),
             (13, 15744, 128), (11, 3000, 512),
             (2, 20_000, T.BLOCK_K_MAX), (2, 20_000, T.BLOCK_K_MAX + 1)]
    for rows, width, k in cases:
        x = torch.from_numpy(tie_heavy(rows, width, rows + k, nan=True))
        for view in (x, x.T.contiguous().T, x.to(torch.bfloat16)):
            want_v, want_i = T.select_topk_reference(view, k)
            launched = T.select_topk.launches
            got_v, got_i = T.select_topk(view.cuda(), k)
            torch.cuda.synchronize()
            assert T.select_topk.launches == launched + 1
            assert torch.equal(got_i.cpu(), want_i), (rows, width, k)
            assert same_bits(got_v.cpu(), want_v), (rows, width, k)
    ints = torch.randint(-5, 5, (8, 40_000), dtype=torch.int32)
    got = T.select_topk(ints.cuda(), 300)
    want = T.select_topk_reference(ints, 300)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])
    # past the one-block k: a frontier compaction's 65,536 of 1M slots
    frontier = torch.where(torch.rand(1_000_000) < 0.1,
                           torch.arange(1_000_000, dtype=torch.int32), -1)
    got = _top_k(frontier.cuda(), 65_536)
    want = T.select_topk_reference(frontier, 65_536)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])
    # past the width: the whole row
    got = T.select_topk(ints.cuda(), 50_000)
    assert torch.equal(got[1].cpu(), T.select_topk_reference(ints,
                                                             50_000)[1])
