"""Tie order of the port's selections: ``lax.top_k``'s rule everywhere.

``distance._top_k`` keeps ``lax.top_k``'s total order (+0.0 above -0.0)
and among equal values puts the lower position first, on any device (the
selection kernel ``csrc/select_topk.cu`` on the card, its plain version,
a stable sort of order keys, here; ``torch.topk`` promises no order
among equal values on CUDA).  It is held to ``lax.top_k`` itself here on
tie-heavy rows.  The fused exact
path and the int8 rung's fused coarse path select through it: rows
duplicated into different buckets come back lower position first, as
the JAX reference returns them.
"""

import numpy as np
import pytest
import torch

import helix_tpu.ops.fused_topk as JF
from helix_tpu_torch.ops import fused_topk as TF
from helix_tpu_torch.ops import quant as TQ
from helix_tpu_torch.ops.distance import _top_k

torch.set_num_threads(2)


def tie_heavy(rows: int, width: int, seed: int) -> torch.Tensor:
    """Few distinct values (many ties), with -inf, the masked-row
    sentinel, -0.0 (beside the +0.0 of the draws), +inf and NaN
    sprinkled in."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-4, 4, (rows, width), generator=gen).float() * 0.25
    roll = torch.rand((rows, width), generator=gen)
    x[roll < 0.05] = float("-inf")
    x[(roll >= 0.05) & (roll < 0.10)] = TF.NEG_SENTINEL
    x[(roll >= 0.10) & (roll < 0.13)] = -0.0
    x[(roll >= 0.13) & (roll < 0.15)] = float("inf")
    x[(roll >= 0.15) & (roll < 0.16)] = float("nan")
    return x


def lax_top_k(x: torch.Tensor, k: int):
    import jax
    import jax.numpy as jnp

    vals, idx = jax.lax.top_k(jnp.asarray(x.numpy()), k)
    return (torch.from_numpy(np.array(vals)),
            torch.from_numpy(np.array(idx)).long())


@pytest.mark.parametrize("rows,width,k,seed", [
    (1, 1, 1, 0), (3, 17, 5, 1), (8, 64, 64, 2), (4, 300, 37, 3),
    (256, 512, 16, 4), (2, 4096, 512, 5),
])
def test_top_k_equals_lax_top_k(rows, width, k, seed):
    x = tie_heavy(rows, width, seed)
    want_v, want_i = lax_top_k(x, k)
    for view in (x, x.T.contiguous().T):  # contiguous and strided
        got_v, got_i = _top_k(view, k)
        assert torch.equal(got_i, want_i)
        assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))


def test_top_k_rows_of_one_value():
    """All -inf, all sentinel, all zeros, all NaN: positions in order."""
    for fill in (float("-inf"), TF.NEG_SENTINEL, 0.0, float("nan")):
        x = torch.full((3, 40), fill)
        vals, idx = _top_k(x, 40)
        assert torch.equal(idx, torch.arange(40).expand(3, 40))
        assert torch.equal(vals.view(torch.int32), x.view(torch.int32))
        assert torch.equal(idx, lax_top_k(x, 40)[1])


DUP_ROW = 70          # bucket 1, slot 6
DUP_BUCKETS = (0, 40, 100, 101, 200)


def duplicated(n: int, d: int, seed: int):
    """Unit rows where row ``DUP_ROW`` is copied to slot 6 of every
    bucket in ``DUP_BUCKETS``, and queries that are that row (their top
    answers are exact ties)."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    dups = [b * TF.BUCKET + DUP_ROW % TF.BUCKET for b in DUP_BUCKETS]
    xs[dups] = xs[DUP_ROW]
    qs = np.repeat(xs[DUP_ROW:DUP_ROW + 1], 4, axis=0)
    qs[1:] += 1e-3 * rng.normal(size=(3, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    return xs, qs, dups


@pytest.fixture()
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


def port_fused(xs, qs, n_valid, k, device="cpu"):
    x16 = torch.from_numpy(xs).to(device, torch.bfloat16)
    x32 = torch.from_numpy(xs).to(device)
    q = torch.from_numpy(qs).to(device)
    d, i = TF.fused_topk(x16, x32, q, n_valid, torch.ones(len(xs)), k=k)
    return d.cpu().numpy(), i.cpu().numpy()


def test_fused_topk_returns_duplicates_in_the_reference_order(interpret_mode):
    import jax.numpy as jnp

    n, k = 16384, 16
    xs, qs, dups = duplicated(n, 128, seed=9)
    want_d, want_i = JF.fused_topk(
        jnp.asarray(xs, jnp.bfloat16), jnp.asarray(xs), jnp.asarray(qs), n,
        jnp.ones(n), k=k,
    )
    got_d, got_i = port_fused(xs, qs, n, k)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_allclose(got_d, np.asarray(want_d), rtol=0, atol=1e-6)
    # the exact query's first answers are the six copies, lowest first
    assert got_i[0, :len(dups) + 1].tolist() == sorted([DUP_ROW] + dups)


def test_fused_coarse_keeps_the_lower_bucket_at_the_pool_boundary():
    """More equal winners than the pool holds: the pool takes the
    lowest buckets, as ``lax.top_k`` does."""
    n, d, pool = 8192, 128, 8
    codes = torch.zeros((n, d), dtype=torch.int8)
    slot = 6
    codes[slot::TF.BUCKET] = 5          # every bucket's winner ties
    q = torch.ones((1, d))
    best, _, ids = TQ.fused_coarse(
        lambda q_i8: TQ.i8_bucket_scores(codes, q_i8, n), n, q, k=pool)
    assert ids[0].tolist() == [b * TF.BUCKET + slot for b in range(pool)]
    assert torch.unique(best[0].view(torch.int32)).numel() == 1


@pytest.mark.cuda
def test_duplicates_come_back_in_the_reference_order_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.topk's tie order is the "
                    "card's")
    n, k = 3 * 8192, 16
    xs, qs, dups = duplicated(n, 128, seed=9)
    want_d, want_i = port_fused(xs, qs, n, k)      # the CPU path
    for _ in range(5):
        got_d, got_i = port_fused(xs, qs, n, k, device="cuda")
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-5)
    assert got_i[0, :len(dups) + 1].tolist() == sorted([DUP_ROW] + dups)
    x = tie_heavy(256, 15744, seed=6)  # the fused step's winner rows
    want_v, want_i = _top_k(x, 512)
    got_v, got_i = _top_k(x.cuda(), 512)
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_v.cpu().view(torch.int32), want_v.view(torch.int32))
