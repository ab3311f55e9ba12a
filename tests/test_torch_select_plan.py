"""The selection kernel's planner and its passes, rehearsed on the CPU.

``csrc/select_topk.cu`` picks a path from the shape and the strides
(``plan_of``); ``helix_tpu_torch/ops/topk.py:plan`` is its twin, pinned
here at the five shapes ``chip_smoke.py`` times and at the edges, and
held to the C planner on the card.  :func:`model_select` is a model of
the kernel's passes in torch ops, step for step: the warp path's bitonic
network, the block path's tiles, the first tile's seeding of the
threshold, the filter, buffer compactions
(for k <= 256 the top 256 by sorted chunks merged in pairs, else an MSB
radix select of 8 bits a pass over 64-bit (key, column) words, stopping
when the picked bin is taken whole) and stages, with the
planner's tile, buffer and chunk sizes.  It must equal the plain version
``select_topk_reference`` on tie-heavy rows (+-0.0, +-inf, +-NaN, all
equal, and a threshold bin holding most of the row), so the design's
logic is checked before the kernel runs.  The module imports no JAX:
its ``cuda`` test runs on the card (``pytest -m cuda
tests/test_torch_select_plan.py``).
"""

import ctypes

import numpy as np
import pytest
import torch

from helix_tpu_torch.ops import topk as T

torch.set_num_threads(2)

PAD = torch.iinfo(torch.int64).min   # the word 0: below every real word
SIGN = -(1 << 63)                    # the word's top bit, as an int64


def tie_heavy(rows: int, width: int, seed: int) -> np.ndarray:
    """Few distinct values with +-0.0, +-inf, the fused paths' sentinel
    and +-NaN (as ``tests/test_torch_select.py``)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 4, (rows, width)).astype(np.float32) * 0.25
    roll = rng.random((rows, width))
    x[roll < 0.05] = -np.inf
    x[(roll >= 0.05) & (roll < 0.10)] = -3.0e38
    x[(roll >= 0.10) & (roll < 0.16)] = -0.0
    x[(roll >= 0.16) & (roll < 0.18)] = np.inf
    x[(roll >= 0.18) & (roll < 0.19)] = np.nan
    x.view(np.uint32)[(roll >= 0.19) & (roll < 0.20)] = 0xFFC00000
    return x


# ---------------------------------------------------------------- planner

# (rows, width, k) -> the plan: the five timed shapes of chip_smoke.py's
# select phase, then the edges.
PINS = [
    # the fused tail (kernel 1's transposed winners) and the 10M int4
    # pool: one block per row, the pool's with a 16,384-word buffer
    ((256, 15744, 128), ("block", 0, ((15744, 15744, 1, 12),), 0)),
    ((256, 156_288, 9765), ("block", 0, ((156_288, 156_288, 1, 14),), 0)),
    # the re-rank: one warp per row, 4 words a lane
    ((256, 128, 16), ("warp", 4, (), 0)),
    # the l2 exact rung's scores and the cosine single shot's: 8 chunks
    # a row, then one
    ((256, 1_000_448, 128),
     ("block", 0, ((1_000_448, 131072, 8, 12), (1024, 1024, 1, 12)),
      2097152)),
    ((256, 1_007_616, 128),
     ("block", 0, ((1_007_616, 131072, 8, 12), (1024, 1024, 1, 12)),
      2097152)),
    # edges: width 1; k = width, narrow and not; the widest warp row and
    # one past; k = BLOCK_K_MAX - 1, BLOCK_K_MAX and one past (the wide
    # path); one query; rows no multiple of 8; 2,048 of a 1M row in 31
    # chunks
    ((1, 1, 1), ("warp", 1, (), 0)),
    ((7, 32, 32), ("warp", 1, (), 0)),
    ((5, 512, 512), ("warp", 16, (), 0)),
    ((5, 513, 513), ("block", 0, ((513, 513, 1, 12),), 0)),
    ((2, 2048, 2048), ("block", 0, ((2048, 2048, 1, 12),), 0)),
    ((2, 20_000, T.BLOCK_K_MAX - 1), ("block", 0,
                                      ((20_000, 20_000, 1, 14),), 0)),
    ((2, 20_000, T.BLOCK_K_MAX), ("block", 0, ((20_000, 20_000, 1, 14),),
                                  0)),
    ((2, 20_000, T.BLOCK_K_MAX + 1),
     ("wide", 0, (), 2 * (16 * (T.BLOCK_K_MAX + 1) + 8 * 2 + 4 * 260))),
    ((1, 15744, 128), ("block", 0, ((15744, 15744, 1, 12),), 0)),
    ((13, 40_000, 128),
     ("block", 0, ((40_000, 16384, 3, 12), (384, 384, 1, 12)),
      13 * 8 * 384)),
    ((2, 1_000_448, 2048),
     ("block", 0, ((1_000_448, 32768, 31, 12), (63488, 63488, 1, 12)),
      1015808)),
    ((1, 1_000_000, 65_536),
     ("wide", 0, (), 16 * 65_536 + 8 * 62 + 4 * 260)),
]


@pytest.mark.parametrize("shape,want", PINS)
def test_planner_twin(shape, want):
    p = T.plan(*shape)
    assert (p.path, p.param, p.stages, p.scratch) == want
    assert T.scratch_bytes(*shape) == p.scratch
    rows, _, k = shape
    for width, chunk, chunks, log_cap in p.stages:
        # a buffer holds k words and one tile; chunks start on a tile;
        # each stage shrinks the row
        assert 1 << log_cap >= k + T.THREADS * T.BV
        assert 1 << log_cap <= T.MAX_CAP
        assert chunks == -(-width // chunk)
        assert chunks == 1 or chunk % (T.THREADS * T.BV) == 0
    widths = [s[0] for s in p.stages]
    assert all(b * 10 < a for a, b in zip(widths, widths[1:]))
    assert rows >= 1


def test_planner_refuses_what_the_kernel_does_not_take():
    for shape in ((0, 10, 1), (2, 10, 0), (2, 10, 11), (1, 1 << 31, 5)):
        with pytest.raises(ValueError, match="no plan"):
            T.plan(*shape)


# ---------------------------------------------------------------- model


def words_of(x: torch.Tensor) -> torch.Tensor:
    """The kernel's 64-bit words key << 32 | ~column, as int64 shifted by
    2^63 so that the signed order is the words' unsigned order."""
    keys = T.order_keys(x).long()
    cols = torch.arange(x.shape[-1], dtype=torch.int64)
    return keys * (1 << 32) + ((1 << 32) - 1 - cols)


def bitonic(v: torch.Tensor) -> torch.Tensor:
    """The kernels' bitonic network on the last axis (a power of two),
    descending: the warp path's in registers, the block path's in shared
    memory."""
    n = v.shape[-1]
    idx = torch.arange(n)
    size = 2
    while size <= n:
        stride = size // 2
        while stride:
            other = v[..., idx ^ stride]
            keep_larger = ((idx & stride) == 0) == ((idx & size) == 0)
            v = torch.where(keep_larger, torch.maximum(v, other),
                            torch.minimum(v, other))
            stride //= 2
        size *= 2
    return v


def radix_threshold(buf: torch.Tensor, need: int) -> int:
    """compact_rows' select: the need-th largest word's prefix, 8 bits a
    pass from the top, stopping when the picked bin is taken whole."""
    u = buf ^ SIGN          # the unsigned words' bits
    prefix, rank = 0, need
    for shift in range(56, -1, -8):
        if shift == 56:
            live = u
        else:
            live = u[((u ^ (prefix - (1 << 64) if prefix >= 1 << 63
                          else prefix)) >> (shift + 8)) == 0]
        hist = torch.bincount((live >> shift) & 255, minlength=256)
        from_top = hist.flip(0).cumsum(0)
        d = 255 - int(torch.nonzero(from_top >= rank)[0])
        before = int(from_top[255 - d] - hist[d])
        left = rank - before
        prefix |= d << shift
        if int(hist[d]) == left:
            break
        rank = left
    return prefix - (1 << 63)   # back to the signed words


def bitonic_merge(v: torch.Tensor) -> torch.Tensor:
    """A bitonic sequence's descending merge: strides n/2 down to 1."""
    n = v.shape[-1]
    idx = torch.arange(n)
    stride = n // 2
    while stride:
        other = v[..., idx ^ stride]
        v = torch.where((idx & stride) == 0, torch.maximum(v, other),
                        torch.minimum(v, other))
        stride //= 2
    return v


def top_256(buf: torch.Tensor) -> torch.Tensor:
    """compact_top: the buffer's 256 largest words, sorted descending:
    chunks of 256 sorted, then merged two by two keeping the larger of
    a[i] and b[255 - i]."""
    n = -(-buf.shape[0] // 256) * 256
    padded = torch.full((n,), PAD)
    padded[:buf.shape[0]] = buf
    chunks = [bitonic(c) for c in padded.split(256)]
    while len(chunks) > 1:
        merged = [bitonic_merge(torch.maximum(a, b.flip(0)))
                  for a, b in zip(chunks[::2], chunks[1::2])]
        chunks = merged + ([chunks[-1]] if len(chunks) % 2 else [])
    return chunks[0]


def compact(buf: torch.Tensor, need: int) -> tuple[torch.Tensor, int]:
    """A buffer's need largest words and the new tau: compact_top's
    sorted 256 for need <= 256, else compact_rows' radix select."""
    if need <= 256:
        top = top_256(buf)[:need]
        return top, int(top[-1])
    tau = radix_threshold(buf, need)
    return buf[buf >= tau], tau


def filter_chunk(words: torch.Tensor, need: int, per_row: int, cap: int,
                 vec: bool) -> torch.Tensor:
    """One row of one block, its ``per_row`` threads loading BV words
    each a tile (``vec``, a contiguous row: BV adjacent columns a thread): the first tile seeds tau (each thread's ``seed``
    largest words in first, tau their need-th largest, then the rest of
    the tile at or above tau); then the buffer is compacted to ``need``
    when a tile might not fit in ``cap`` (past 256, when the tile's words
    at or above tau would not), and the tile's words at or above tau
    appended; compacted again at the end."""
    tile = per_row * T.BV
    seed = -(-need // per_row)
    seed = seed if seed <= T.BV // 2 else 0
    buf = words[:0]
    tau = PAD
    for lo in range(0, words.shape[0], tile):
        w = words[lo:lo + tile]
        if lo == 0 and seed:
            padded = torch.full((tile,), PAD)
            padded[:w.shape[0]] = w
            # thread g holds the tile's words g + j * per_row, or
            # g * BV + j
            mine = (padded.view(per_row, T.BV) if vec
                    else padded.view(T.BV, per_row).T)
            mine = mine.sort(dim=1, descending=True).values
            buf = mine[:, :seed].flatten()
            buf = buf[buf != PAD]
            if buf.shape[0] >= need:
                buf, tau = compact(buf, need)
            rest = mine[:, seed:].flatten()
            buf = torch.cat([buf, rest[(rest != PAD) & (rest >= tau)]])
            continue
        survivors = w[(w != PAD) & (w >= tau)]
        # past 256 the survivors are counted first; else a whole tile is
        # room enough
        coming = survivors.shape[0] if need > 256 else tile
        if buf.shape[0] + coming > cap:
            buf, tau = compact(buf, need)
            assert buf.shape[0] == need
            survivors = w[(w != PAD) & (w >= tau)]
        buf = torch.cat([buf, survivors])
        assert buf.shape[0] <= cap
    if buf.shape[0] > need:
        buf, tau = compact(buf, need)
    return buf


def model_select(x: torch.Tensor, k: int):
    """The kernel's passes on the CPU: (values, int64 ids) of the top k
    of each row of ``x``, as ``select_topk`` returns them."""
    rows, width = x.shape
    k = min(k, width)
    p = T.plan(rows, width, k)
    words = words_of(x)
    if p.path == "warp":
        n = 32 * p.param
        padded = torch.full((rows, n), PAD)
        padded[:, :width] = words
        top = bitonic(padded)[:, :k]
    elif p.path == "wide":   # the sort-and-merge of its runs
        top = torch.sort(words, dim=1, descending=True).values[:, :k]
    else:
        for stage, (w, chunk, chunks, log_cap) in enumerate(p.stages):
            per_row, cap = T.THREADS, 1 << log_cap
            out = torch.full((rows, chunks * k), PAD)
            for r in range(rows):
                for c in range(chunks):
                    lo = c * chunk
                    need = min(k, min(w, lo + chunk) - lo)
                    kept = filter_chunk(words[r, lo:lo + chunk], need,
                                        per_row, cap,
                                        stage == 0 and x.stride(1) == 1)
                    out[r, c * k:c * k + kept.shape[0]] = kept
            words = out
        if k <= 256:
            top = torch.stack([top_256(w[:k]) for w in words])[:, :k]
        else:
            pw = 1 << (k - 1).bit_length()
            padded = torch.full((rows, pw), PAD)
            padded[:, :k] = words[:, :k]
            top = bitonic(padded)[:, :k]
    ids = (1 << 32) - 1 - (top & 0xFFFFFFFF)
    return torch.gather(x, 1, ids), ids


def same(got, want) -> bool:
    wide = torch.int16 if got[0].dtype == torch.bfloat16 else torch.int32
    return (torch.equal(got[1], want[1])
            and torch.equal(got[0].view(wide), want[0].view(wide)))


@pytest.mark.parametrize("rows,width,k", [
    (3, 17, 5), (1, 1, 1), (4, 128, 16), (2, 512, 512), (3, 600, 300),
    (2, 5000, 64), (9, 5000, 64), (3, 40_000, 128), (2, 20_000, 2048),
    (11, 3000, 200)])
def test_model_equals_the_plain_version_on_tie_heavy_rows(rows, width, k):
    x = torch.from_numpy(tie_heavy(rows, width, rows * 7 + k))
    for view in (x, x.T.contiguous().T, x.to(torch.bfloat16)):
        assert same(model_select(view, k), T.select_topk_reference(view, k))


def test_model_on_all_equal_rows_and_one_crowded_bin():
    # every key equal: the lowest columns win, the radix select runs all
    # eight passes (words differ only in the column)
    flat = torch.zeros((3, 20_000))
    assert same(model_select(flat, 100), T.select_topk_reference(flat, 100))
    # the threshold bin holds most of the row: values one ulp apart
    base = torch.full((2, 30_000), 1.0).view(torch.int32)
    rng = np.random.default_rng(5)
    crowded = (base + torch.from_numpy(rng.integers(0, 3, (2, 30_000))
                                       .astype(np.int32))).view(torch.float32)
    for view in (crowded, crowded.T.contiguous().T):
        assert same(model_select(view, 1000),
                    T.select_topk_reference(view, 1000))
    # ascending rows: every tile passes tau, so the buffer fills again and
    # again
    up = torch.arange(50_000, dtype=torch.int32).repeat(2, 1)
    assert same(model_select(up, 128), T.select_topk_reference(up, 128))
    # signed zeros and NaNs only
    z = torch.tensor([0.0, -0.0, float("nan")]).repeat(2, 3000)
    z.view(torch.int32)[:, ::7] = -4194304   # 0xFFC00000: -NaN
    assert same(model_select(z, 2500), T.select_topk_reference(z, 2500))


def test_radix_threshold_keeps_exactly_need():
    rng = np.random.default_rng(3)
    for n, need in ((4096, 128), (1000, 999), (300, 1), (8192, 4096)):
        x = torch.from_numpy(rng.integers(-3, 3, (1, n)).astype(np.float32))
        buf = words_of(x)[0]
        t = radix_threshold(buf, need)
        assert int((buf >= t).sum()) == need
        assert torch.equal(torch.sort(buf[buf >= t]).values,
                           torch.sort(buf, descending=True).values[:need]
                           .sort().values)


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_planner_and_kernel_on_the_card():
    """The C planner equals the twin, and the kernel equals its plain
    version bit for bit on narrow rows (1, 32, 128, 2,048 columns),
    transposed views whose row count is no multiple of 8, and k at the
    block path's limit and one past it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/select_topk.cu runs only "
                    "on the card")
    from helix_tpu_torch import kernels

    lib = kernels.load()
    for shape, _ in PINS:
        out = (ctypes.c_longlong * 64)()
        rows, width, k = shape
        assert lib.hx_select_topk_plan(rows, width, k, out) == 0
        p = T.plan(*shape)
        flat = [T.PATHS.index(p.path), p.param, len(p.stages), p.scratch]
        flat += [v for stage in p.stages for v in stage]
        assert list(out[:len(flat)]) == flat, shape
    cases = [(5, 1, 1), (9, 32, 7), (256, 128, 16), (6, 2048, 100),
             (13, 15744, 128), (3, 5000, 64), (11, 3000, 512),
             (2, 20_000, T.BLOCK_K_MAX), (2, 20_000, T.BLOCK_K_MAX + 1)]
    for rows, width, k in cases:
        x = torch.from_numpy(tie_heavy(rows, width, rows + k))
        for view in (x, x.T.contiguous().T, x.to(torch.bfloat16)):
            got = T.select_topk(view.cuda(), k)
            torch.cuda.synchronize()
            assert same((got[0].cpu(), got[1].cpu()),
                        T.select_topk_reference(view, k)), (rows, width, k)
