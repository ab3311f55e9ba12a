"""Row-wise top-k selection on the card: the port of the reference's two
device selections, ``jax.lax.approx_max_k`` (the TPU's partial-reduce
top-k) and ``jax.lax.top_k``.  On the TPU both are XLA ops, not Pallas
kernels, so the reference has no module of its own for them; they stand
at ``helix_tpu/ops/fused_topk.py:244,262``, ``quant.py:111,165,654``,
``quant4.py:172,332``, ``distance.py:88-135,179-227``, the IVF and BM25
selections and ``parallel/sharded.py:66-201``.

Both return the ``k`` largest values of each row, descending, ties to
the lower position, in ``lax.top_k``'s total order of floats: +NaN
first, then +inf down to +0.0, then -0.0 below it, down to -inf, and
-NaN last (NaNs of one sign by their payload bits).  The reference's
``approx_max_k`` on the CPU (where it is exact) orders f32 rows the same
way for ``1 < k < width``: XLA lowers it to the TopK call that
``lax.top_k`` makes.  Elsewhere its tie order is XLA's, not a rule: at
``k == width`` and for bf16 rows an unstable sort whose comparator holds
+0.0 and -0.0 equal, at ``k == 1`` the last maximum
(``tests/test_torch_select.py`` pins all three).  So one order serves
both, and :func:`order_keys` writes it as an int32 key: the float's bits
with the magnitude bits of negatives flipped.  bf16 rows are keyed
through their exact f32 value; int32 rows by value.

:func:`select_topk` is the kernel wrapper and the route every selection
of the port takes (``distance._top_k``, at the reference's
``approx_max_k`` and ``lax.top_k`` sites alike).  On a CUDA tensor
inside :func:`supports_select` (f32, bf16 or int32 rows narrower than
2^31: every shape of the port) it launches ``csrc/select_topk.cu`` on
the path :func:`plan` picks from the shape and strides: rows of at most
``WARP_MAX`` columns one warp each, sorted in registers; ``k <=
BLOCK_K_MAX`` a threshold filter per chunk of a row (8 adjacent rows a
block for a transposed view) into a buffer in shared memory, radix
selects on that buffer alone, and a second launch over the chunks'
survivors where a row takes more than one chunk; past ``BLOCK_K_MAX``
the wide path (radix passes over the whole row, sorted runs merged).
It counts the launch in ``select_topk.launches`` (``.captured`` on a
stream capturing a CUDA graph); any other CUDA call raises.  On a CPU
tensor it runs :func:`select_topk_reference`, the plain version: a
stable descending sort of the keys.  Both return the same values (the
input's dtype and bits) and int64 positions.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .. import kernels

# csrc/select_topk.cu's planner constants (plan_of)
THREADS = 512         # a block path block's threads
BV = 4                # keys a thread loads per tile
WARP_MAX = 512        # the warp path's widest row
MAX_CAP = 16384       # words of one block's buffers
BLOCK_K_MAX = MAX_CAP - THREADS * BV   # 14,336: past it the wide path
SMS = 132             # an H100 SXM's SMs: the planner's target
SLICE = 16384         # the wide path's columns per block
PATHS = ("warp", "block", "wide")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_INT32_MAX = 0x7FFFFFFF


def supports_select(width: int, k: int, dtype: torch.dtype) -> bool:
    """Whether ``csrc/select_topk.cu`` takes ``k`` of ``width`` columns
    of ``dtype``: f32, bf16 or int32 and ``1 <= k <= width < 2^31``."""
    return dtype in _DTYPE_CODES and 1 <= k <= width < 1 << 31


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose order is the selection's order of ``x`` (f32,
    bf16 or int32; see the module docstring)."""
    if x.dtype == torch.int32:
        return x
    if x.dtype == torch.bfloat16:
        x = x.float()  # exact
    if x.dtype != torch.float32:
        raise TypeError(
            f"order_keys takes f32, bf16 or int32, got {x.dtype}")
    bits = x.view(torch.int32)
    # negative floats order the other way as integers: flip their
    # magnitude bits
    return bits ^ ((bits >> 31) & _INT32_MAX)


def select_topk_reference(x: torch.Tensor,
                          k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: a stable descending sort of the order
    keys along the last axis, the first ``k`` positions (int64) and the
    values there."""
    _, idx = torch.sort(order_keys(x), dim=-1,
                        descending=True, stable=True)
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx


class Plan(NamedTuple):
    """How ``csrc/select_topk.cu`` runs one shape: ``path`` (``PATHS``);
    ``param``, the warp path's words per lane (else 0); for the block
    path one ``(width, chunk, chunks, log2 of the buffer)`` per stage; the
    scratch bytes."""

    path: str
    param: int
    stages: tuple
    scratch: int


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _log_cap(k: int) -> int:
    """log2 of a block's buffer: room for k words and one tile."""
    return (k + THREADS * BV - 1).bit_length()


def _chunk(width: int, rows: int, k: int) -> tuple[int, int]:
    """A block path stage's (chunk, chunks) over ``width`` columns: one
    chunk up to 32k columns, else about 4 x SMS blocks over the rows,
    each chunk within [max(16384, 16k), 131072], rounded up to a
    tile."""
    if width <= 32 * k:
        return width, 1
    want = _ceil_div(4 * SMS, rows)
    lo = max(16384, 16 * k)
    hi = max(lo, 131072)
    tile = THREADS * BV   # chunks start on a tile
    c = _ceil_div(min(max(_ceil_div(width, want), lo), hi), tile) * tile
    if c >= width:
        return width, 1
    return c, _ceil_div(width, c)


@functools.lru_cache(maxsize=4096)
def plan(rows: int, width: int, k: int) -> Plan:
    """The kernel's plan for ``k`` of ``width`` columns over ``rows``
    rows (csrc/select_topk.cu: plan_of, which the card checks against
    this twin).  The block path's scratch holds the words of its first
    two intermediate stages (later stages alternate between those
    regions); the wide path's two regions of ``rows * k`` packed pairs,
    8 bytes per chunk of ``SLICE`` columns, and 256 bins and 4 ints of
    state per row."""
    if not (rows >= 1 and 1 <= k <= width < 1 << 31):
        raise ValueError(f"select_topk: no plan for k={k} of {width} "
                         f"columns over {rows} rows")
    if k > BLOCK_K_MAX:
        return Plan("wide", 0, (), rows * (
            16 * k + 8 * _ceil_div(width, SLICE) + 4 * 260))
    if width <= WARP_MAX:
        return Plan("warp", 1 << max(0, (width - 1) // 32).bit_length(),
                    (), 0)
    stages, w, need = [], width, 0
    while True:
        chunk, chunks = _chunk(w, rows, k)
        stages.append((w, chunk, chunks, _log_cap(k)))
        if chunks == 1:
            break
        w = chunks * k
        if len(stages) <= 2:
            need += w
    return Plan("block", 0, tuple(stages), 8 * rows * need)


def scratch_bytes(rows: int, width: int, k: int) -> int:
    """Scratch bytes that a selection of ``k`` of ``width`` columns over
    ``rows`` rows needs (:func:`plan`)."""
    return plan(rows, width, k).scratch


_ENTRY = None   # the C entry hx_select_topk, bound at the first launch


@functools.lru_cache(maxsize=4096)
def _scratch_for(rows: int, width: int, k: int, dtype: torch.dtype) -> int:
    """The wrapper's per-shape plan: the scratch bytes, after the gate."""
    if not supports_select(width, k, dtype):
        raise ValueError(
            f"select_topk: the kernel does not take k={k} of {width} "
            f"columns of {dtype} (f32, bf16 or int32; 1 <= k <= width "
            "< 2^31)"
        )
    return plan(rows, width, k).scratch if rows else 0


def select_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row of ``x`` (any strided view; the
    last axis is the row), descending, ties to the lower position:
    ``(values in x's dtype, int64 positions)``, in ``lax.top_k``'s order
    (module docstring).  Past the row's width the whole row comes back,
    as the sort's slice gives it.

    A CPU tensor runs :func:`select_topk_reference`.  A CUDA tensor
    launches ``csrc/select_topk.cu`` on the current stream, with outputs
    and scratch from the caching allocator (``Tensor.new_empty``: safe
    under CUDA-graph capture and from several threads), or raises outside
    :func:`supports_select`.  The host's part is one plan lookup (cached
    per shape and dtype), the allocations and one
    :func:`~helix_tpu_torch.kernels.launch`: a device guard only where
    ``x`` is not on the current device and one ``ctypes`` call."""
    global _ENTRY
    if x.dim() != 2:
        if x.dim() == 0:
            raise ValueError("select_topk needs at least one axis")
        lead = x.shape[:-1]
        vals, ids = select_topk(x.reshape(math.prod(lead), x.shape[-1]), k)
        return (vals.reshape(*lead, vals.shape[-1]),
                ids.reshape(*lead, ids.shape[-1]))
    if k < 0:
        raise ValueError(f"select_topk: k={k} is negative")
    if x.is_cpu:
        return select_topk_reference(x, k)
    rows, width = x.shape
    k = min(k, width)
    nbytes = _scratch_for(rows, width, k, x.dtype) if k else 0
    if not x.is_cuda:
        raise ValueError(f"select_topk runs on CPU or CUDA, got {x.device}")
    vals = x.new_empty(rows, k)
    ids = x.new_empty(rows, k, dtype=torch.int64)
    if rows == 0 or k == 0:
        return vals, ids
    scratch = x.new_empty(nbytes, dtype=torch.uint8) if nbytes else None
    if _ENTRY is None:
        _ENTRY = kernels.load().hx_select_topk
    s0, s1 = x.stride()
    kernels.launch(select_topk, _ENTRY, x.get_device(), x.data_ptr(),
                   _DTYPE_CODES[x.dtype], rows, width, s0, s1, k,
                   vals.data_ptr(), ids.data_ptr(),
                   scratch.data_ptr() if nbytes else None, nbytes)
    return vals, ids


select_topk.launches = 0
select_topk.captured = 0
