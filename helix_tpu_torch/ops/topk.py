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
2^31: every shape of the port) it launches ``csrc/select_topk.cu``: for
``k <= MAX_K`` a radix select per slice of a row in one block's shared
memory, an ordered compaction that keeps the lower columns among equal
keys, and a bitonic sort; past ``MAX_K`` the same select over the whole
row in device memory, then sorted runs merged.  It counts the launch in
``select_topk.launches`` (``.captured`` on a stream capturing a CUDA
graph); any other CUDA call raises.  On a CPU tensor it runs
:func:`select_topk_reference`, the plain version: a stable descending
sort of the keys.  Both return the same values (the input's dtype and
bits) and int64 positions.
"""

from __future__ import annotations

import math

import torch

from .. import kernels

MAX_K = 2048          # csrc/select_topk.cu: the one-block select's largest k
SLICE = 16384         # csrc/select_topk.cu: columns per block and pass
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


def scratch_bytes(rows: int, width: int, k: int) -> int:
    """Scratch bytes that a selection of ``k`` of ``width`` columns over
    ``rows`` rows needs (csrc/select_topk.cu: scratch_of).  For ``k <=
    MAX_K``: a key and a column (4 bytes each) for every candidate of the
    first two passes; past it: two regions of ``rows * k`` packed pairs,
    8 bytes per chunk of ``SLICE`` columns, and 256 bins and 4 ints of
    state per row."""
    def slices(w: int) -> int:
        return -(-w // SLICE)

    if k > MAX_K:
        return rows * (16 * k + 8 * slices(width) + 4 * 260)
    need, w, passes = 0, width, 0
    while slices(w) > 1:
        s = slices(w)
        w = (s - 1) * k + min(k, w - (s - 1) * SLICE)
        if passes < 2:
            need += w
        passes += 1
    return 8 * rows * need


def select_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row of ``x`` (any strided view; the
    last axis is the row), descending, ties to the lower position:
    ``(values in x's dtype, int64 positions)``, in ``lax.top_k``'s order
    (module docstring).  Past the row's width the whole row comes back,
    as the sort's slice gives it.

    A CPU tensor runs :func:`select_topk_reference`.  A CUDA tensor
    launches ``csrc/select_topk.cu`` on the current stream, with outputs
    and scratch from ``torch.empty`` (safe under CUDA-graph capture and
    from several threads), or raises outside :func:`supports_select`."""
    if x.dim() == 0:
        raise ValueError("select_topk needs at least one axis")
    if x.dim() != 2:
        lead = x.shape[:-1]
        vals, ids = select_topk(x.reshape(math.prod(lead), x.shape[-1]), k)
        return (vals.reshape(*lead, vals.shape[-1]),
                ids.reshape(*lead, ids.shape[-1]))
    if k < 0:
        raise ValueError(f"select_topk: k={k} is negative")
    if x.device.type == "cpu":
        return select_topk_reference(x, k)
    rows, width = x.shape
    k = min(k, width)
    if k > 0 and not supports_select(width, k, x.dtype):
        raise ValueError(
            f"select_topk: the kernel does not take k={k} of {width} "
            f"columns of {x.dtype} (f32, bf16 or int32; 1 <= k <= width "
            "< 2^31)"
        )
    if x.device.type != "cuda":
        raise ValueError(f"select_topk runs on CPU or CUDA, got {x.device}")
    vals = torch.empty((rows, k), dtype=x.dtype, device=x.device)
    ids = torch.empty((rows, k), dtype=torch.int64, device=x.device)
    if rows == 0 or k == 0:
        return vals, ids
    nbytes = scratch_bytes(rows, width, k)
    # one pass (the fused tail, the re-rank) needs none
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=x.device)
               if nbytes else None)
    lib = kernels.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hx_select_topk(
            x.data_ptr(), _DTYPE_CODES[x.dtype], rows, width,
            x.stride(0), x.stride(1), k, vals.data_ptr(), ids.data_ptr(),
            scratch.data_ptr() if nbytes else None, nbytes, stream,
        )
    kernels.check_launch("select_topk", rc)
    kernels.count_launch(select_topk, x.device)
    return vals, ids


select_topk.launches = 0
select_topk.captured = 0
