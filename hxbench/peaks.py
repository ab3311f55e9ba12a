"""The yardstick: NVIDIA's data-sheet peaks of one H100 SXM (dense, no
sparsity, at its full 700 W limit), and the least time a piece of work
can take on it.  A copy of ``helix_tpu_torch/card.py``'s rates, kept here
so that the program cannot move the bound it is measured against."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_PER_S = 989e12


def least_seconds(n_bytes: float, ops: float,
                  peak_ops: float = PEAK_BF16_PER_S,
                  peak_bytes: float = PEAK_BYTES_PER_S) -> tuple[float, str]:
    """The larger of the bytes over the memory rate and the operations
    over ``peak_ops``, in seconds, and which of the two it is."""
    t_bytes = n_bytes / peak_bytes
    t_ops = ops / peak_ops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def search_work(rows: int, dim: int, batch: int, k: int) -> tuple[float, float]:
    """(bytes, operations) of one exact search of ``batch`` queries over
    ``rows`` vectors of the published width ``dim``: the corpus read once
    at 2 bytes an element, the f32 queries read once, ``k`` (int64 id,
    f32 distance) pairs written per query; ``2 * batch * rows * dim``
    multiply-adds counted as operations.  The count is of the work, so it
    is the same whatever implements the search."""
    n_bytes = rows * dim * 2 + batch * dim * 4 + batch * k * (8 + 4)
    ops = 2.0 * batch * rows * dim
    return float(n_bytes), ops
