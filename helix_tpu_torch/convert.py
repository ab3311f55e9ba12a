"""Carry state from ``helix_tpu`` into the port.

A database's counterpart of a model's weights is its resident state.
:func:`packed_matrix_from_reference` takes the host arrays of a
``helix_tpu.ops.distance.PackedMatrix`` (its ``.data``, ``.sq_norms``,
``.n``, ``.dim`` and ``.metric``) and returns the port's matrix holding
the same rows bit for bit, so both packages can be fed one resident
matrix.  The rows are installed as they are: they were already
normalised on the way in, and normalising again could move the last
bit.  At engine level, state carries across as the same logical write
requests (the WAL records) replayed into both engines.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.distance import PackedMatrix


def packed_matrix_from_reference(
    data: np.ndarray,
    sq_norms: np.ndarray,
    n: int,
    dim: int,
    metric: str,
    *,
    device: torch.device | str,
) -> PackedMatrix:
    """The port's :class:`PackedMatrix` with the reference's rows."""
    matrix = PackedMatrix(dim, metric, device=device)
    data = np.array(data, np.float32, copy=True)
    sq_norms = np.array(sq_norms, np.float32, copy=True)
    if data.ndim != 2 or data.shape[1] != matrix.dim_pad:
        raise ValueError(
            f"reference rows have shape {data.shape}, expected [*, "
            f"{matrix.dim_pad}] for dim {dim}"
        )
    if not 0 <= n <= len(data) or len(sq_norms) != len(data):
        raise ValueError(
            f"inconsistent reference state: n={n}, {len(data)} rows, "
            f"{len(sq_norms)} norms"
        )
    matrix.data = data
    matrix.sq_norms = sq_norms
    matrix.capacity = len(data)
    matrix.n = int(n)
    matrix.version = 1
    return matrix
