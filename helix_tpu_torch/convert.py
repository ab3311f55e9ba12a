"""Carry state from ``helix_tpu`` into the port.

A database's counterpart of a model's weights is its resident state.
:func:`packed_matrix_from_reference` takes the host arrays of a
``helix_tpu.ops.distance.PackedMatrix`` (its ``.data``, ``.sq_norms``,
``.n``, ``.dim`` and ``.metric``) and returns the port's matrix holding
the same rows bit for bit, so both packages can be fed one resident
matrix.  The rows are installed as they are: they were already
normalised on the way in, and normalising again could move the last
bit.  :func:`quantized_resident_from_reference` and
:func:`int4_resident_from_reference` install the reference's quantized
state (its int8 codes; its packed int4 codes, bucket scales, row scales
and ``perm``) in the port's int8 and int4 residents for such a matrix,
so both packages can serve one quantized state too.
:func:`host_ivf_from_reference` installs a reference ``HostIVFIndex``'s
fitted state (centroids, cell-sorted rows, cell boundaries, row map) in
the port's, since the two k-means fits cannot agree bit for bit.  The
padded adjacency and the BM25 postings need no converter: both packages
build them from the same host data.  At engine level, state carries
across as the same logical write requests (the WAL records) replayed
into both engines.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.distance import PackedMatrix
from .ops.ivf import HostIVFIndex
from .ops.quant import QuantizedResident, _sq_device
from .ops.quant4 import Int4Resident


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


def _check_rows(matrix: PackedMatrix, name: str, array: np.ndarray,
                width: int) -> None:
    if array.ndim != 2 or array.shape[1] != width or len(array) < matrix.n:
        raise ValueError(
            f"reference {name} have shape {array.shape}, expected "
            f"[>= {matrix.n}, {width}]"
        )


def quantized_resident_from_reference(
    matrix: PackedMatrix, codes: np.ndarray, scales: np.ndarray,
) -> QuantizedResident:
    """The port's int8 resident for ``matrix`` holding the reference's
    ``QuantizedResident`` state: int8 ``codes [N, dim_pad]`` and f32
    per-row ``scales [N]`` (N padded rows), installed on the matrix's
    device for its current version."""
    codes = np.ascontiguousarray(codes, np.int8)
    scales = np.ascontiguousarray(scales, np.float32)
    _check_rows(matrix, "int8 codes", codes, matrix.dim_pad)
    if scales.shape != (len(codes),):
        raise ValueError(f"reference scales have shape {scales.shape}, "
                         f"expected [{len(codes)}]")
    n_rows = len(codes)
    resident = QuantizedResident()
    resident._cached = (
        matrix.version,
        matrix._upload(codes, n_rows, torch.int8),
        torch.from_numpy(scales).to(matrix.device),
        _sq_device(matrix, n_rows),
    )
    return resident


def int4_resident_from_reference(
    matrix: PackedMatrix, packed: np.ndarray, bucket_scales: np.ndarray,
    row_scales: np.ndarray, perm: np.ndarray,
) -> Int4Resident:
    """The port's int4 resident for ``matrix`` holding the reference's
    ``Int4Resident`` state: uint8 ``packed [N, dim_pad / 2]``, f32
    ``bucket_scales [N / 64]`` (or the 1-element dummy of an l2 matrix),
    f32 ``row_scales [N]`` and int64 ``perm [N]`` (sorted position ->
    row), installed on the matrix's device for its current version."""
    packed = np.ascontiguousarray(packed, np.uint8)
    bucket_scales = np.ascontiguousarray(bucket_scales, np.float32)
    row_scales = np.ascontiguousarray(row_scales, np.float32)
    perm = np.array(perm, np.int64, copy=True)
    _check_rows(matrix, "int4 codes", packed, matrix.dim_pad // 2)
    n_rows = len(packed)
    if row_scales.shape != (n_rows,) or perm.shape != (n_rows,):
        raise ValueError(
            f"reference row_scales {row_scales.shape} and perm {perm.shape} "
            f"must both be [{n_rows}]"
        )
    if bucket_scales.shape not in ((n_rows // 64,), (1,)):
        raise ValueError(f"reference bucket_scales have shape "
                         f"{bucket_scales.shape}, expected [{n_rows // 64}]")
    resident = Int4Resident()
    resident._cached = (
        matrix.version,
        matrix._upload(packed, n_rows, torch.uint8),
        torch.from_numpy(row_scales).to(matrix.device),
        _sq_device(matrix, n_rows),
        torch.from_numpy(bucket_scales).to(matrix.device),
        perm,
    )
    return resident


def host_ivf_from_reference(
    centroids: np.ndarray, packed: np.ndarray, indptr: np.ndarray,
    row_to_original: np.ndarray, *, device: torch.device | str,
) -> HostIVFIndex:
    """The port's :class:`HostIVFIndex` holding the reference's fitted
    state: f32 ``centroids [C, D]`` (put on ``device``), the cell-sorted
    unit rows ``packed [N, D]``, ``indptr [C + 1]`` and
    ``row_to_original [N]``."""
    centroids = np.array(centroids, np.float32, copy=True)
    packed = np.array(packed, np.float32, copy=True)
    indptr = np.array(indptr, np.int64, copy=True)
    row_to_original = np.array(row_to_original, np.int64, copy=True)
    c, d = centroids.shape
    if packed.ndim != 2 or packed.shape[1] != d:
        raise ValueError(f"reference rows have shape {packed.shape}, "
                         f"expected [*, {d}]")
    if indptr.shape != (c + 1,) or indptr[0] != 0 \
            or indptr[-1] != len(packed) or np.any(np.diff(indptr) < 0):
        raise ValueError(f"reference indptr is not the boundaries of {c} "
                         f"cells over {len(packed)} rows")
    if row_to_original.shape != (len(packed),):
        raise ValueError(f"reference row_to_original has shape "
                         f"{row_to_original.shape}, expected "
                         f"[{len(packed)}]")
    return HostIVFIndex(packed, torch.from_numpy(centroids).to(device),
                        indptr, row_to_original, 0.0)
