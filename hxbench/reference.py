"""The plain reference: the exact top-k by brute force, in plain PyTorch
and NumPy, from the raw generated rows (and, under a write mix, the raw
rows the harness inserted, each seen only by the queries it could
reach).  It imports nothing of the program and takes nothing the program
made: it normalises the rows and queries itself (angular), and works in
float64 unless asked otherwise (the control, :mod:`hxbench.control`, asks
for bfloat16)."""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 1 << 18


def _prepare(x: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "cosine":
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x / torch.where(norm > 0, norm, torch.ones_like(norm))
    return x


def exact_topk(rows: np.ndarray, queries: np.ndarray, k: int, metric: str,
               device: torch.device, dtype: torch.dtype = torch.float64,
               block_rows: int = BLOCK_ROWS,
               visible: np.ndarray | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """``(distances [S, k] float64, positions [S, k] int64)`` ascending:
    cosine distance ``1 - q.x`` of the normalised vectors, or the squared
    l2 distance, computed in ``dtype`` block by block of rows.  With
    ``visible [S]`` query ``i`` sees only the first ``visible[i]`` rows
    (the rest at an infinite distance)."""
    q = _prepare(torch.from_numpy(queries).to(device).to(dtype), metric)
    if visible is not None:
        visible = torch.from_numpy(np.asarray(visible, np.int64)).to(device)
    q_sq = (q * q).sum(dim=1, keepdim=True)
    best_d = torch.full((len(q), 0), float("inf"), dtype=dtype, device=device)
    best_i = torch.zeros((len(q), 0), dtype=torch.int64, device=device)
    for s in range(0, len(rows), block_rows):
        e = min(len(rows), s + block_rows)
        x = _prepare(torch.from_numpy(rows[s:e]).to(device).to(dtype), metric)
        if metric == "cosine":
            d = 1.0 - q @ x.T
        else:
            d = (x * x).sum(dim=1)[None, :] - 2.0 * (q @ x.T) + q_sq
        if visible is not None:
            cols = torch.arange(s, e, device=device)
            d = torch.where(cols[None, :] < visible[:, None], d,
                            torch.full_like(d, float("inf")))
        vals, idx = torch.topk(d, min(k, e - s), dim=1, largest=False)
        cat_d = torch.cat([best_d, vals], dim=1)
        cat_i = torch.cat([best_i, idx + s], dim=1)
        best_d, pick = torch.topk(cat_d, min(k, cat_d.shape[1]), dim=1,
                                  largest=False)
        best_i = torch.gather(cat_i, 1, pick)
    return (best_d.to(torch.float64).cpu().numpy(),
            best_i.cpu().numpy())


def distances_of(rows: np.ndarray, queries: np.ndarray,
                 positions: np.ndarray, metric: str,
                 extra: np.ndarray | None = None) -> np.ndarray:
    """float64 distances of ``queries[i]`` to ``rows[positions[i, j]]``
    (``[S, k]``; NaN where the position is out of range).  Rows ``extra``
    follow ``rows``: position ``len(rows) + i`` is ``extra[i]``."""
    n_extra = 0 if extra is None else len(extra)
    ok = (positions >= 0) & (positions < len(rows) + n_extra)
    pos = np.where(ok, positions, 0)
    x = rows[np.minimum(pos, len(rows) - 1)].astype(np.float64)
    if n_extra:
        late = pos >= len(rows)
        x[late] = extra[pos[late] - len(rows)]
    q = queries.astype(np.float64)
    if metric == "cosine":
        xn = np.linalg.norm(x, axis=2, keepdims=True)
        x = x / np.where(xn > 0, xn, 1.0)
        qn = np.linalg.norm(q, axis=1, keepdims=True)
        q = q / np.where(qn > 0, qn, 1.0)
        d = 1.0 - np.einsum("skd,sd->sk", x, q)
    else:
        diff = x - q[:, None, :]
        d = np.einsum("skd,skd->sk", diff, diff)
    return np.where(ok, d, np.nan)
