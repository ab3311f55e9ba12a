"""The corpus, oracle and recall of ``benchmarks/ladder.py`` (PyTorch
port; the ladder itself is not ported yet).

``bench.py``'s headline configuration: 1000 cluster centres drawn from
seed 42, rows and queries a centre plus N(0, 0.3^2) noise, normalised.
numpy only, as in the reference.

Difference from the reference: :func:`_oracle` selects each chunk's top
k with ``argpartition`` and sorts only those, where the reference sorts
every score (``argsort`` over 1M columns, slow on a slow host); the ids
are the same wherever no two scores tie at rank k.
"""

from __future__ import annotations

import numpy as np


def _corpus(n: int, d: int, batch: int, n_batches: int):
    rng = np.random.default_rng(42)
    n_clusters = 1000
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    parts = []
    chunk = 1_000_000
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        assign = rng.integers(0, n_clusters, size=e - s)
        block = centers[assign] + 0.3 * rng.normal(size=(e - s, d)).astype(
            np.float32
        )
        block /= np.linalg.norm(block, axis=1, keepdims=True) + 1e-9
        parts.append(block)
    data = np.concatenate(parts) if len(parts) > 1 else parts[0]
    queries = centers[rng.integers(0, n_clusters, size=batch * n_batches)] + \
        0.3 * rng.normal(size=(batch * n_batches, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-9
    return data, queries


def _top(sims: np.ndarray, k: int) -> np.ndarray:
    """Column indices of each row's k largest scores, descending."""
    k = min(k, sims.shape[1])
    part = np.argpartition(-sims, k - 1, axis=1)[:, :k]
    order = np.argsort(-np.take_along_axis(sims, part, axis=1), axis=1,
                       kind="stable")
    return np.take_along_axis(part, order, axis=1)


def _oracle(data: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """Blocked exact scan (host): top-k ids per query."""
    b = len(queries)
    best = np.full((b, 0), 0.0)
    best_i = np.zeros((b, 0), np.int64)
    chunk = 1_000_000
    for s in range(0, len(data), chunk):
        e = min(len(data), s + chunk)
        sims = queries @ data[s:e].T
        ci = _top(sims, k)
        cs = np.take_along_axis(sims, ci, axis=1)
        best = np.concatenate([best, cs], axis=1)
        best_i = np.concatenate([best_i, ci + s], axis=1)
        keep = np.argsort(-best, axis=1, kind="stable")[:, :k]
        best = np.take_along_axis(best, keep, axis=1)
        best_i = np.take_along_axis(best_i, keep, axis=1)
    return best_i


def _recall(ids: np.ndarray, oracle: np.ndarray, k: int) -> float:
    return float(np.mean([
        len(set(ids[i][ids[i] >= 0]) & set(oracle[i])) / k
        for i in range(len(oracle))
    ]))
