"""The comparison that decides ``correct``: the answers the timed path
returned, for a sample of its queries drawn from the seed, against the
plain reference (:mod:`hxbench.reference`).

Numbers compared, each with its limit (the configuration's
``guarantees``):

- ``failed``: requests that failed, were refused or never answered (0).
- ``bad_answers``: answers with fewer than k hits, an id outside the
  corpus, or an id twice (0).
- ``dist_err``: the widest gap between a returned distance and the
  reference's float64 distance of the returned id; absolute for cosine,
  relative to that distance (at least 1) for l2.
- ``recall_miss``: 1 - recall@k, a returned id counting as a hit where
  its reference distance is within the reference's k-th (ties count).
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference

TIE = 1e-12
# answers compared per run
SAMPLE = 2048


def sample(n_answered: int, size: int, seed: int) -> np.ndarray:
    """Indices of the answers to compare, drawn from the seed."""
    rng = np.random.default_rng([seed % (1 << 64), 4])
    if n_answered <= size:
        return np.arange(n_answered)
    return np.sort(rng.choice(n_answered, size=size, replace=False))


def limits(config: dict) -> dict:
    g = config["guarantees"]
    return {"failed": 0, "bad_answers": 0,
            "dist_err": float(g["distance"]["limit"]),
            "recall_miss": round(1.0 - float(g["recall_at_k_min"]), 12)}


def numbers(served_ids: np.ndarray, served_dists: np.ndarray,
            queries: np.ndarray, rows: np.ndarray, config: dict,
            device: torch.device, ref: tuple | None = None) -> dict:
    """The compared numbers for answers ``[S, k]`` (element ids, which the
    harness assigns as row position + 1; distances, NaN where missing)
    to ``queries [S, D]`` over ``rows``.  ``ref`` is the reference's
    ``exact_topk`` for the same queries where already worked out."""
    k, metric = int(config["k"]), config["metric"]
    served_ids = np.asarray(served_ids, np.int64)[:, :k]
    served_dists = np.asarray(served_dists, np.float64)[:, :k]
    short = k - served_ids.shape[1]
    if short:
        served_ids = np.pad(served_ids, ((0, 0), (0, short)))
        served_dists = np.pad(served_dists, ((0, 0), (0, short)),
                              constant_values=np.nan)
    pos = served_ids - 1
    in_range = (pos >= 0) & (pos < len(rows))
    first = np.ones_like(in_range)
    for j in range(1, k):
        first[:, j] = ~(pos[:, :j] == pos[:, j:j + 1]).any(axis=1)
    bad = ~(in_range & first).all(axis=1)
    ref_d, _ = ref if ref is not None else reference.exact_topk(
        rows, queries, k, metric, device)
    kth = ref_d[:, k - 1:k]
    exact = reference.distances_of(rows, queries, pos, metric)
    if config["guarantees"]["distance"]["kind"] == "relative":
        scale = np.maximum(np.abs(exact), 1.0)
    else:
        scale = 1.0
    gap = np.abs(served_dists - exact) / scale
    gap = np.where(in_range, gap, np.inf)
    hits = in_range & first & (exact <= kth * (1 + TIE) + TIE)
    return {
        "bad_answers": int(bad.sum()),
        "dist_err": float(np.nanmax(np.where(np.isnan(gap), np.inf, gap))),
        "recall_miss": float(1.0 - hits.sum() / (len(pos) * k)),
    }


def verdict(found: dict, limit: dict) -> tuple[bool, dict]:
    """``(correct, {name: [number, limit]})``: every number at or under
    its limit."""
    checked = {name: [found[name], limit[name]] for name in limit}
    ok = all(np.isfinite(v) and v <= lim for v, lim in checked.values())
    return bool(ok), checked
