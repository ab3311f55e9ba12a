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
- ``unread_writes`` (mixes with inserts alone): answers whose query was
  an acknowledged insert's own row, visible to it, and whose own id is
  not among the k returned at a distance within ``dist_err``'s limit of
  0 (0).  Those are the window's latest queries (``latest_share``) and
  the read-back after it: the newest acknowledged inserts, up to one
  batch, each searched with its own row once every insert is visible.

Under a write mix the guarantee is read-your-writes: a search returns
every row whose insert was acknowledged before the search was
dispatched, and may return rows acknowledged before its ``finalize()``
returned.  So each answer's reference k-th distance is over the built
rows and the inserts acknowledged before its dispatch, an id is in range
up to the rows acknowledged before its finalize, and every distance is
held to its true row, inserted or not.  The read-back's answers are
compared so too, with every insert acknowledged before them.
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


def limits(config: dict, writes: bool = False) -> dict:
    g = config["guarantees"]
    out = {"failed": 0, "bad_answers": 0,
           "dist_err": float(g["distance"]["limit"]),
           "recall_miss": round(1.0 - float(g["recall_at_k_min"]), 12)}
    if writes:
        out["unread_writes"] = 0
    return out


def numbers(served_ids: np.ndarray, served_dists: np.ndarray,
            queries: np.ndarray, rows: np.ndarray, config: dict,
            device: torch.device, ref: tuple | None = None,
            writes: dict | None = None) -> dict:
    """The compared numbers for answers ``[S, k]`` (element ids, which the
    harness assigns as row position + 1; distances, NaN where missing)
    to ``queries [S, D]`` over ``rows``.  ``ref`` is the reference's
    ``exact_topk`` for the same queries where already worked out.
    ``writes`` (a write mix, :meth:`hxbench.loops.EngineLoop.sample`):
    the acknowledged inserts ``inserts [M, D]``, at positions
    ``len(rows)`` on, and per answer the count acknowledged before its
    dispatch (``seen [S]``) and before its finalize (``acked [S]``), and
    the insert whose own row it searched with (``own [S]``, -1 for
    none); the numbers then include ``unread_writes``."""
    k, metric = int(config["k"]), config["metric"]
    served_ids = np.asarray(served_ids, np.int64)[:, :k]
    served_dists = np.asarray(served_dists, np.float64)[:, :k]
    short = k - served_ids.shape[1]
    if short:
        served_ids = np.pad(served_ids, ((0, 0), (0, short)))
        served_dists = np.pad(served_dists, ((0, 0), (0, short)),
                              constant_values=np.nan)
    pos = served_ids - 1
    extra, bound = None, len(rows)
    if writes is not None:
        extra = np.asarray(writes["inserts"], np.float32)
        bound = len(rows) + np.asarray(writes["acked"], np.int64)[:, None]
    in_range = (pos >= 0) & (pos < bound)
    first = np.ones_like(in_range)
    for j in range(1, k):
        first[:, j] = ~(pos[:, :j] == pos[:, j:j + 1]).any(axis=1)
    bad = ~(in_range & first).all(axis=1)
    ref_d, _ = ref if ref is not None else reference.exact_topk(
        rows, queries, k, metric, device)
    if extra is not None and len(extra):
        new_d, _ = reference.exact_topk(extra, queries, k, metric, device,
                                        visible=writes["seen"])
        ref_d = np.sort(np.concatenate([ref_d, new_d], axis=1), axis=1)
    kth = ref_d[:, k - 1:k]
    exact = reference.distances_of(rows, queries, pos, metric, extra)
    if config["guarantees"]["distance"]["kind"] == "relative":
        scale = np.maximum(np.abs(exact), 1.0)
    else:
        scale = 1.0
    gap = np.abs(served_dists - exact) / scale
    gap = np.where(in_range, gap, np.inf)
    hits = in_range & first & (exact <= kth * (1 + TIE) + TIE)
    out = {
        "bad_answers": int(bad.sum()),
        "dist_err": float(np.nanmax(np.where(np.isnan(gap), np.inf, gap))),
        "recall_miss": float(1.0 - hits.sum() / (len(pos) * k)),
    }
    if writes is not None:
        own = np.asarray(writes["own"], np.int64)
        mine = own >= 0
        out["unread_writes"] = unread_writes(
            len(rows) + own[mine] + 1, served_ids[mine], served_dists[mine],
            float(config["guarantees"]["distance"]["limit"]))
    return out


def unread_writes(own: np.ndarray, ids: np.ndarray, dists: np.ndarray,
                  limit: float) -> int:
    """Searches ``[R]`` with an insert's own row whose own id is not among
    the returned ``ids [R, k']`` at a distance within ``limit`` of 0 (a
    row's distance to itself)."""
    ids = np.asarray(ids).astype(np.int64)
    near = np.abs(np.asarray(dists, np.float64)) <= limit
    found = ((ids == np.asarray(own, np.int64)[:, None]) & near).any(axis=1)
    return int((~found).sum())


def verdict(found: dict, limit: dict) -> tuple[bool, dict]:
    """``(correct, {name: [number, limit]})``: every number at or under
    its limit."""
    checked = {name: [found[name], limit[name]] for name in limit}
    ok = all(np.isfinite(v) and v <= lim for v, lim in checked.values())
    return bool(ok), checked
