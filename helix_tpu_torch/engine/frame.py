"""Traverser stream frames.

A frame is the interpreter's unit of dataflow: a bag of traversers (node
ids, edge ids, or projected rows) with row-aligned metadata columns:

- ``dist`` — vector-hit distance (``$distance``), carried until a traversal
  step leaves the hit stream (reference contract ``dsl.rs:129-155``)
- ``score`` — BM25 text score (``$score``)
- ``src`` — provenance: index of the originating traverser of the current
  sub-pipeline (drives per-traverser Coalesce/Optional/Choose and ForEach)
- ``bindings`` — row-local captures made by ``Bind`` (wire v5), each a
  (kind, ids, dist, score) tuple aligned with the rows

Every shaping operation goes through :meth:`take` (subset/reorder) or
:meth:`expand` (fan-out via a src-row map), which keep all columns aligned.

Port copy of ``helix_tpu/engine/frame.py`` for ``helix_tpu_torch``: it
imports the port's own copies of the framework-free modules (wire, dsl,
native, telemetry, fastjson), so importing this module loads nothing of
the JAX package.  ``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in: nothing.
"""

from __future__ import annotations

from typing import Any

import numpy as np

UINT64 = np.uint64


class Binding:
    __slots__ = ("kind", "ids", "dist", "score")

    def __init__(self, kind: str, ids: np.ndarray, dist=None, score=None):
        self.kind = kind
        self.ids = ids
        self.dist = dist
        self.score = score

    def take(self, idx: np.ndarray) -> "Binding":
        return Binding(
            self.kind,
            self.ids[idx],
            None if self.dist is None else self.dist[idx],
            None if self.score is None else self.score[idx],
        )


class Frame:
    __slots__ = ("kind", "ids", "rows", "dist", "score", "_src", "bindings", "anchor")

    def __init__(
        self,
        kind: str,
        ids: np.ndarray | None = None,
        rows: list[Any] | None = None,
        dist: np.ndarray | None = None,
        score: np.ndarray | None = None,
        src: np.ndarray | None = None,
        bindings: dict[str, Binding] | None = None,
        anchor: np.ndarray | None = None,
    ):
        self.kind = kind  # 'nodes' | 'edges' | 'rows'
        self.ids = ids if ids is not None else np.empty(0, UINT64)
        self.rows = rows
        self.dist = dist
        self.score = score
        self._src = src  # lazy: materialized as arange on first access
        self.bindings = bindings or {}
        # For edge frames reached via OutE/InE/BothE: the node each edge was
        # reached from (drives OtherN). None for direct edge sources.
        self.anchor = anchor

    @property
    def src(self) -> np.ndarray:
        """Provenance rows (which input traverser produced each element);
        identity by default, materialized lazily (hot write paths never
        touch it)."""
        if self._src is None:
            n = (
                len(self.rows)
                if self.kind == "rows" and self.rows is not None
                else len(self.ids)
            )
            self._src = np.arange(n, dtype=np.int64)
        return self._src

    @src.setter
    def src(self, value: np.ndarray) -> None:
        self._src = value

    # -- constructors -----------------------------------------------------

    @staticmethod
    def empty(kind: str = "nodes") -> "Frame":
        return Frame(kind)

    @staticmethod
    def nodes(ids, dist=None, score=None) -> "Frame":
        return Frame("nodes", np.asarray(ids, UINT64), dist=dist, score=score)

    @staticmethod
    def edges(ids, dist=None, score=None) -> "Frame":
        return Frame("edges", np.asarray(ids, UINT64), dist=dist, score=score)

    @staticmethod
    def of_rows(rows: list[Any]) -> "Frame":
        return Frame("rows", rows=list(rows))

    # -- basics -----------------------------------------------------------

    def __len__(self) -> int:
        if self.kind == "rows":
            return len(self.rows or [])
        return len(self.ids)

    def is_elements(self) -> bool:
        return self.kind in ("nodes", "edges")

    def copy(self) -> "Frame":
        return Frame(
            self.kind,
            None if self.ids is None else self.ids.copy(),
            None if self.rows is None else list(self.rows),
            None if self.dist is None else self.dist.copy(),
            None if self.score is None else self.score.copy(),
            # keep provenance lazy: forcing self.src here would allocate
            # an O(n) arange on every Union branch / Bind even when no
            # consumer ever reads it
            None if self._src is None else self._src.copy(),
            dict(self.bindings),
            None if self.anchor is None else self.anchor.copy(),
        )

    # -- aligned shaping ----------------------------------------------------

    def take(self, idx: np.ndarray) -> "Frame":
        """Subset/reorder rows by positional index, keeping columns aligned."""
        idx = np.asarray(idx, np.int64)
        if self.kind == "rows":
            rows = [self.rows[i] for i in idx]
            return Frame(
                "rows", rows=rows, src=self.src[idx],
                bindings={k: b.take(idx) for k, b in self.bindings.items()},
            )
        return Frame(
            self.kind,
            self.ids[idx],
            dist=None if self.dist is None else self.dist[idx],
            score=None if self.score is None else self.score[idx],
            src=self.src[idx],
            bindings={k: b.take(idx) for k, b in self.bindings.items()},
            anchor=None if self.anchor is None else self.anchor[idx],
        )

    def mask(self, keep: np.ndarray) -> "Frame":
        return self.take(np.nonzero(keep)[0])

    def expand(self, src_rows: np.ndarray, new_kind: str, new_ids: np.ndarray,
               anchor: np.ndarray | None = None) -> "Frame":
        """Fan-out: each output row comes from input row ``src_rows[i]``.

        Hit metadata does NOT survive expansion (the traversal left the hit
        stream); bindings and provenance do.
        """
        src_rows = np.asarray(src_rows, np.int64)
        return Frame(
            new_kind,
            np.asarray(new_ids, UINT64),
            src=self.src[src_rows],
            bindings={k: b.take(src_rows) for k, b in self.bindings.items()},
            anchor=anchor,
        )

    def with_binding(self, name: str) -> "Frame":
        """Capture the current element stream under ``name`` (Bind step)."""
        out = self.copy()
        out.bindings[name] = Binding(
            self.kind,
            self.ids.copy(),
            None if self.dist is None else self.dist.copy(),
            None if self.score is None else self.score.copy(),
        )
        return out

    def reset_src(self) -> "Frame":
        """Start a new provenance scope (entering a sub-pipeline)."""
        out = self.copy()
        out.src = np.arange(len(out), dtype=np.int64)
        return out


def _merge_bindings(frames: list[Frame]) -> dict[str, Binding]:
    """Bindings present in ALL parts concatenate row-aligned; their
    dist/score columns survive the merge (NaN-filled where a part lacks
    them), exactly like the frame-level hit metadata."""
    shared = set(frames[0].bindings)
    for f in frames[1:]:
        shared &= set(f.bindings)
    bindings = {}
    for name in shared:
        parts = [f.bindings[name] for f in frames]
        if any(p.kind != parts[0].kind for p in parts):
            continue
        dist = (
            np.concatenate([
                p.dist if p.dist is not None else np.full(len(p.ids), np.nan)
                for p in parts
            ])
            if any(p.dist is not None for p in parts)
            else None
        )
        score = (
            np.concatenate([
                p.score if p.score is not None else np.full(len(p.ids), np.nan)
                for p in parts
            ])
            if any(p.score is not None for p in parts)
            else None
        )
        bindings[name] = Binding(
            parts[0].kind, np.concatenate([p.ids for p in parts]),
            dist, score,
        )
    return bindings


def concat_frames(frames: list[Frame]) -> Frame:
    """Concatenate compatible frames (same kind); bindings kept only when
    present in all parts."""
    # The empty result's KIND comes from the inputs, not a default: an
    # all-empty concat of edge frames must stay an edge stream (a
    # follow-on endpoint step would otherwise reject a valid query).
    kind = frames[0].kind if frames else "nodes"
    frames = [f for f in frames if len(f) > 0]
    if not frames:
        return Frame.empty(kind)
    kind = frames[0].kind
    if any(f.kind != kind for f in frames):
        # Mixed kinds collapse to rows of encoded elements; callers that
        # need mixed streams (Union over node+edge branches) handle encoding.
        raise ValueError("cannot concatenate frames of different kinds")
    src = np.concatenate([f.src for f in frames])
    if kind == "rows":
        rows: list[Any] = []
        for f in frames:
            rows.extend(f.rows or [])
        return Frame("rows", rows=rows, src=src,
                     bindings=_merge_bindings(frames))
    ids = np.concatenate([f.ids for f in frames])
    dist = (
        np.concatenate([
            f.dist if f.dist is not None else np.full(len(f), np.nan) for f in frames
        ])
        if any(f.dist is not None for f in frames)
        else None
    )
    score = (
        np.concatenate([
            f.score if f.score is not None else np.full(len(f), np.nan) for f in frames
        ])
        if any(f.score is not None for f in frames)
        else None
    )
    # Anchors survive only when EVERY part has them (a part without
    # anchors has no meaningful fill value — OtherN falls back to
    # dst-endpoint semantics for the merged stream).
    anchor = (
        np.concatenate([f.anchor for f in frames])
        if all(f.anchor is not None for f in frames)
        else None
    )
    return Frame(kind, ids, dist=dist, score=score, src=src,
                 bindings=_merge_bindings(frames), anchor=anchor)
