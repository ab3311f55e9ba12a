"""The port's own host spans and counters, kept in memory.

Nothing is recorded unless a ``torch.profiler`` records in the process:
the tracer reads the profiler's process-wide flag
(``torch.autograd.profiler._is_profiler_enabled``, set on every thread
while a profiler records), not the thread-local
``torch.autograd._profiler_enabled()``.  So a process that runs no
profiler pays one global read per span and allocates nothing, and a
profiled window records exactly its spans.  There is no switch of its
own: an operator who wants the spans runs a profiler, as for a device
trace.

- :func:`span` is a context manager.  Its parent is, unless given, the
  innermost span open on the calling thread.  While recording it also
  opens a user annotation named ``name`` in the profiler, as
  ``torch.profiler.record_function`` does, so a span on the profiled
  thread lands in the profiler's trace, on its clock.
- :func:`record` adds a span timed elsewhere, e.g. one that starts on one
  thread and ends on another.
- :func:`count` adds to a counter.
- :func:`recording` says whether anything records now, for a caller
  whose count costs work of its own to make.
- :func:`snapshot` reads what was recorded since the process started or
  the last :func:`clear`, without taking it away.

Timestamps are ``time.time_ns()``: the unix clock in nanoseconds.  A
Chrome trace exported by the profiler puts its CPU events at ``ts`` µs
after ``baseTimeNanoseconds`` on that clock, so ``ts +
baseTimeNanoseconds / 1000`` places a profiler event and ``t0_ns /
1000`` places a span on one timeline, including spans of threads the
profiler did not trace.

The buffer holds at most :data:`CAPACITY` spans; later ones are counted
in ``dropped`` and not kept.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

from torch._C._autograd import (
    _record_function_with_args_enter as _annotate,
    _record_function_with_args_exit as _end_annotation,
)
from torch.autograd import profiler as _profiler

# ``_annotate`` / ``_end_annotation`` open and close the same
# ``user_annotation`` event as ``torch.profiler.record_function``, which
# goes through ``torch.ops.profiler._record_function_enter_new`` and a
# Python wrapper: 4-9 µs a span against 12-22 under the profiler on an
# H100 host.

CAPACITY = 1 << 20

_spans: list[tuple] = []
_counts: dict[str, float] = {}
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)


class _Thread(threading.local):
    """Each thread's open spans, and its native id, read once: it is a
    system call."""

    def __init__(self):
        self.stack: list = []
        self.tid = threading.get_native_id()


_local = _Thread()


class Snapshot(NamedTuple):
    # (name, id, parent id or None, native thread id, t0_ns, t1_ns)
    spans: list
    counts: dict
    dropped: int


def _add(row: tuple) -> None:
    global _dropped
    with _lock:
        if len(_spans) < CAPACITY:
            _spans.append(row)
        else:
            _dropped += 1


class _Off:
    """What :func:`span` returns while nothing records."""

    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "t0", "_annotation")

    def __init__(self, name: str, parent: int | None):
        self.name = name
        self.id = next(_ids)
        self.parent = parent

    def __enter__(self):
        stack = _local.stack
        if self.parent is None and stack:
            self.parent = stack[-1].id
        stack.append(self)
        self._annotation = _annotate(self.name)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        _end_annotation(self._annotation)
        _local.stack.pop()
        _add((self.name, self.id, self.parent, _local.tid, self.t0, t1))
        return False


def span(name: str, parent: int | None = None):
    """A span named ``name`` around the ``with`` block; ``.id`` is its id
    (``None`` while nothing records)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, parent)


def record(name: str, t0_ns: int, t1_ns: int,
           parent: int | None = None) -> int | None:
    """Add a span timed by the caller (``time.time_ns()``); its id, or
    ``None`` while nothing records."""
    if not _profiler._is_profiler_enabled:
        return None
    sid = next(_ids)
    _add((name, sid, parent, _local.tid, t0_ns, t1_ns))
    return sid


def recording() -> bool:
    """Whether spans and counters record now (a profiler records)."""
    return bool(_profiler._is_profiler_enabled)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not _profiler._is_profiler_enabled:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def snapshot() -> Snapshot:
    with _lock:
        return Snapshot(list(_spans), dict(_counts), _dropped)


def clear() -> None:
    global _dropped
    with _lock:
        _spans.clear()
        _counts.clear()
        _dropped = 0
