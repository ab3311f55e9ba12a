"""Readers-writer lock for the engine's single-writer concurrency model.

The reference topology is one writer + autoscaled readers
(``README.md:248``).  In-process, reads execute concurrently against the
store while a write batch must be exclusive: the interpreter walks store
dicts and adjacency lists directly, so a concurrent mutation could
surface torn state.  Writer-preference keeps bulk ingests from starving
behind a read storm.

Port copy of ``helix_tpu/engine/rwlock.py`` for ``helix_tpu_torch``: it
imports the port's own copies of the framework-free modules (wire, dsl,
native, telemetry, fastjson), so importing this module loads nothing of
the JAX package.  ``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in: nothing.
"""

from __future__ import annotations

import threading


class RWLock:
    def __init__(self):
        self._lock = threading.Lock()
        self._readers_ok = threading.Condition(self._lock)
        self._writers_ok = threading.Condition(self._lock)
        self._readers = 0
        self._writers_waiting = 0
        self._writing = False

    def acquire_read(self) -> None:
        with self._lock:
            while self._writing or self._writers_waiting:
                self._readers_ok.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._lock:
            self._readers -= 1
            if self._readers == 0:
                self._writers_ok.notify()

    def acquire_write(self) -> None:
        with self._lock:
            self._writers_waiting += 1
            while self._writing or self._readers:
                self._writers_ok.wait()
            self._writers_waiting -= 1
            self._writing = True

    def release_write(self) -> None:
        with self._lock:
            self._writing = False
            self._writers_ok.notify()
            self._readers_ok.notify_all()

    class _ReadGuard:
        def __init__(self, lock: "RWLock"):
            self._lock = lock

        def __enter__(self):
            self._lock.acquire_read()

        def __exit__(self, *exc):
            self._lock.release_read()

    class _WriteGuard:
        def __init__(self, lock: "RWLock"):
            self._lock = lock

        def __enter__(self):
            self._lock.acquire_write()

        def __exit__(self, *exc):
            self._lock.release_write()

    def read(self) -> "_ReadGuard":
        return self._ReadGuard(self)

    def write(self) -> "_WriteGuard":
        return self._WriteGuard(self)
