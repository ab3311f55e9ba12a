"""Read-replica replication: logical write-record shipping.

The reference topology is a single writer with autoscaled read replicas
(``README.md:248``; the client's ``x-helix-require-writer`` header exists
to route writes, ``lib.rs:274-281``).  helix-tpu replicates the same way
it persists: every committed write batch is a deterministic logical
record (request + evaluation clock), so a replica is just an engine that
re-executes the primary's record stream in order.

- The primary keeps a sequence-numbered ring of committed write records
  (``RING_CAP``) and serves it at ``GET /v1/replication?after=<seq>``.
  A replica further behind than the ring (or joining fresh after a
  trim) bootstraps from ``GET /v1/snapshot`` — a consistent seed
  snapshot tagged with the replication watermark it was taken at —
  then resumes tailing the ring from that watermark.
- A replica runs a follower thread polling the primary and applying
  records under the engine's writer lock; its gateway rejects client
  writes with a pointer to the primary.

Port copy of ``helix_tpu/engine/replication.py`` for ``helix_tpu_torch``: it
imports the port's own copies of the framework-free modules (wire, dsl,
native, telemetry, fastjson), so importing this module loads nothing of
the JAX package.  ``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:
"""

from __future__ import annotations

import http.client
import threading
import urllib.error
import urllib.request
import uuid
from typing import Any

RING_CAP = 65536
# Byte cap on retained records: bulk-ingest records are multi-MB each
# (a 27 MB ForEach body is ONE record), so a record-count cap alone
# retains gigabytes — measured ~900 MB after 184 bulk writes in a 3-min
# soak.  Replicas that fall behind the byte window reseed from
# /v1/snapshot, the already-supported catch-up path.
RING_BYTES_CAP = 256 << 20
POLL_INTERVAL_S = 0.25


class ReplicationLog:
    """Primary-side ring of committed write records.

    Records carry ``bytes`` (the wire-size estimate used for the ring's
    byte cap) through the replication feed on purpose: followers reuse
    it so THEIR ring accounts bulk records truthfully too.  Absent
    (older primary), the follower falls back to the small-record
    default."""

    def __init__(self, cap: int = RING_CAP, bytes_cap: int = RING_BYTES_CAP):
        self.cap = cap
        self.bytes_cap = bytes_cap
        self._records: list[dict] = []
        self._bytes = 0
        self._start_seq = 0
        self._lock = threading.Lock()
        # Lineage token: ring sequence numbers are only comparable
        # within one epoch.  A restarted primary starts a fresh ring
        # (and a fresh epoch), so followers holding positions from the
        # previous process detect the change and reseed instead of
        # silently stalling or applying a colliding sequence space.
        self.epoch = uuid.uuid4().hex

    def append(
        self, request: dict, now_ms: int, approx_bytes: int | None = None
    ) -> int:
        if approx_bytes is None:
            # callers off the HTTP path (tests, embedded use) don't know
            # the wire size; assume a small record
            approx_bytes = 4096
        with self._lock:
            seq = self._start_seq + len(self._records)
            self._records.append(
                {"seq": seq, "now_ms": now_ms, "request": request,
                 "bytes": approx_bytes}
            )
            self._bytes += approx_bytes
            while len(self._records) > 1 and (
                len(self._records) > self.cap or self._bytes > self.bytes_cap
            ):
                dropped = self._records.pop(0)
                self._bytes -= dropped.get("bytes", 0)
                self._start_seq += 1
            return seq

    # One replication page stops at this many bytes (bulk-ingest
    # records are multi-MB; an uncapped 512-record page could serialize
    # the whole 256 MB ring into one response body on both sides).
    PAGE_BYTES = 32 << 20

    def since(self, after_seq: int, limit: int = 512) -> tuple[list[dict], bool]:
        """(records with seq > after_seq, caller_must_reseed)."""
        with self._lock:
            head = self._start_seq + len(self._records) - 1
            if after_seq + 1 < self._start_seq or after_seq > head:
                # behind the ring, or holding a position this ring never
                # issued (previous primary epoch)
                return [], True
            start = max(after_seq + 1 - self._start_seq, 0)
            out: list[dict] = []
            total = 0
            for record in self._records[start:start + limit]:
                out.append(record)
                total += record.get("bytes", 0)
                if total >= self.PAGE_BYTES:
                    break
            return out, False

    def head_seq(self) -> int:
        with self._lock:
            return self._start_seq + len(self._records) - 1

    def reset_to(self, next_seq: int) -> None:
        """Drop all records and continue numbering at ``next_seq``
        (replica seeded from a snapshot watermark).  The epoch rolls:
        cascaded followers of this node must reseed too."""
        with self._lock:
            self._records = []
            self._bytes = 0
            self._start_seq = next_seq
            self.epoch = uuid.uuid4().hex


class _SeedUnpickler:
    """Restricted unpickler for seed snapshots fetched over the wire.

    The seed payload only ever contains plain containers, scalars, and
    numpy arrays — a malicious or corrupted primary response cannot
    smuggle arbitrary callables through pickle.  Shares the allowlist
    with disk-snapshot loading (:mod:`helix_tpu.engine.persist`)."""

    @classmethod
    def loads(cls, data: bytes):
        from .persist import restricted_loads

        return restricted_loads(data)

    @classmethod
    def load(cls, fileobj):
        from .persist import restricted_load

        return restricted_load(fileobj)


class Follower:
    """Replica-side thread applying the primary's record stream."""

    def __init__(self, engine: Any, primary_url: str, api_key: str | None = None):
        self.engine = engine
        self.primary_url = primary_url.rstrip("/")
        self.api_key = api_key
        self.applied_seq = -1
        # primary lineage this replica's position belongs to; None
        # forces a reseed on (re)connect, which is also how apply
        # failures bound their damage (reseed > silently skipping)
        self.primary_epoch: str | None = None
        # set when a record fails to apply: reseed on the next loop even
        # against a pre-epoch primary (whose feed carries no epoch to
        # trigger the lineage check)
        self._force_reseed = False
        self.last_error: str | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _fetch(self) -> dict:
        url = f"{self.primary_url}/v1/replication?after={self.applied_seq}"
        req = urllib.request.Request(url, method="GET")
        if self.api_key:
            req.add_header("Authorization", f"Bearer {self.api_key}")
        with urllib.request.urlopen(req, timeout=30) as resp:
            # native codec with the numeric-array fast path: bulk
            # ingest records are multi-MB vector bodies, and the
            # follower re-parses every one the primary accepted
            from .. import fastjson

            return fastjson.loads(resp.read(), fast_arrays=True)

    def _reseed(self) -> None:
        """Bootstrap from the primary's seed snapshot when this replica
        is behind the record ring (fresh replica, or ring trimmed past
        our position).  ``GET /v1/snapshot`` returns a consistent
        snapshot plus the replication watermark it was taken at; we
        replace local state wholesale and resume tailing from there."""
        url = f"{self.primary_url}/v1/snapshot"
        req = urllib.request.Request(url, method="GET")
        if self.api_key:
            req.add_header("Authorization", f"Bearer {self.api_key}")
        with urllib.request.urlopen(req, timeout=600) as resp:
            # stream-unpickle off the socket: no full-seed byte buffer
            seed = _SeedUnpickler.load(resp)
        self.engine.load_replica_seed(seed)
        self.applied_seq = seed["seed_seq"]
        seed_epoch = seed.get("epoch")
        if seed_epoch is not None:
            # the epoch the seed was EXPORTED under, not the one we
            # fetched before the (possibly minutes-long) download — a
            # primary restart mid-download must not waste this seed
            self.primary_epoch = seed_epoch
        self.last_error = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                payload = self._fetch()
            except (
                urllib.error.URLError, OSError, ValueError,
                http.client.HTTPException,
            ) as exc:
                # ValueError covers both stdlib JSONDecodeError and the
                # native codec's parse errors; HTTPException covers
                # connections dropped mid-body (IncompleteRead).  The
                # follower thread must never die silently.
                self.last_error = str(exc)
                self._stop.wait(POLL_INTERVAL_S * 4)
                continue
            epoch = payload.get("epoch")
            if (
                payload.get("reseed_required")
                or self._force_reseed
                or (epoch is not None and epoch != self.primary_epoch)
            ):
                # new primary lineage (restart, or our first contact):
                # sequence numbers are not comparable across epochs
                try:
                    self._reseed()
                    self._force_reseed = False
                    if self.primary_epoch is None:
                        # pre-epoch seed payload: fall back to the
                        # epoch the feed reported
                        self.primary_epoch = epoch
                except Exception as exc:
                    self.last_error = f"reseed failed: {exc}"
                    self._stop.wait(POLL_INTERVAL_S * 4)
                continue
            records = payload.get("records", [])
            for record in records:
                try:
                    self.engine.apply_replicated(
                        record["request"], record["now_ms"],
                        request_bytes=record.get("bytes"),
                    )
                    self.applied_seq = record["seq"]
                except Exception as exc:
                    # a record this replica cannot apply leaves it
                    # divergent: reseed from the primary's snapshot
                    # rather than skipping the write forever — but
                    # BACK OFF first: a deterministically failing
                    # record would otherwise drive an unthrottled
                    # full-snapshot reseed loop against the primary
                    self.last_error = (
                        f"apply failed at seq {record['seq']}: {exc}; reseeding"
                    )
                    self.primary_epoch = None
                    self._force_reseed = True
                    self._stop.wait(POLL_INTERVAL_S * 8)
                    break
            if not records:
                self._stop.wait(POLL_INTERVAL_S)
