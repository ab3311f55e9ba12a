"""Telemetry pipeline: buffered events, levels, opt-out.

Per-query success and error events with their latency, buffered in
memory and drained by a background thread to a local JSONL sink;
levels ``full`` / ``basic`` / ``off`` and opt-out via
``HELIX_TPU_METRICS=off``.  The engine holds a :class:`NullTelemetry`
unless a caller installs a :class:`Telemetry`.

Port copy of ``helix_tpu/telemetry.py`` (standard library only).
``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's.

Differs from the reference in: nothing.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any

BUFFER_CAP = 4096
FLUSH_AT = 2048
FLUSH_INTERVAL_S = 1.0

LEVEL_FULL = "full"
LEVEL_BASIC = "basic"
LEVEL_OFF = "off"

# Events always sent at `basic`; everything else needs `full`
# (mirrors the Basic/Full split in metrics_sender.rs).
BASIC_EVENTS = frozenset(
    {"install", "deploy_local", "redeploy_local", "instance_start",
     "instance_stop", "query_error", "write_error", "read_error"}
)


def _credentials_opt_out() -> bool:
    path = Path.home() / ".helix-tpu" / "credentials"
    try:
        for line in path.read_text().splitlines():
            key, _, value = line.partition("=")
            if key.strip() == "metrics" and value.strip().lower() == "false":
                return True
    except OSError:
        pass
    return False


def resolve_level(explicit: str | None = None) -> str:
    if explicit is not None:
        return explicit
    env = os.environ.get("HELIX_TPU_METRICS", "").lower()
    if env in (LEVEL_FULL, LEVEL_BASIC, LEVEL_OFF):
        return env
    if env in ("0", "false", "off"):
        return LEVEL_OFF
    if _credentials_opt_out():
        return LEVEL_OFF
    return LEVEL_BASIC


class Telemetry:
    """Buffered event collector with a background flusher."""

    RING_CAP = 1024

    def __init__(
        self,
        sink_path: str | Path | None = None,
        level: str | None = None,
        clock=time.time,
        remote_url: str | None = None,
        remote_key: str | None = None,
    ):
        self.level = resolve_level(level)
        self.sink_path = Path(sink_path) if sink_path else None
        # Remote sink (the reference's logs-service POST,
        # metrics/src/lib.rs:50 / :220-298): batches additionally POST
        # to ``remote_url`` as {"events": [...]} with an optional
        # bearer.  Configured explicitly or via HELIX_TPU_LOGS_URL /
        # HELIX_TPU_LOGS_KEY — pointed at the in-repo control plane's
        # /api/cli/logs/<cluster_id> it feeds `logs --start/--end`.
        self.remote_url = remote_url or os.environ.get("HELIX_TPU_LOGS_URL")
        self.remote_key = remote_key or os.environ.get("HELIX_TPU_LOGS_KEY")
        self._clock = clock
        self._buffer: list[dict] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Live-subscriber ring (SSE event stream): monotonically numbered
        # events, condition-signaled on append.
        self._ring: list[dict] = []
        self._ring_start = 0
        self._ring_cond = threading.Condition()
        if self.level != LEVEL_OFF and (
            self.sink_path is not None or self.remote_url is not None
        ):
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    # -- producer side ---------------------------------------------------

    def log_event(self, kind: str, **fields: Any) -> None:
        if self.level == LEVEL_OFF:
            return
        if self.level == LEVEL_BASIC and kind not in BASIC_EVENTS:
            return
        event = {"event": kind, "ts_ms": int(self._clock() * 1000), **fields}
        flush_now = False
        with self._ring_cond:
            event["seq"] = self._ring_start + len(self._ring)
            self._ring.append(event)
            if len(self._ring) > self.RING_CAP:
                drop = len(self._ring) - self.RING_CAP
                self._ring = self._ring[drop:]
                self._ring_start += drop
            self._ring_cond.notify_all()
            # buffer append under the SAME lock that assigned seq:
            # releasing in between let a later seq win the buffer race
            # and the sink file record history out of order
            with self._lock:
                if len(self._buffer) >= BUFFER_CAP:
                    self._buffer.pop(0)  # drop-oldest under pressure
                self._buffer.append(event)
                flush_now = len(self._buffer) >= FLUSH_AT
        if flush_now:
            self.flush()

    def query_event(
        self,
        success: bool,
        query_name: str | None,
        request_type: str,
        time_taken_usec: int,
        error: str | None = None,
    ) -> None:
        """Per-query event (events.rs:232-273 analog)."""
        kind = "query_success" if success else "query_error"
        fields: dict[str, Any] = {
            "query_name": query_name,
            "request_type": request_type,
            "time_taken_usec": time_taken_usec,
        }
        if error is not None:
            fields["error"] = error
        self.log_event(kind, **fields)

    # -- sender side ------------------------------------------------------

    def flush(self) -> None:
        with self._lock:
            batch, self._buffer = self._buffer, []
        if not batch:
            return
        self._send(batch)

    def _send(self, batch: list[dict]) -> None:
        if self.sink_path is not None:
            try:
                self.sink_path.parent.mkdir(parents=True, exist_ok=True)
                with open(self.sink_path, "a", encoding="utf-8") as fh:
                    for event in batch:
                        fh.write(json.dumps(event, ensure_ascii=False) + "\n")
            except OSError:
                pass  # telemetry must never take the engine down
        if self.remote_url is not None:
            import urllib.request

            headers = {"Content-Type": "application/json"}
            if self.remote_key:
                headers["Authorization"] = f"Bearer {self.remote_key}"
            try:
                req = urllib.request.Request(
                    self.remote_url,
                    data=json.dumps(
                        {"events": batch}, ensure_ascii=False
                    ).encode(),
                    headers=headers,
                )
                urllib.request.urlopen(req, timeout=10).read()
            except Exception:
                pass  # telemetry must never take the engine down

    def _run(self) -> None:
        while not self._stop.wait(FLUSH_INTERVAL_S):
            self.flush()
        self.flush()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        self.flush()


    # -- live subscription (SSE) ------------------------------------------

    def events_since(self, after_seq: int, timeout: float = 10.0) -> list[dict]:
        """Events with seq > after_seq; blocks up to ``timeout`` when none."""
        with self._ring_cond:
            def pending():
                last = self._ring_start + len(self._ring) - 1
                return last > after_seq

            if not pending():
                self._ring_cond.wait(timeout)
            start = max(after_seq + 1 - self._ring_start, 0)
            return list(self._ring[start:])


class NullTelemetry(Telemetry):
    def __init__(self):
        super().__init__(sink_path=None, level=LEVEL_OFF)
