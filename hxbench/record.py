"""What one run recorded, handed to the per-layer readers."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Record:
    cell: dict
    config: dict
    traffic: dict
    # span name -> host seconds of each occurrence inside the window
    spans: dict = field(default_factory=dict)
    # counter name -> count inside the window
    counts: dict = field(default_factory=dict)
    # the reduced device trace of a traced run (hxbench.trace.reduce)
    trace: dict | None = None

    def add_span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def count(self, name: str, n: float = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n


class Spans:
    """Host spans around calls into a layer: always timed on the host
    clock into the record; under a trace also named in the profiler's
    timeline (``record_function``), so the idle gaps of the device can be
    put down to what the host was doing."""

    def __init__(self, record: Record, traced: bool):
        self.record = record
        self.traced = traced

    @contextlib.contextmanager
    def span(self, name: str):
        if self.traced:
            from torch.profiler import record_function

            ctx = record_function(name)
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.record.add_span(name, time.perf_counter() - t0)
