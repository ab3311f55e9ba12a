"""The program's own spans and counters (``helix_tpu_torch.tracing``) as
the readers in ``metrics/`` take them.  The program records them while
the window's profiler records, so only in a traced run.  Each function
gives ``None`` in an untraced run, in a run of another ``entry`` than the
one asked for, on a program without the tracer, where the tracer dropped
any span, and where it finds nothing."""

from __future__ import annotations


def snapshot(run, entry: str | None = None):
    """The tracer's snapshot, or ``None`` where there is none to read."""
    if run.trace is None:
        return None
    if entry is not None and run.traffic.get("entry") != entry:
        return None
    try:
        from helix_tpu_torch import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    return None if snap.dropped else snap


def mean_ms(run, name: str, entry: str | None = None) -> float | None:
    """Mean duration, in ms, of the spans named ``name``."""
    snap = snapshot(run, entry)
    if snap is None:
        return None
    took = [r[5] - r[4] for r in snap.spans if r[0] == name]
    return sum(took) / len(took) * 1e-6 if took else None
