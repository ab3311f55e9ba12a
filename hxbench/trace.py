"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, exported as a Chrome trace and reduced to the device's
busy time, its kernel time, the operations that took most time, and its
idle gaps put down to the host span (``hxbench.record.Spans``) that was
open at each gap's middle."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

import numpy as np

WINDOW = "hxbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@contextlib.contextmanager
def traced(out: dict, on: bool):
    """Profile the block when ``on``; ``out['trace']`` then holds
    :func:`reduce` of it.  The block is marked as the window."""
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    import torch

    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    out["trace"] = reduce(events)


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged ``[start, end]`` rows of ``intervals`` sorted by start."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(new)
    stops = ends[np.r_[last[1:] - 1, len(iv) - 1]]
    return np.stack([starts, stops], axis=1)


def reduce(events: list) -> dict:
    """``busy_s``, ``window_s``, ``kernel_s``, ``device_ops`` and
    ``idle_gaps`` (lists of ``[name, seconds]``, most first) of one traced
    window.  Times in the Chrome trace are microseconds."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans
           if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = []
    by_name: dict[str, float] = {}
    kernel_us = 0.0
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        dev.append((s, t))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t - s)
        if e["cat"] == "kernel":
            kernel_us += t - s
    merged = _union(np.asarray(dev, np.float64).reshape(-1, 2))
    busy_us = float((merged[:, 1] - merged[:, 0]).sum())
    edges = np.concatenate([[w0], merged.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    notes = [e for e in spans if e.get("cat") == "user_annotation"
             and e.get("name") != WINDOW]
    idle = _name_gaps(gaps, notes)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "kernel_s": kernel_us * 1e-6,
        "device_ops": [[name[:160], us * 1e-6] for name, us in ops],
        "idle_gaps": idle,
    }


def _name_gaps(gaps: np.ndarray, notes: list) -> list:
    """Idle time by the innermost host span open at each gap's middle
    (``host outside any span`` where none is)."""
    if len(gaps) == 0:
        return []
    mids = gaps.mean(axis=1)
    lengths = gaps[:, 1] - gaps[:, 0]
    labels = np.full(len(gaps), -1)
    if notes:
        st = np.array([float(e["ts"]) for e in notes])
        en = st + np.array([float(e["dur"]) for e in notes])
        size = en - st
        for c in range(0, len(mids), 256):
            m = mids[c:c + 256, None]
            cover = (st[None, :] <= m) & (en[None, :] >= m)
            masked = np.where(cover, size[None, :], np.inf)
            pick = masked.argmin(axis=1)
            labels[c:c + 256] = np.where(cover.any(axis=1), pick, -1)
    names = np.array(["host outside any span"]
                     + [str(e["name"]) for e in notes], dtype=object)
    total: dict[str, float] = {}
    for name, us in zip(names[labels + 1], lengths):
        total[name] = total.get(name, 0.0) + float(us)
    return [[name, us * 1e-6]
            for name, us in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]
