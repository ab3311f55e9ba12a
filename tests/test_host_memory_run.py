"""``tools/host_memory_run.py``: a cell run in a child process with its
host memory reported, and the guard that ends the child before the host
runs out.  On the CPU the harness exits 2 (no card), which is enough to
see both ends work."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOOL = ROOT / "tools" / "host_memory_run.py"
RUN_ARGS = ["--workload", "deep10m-cos.batch16", "--seed", "1",
            "--seconds", "1"]


def run_tool(*options: str) -> tuple[int, str]:
    proc = subprocess.run(
        [sys.executable, str(TOOL), *options, "--", *RUN_ARGS],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    return proc.returncode, proc.stderr


def report(stderr: str) -> dict:
    lines = [ln for ln in stderr.splitlines()
             if ln.startswith("host_memory: {")]
    assert len(lines) == 1, stderr
    return json.loads(lines[0].split(": ", 1)[1])


def test_reads_the_host():
    sys.path.insert(0, str(TOOL.parent))
    try:
        import host_memory_run as H
    finally:
        sys.path.remove(str(TOOL.parent))
    info = H.meminfo()
    assert info["MemTotal"] >= info["MemAvailable"] > 0
    assert 0 < H.room() <= info["MemTotal"]
    assert H.vm_hwm() is None or H.vm_hwm() > 0


def test_reports_the_child_and_passes_its_exit_code_on():
    rc, err = run_tool("--floor-gib", "0")
    got = report(err)
    assert rc == got["rc"] == 2          # hxbench.run: no CUDA device here
    assert not got["guard_fired"]
    assert got["mem_total_bytes"] > 0 and got["child_peak_rss_bytes"] > 0
    assert "program_counts: {}" in err
    assert "child_peak_rss_bytes: " in err


def test_the_guard_kills_the_child_under_its_floor():
    rc, err = run_tool("--floor-gib", "100000")    # more than any host has
    got = report(err)
    assert got["guard_fired"] and got["rc"] == -9 and rc == 137
    assert "the child is killed" in err
