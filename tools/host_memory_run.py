"""Run one cell of the benchmark (``python3 -m hxbench.run``) in a child
process and report the host memory it took, with a guard that ends the
child before the host runs out.

    python3 tools/host_memory_run.py [--floor-gib 6] [--checkout DIR] \\
        -- --workload <name> --seed <n> --seconds 10 --trace 1

The child runs ``hxbench.run.main`` from ``--checkout`` (default: the
current directory) with the arguments after ``--``, so its standard
output ends with the cell's result line as the harness prints it.  After
the run the child prints to standard error the program's own tracer
counters (``helix_tpu_torch.tracing.snapshot().counts``: kernel launches
by plan in a traced run) and its peak resident set (``VmHWM`` of
``/proc/self/status``, or ``getrusage``'s ``ru_maxrss`` where the kernel
shows no ``VmHWM``).

The parent polls every 50 ms: ``MemAvailable`` of ``/proc/meminfo``, the
memory cgroup's use against its limit where one is set, and the child's
``VmHWM`` where it is shown; its report takes the larger of that and
``getrusage``'s peak of its children.  Where the room left falls below ``--floor-gib`` it kills the
child (SIGKILL) and says so.  Last, it prints one JSON line to standard
error, ``host_memory: {...}``: ``MemTotal``, the cgroup limit, the
child's peak resident set, the least room seen, whether the guard fired,
and the child's exit code, which is also its own."""

from __future__ import annotations

import argparse
import json
import resource
import signal
import subprocess
import sys
import time
from pathlib import Path

GIB = 1 << 30
POLL_S = 0.05
CGROUP_V2 = Path("/sys/fs/cgroup")
CGROUP_V1 = Path("/sys/fs/cgroup/memory")


def meminfo() -> dict[str, int]:
    """``/proc/meminfo`` in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            out[key] = int(value.split()[0]) * 1024
    return out


def _read_int(path: Path) -> int | None:
    try:
        text = path.read_text().strip()
    except OSError:
        return None
    return int(text) if text.isdigit() else None


def cgroup_limit_and_use() -> tuple[int | None, int | None]:
    """The memory cgroup's limit and use in bytes, ``None`` where no limit
    is set or none is readable."""
    for limit_file, use_file in (
            (CGROUP_V2 / "memory.max", CGROUP_V2 / "memory.current"),
            (CGROUP_V1 / "memory.limit_in_bytes",
             CGROUP_V1 / "memory.usage_in_bytes")):
        limit = _read_int(limit_file)
        if limit is not None and limit < 1 << 60:
            return limit, _read_int(use_file)
    return None, None


def vm_hwm(pid: int | str = "self") -> int | None:
    """Peak resident set of a process, in bytes (``VmHWM``)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def room() -> int:
    """Bytes the host can still give: ``MemAvailable``, or less where the
    memory cgroup's limit is nearer."""
    left = meminfo()["MemAvailable"]
    limit, use = cgroup_limit_and_use()
    if limit is not None and use is not None:
        left = min(left, limit - use)
    return left


def child(checkout: str, argv: list[str]) -> int:
    sys.path.insert(0, checkout)
    from hxbench import run

    rc = run.main(argv)
    try:
        from helix_tpu_torch import tracing

        counts = tracing.snapshot().counts
    except ImportError:
        counts = None
    print("program_counts: " + json.dumps(counts), file=sys.stderr)
    peak = vm_hwm() or resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(f"child_peak_rss_bytes: {peak}", file=sys.stderr, flush=True)
    return rc


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--" not in argv:
        raise SystemExit("usage: host_memory_run.py [options] -- <run args>")
    split = argv.index("--")
    ap = argparse.ArgumentParser(prog="host_memory_run.py")
    ap.add_argument("--floor-gib", type=float, default=6.0)
    ap.add_argument("--checkout", default=".")
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args(argv[:split])
    run_args = argv[split + 1:]
    checkout = str(Path(args.checkout).resolve())
    if args.child:
        return child(checkout, run_args)

    floor = int(args.floor_gib * GIB)
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--child",
         "--checkout", checkout, "--", *run_args], cwd=checkout)
    least = room()
    peak = 0
    guarded = False
    while proc.poll() is None:
        left = room()
        least = min(least, left)
        peak = max(peak, vm_hwm(proc.pid) or 0)
        if left < floor and not guarded:
            guarded = True
            print(f"host_memory: {left / GIB:.2f} GiB left, under the floor "
                  f"of {args.floor_gib} GiB: the child is killed",
                  file=sys.stderr, flush=True)
            proc.send_signal(signal.SIGKILL)
        time.sleep(POLL_S)
    rc = proc.wait()
    limit, _ = cgroup_limit_and_use()
    info = meminfo()
    print("host_memory: " + json.dumps({
        "mem_total_bytes": info["MemTotal"],
        "cgroup_limit_bytes": limit,
        "child_peak_rss_bytes": max(
            peak, resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss * 1024),
        "least_room_bytes": least,
        "guard_fired": guarded,
        "rc": rc,
    }), file=sys.stderr, flush=True)
    return rc if rc >= 0 else 128 - rc


if __name__ == "__main__":
    sys.exit(main())
