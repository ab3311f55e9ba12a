"""Instance supervisor: the restart-policy analog of the reference's
``docker run --restart unless-stopped`` (``local_runtime.rs:699-703``)
and its restart-falls-back-to-rerun behavior (``:294-311``).

``helix start --restart unless-stopped|on-failure`` launches this module
instead of the engine directly.  The supervisor spawns the engine as a
child, records both pids, and restarts the child when it dies:

- ``unless-stopped`` — restart on any exit (crash or clean) until the
  supervisor itself is told to stop (SIGTERM from ``helix stop``);
- ``on-failure``    — restart only on non-zero exit.

Backoff doubles from HELIX_SUPERVISOR_BACKOFF_BASE (default 0.2 s) up to
HELIX_SUPERVISOR_BACKOFF_MAX (default 5 s) and resets once a child
survives 30 s — the crash-loop guard the reference delegates to the
container runtime.  Restart count is persisted next to the pidfile so
``helix status`` can surface instability.

Port copy of ``helix_tpu/cli/supervisor.py`` for ``helix_tpu_torch``.

``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

STABLE_AFTER_S = 30.0


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="helix-tpu instance supervisor")
    parser.add_argument("--policy", choices=["unless-stopped", "on-failure"],
                        required=True)
    parser.add_argument("--state-dir", required=True,
                        help="instance state dir for engine.pid / restarts")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="engine argv (after --)")
    args = parser.parse_args(argv)
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        parser.error("no engine command given")

    state = Path(args.state_dir)
    state.mkdir(parents=True, exist_ok=True)
    engine_pidfile = state / "engine.pid"
    restarts_file = state / "restarts"
    # a fresh supervision run starts at zero — a stale count from the
    # previous run would falsely flag a now-stable instance in `status`
    restarts_file.unlink(missing_ok=True)

    backoff_base = float(os.environ.get("HELIX_SUPERVISOR_BACKOFF_BASE", "0.2"))
    backoff_max = float(os.environ.get("HELIX_SUPERVISOR_BACKOFF_MAX", "5.0"))

    stopping = False
    child: subprocess.Popen | None = None

    def _stop(signum, frame):
        nonlocal stopping
        stopping = True
        if child is not None and child.poll() is None:
            child.send_signal(signal.SIGTERM)

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)

    restarts = 0
    backoff = backoff_base
    while True:
        if stopping:
            return 0
        started = time.monotonic()
        child = subprocess.Popen(command)
        if stopping:
            # TERM landed between the loop check and the spawn: the
            # handler saw only the dead previous child, so this fresh
            # one must be stopped here or it outlives the supervisor
            child.send_signal(signal.SIGTERM)
        engine_pidfile.write_text(str(child.pid))
        rc = child.wait()
        lived = time.monotonic() - started
        engine_pidfile.unlink(missing_ok=True)
        if stopping:
            return 0
        if args.policy == "on-failure" and rc == 0:
            return 0
        restarts += 1
        restarts_file.write_text(str(restarts))
        if lived >= STABLE_AFTER_S:
            backoff = backoff_base
        print(f"supervisor: engine exited rc={rc} after {lived:.1f}s; "
              f"restart #{restarts} in {backoff:.1f}s", file=sys.stderr,
              flush=True)
        # interruptible backoff sleep: a stop during the wait must not
        # resurrect the child
        deadline = time.monotonic() + backoff
        while time.monotonic() < deadline:
            if stopping:
                return 0
            time.sleep(0.05)
        backoff = min(backoff * 2, backoff_max)


if __name__ == "__main__":
    sys.exit(main())
