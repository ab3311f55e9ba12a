"""The reference's supervisor tests (``tests/test_supervisor.py``) on the
port: ``helix_tpu_torch.cli start --restart`` runs the port's supervisor
over the port's server on ``--device cpu``.

Covers: crash recovery under ``unless-stopped`` (kill -9 the engine,
observe a new engine serving), clean-exit semantics under ``on-failure``
(no restart on rc=0), and ``stop`` terminating the whole tree.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tests.test_torch_cli import run_cli, _free_port

REPO = Path(__file__).resolve().parents[1]


def _engine_pid(root: Path, instance: str = "dev") -> int | None:
    path = root / ".helix" / instance / "engine.pid"
    if not path.exists():
        return None
    try:
        return int(path.read_text().strip())
    except ValueError:
        return None


def _alive(pid: int) -> bool:
    from helix_tpu_torch.cli.main import _process_gone

    return not _process_gone(pid)


def _wait(predicate, timeout: float = 30.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.1)
    return False


@pytest.fixture
def fast_backoff(monkeypatch):
    monkeypatch.setenv("HELIX_SUPERVISOR_BACKOFF_BASE", "0.1")
    monkeypatch.setenv("HELIX_SUPERVISOR_BACKOFF_MAX", "0.5")


def test_unless_stopped_restarts_after_kill9(tmp_path, fast_backoff):
    root = tmp_path / "proj"
    port = _free_port()
    assert run_cli(["init", "--path", str(root), "--port", str(port)])[0] == 0
    code, out, err = run_cli(
        ["start", "dev", "--restart", "unless-stopped", "--device", "cpu"], cwd=root
    )
    assert code == 0, err
    try:
        sup_pid = int((root / ".helix" / "dev" / "server.pid").read_text())
        engine = _engine_pid(root)
        assert engine is not None and engine != sup_pid

        os.kill(engine, signal.SIGKILL)
        # the supervisor must bring up a NEW engine that becomes ready
        assert _wait(
            lambda: (_engine_pid(root) or engine) != engine
            and _alive(_engine_pid(root))
        ), "engine never restarted"
        from helix_tpu_torch.cli.main import _wait_ready

        assert _wait_ready(port, timeout=30.0), "restarted engine not ready"
        assert (root / ".helix" / "dev" / "restarts").read_text().strip() == "1"

        code, out, _ = run_cli(["status"], cwd=root)
        assert "restarts=1" in out
    finally:
        assert run_cli(["stop", "dev"], cwd=root)[0] == 0
    assert not _alive(sup_pid)
    final_engine = _engine_pid(root)
    assert final_engine is None or not _alive(final_engine)


def test_stop_terminates_supervised_tree(tmp_path, fast_backoff):
    root = tmp_path / "proj"
    port = _free_port()
    assert run_cli(["init", "--path", str(root), "--port", str(port)])[0] == 0
    assert run_cli(
        ["start", "dev", "--restart", "unless-stopped", "--device", "cpu"], cwd=root
    )[0] == 0
    sup_pid = int((root / ".helix" / "dev" / "server.pid").read_text())
    engine = _engine_pid(root)
    assert run_cli(["stop", "dev"], cwd=root)[0] == 0
    assert _wait(lambda: not _alive(sup_pid), timeout=10.0)
    assert engine is None or _wait(lambda: not _alive(engine), timeout=10.0)
    # stop must not resurrect: no engine.pid reappears
    time.sleep(0.6)
    assert _engine_pid(root) is None


def test_on_failure_policy_unit(tmp_path):
    """Supervisor semantics without a real engine: a failing child is
    restarted with backoff; a clean exit (rc=0) under on-failure ends
    supervision.  State dirs must be unique per run: a stale restarts
    file satisfies the wait instantly and the TERM then lands in the
    fresh supervisor's import window, before its handler installs."""
    env = dict(os.environ)
    env["HELIX_SUPERVISOR_BACKOFF_BASE"] = "0.05"
    env["HELIX_SUPERVISOR_BACKOFF_MAX"] = "0.1"
    env["PYTHONPATH"] = str(REPO)

    # clean exit: supervisor exits on its own, no restart
    proc = subprocess.run(
        [sys.executable, "-m", "helix_tpu_torch.cli.supervisor",
         "--policy", "on-failure", "--state-dir", str(tmp_path / "a"),
         "--", sys.executable, "-c", "pass"],
        capture_output=True, timeout=30, env=env,
    )
    assert proc.returncode == 0
    assert b"restart" not in proc.stderr

    # failing child: restarted until the supervisor is stopped
    sup = subprocess.Popen(
        [sys.executable, "-m", "helix_tpu_torch.cli.supervisor",
         "--policy", "on-failure", "--state-dir", str(tmp_path / "b"),
         "--", sys.executable, "-c", "raise SystemExit(3)"],
        stderr=subprocess.PIPE, env=env,
    )
    restarts = tmp_path / "b" / "restarts"
    assert _wait(
        lambda: restarts.exists() and int(restarts.read_text() or 0) >= 2,
        timeout=20.0,
    ), "failing child was not restarted"
    sup.send_signal(signal.SIGTERM)
    assert sup.wait(timeout=10.0) == 0
