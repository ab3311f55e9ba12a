"""The reference's control-plane command tests (``tests/test_cloud_cli.py``)
on the port's CLI: auth, cluster registry, push, sync, against the
port's server on ``device="cpu"``.
"""

import json

import pytest

from helix_tpu_torch.server import HelixHTTPServer
from tests.test_torch_cli import run_cli


@pytest.fixture(autouse=True)
def state_home(tmp_path, monkeypatch):
    home = tmp_path / "home"
    monkeypatch.setenv("HELIX_TPU_HOME", str(home))
    import importlib

    from helix_tpu_torch.cli import cloud

    importlib.reload(cloud)
    yield home
    importlib.reload(cloud)


@pytest.fixture
def gateway():
    srv = HelixHTTPServer(host="127.0.0.1", port=0, device="cpu")
    srv.start()
    yield srv
    srv.stop()


def test_auth_lifecycle(state_home):
    code, out, _ = run_cli(["auth", "status"])
    assert code == 0 and "not logged in" in out
    code, out, _ = run_cli(
        ["auth", "login", "--user-id", "u1", "--user-key", "k1"]
    )
    assert code == 0
    assert "helix_user_id=u1" in (state_home / "credentials").read_text()
    code, out, _ = run_cli(["auth", "status"])
    assert "logged in as u1" in out
    assert run_cli(["auth", "logout"])[0] == 0


def test_cluster_registry(state_home):
    code, out, _ = run_cli(["cluster"])
    assert "no clusters" in out
    assert run_cli(
        ["cluster", "add", "prod", "--gateway", "http://example:6969"]
    )[0] == 0
    code, out, _ = run_cli(["cluster", "list"])
    assert "prod" in out and "http://example:6969" in out
    code, out, _ = run_cli(["cluster", "list", "--format", "json"])
    assert json.loads(out)["prod"]["gateway_url"] == "http://example:6969"
    assert run_cli(["cluster", "remove", "prod"])[0] == 0


def test_push_requires_auth(state_home, tmp_path):
    run_cli(["init", "--path", str(tmp_path / "proj")])
    with pytest.raises(SystemExit, match="not logged in"):
        run_cli(["push", "prod"], cwd=tmp_path / "proj")


def test_push_and_sync_roundtrip(state_home, gateway, tmp_path):
    run_cli(["auth", "login", "--user-id", "u", "--user-key", "k"])
    run_cli(
        ["cluster", "add", "dev", "--gateway", f"http://127.0.0.1:{gateway.port}"]
    )
    root = tmp_path / "proj"
    run_cli(["init", "--path", str(root)])
    db = root / "db"
    db.mkdir()
    (db / "queries.py").write_text(
        "queries = define_queries({\n"
        '    "read": {\n'
        '        "count_users": register_read(\n'
        '            lambda p: read_batch().var_as("n", g().n_with_label("User").count()).returning(["n"]),\n'
        '            define_params({}),\n'
        "        )\n"
        "    }\n"
        "})\n"
    )
    code, out, err = run_cli(["push", "dev"], cwd=root)
    assert code == 0, err
    assert "count_users" in out and "pushed 1 source files" in out
    # The route is live on the gateway.
    from helix_tpu_torch.client import Client

    client = Client(f"http://127.0.0.1:{gateway.port}")
    assert client.call("count_users", {}) == {"n": 0}

    # Sync: no changes -> in sync.
    code, out, _ = run_cli(["sync", "dev", "--dry-run"], cwd=root)
    assert code == 0 and "in sync" in out

    # Remote-only file appears in the pull plan and gets pulled.
    snapshot = gateway.engine.source_snapshot
    snapshot["files"]["extra.py"] = {
        "content_b64": "IyBleHRyYQ==",  # "# extra"
        "sha256": "x",
        "last_modified_ms": 0,
    }
    code, out, _ = run_cli(["sync", "dev", "--yes"], cwd=root)
    assert code == 0 and "pull:  extra.py" in out
    assert (db / "extra.py").read_text() == "# extra"


def test_safe_member_rejects_traversal(tmp_path):
    """Remote-supplied file names must stay inside the project dir."""
    from helix_tpu_torch.cli.cloud import _safe_member

    root = tmp_path / "db"
    root.mkdir()
    assert _safe_member(root, "sub/queries.py") == (
        root / "sub" / "queries.py"
    ).resolve()
    for evil in ("../outside.py", "/etc/x", "a/../../b", "sub/../../../x"):
        with pytest.raises(SystemExit):
            _safe_member(root, evil)


def test_sync_preserves_diverged_remote_ties(tmp_path, monkeypatch):
    """A push must not destroy the remote copy of a file the plan
    classified as a tie ('resolve manually')."""
    import helix_tpu_torch.cli.cloud as cloud

    queries = tmp_path / "db"
    queries.mkdir()
    now_ms = 1_000_000
    (queries / "pushme.py").write_text("local newer")
    (queries / "tie.py").write_text("local tie content")
    import os as _os
    _os.utime(queries / "pushme.py", (2_000, 2_000))
    _os.utime(queries / "tie.py", (1_000, 1_000))

    import base64 as _b64
    import hashlib as _hash

    def entry(content, ms):
        data = content.encode()
        return {
            "content_b64": _b64.b64encode(data).decode(),
            "sha256": _hash.sha256(data).hexdigest(),
            "last_modified_ms": ms,
        }

    remote = {
        "pushme.py": entry("old remote", 1_000),       # LocalNewer
        "tie.py": entry("REMOTE tie content", 1_000_000 - 1),  # within skew
    }
    # tie classification needs matching mtimes; rebuild local mtime close
    local_snapshot = cloud.collect_source_snapshot(queries)
    remote["tie.py"]["last_modified_ms"] = (
        local_snapshot["tie.py"]["last_modified_ms"] - 1
    )
    remote["pushme.py"]["last_modified_ms"] = 0

    posted = {}
    monkeypatch.setattr(cloud, "require_auth", lambda: {"helix_user_key": "k"})
    monkeypatch.setattr(cloud, "_cluster_client", lambda c: object())
    monkeypatch.setattr(cloud, "_get_source", lambda c: {"files": remote})
    monkeypatch.setattr(
        cloud, "_post_source", lambda c, files: posted.update(files)
    )

    class P:
        root = tmp_path
        queries_dir = "db"

    import helix_tpu_torch.cli.config as cfg

    monkeypatch.setattr(cfg, "find_project", lambda: P())

    import argparse

    args = argparse.Namespace(cluster="c", dry_run=False, yes=True)
    assert cloud.cmd_sync(args) == 0
    # the push carried the local pushme.py...
    assert posted["pushme.py"]["sha256"] == local_snapshot["pushme.py"]["sha256"]
    # ...but the tie kept the REMOTE copy (not overwritten by local)
    assert posted["tie.py"]["sha256"] == remote["tie.py"]["sha256"]


def test_config_grouping_command(state_home):
    """Hidden `helix config <target>` delegates to the top-level
    commands (reference Commands::Config, commands/config.rs:19-28)."""
    code, out, _ = run_cli(["config", "workspace"])
    assert code == 0 and "active workspace" in out
    assert run_cli(["config", "workspace", "use", "team"])[0] == 0
    code, out, _ = run_cli(["workspace"])
    assert "team" in out
    assert run_cli(
        ["config", "cluster", "add", "prod", "--gateway", "http://x:1"]
    )[0] == 0
    code, out, _ = run_cli(["config", "cluster", "list"])
    assert "prod" in out
    code, out, _ = run_cli(["config", "project"])
    assert code == 0 and "active project" in out
