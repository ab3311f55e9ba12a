"""The reference's control-plane tests (``tests/test_control_plane.py``)
on the port: ``helix_tpu_torch.server.control_plane`` and the port's CLI
(``helix_tpu_torch.cli.cloud``), deploying to the port's server on
``device="cpu"``.  Device-flow login over SSE, cluster CRUD, deploy
with SSE status transitions landing on a real gateway.  Reference:
``enterprise_cloud.rs:7-22`` (REST surface), ``auth.rs:265-316``
(device flow), ``sse_client.rs:60-91`` (deploy events).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import pytest

from helix_tpu_torch.client import Client
from helix_tpu_torch.server import HelixHTTPServer
from helix_tpu_torch.server.control_plane import ControlPlane

from tests.test_torch_cli import run_cli


@pytest.fixture
def plane(tmp_path):
    plane = ControlPlane(tmp_path / "cp", host="127.0.0.1").start()
    yield plane
    plane.stop()


@pytest.fixture
def cloud_env(plane, tmp_path, monkeypatch):
    monkeypatch.setenv("CLOUD_AUTHORITY", f"http://127.0.0.1:{plane.port}")
    monkeypatch.setenv("HELIX_TPU_HOME", str(tmp_path / "home"))
    # HELIX_TPU_HOME is resolved at import time; patch the module state
    import helix_tpu_torch.cli.cloud as cloud

    monkeypatch.setattr(cloud, "STATE_HOME", tmp_path / "home")
    return plane


def _approve_soon(plane: ControlPlane, user_id: str = "tester") -> None:
    """Approve the first outstanding device grant from a side thread
    (the browser's role in the reference flow)."""

    def approve():
        deadline = time.time() + 10
        while time.time() < deadline:
            if plane._grants:
                code = next(iter(plane._grants))
                req = urllib.request.Request(
                    f"http://127.0.0.1:{plane.port}"
                    f"/api/cli/auth/device/{code}/approve",
                    data=json.dumps({"user_id": user_id}).encode(),
                    headers={"Content-Type": "application/json"},
                )
                urllib.request.urlopen(req, timeout=10)
                return
            time.sleep(0.05)

    threading.Thread(target=approve, daemon=True).start()


def test_device_flow_login(cloud_env):
    plane = cloud_env
    _approve_soon(plane, "alice")
    code, out, err = run_cli(["auth", "login", "--device"])
    assert code == 0, err
    assert "logged in as alice" in out
    code, out, _ = run_cli(["auth", "status"])
    assert "logged in as alice" in out
    # the control plane registered the user's key
    assert "alice" in plane.state.data["users"]


def test_unauthed_requests_rejected(cloud_env):
    plane = cloud_env
    req = urllib.request.Request(
        f"http://127.0.0.1:{plane.port}/api/cli/enterprise-clusters"
    )
    try:
        urllib.request.urlopen(req, timeout=10)
        raise AssertionError("expected 401")
    except urllib.error.HTTPError as exc:
        assert exc.code == 401


def test_cluster_crud_and_push_deploys_to_gateway(cloud_env, tmp_path):
    plane = cloud_env
    _approve_soon(plane, "bob")
    assert run_cli(["auth", "login", "--device"])[0] == 0

    gateway = HelixHTTPServer(host="127.0.0.1", port=0, device="cpu")
    gateway.start()
    try:
        code, out, err = run_cli([
            "cluster", "add", "prod",
            "--gateway", f"http://127.0.0.1:{gateway.port}",
        ])
        assert code == 0, err
        code, out, _ = run_cli(["cluster", "list"])
        assert "prod" in out and str(gateway.port) in out

        # a project with a queries.py that defines a stored route
        root = tmp_path / "proj"
        assert run_cli(["init", "--path", str(root)])[0] == 0
        (root / "db").mkdir(exist_ok=True)
        (root / "db" / "queries.py").write_text(
            "p = define_params({})\n"
            "define_queries({\n"
            "    'read': {\n"
            "        'count_users': register_read(\n"
            "            lambda pp: read_batch().var_as(\n"
            "                'n', g().n_with_label('User').count()\n"
            "            ).returning(['n']),\n"
            "            p,\n"
            "        ),\n"
            "    },\n"
            "})\n"
        )
        code, out, err = run_cli(["push", "prod"], cwd=root)
        assert code == 0, err + out
        assert "deployed to" in out
        # the stored route actually landed on the gateway
        out = Client(f"http://127.0.0.1:{gateway.port}").query().stored(
            "count_users"
        ).send()
        assert out == {"n": 0}
        # and the source snapshot is there for sync
        req = urllib.request.Request(
            f"http://127.0.0.1:{gateway.port}/v1/source"
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            files = json.loads(resp.read())["files"]
        assert "queries.py" in files
    finally:
        gateway.stop()


def test_deploy_unknown_cluster_404(cloud_env):
    plane = cloud_env
    _approve_soon(plane)
    assert run_cli(["auth", "login", "--device"])[0] == 0
    import helix_tpu_torch.cli.cloud as cloud

    creds = cloud.require_auth()
    req = urllib.request.Request(
        f"http://127.0.0.1:{plane.port}/api/cli/enterprise-clusters/nope/deploy",
        data=b"{}",
        headers={
            "Content-Type": "application/json",
            "Authorization": f"Bearer {creds['helix_user_key']}",
        },
    )
    try:
        urllib.request.urlopen(req, timeout=10)
        raise AssertionError("expected 404")
    except urllib.error.HTTPError as exc:
        assert exc.code == 404


def test_state_persists_across_restart(tmp_path):
    plane = ControlPlane(tmp_path / "cp", host="127.0.0.1").start()
    with plane.state.lock:
        plane.state.data["users"]["u1"] = {"user_key": "k1"}
        plane.state.data["clusters"]["c1"] = {
            "gateway_url": "http://x", "query_auth_env": "HELIX_API_KEY",
            "project": "default",
        }
        plane.state.save()
    plane.stop()
    reborn = ControlPlane(tmp_path / "cp", host="127.0.0.1")
    assert reborn.state.data["users"]["u1"]["user_key"] == "k1"
    assert reborn.state.data["clusters"]["c1"]["gateway_url"] == "http://x"


def test_expired_device_code_not_approvable(tmp_path):
    plane = ControlPlane(
        tmp_path / "cp", host="127.0.0.1", device_timeout_s=0.2
    ).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{plane.port}/api/cli/auth/device", data=b"{}"
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            code = json.loads(resp.read())["device_code"]
        time.sleep(0.4)
        # approval after expiry must be rejected, and the grant dropped
        req = urllib.request.Request(
            f"http://127.0.0.1:{plane.port}/api/cli/auth/device/{code}/approve",
            data=b"{}",
        )
        try:
            urllib.request.urlopen(req, timeout=10)
            raise AssertionError("expected 404 for expired code")
        except urllib.error.HTTPError as exc:
            assert exc.code == 404
        assert code not in plane._grants
    finally:
        plane.stop()


def test_browser_get_approves_and_uri_is_connectable(plane):
    req = urllib.request.Request(
        f"http://127.0.0.1:{plane.port}/api/cli/auth/device", data=b"{}"
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        grant = json.loads(resp.read())
    # the printed URI must embed a reachable host (the request's Host
    # header), never the 0.0.0.0 bind address
    assert "0.0.0.0" not in grant["verification_uri"]
    # a plain browser GET on the URI approves the grant
    with urllib.request.urlopen(grant["verification_uri"], timeout=10) as resp:
        assert json.loads(resp.read())["approved"] is True


def test_project_command_local_and_cloud(cloud_env, monkeypatch):
    plane = cloud_env
    _approve_soon(plane, "carol")
    assert run_cli(["auth", "login", "--device"])[0] == 0
    code, out, _ = run_cli(["project", "use", "analytics"])
    assert code == 0 and "analytics" in out
    code, out, _ = run_cli(["project"])
    assert "analytics" in out
    code, out, _ = run_cli(["project", "list"])
    assert "analytics" in out
    assert "analytics" in plane.state.data["projects"]
    # without the control plane, selection persists locally
    monkeypatch.delenv("CLOUD_AUTHORITY")
    code, out, _ = run_cli(["project"])
    assert "analytics" in out


def test_approve_cannot_impersonate_existing_user(cloud_env):
    """Claiming an EXISTING identity through device-approve without that
    user's key must 403 (it used to mint a key as any user AND rotate
    the victim's real key)."""
    plane = cloud_env
    _approve_soon(plane, "victim")
    code, out, err = run_cli(["auth", "login", "--device"])
    assert code == 0, err
    victim_key = plane.state.data["users"]["victim"]["user_key"]

    import urllib.error

    # attacker starts a device grant...
    grant = json.loads(urllib.request.urlopen(
        urllib.request.Request(
            f"http://127.0.0.1:{plane.port}/api/cli/auth/device",
            data=b"{}", headers={"Content-Type": "application/json"},
        ), timeout=10,
    ).read())
    dc = grant["device_code"]
    # ...and tries to approve it AS the victim, with no credentials
    try:
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{plane.port}/api/cli/auth/device/{dc}/approve",
            data=json.dumps({"user_id": "victim"}).encode(),
            headers={"Content-Type": "application/json"},
        ), timeout=10)
        raise AssertionError("expected 403")
    except urllib.error.HTTPError as exc:
        assert exc.code == 403
    # victim's key is untouched
    assert plane.state.data["users"]["victim"]["user_key"] == victim_key


def test_relogin_keeps_existing_key(cloud_env):
    """A second device-flow login as the same user (authorized approve)
    hands back the SAME key instead of rotating it out from under other
    sessions."""
    plane = cloud_env
    _approve_soon(plane, "carol")
    code, _, err = run_cli(["auth", "login", "--device"])
    assert code == 0, err
    key1 = plane.state.data["users"]["carol"]["user_key"]

    # approve again WITH carol's key (an authorized re-login)
    def approve():
        deadline = time.time() + 10
        while time.time() < deadline:
            if plane._grants:
                dc = next(iter(plane._grants))
                urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{plane.port}"
                    f"/api/cli/auth/device/{dc}/approve",
                    data=json.dumps({"user_id": "carol"}).encode(),
                    headers={"Content-Type": "application/json",
                             "Authorization": f"Bearer {key1}"},
                ), timeout=10)
                return
            time.sleep(0.05)

    threading.Thread(target=approve, daemon=True).start()
    code, _, err = run_cli(["auth", "login", "--device"])
    assert code == 0, err
    assert plane.state.data["users"]["carol"]["user_key"] == key1


def test_auth_create_key_rotates_cluster_key(cloud_env):
    """`helix auth create-key <cluster>` mints a fresh cluster API key,
    revoking the previous one (reference auth.rs:95-140)."""
    plane = cloud_env
    _approve_soon(plane, "carol")
    assert run_cli(["auth", "login", "--device"])[0] == 0
    assert run_cli(
        ["cluster", "add", "prod", "--gateway", "http://x:1"]
    )[0] == 0
    code, out, err = run_cli(["auth", "create-key", "prod"])
    assert code == 0, err
    assert "shown once" in out
    first = plane.state.data["clusters"]["prod"]["query_key"]
    assert first in out
    # rotation replaces (revokes) the previous key
    code, out, _ = run_cli(["auth", "create-key", "prod"])
    assert code == 0
    second = plane.state.data["clusters"]["prod"]["query_key"]
    assert second != first and second in out
    assert "revoked" in out
    # unknown cluster is a clean error, not a crash
    with pytest.raises(SystemExit):
        run_cli(["auth", "create-key", "nope"])


# -- query-log history (logs/mod.rs:21-50 analog) --------------------------

def _iso(ms: int) -> str:
    from datetime import datetime, timezone

    return datetime.fromtimestamp(ms / 1000, tz=timezone.utc).isoformat()


def test_query_log_history_range(cloud_env):
    """Engine pushes query events (cluster-key auth) -> `logs --cluster
    --start --end` ranges over them with ISO-8601 bounds."""
    from helix_tpu_torch.telemetry import Telemetry

    plane = cloud_env
    _approve_soon(plane, "loguser")
    assert run_cli(["auth", "login", "--device"])[0] == 0
    assert run_cli([
        "cluster", "add", "logc", "--gateway", "http://127.0.0.1:1",
    ])[0] == 0
    code, out, _ = run_cli(["auth", "create-key", "logc"])
    assert code == 0, out
    cluster_key = out.strip().splitlines()[-1].split(": ")[-1]

    # the engine-side push: Telemetry's remote sink with the CLUSTER key
    clock = [1_000.0]
    tel = Telemetry(
        level="full", clock=lambda: clock[0],
        remote_url=(
            f"http://127.0.0.1:{plane.port}/api/cli/logs/logc"
        ),
        remote_key=cluster_key,
    )
    for t, name in ((1_000.0, "early"), (2_000.0, "mid"), (3_000.0, "late")):
        clock[0] = t
        tel.query_event(True, name, "read", 123)
    tel.close()

    code, out, err = run_cli([
        "logs", "--cluster", "logc",
        "--start", _iso(1_500_000), "--end", _iso(2_500_000),
    ])
    assert code == 0, err
    events = [json.loads(ln) for ln in out.strip().splitlines()]
    assert [e["query_name"] for e in events] == ["mid"]
    assert events[0]["time_taken_usec"] == 123

    # open-ended range returns everything; epoch-ms bounds accepted too
    code, out, _ = run_cli(["logs", "--cluster", "logc"])
    assert [json.loads(ln)["query_name"] for ln in out.strip().splitlines()] \
        == ["early", "mid", "late"]
    code, out, _ = run_cli([
        "logs", "--cluster", "logc", "--start", "2500000",
    ])
    assert [json.loads(ln)["query_name"] for ln in out.strip().splitlines()] \
        == ["late"]


def test_query_log_follow_rejected_and_auth(cloud_env):
    plane = cloud_env
    _approve_soon(plane, "loguser2")
    assert run_cli(["auth", "login", "--device"])[0] == 0
    assert run_cli([
        "cluster", "add", "logd", "--gateway", "http://127.0.0.1:1",
    ])[0] == 0
    # reference: live-follow unsupported for historical queries
    code, _, err = run_cli([
        "logs", "--cluster", "logd", "--start", "0", "--follow",
    ])
    assert code == 2 and "--follow" in err
    # ingest without any key is rejected
    import urllib.error
    req = urllib.request.Request(
        f"http://127.0.0.1:{plane.port}/api/cli/logs/logd",
        data=json.dumps({"events": [{"event": "x"}]}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=10)
    assert exc.value.code == 401
    # unknown cluster 404s on the range query
    req = urllib.request.Request(
        f"http://127.0.0.1:{plane.port}/api/cli/logs/nosuch?start=0",
    )
    import helix_tpu_torch.cli.cloud as cloud
    creds = cloud.require_auth()
    req.add_header("Authorization", f"Bearer {creds['helix_user_key']}")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=10)
    assert exc.value.code == 404
