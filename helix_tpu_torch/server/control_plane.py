"""Control-plane service: the hosted half of the reference's L7 surface.

The reference CLI talks to ``https://cloud.helix-db.com/api/cli/...``
(``enterprise_cloud.rs:7-22``) for auth (GitHub device flow over SSE,
``auth.rs:265-316``), workspace/project/cluster CRUD, and deploys that
stream SSE status transitions (``sse_client.rs:60-91``:
ValidatingQueries → Building → Deploying → Deployed).  This module is a
runnable implementation of that contract so ``helix auth login
--device`` / ``cluster`` / ``push`` exercise a real control plane over
HTTP instead of a local file registry (set ``CLOUD_AUTHORITY`` to its
URL, reference ``enterprise_cloud.rs:9-11``).

Surface:

- ``POST /api/cli/auth/device``                 → {device_code, verification_uri}
- ``GET  /api/cli/auth/device/<code>/events``   → SSE: UserVerification,
  then Success{user_id, user_key} once approved (DeviceCodeTimeout after
  ``device_timeout_s``)
- ``POST /api/cli/auth/device/<code>/approve``  → browser-side approval
  (tests drive it programmatically)
- ``GET/POST /api/cli/workspaces`` · ``/api/cli/projects``
- ``GET/POST /api/cli/enterprise-clusters`` — cluster records carry
  ``gateway_url`` + ``query_auth_env``
- ``POST /api/cli/enterprise-clusters/<id>/deploy`` → SSE stream of
  status transitions while the bundle + source snapshot are pushed to
  the cluster's gateway
- ``POST /api/cli/logs/<cluster_id>`` → ingest a batch of query events
  (``{"events": [{"event", "ts_ms", ...}]}``) — the engine-side
  analog of the reference's logs service (``metrics/src/lib.rs:50``);
  authenticates with a user key OR the cluster's ``query_key``
- ``GET /api/cli/logs/<cluster_id>?start=<iso8601>&end=<iso8601>`` →
  historical range query (inclusive bounds; epoch-ms also accepted) —
  the API behind ``helix logs`` on an enterprise instance
  (``helix-cli/src/commands/logs/mod.rs:21-50``)

State persists as JSON under ``--state-dir``; per-cluster query-event
history as JSONL under ``<state-dir>/logs/``.  All non-auth routes
require ``Authorization: Bearer <user_key>`` of a registered user.

Port copy of ``helix_tpu/server/control_plane.py`` for
``helix_tpu_torch``.

``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:
"""

from __future__ import annotations

import base64
import json
import secrets
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path


class ControlPlaneState:
    def __init__(self, state_dir: str | Path):
        self.path = Path(state_dir) / "control_plane.json"
        self.lock = threading.Lock()
        self.data = {
            "users": {},        # user_id -> {user_key}
            "workspaces": {},   # name -> {created_ms}
            "projects": {},     # name -> {workspace}
            "clusters": {},     # id -> {gateway_url, query_auth_env, project}
        }
        try:
            self.data.update(json.loads(self.path.read_text()))
        except (OSError, json.JSONDecodeError):
            pass

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.data, indent=2))
        tmp.replace(self.path)


class _DeviceGrant:
    def __init__(self):
        self.approved = threading.Event()
        self.user_id: str | None = None
        self.created = time.monotonic()


class ControlPlane:
    def __init__(
        self,
        state_dir: str | Path,
        host: str = "0.0.0.0",
        port: int = 0,
        device_timeout_s: float = 120.0,
    ):
        self.state = ControlPlaneState(state_dir)
        self.logs_dir = Path(state_dir) / "logs"
        self._logs_lock = threading.Lock()
        self.host = host
        self.port = port
        self.device_timeout_s = device_timeout_s
        self._grants: dict[str, _DeviceGrant] = {}
        self._httpd: ThreadingHTTPServer | None = None

    # -- auth helpers -----------------------------------------------------

    def _authorized(self, headers) -> str | None:
        token = (headers.get("Authorization") or "").removeprefix("Bearer ").strip()
        if not token:
            return None
        with self.state.lock:
            for user_id, record in self.state.data["users"].items():
                if record.get("user_key") == token:
                    return user_id
        return None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "ControlPlane":
        plane = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _json(self, status: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _sse_begin(self) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Connection", "close")
                self.end_headers()

            def _sse(self, event: dict) -> None:
                self.wfile.write(f"data: {json.dumps(event)}\n\n".encode())
                self.wfile.flush()

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b"{}"
                try:
                    return json.loads(raw)
                except json.JSONDecodeError:
                    return {}

            def do_POST(self):
                plane._post(self)

            def do_GET(self):
                plane._get(self)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_port
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    # -- request handling -------------------------------------------------

    def _expire_grants(self) -> None:
        now = time.monotonic()
        for code in [
            c for c, g in self._grants.items()
            if now - g.created > self.device_timeout_s and not g.approved.is_set()
        ]:
            self._grants.pop(code, None)

    def _approve(self, rq, code: str) -> None:
        grant = self._grants.get(code)
        if grant is None or (
            time.monotonic() - grant.created > self.device_timeout_s
        ):
            self._grants.pop(code, None)
            rq._json(404, {"error": "unknown or expired device code"})
            return
        body = rq._body()
        user_id = body.get("user_id") or f"user-{code[:6]}"
        with self.state.lock:
            exists = user_id in self.state.data["users"]
        if exists and self._authorized(rq.headers) != user_id:
            # claiming an existing identity needs that identity's key —
            # otherwise anyone could mint a bearer token as any user
            rq._json(403, {
                "error": "approving as an existing user requires that "
                         "user's api key"})
            return
        grant.user_id = user_id
        grant.approved.set()
        rq._json(200, {"approved": True})

    def _public_host(self, rq) -> str:
        """An address a browser can actually reach: the request's Host
        header when present, else the bind host (0.0.0.0 is not
        connectable — substitute loopback)."""
        host = rq.headers.get("Host")
        if host:
            return host
        bind = "127.0.0.1" if self.host in ("0.0.0.0", "::") else self.host
        return f"{bind}:{self.port}"

    def _post(self, rq) -> None:
        path = rq.path
        if path == "/api/cli/auth/device":
            self._expire_grants()
            code = secrets.token_hex(8)
            self._grants[code] = _DeviceGrant()
            rq._json(200, {
                "device_code": code,
                "verification_uri": (
                    f"http://{self._public_host(rq)}"
                    f"/api/cli/auth/device/{code}/approve"
                ),
            })
            return
        if path.startswith("/api/cli/auth/device/") and path.endswith("/approve"):
            self._approve(rq, path.split("/")[-2])
            return
        if path.startswith("/api/cli/logs/"):
            # engines push with their CLUSTER key (they hold no user
            # credentials), so this route runs its own auth
            self._logs_ingest(rq, path.split("/")[-1])
            return

        user = self._authorized(rq.headers)
        if user is None:
            rq._json(401, {"error": "invalid or missing api key"})
            return
        body = rq._body()
        if path == "/api/cli/workspaces":
            name = body.get("name")
            if not name:
                rq._json(400, {"error": "name required"})
                return
            with self.state.lock:
                self.state.data["workspaces"].setdefault(
                    name, {"created_ms": int(time.time() * 1000)}
                )
                self.state.save()
            rq._json(200, {"name": name})
            return
        if path == "/api/cli/projects":
            name = body.get("name")
            if not name:
                rq._json(400, {"error": "name required"})
                return
            with self.state.lock:
                self.state.data["projects"][name] = {
                    "workspace": body.get("workspace", "default"),
                }
                self.state.save()
            rq._json(200, {"name": name})
            return
        if path == "/api/cli/enterprise-clusters":
            cluster_id = body.get("cluster_id") or f"cluster-{secrets.token_hex(4)}"
            record = {
                "gateway_url": body.get("gateway_url"),
                "query_auth_env": body.get("query_auth_env", "HELIX_API_KEY"),
                "project": body.get("project", "default"),
            }
            if not record["gateway_url"]:
                rq._json(400, {"error": "gateway_url required"})
                return
            with self.state.lock:
                self.state.data["clusters"][cluster_id] = record
                self.state.save()
            rq._json(200, {"cluster_id": cluster_id, **record})
            return
        if path.startswith("/api/cli/enterprise-clusters/") and path.endswith("/deploy"):
            self._deploy(rq, path.split("/")[-2], body)
            return
        if path.startswith("/api/cli/enterprise-clusters/") and path.endswith("/key"):
            # Cluster API-key rotation (reference POST
            # /api/cli/enterprise-clusters/<id>/key, auth.rs:95-140):
            # mint a fresh query key; overwriting revokes the previous.
            cluster_id = path.split("/")[-2]
            with self.state.lock:
                record = self.state.data["clusters"].get(cluster_id)
                if record is None:
                    rq._json(404, {"error": f"unknown cluster {cluster_id}"})
                    return
                had_key = "query_key" in record
                new_key = secrets.token_hex(16)
                record["query_key"] = new_key
                self.state.save()
            payload = {"key": new_key}
            if not had_key:
                payload["warning"] = (
                    "no previous cluster key existed; this is the first"
                )
            rq._json(200, payload)
            return
        rq._json(404, {"error": f"unknown route {path}"})

    def _get(self, rq) -> None:
        path = rq.path
        if path.startswith("/api/cli/auth/device/") and path.endswith("/approve"):
            # browsers GET the verification_uri; approving on GET keeps
            # the interactive flow one click (this is a local analog,
            # not an OAuth server)
            self._approve(rq, path.split("/")[-2])
            return
        if path.startswith("/api/cli/auth/device/") and path.endswith("/events"):
            code = path.split("/")[-2]
            grant = self._grants.get(code)
            if grant is None:
                rq._json(404, {"error": "unknown device code"})
                return
            rq._sse_begin()
            rq._sse({"type": "UserVerification", "device_code": code})
            remaining = self.device_timeout_s - (time.monotonic() - grant.created)
            if not grant.approved.wait(timeout=max(0.0, remaining)):
                self._grants.pop(code, None)  # expired: not approvable later
                rq._sse({"type": "DeviceCodeTimeout"})
                return
            # pop before minting so a concurrent stream for the same
            # code cannot double-redeem (the loser reports a timeout)
            if self._grants.pop(code, None) is None:
                rq._sse({"type": "DeviceCodeTimeout"})
                return
            user_id = grant.user_id or ""
            with self.state.lock:
                existing = self.state.data["users"].get(user_id)
                if existing is not None:
                    # re-login: hand back the existing key instead of
                    # rotating it (rotation would lock out every other
                    # session holding the old key)
                    user_key = existing["user_key"]
                else:
                    user_key = secrets.token_hex(16)
                    self.state.data["users"][user_id] = {
                        "user_key": user_key
                    }
                    self.state.save()
            rq._sse({
                "type": "Success", "user_id": user_id, "user_key": user_key,
            })
            return

        user = self._authorized(rq.headers)
        if user is None:
            rq._json(401, {"error": "invalid or missing api key"})
            return
        if path.startswith("/api/cli/logs/"):
            self._logs_range(rq, path[len("/api/cli/logs/"):])
            return
        with self.state.lock:
            if path == "/api/cli/workspaces":
                rq._json(200, {"workspaces": sorted(self.state.data["workspaces"])})
                return
            if path == "/api/cli/projects":
                rq._json(200, {"projects": self.state.data["projects"]})
                return
            if path == "/api/cli/enterprise-clusters":
                rq._json(200, {"clusters": self.state.data["clusters"]})
                return
            if path.startswith("/api/cli/enterprise-clusters/"):
                cluster_id = path.rsplit("/", 1)[-1]
                record = self.state.data["clusters"].get(cluster_id)
                if record is None:
                    rq._json(404, {"error": f"unknown cluster {cluster_id}"})
                    return
                rq._json(200, {"cluster_id": cluster_id, **record})
                return
        rq._json(404, {"error": f"unknown route {path}"})

    # -- query-log history (logs/mod.rs:21-50 analog) ----------------------

    LOGS_MAX_EVENTS_PER_BATCH = 4096
    LOGS_MAX_BYTES = 64 << 20  # per-cluster history cap (oldest dropped)

    def _cluster_key_authorized(self, headers, cluster_id: str) -> bool:
        token = (
            headers.get("Authorization") or ""
        ).removeprefix("Bearer ").strip()
        if not token:
            return False
        with self.state.lock:
            record = self.state.data["clusters"].get(cluster_id)
            return record is not None and record.get("query_key") == token

    def _logs_path(self, cluster_id: str) -> Path:
        # cluster ids are minted/registered server-side, but never trust
        # them as path components
        safe = "".join(
            c if c.isalnum() or c in "-_" else "_" for c in cluster_id
        )
        return self.logs_dir / f"{safe}.jsonl"

    def _logs_ingest(self, rq, cluster_id: str) -> None:
        if not (
            self._authorized(rq.headers)
            or self._cluster_key_authorized(rq.headers, cluster_id)
        ):
            rq._json(401, {"error": "invalid or missing api key"})
            return
        with self.state.lock:
            known = cluster_id in self.state.data["clusters"]
        if not known:
            rq._json(404, {"error": f"unknown cluster {cluster_id}"})
            return
        events = rq._body().get("events")
        if not isinstance(events, list):
            rq._json(400, {"error": "events list required"})
            return
        events = events[: self.LOGS_MAX_EVENTS_PER_BATCH]
        now_ms = int(time.time() * 1000)
        path = self._logs_path(cluster_id)
        with self._logs_lock:
            self.logs_dir.mkdir(parents=True, exist_ok=True)
            with open(path, "a", encoding="utf-8") as fh:
                for ev in events:
                    if not isinstance(ev, dict):
                        continue
                    ev.setdefault("ts_ms", now_ms)
                    fh.write(json.dumps(ev, ensure_ascii=False) + "\n")
            self._logs_trim(path)
        rq._json(200, {"accepted": len(events)})

    def _logs_trim(self, path: Path) -> None:
        """Drop the oldest half when the per-cluster history exceeds the
        byte cap (bounded storage; callers hold _logs_lock)."""
        try:
            if path.stat().st_size <= self.LOGS_MAX_BYTES:
                return
            lines = path.read_text(encoding="utf-8").splitlines(True)
            tmp = path.with_suffix(".tmp")
            tmp.write_text("".join(lines[len(lines) // 2:]), encoding="utf-8")
            tmp.replace(path)
        except OSError:
            pass

    @staticmethod
    def _parse_log_time(value: str) -> int:
        """ISO-8601 (the reference's wire format, logs/mod.rs:21-50) or
        epoch milliseconds -> epoch ms."""
        from datetime import datetime, timezone

        if value.isdigit():
            return int(value)
        dt = datetime.fromisoformat(value.replace("Z", "+00:00"))
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return int(dt.timestamp() * 1000)

    def _logs_range(self, rq, rest: str) -> None:
        from urllib.parse import parse_qs, urlparse

        parsed = urlparse(rest)
        cluster_id = parsed.path
        qs = parse_qs(parsed.query)
        with self.state.lock:
            known = cluster_id in self.state.data["clusters"]
        if not known:
            rq._json(404, {"error": f"unknown cluster {cluster_id}"})
            return
        try:
            start = (
                self._parse_log_time(qs["start"][0]) if "start" in qs else 0
            )
            end = (
                self._parse_log_time(qs["end"][0]) if "end" in qs
                else (1 << 62)
            )
        except ValueError as exc:
            rq._json(400, {"error": f"bad start/end timestamp: {exc}"})
            return
        limit = int(qs.get("limit", ["10000"])[0])
        out: list[dict] = []
        path = self._logs_path(cluster_id)
        with self._logs_lock:
            try:
                lines = path.read_text(encoding="utf-8").splitlines()
            except OSError:
                lines = []
        for line in lines:
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            ts = ev.get("ts_ms")
            if isinstance(ts, (int, float)) and start <= ts <= end:
                out.append(ev)
                if len(out) >= limit:
                    break
        rq._json(200, {"events": out, "start_ms": start,
                       "end_ms": None if end == (1 << 62) else end})

    # -- deploy (SSE status transitions) ----------------------------------

    def _deploy(self, rq, cluster_id: str, body: dict) -> None:
        with self.state.lock:
            record = self.state.data["clusters"].get(cluster_id)
        if record is None:
            rq._json(404, {"error": f"unknown cluster {cluster_id}"})
            return
        gateway = record["gateway_url"].rstrip("/")
        rq._sse_begin()
        try:
            rq._sse({"type": "ValidatingQueries"})
            bundle = None
            if body.get("queries_json_b64"):
                try:
                    bundle = json.loads(
                        base64.b64decode(body["queries_json_b64"])
                    )
                except Exception as exc:
                    rq._sse({"type": "QueryValidationError", "message": str(exc)})
                    return
            rq._sse({"type": "Building", "estimated_percentage": 50})
            rq._sse({"type": "Deploying"})
            if bundle is not None:
                self._gateway_post(gateway, "/v1/bundle", bundle)
            if body.get("source_files"):
                self._gateway_post(gateway, "/v1/source", {
                    "files": body["source_files"],
                    "pushed_at_ms": int(time.time() * 1000),
                })
            rq._sse({"type": "Deployed", "url": gateway})
            rq._sse({"type": "Done"})
        except Exception as exc:
            try:
                rq._sse({"type": "Error", "message": str(exc)})
            except Exception:
                pass

    @staticmethod
    def _gateway_post(gateway: str, path: str, payload: dict) -> None:
        req = urllib.request.Request(
            f"{gateway}{path}", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            if resp.status != 200:
                raise RuntimeError(f"gateway {path} -> {resp.status}")


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="helix-tpu control plane")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--state-dir", default="~/.helix-tpu/control-plane")
    args = parser.parse_args(argv)
    plane = ControlPlane(
        Path(args.state_dir).expanduser(), host=args.host, port=args.port
    )
    plane.start()
    print(f"control plane on {args.host}:{plane.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        plane.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
