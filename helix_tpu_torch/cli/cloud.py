"""Control-plane commands: auth, workspace/project/cluster, push, sync.

The reference's L7 surface (``helix-cli/src/commands/{auth,push,
enterprise_deploy,sync,config}.rs`` + ``enterprise_cloud.rs``) targets a
hosted control plane.  This rebuild keeps the same command surface and
state files but points them at engine gateways directly:

- credentials at ``~/.helix-tpu/credentials`` (``helix_user_id=`` /
  ``helix_user_key=`` key-value lines, reference ``auth.rs:171-216``)
- workspace/project selection at ``~/.helix-tpu/config``
- a cluster registry at ``~/.helix-tpu/clusters.json`` mapping cluster
  ids to gateway URLs + auth env names (the reference resolves these
  from the cloud API, ``enterprise_cloud.rs:383-419``)
- ``push`` compiles the project's query module to a queries.json bundle
  (the analog of the reference's ``cargo run`` compile step,
  ``enterprise_deploy.rs:131-177``), collects a bounded source snapshot
  (<=2000 files / <=20MB, ``:13-15``), and ships both to the gateway
- ``sync`` reconciles local ``db/`` sources against the gateway's stored
  snapshot with sha256+mtime manifests and LocalNewer/RemoteNewer/
  TieOrUnknown divergence classes with a 5s skew window
  (``sync.rs:22``, ``:72-117``)

Port copy of ``helix_tpu/cli/cloud.py`` for ``helix_tpu_torch``.

``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import sys
import time
from pathlib import Path

from ..client import Client, HelixError

STATE_HOME = Path(os.environ.get("HELIX_TPU_HOME", "~/.helix-tpu")).expanduser()
MAX_FILES = 2000
MAX_BYTES = 20 * 1024 * 1024
CLOCK_SKEW_MS = 5000


def cloud_authority() -> str | None:
    """Control-plane URL (reference env ``CLOUD_AUTHORITY``,
    ``enterprise_cloud.rs:9-11``).  When set, auth/cluster/push talk to
    the control-plane service (:mod:`helix_tpu_torch.server.control_plane`);
    unset, the local file-backed registry is used."""
    url = os.environ.get("CLOUD_AUTHORITY")
    return url.rstrip("/") if url else None


def _cloud_request(
    path: str, payload: dict | None = None, *, method: str | None = None,
    authed: bool = True,
) -> dict:
    import urllib.error
    import urllib.request

    authority = cloud_authority()
    assert authority is not None
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        f"{authority}{path}", data=data,
        method=method or ("POST" if data is not None else "GET"),
        headers={"Content-Type": "application/json"},
    )
    if authed:
        creds = require_auth()
        req.add_header("Authorization", f"Bearer {creds['helix_user_key']}")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        raise SystemExit(_cloud_error(path, exc)) from exc
    except urllib.error.URLError as exc:
        raise SystemExit(
            f"cloud request to {path} failed: {exc.reason}"
        ) from exc


def _cloud_sse(path: str, payload: dict | None = None, authed: bool = True):
    """POST (or GET) an SSE route; yield decoded event dicts."""
    import urllib.error
    import urllib.request

    authority = cloud_authority()
    assert authority is not None
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        f"{authority}{path}", data=data,
        headers={"Content-Type": "application/json"},
    )
    if authed:
        creds = require_auth()
        req.add_header("Authorization", f"Bearer {creds['helix_user_key']}")
    try:
        resp = urllib.request.urlopen(req, timeout=300)
    except urllib.error.HTTPError as exc:
        raise SystemExit(_cloud_error(path, exc)) from exc
    except urllib.error.URLError as exc:
        raise SystemExit(
            f"cloud request to {path} failed: {exc.reason}"
        ) from exc
    with resp:
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                yield json.loads(line[len("data: "):])


def _cloud_error(path: str, exc) -> str:
    """Human message for a control-plane HTTP error (the raw traceback
    hid the server's own error text)."""
    detail = ""
    try:
        body = json.loads(exc.read())
        detail = body.get("error") or ""
    except Exception:
        pass
    msg = f"cloud request to {path} failed: HTTP {exc.code}"
    if exc.code == 401:
        msg += " (credentials rejected; re-run `auth login`)"
    return f"{msg}" + (f" — {detail}" if detail else "")


def _credentials_path() -> Path:
    return STATE_HOME / "credentials"


def _config_path() -> Path:
    return STATE_HOME / "config"


def _clusters_path() -> Path:
    return STATE_HOME / "clusters.json"


def _read_kv(path: Path) -> dict[str, str]:
    out: dict[str, str] = {}
    try:
        for line in path.read_text().splitlines():
            key, _, value = line.partition("=")
            if key.strip():
                out[key.strip()] = value.strip()
    except OSError:
        pass
    return out


def _write_kv(path: Path, values: dict[str, str]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        "".join(f"{k}={v}\n" for k, v in values.items()), encoding="utf-8"
    )


def _load_clusters() -> dict:
    try:
        return json.loads(_clusters_path().read_text())
    except (OSError, json.JSONDecodeError):
        return {}


def _save_clusters(clusters: dict) -> None:
    _clusters_path().parent.mkdir(parents=True, exist_ok=True)
    _clusters_path().write_text(json.dumps(clusters, indent=2))


def require_auth() -> dict[str, str]:
    creds = _read_kv(_credentials_path())
    if "helix_user_id" not in creds or "helix_user_key" not in creds:
        raise SystemExit(
            "not logged in; run: helix-tpu auth login --user-id <id> --user-key <key>"
        )
    return creds


def _cluster_client(cluster_id: str) -> Client:
    if cloud_authority():
        import urllib.error

        try:
            cluster = _cloud_request(
                f"/api/cli/enterprise-clusters/{cluster_id}"
            )
        except urllib.error.HTTPError as exc:
            raise SystemExit(
                f"unknown cluster '{cluster_id}' on the control plane "
                f"({exc.code}); add it with: helix-tpu cluster add <id> "
                "--gateway <url>"
            )
        auth_env = cluster.get("query_auth_env", "HELIX_API_KEY")
        return Client(cluster["gateway_url"], api_key=os.environ.get(auth_env))
    clusters = _load_clusters()
    cluster = clusters.get(cluster_id)
    if cluster is None:
        raise SystemExit(
            f"unknown cluster '{cluster_id}'; add it with: "
            "helix-tpu cluster add <id> --gateway <url>"
        )
    auth_env = cluster.get("query_auth_env", "HELIX_API_KEY")
    return Client(cluster["gateway_url"], api_key=os.environ.get(auth_env))


# ---------------------------------------------------------------------------
# auth
# ---------------------------------------------------------------------------

def cmd_auth(args) -> int:
    if args.action == "login" and getattr(args, "device", False):
        return _device_login()
    if args.action == "login":
        if not args.user_id or not args.user_key:
            if cloud_authority():
                return _device_login()
            print("auth login requires --user-id and --user-key "
                  "(or CLOUD_AUTHORITY + --device)", file=sys.stderr)
            return 2
        creds = _read_kv(_credentials_path())
        creds["helix_user_id"] = args.user_id
        creds["helix_user_key"] = args.user_key
        _write_kv(_credentials_path(), creds)
        print(f"logged in as {args.user_id}")
        return 0
    if args.action == "status":
        creds = _read_kv(_credentials_path())
        if "helix_user_id" in creds:
            print(f"logged in as {creds['helix_user_id']}")
        else:
            print("not logged in")
        return 0
    if args.action == "logout":
        creds = _read_kv(_credentials_path())
        creds.pop("helix_user_id", None)
        creds.pop("helix_user_key", None)
        _write_kv(_credentials_path(), creds)
        print("logged out")
        return 0
    if args.action == "create-key":
        # Cluster API-key rotation (reference `helix auth create-key
        # <cluster>`, auth.rs:95-140: POST .../enterprise-clusters/
        # <id>/key, previous keys revoked, new key shown once).
        cluster = getattr(args, "cluster", None)
        if not cluster:
            print("auth create-key requires a cluster id", file=sys.stderr)
            return 2
        if not cloud_authority():
            print("auth create-key needs CLOUD_AUTHORITY set to the "
                  "control plane URL", file=sys.stderr)
            return 2
        resp = _cloud_request(
            f"/api/cli/enterprise-clusters/{cluster}/key", {}
        )
        print("Cluster API key refresh completed")
        if resp.get("warning"):
            print(resp["warning"])
        else:
            print("Previous cluster keys were revoked.")
        print(f"Cluster: {cluster}")
        print(f"New API key (shown once): {resp['key']}")
        return 0
    print(f"unknown auth action: {args.action}", file=sys.stderr)
    return 2


def _device_login() -> int:
    """Device-code login over SSE against the control plane (reference:
    GitHub device flow, ``auth.rs:265-316`` + ``sse_client.rs:11-91``)."""
    if not cloud_authority():
        print("device login needs CLOUD_AUTHORITY set to the control "
              "plane URL", file=sys.stderr)
        return 2
    grant = _cloud_request("/api/cli/auth/device", {}, authed=False)
    print(f"confirm this device at: {grant['verification_uri']}")
    print(f"device code: {grant['device_code']}")
    for event in _cloud_sse(
        f"/api/cli/auth/device/{grant['device_code']}/events", authed=False
    ):
        kind = event.get("type")
        if kind == "UserVerification":
            continue
        if kind == "DeviceCodeTimeout":
            print("device code expired; run auth login again", file=sys.stderr)
            return 1
        if kind == "Success":
            creds = _read_kv(_credentials_path())
            creds["helix_user_id"] = event["user_id"]
            creds["helix_user_key"] = event["user_key"]
            _write_kv(_credentials_path(), creds)
            print(f"logged in as {event['user_id']}")
            return 0
    print("login stream ended without a result", file=sys.stderr)
    return 1


# ---------------------------------------------------------------------------
# workspace / cluster registry
# ---------------------------------------------------------------------------

def cmd_config_group(args) -> int:
    """Hidden ``helix config <workspace|project|cluster> ...`` grouping
    command (reference ``Commands::Config``, commands/config.rs:19-28):
    delegates to the top-level command with its default action."""
    defaults = {"workspace": "show", "project": "show", "cluster": "list"}
    if args.action is None:
        args.action = defaults[args.target]
    return {
        "workspace": cmd_workspace,
        "project": cmd_project,
        "cluster": cmd_cluster,
    }[args.target](args)


def cmd_workspace(args) -> int:
    config = _read_kv(_config_path())
    if args.action == "use":
        if not args.name:
            print("workspace use requires a name", file=sys.stderr)
            return 2
        config["workspace"] = args.name
        _write_kv(_config_path(), config)
        print(f"active workspace: {args.name}")
        return 0
    current = config.get("workspace", "(none)")
    print(f"active workspace: {current}")
    return 0


def cmd_project(args) -> int:
    """Select/list projects (reference ``helix project``,
    ``commands/config.rs:19-60``).  With CLOUD_AUTHORITY set, projects
    live on the control plane; otherwise in ``~/.helix-tpu/config``."""
    config = _read_kv(_config_path())
    if args.action == "use":
        if not args.name:
            print("project use requires a name", file=sys.stderr)
            return 2
        if cloud_authority():
            _cloud_request("/api/cli/projects", {
                "name": args.name,
                "workspace": config.get("workspace", "default"),
            })
        config["project"] = args.name
        _write_kv(_config_path(), config)
        print(f"active project: {args.name}")
        return 0
    if args.action == "list":
        if cloud_authority():
            projects = _cloud_request("/api/cli/projects").get("projects", {})
            if not projects:
                print("no projects")
                return 0
            for name, record in sorted(projects.items()):
                print(f"{name}  workspace={record.get('workspace', 'default')}")
            return 0
        current = config.get("project")
        print(current if current else "no projects")
        return 0
    print(f"active project: {config.get('project', '(none)')}")
    return 0


def cmd_cluster(args) -> int:
    if cloud_authority():
        return _cmd_cluster_cloud(args)
    clusters = _load_clusters()
    if args.action == "add":
        if not args.name or not args.gateway:
            print("cluster add requires <name> --gateway <url>", file=sys.stderr)
            return 2
        clusters[args.name] = {
            "gateway_url": args.gateway,
            "query_auth_env": args.auth_env or "HELIX_API_KEY",
        }
        _save_clusters(clusters)
        print(f"registered cluster '{args.name}' -> {args.gateway}")
        return 0
    if args.action == "remove":
        clusters.pop(args.name, None)
        _save_clusters(clusters)
        print(f"removed cluster '{args.name}'")
        return 0
    if not clusters:
        print("no clusters registered")
        return 0
    fmt_json = getattr(args, "format", None) == "json"
    if fmt_json:
        print(json.dumps(clusters, indent=2))
        return 0
    for name, cluster in sorted(clusters.items()):
        print(f"{name}  {cluster['gateway_url']}  auth_env={cluster['query_auth_env']}")
    return 0


def _cmd_cluster_cloud(args) -> int:
    """Cluster registry backed by the control plane."""
    if args.action == "add":
        if not args.name or not args.gateway:
            print("cluster add requires <name> --gateway <url>", file=sys.stderr)
            return 2
        out = _cloud_request("/api/cli/enterprise-clusters", {
            "cluster_id": args.name,
            "gateway_url": args.gateway,
            "query_auth_env": args.auth_env or "HELIX_API_KEY",
        })
        print(f"registered cluster '{out['cluster_id']}' -> {out['gateway_url']}")
        return 0
    if args.action == "remove":
        print("cluster remove is not supported against the control plane",
              file=sys.stderr)
        return 2
    clusters = _cloud_request("/api/cli/enterprise-clusters").get("clusters", {})
    if not clusters:
        print("no clusters registered")
        return 0
    if getattr(args, "format", None) == "json":
        print(json.dumps(clusters, indent=2))
        return 0
    for name, cluster in sorted(clusters.items()):
        print(f"{name}  {cluster['gateway_url']}  "
              f"auth_env={cluster['query_auth_env']}")
    return 0


# ---------------------------------------------------------------------------
# push (compile + deploy)
# ---------------------------------------------------------------------------

def compile_queries(queries_dir: Path) -> dict | None:
    """Build the queries.json bundle from the project's query module.

    The analog of the reference's ``cargo run`` compile step: if
    ``<dir>/queries.py`` exists it is executed against the DSL prelude
    and must call ``define_queries(...)`` (the result's bundle is
    captured); otherwise an existing ``queries.json`` is loaded.
    """
    module = queries_dir / "queries.py"
    if module.exists():
        from .. import dsl as _dsl

        namespace = {
            name: getattr(_dsl, name)
            for name in _dsl.__all__
            if hasattr(_dsl, name)
        }
        captured: list = []
        original = _dsl.define_queries

        def capturing(definitions):
            defined = original(definitions)
            captured.append(defined)
            return defined

        namespace["define_queries"] = capturing
        code = compile(module.read_text(), str(module), "exec")
        exec(code, namespace)  # noqa: S102 - project-authored build script
        if not captured:
            raise SystemExit(f"{module} never called define_queries(...)")
        return captured[-1].build_query_bundle()
    bundle_path = queries_dir / "queries.json"
    if bundle_path.exists():
        return json.loads(bundle_path.read_text())
    return None


def collect_source_snapshot(queries_dir: Path) -> dict:
    """Bounded source snapshot (reference caps: 2000 files / 20 MB)."""
    files = {}
    total = 0
    count = 0
    if queries_dir.exists():
        for path in sorted(queries_dir.rglob("*")):
            if not path.is_file():
                continue
            if any(part in ("target", ".git", "__pycache__") for part in path.parts):
                continue
            data = path.read_bytes()
            total += len(data)
            count += 1
            if count > MAX_FILES or total > MAX_BYTES:
                raise SystemExit(
                    f"source snapshot exceeds limits ({MAX_FILES} files / "
                    f"{MAX_BYTES} bytes)"
                )
            rel = str(path.relative_to(queries_dir))
            files[rel] = {
                "content_b64": base64.b64encode(data).decode(),
                "sha256": hashlib.sha256(data).hexdigest(),
                "last_modified_ms": int(path.stat().st_mtime * 1000),
            }
    return files


def cmd_push(args) -> int:
    from .config import find_project

    require_auth()
    project = find_project()
    queries_dir = project.root / project.queries_dir
    bundle = compile_queries(queries_dir)
    payload_files = collect_source_snapshot(queries_dir)
    if cloud_authority():
        # Deploy through the control plane; it validates, pushes to the
        # cluster's gateway, and streams status transitions
        # (ValidatingQueries -> Building -> Deploying -> Deployed,
        # sse_client.rs:60-91).
        payload = {
            "instance_name": args.cluster,
            "source_files": payload_files,
        }
        if bundle is not None:
            payload["queries_json_b64"] = base64.b64encode(
                json.dumps(bundle).encode()
            ).decode()
        ok = False
        for event in _cloud_sse(
            f"/api/cli/enterprise-clusters/{args.cluster}/deploy", payload
        ):
            kind = event.get("type")
            if kind == "Deployed":
                print(f"deployed to {event.get('url')}")
                ok = True
            elif kind in ("Error", "QueryValidationError"):
                print(f"push failed: {event.get('message')}", file=sys.stderr)
                return 1
            elif kind not in ("Done",):
                print(f"  {kind.lower()}...")
        return 0 if ok else 1
    client = _cluster_client(args.cluster)
    try:
        if bundle is not None:
            installed = client.deploy_bundle(bundle)
            print(f"deployed routes: {', '.join(installed['installed']) or '(none)'}")
        _post_source(client, payload_files)
        print(f"pushed {len(payload_files)} source files to '{args.cluster}'")
    except HelixError as exc:
        print(f"push failed: {exc}", file=sys.stderr)
        return 1
    return 0


def _post_source(client: Client, files: dict) -> dict:
    from ..client import _post

    return _post(
        f"{client.url}/v1/source",
        {"files": files, "pushed_at_ms": int(time.time() * 1000)},
        {},
        client.api_key,
    )


def _get_source(client: Client) -> dict:
    import urllib.request

    req = urllib.request.Request(f"{client.url}/v1/source", method="GET")
    if client.api_key:
        req.add_header("Authorization", f"Bearer {client.api_key}")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


# ---------------------------------------------------------------------------
# sync (manifest reconciliation)
# ---------------------------------------------------------------------------

def classify(local: dict | None, remote: dict | None) -> str:
    if local is None and remote is None:
        return "BothEmpty"
    if remote is None:
        return "LocalOnly"
    if local is None:
        return "RemoteOnly"
    if local["sha256"] == remote["sha256"]:
        return "InSync"
    delta = local["last_modified_ms"] - remote["last_modified_ms"]
    if delta > CLOCK_SKEW_MS:
        return "LocalNewer"
    if delta < -CLOCK_SKEW_MS:
        return "RemoteNewer"
    return "TieOrUnknown"


def cmd_sync(args) -> int:
    from .config import find_project

    require_auth()
    project = find_project()
    queries_dir = project.root / project.queries_dir
    client = _cluster_client(args.cluster)
    try:
        remote = _get_source(client).get("files", {})
    except Exception as exc:
        print(f"sync failed to fetch remote snapshot: {exc}", file=sys.stderr)
        return 1
    local = collect_source_snapshot(queries_dir)

    pulls, pushes, ties = [], [], []
    for name in sorted(set(local) | set(remote)):
        state = classify(local.get(name), remote.get(name))
        if state in ("LocalOnly", "LocalNewer"):
            pushes.append(name)
        elif state in ("RemoteOnly", "RemoteNewer"):
            pulls.append(name)
        elif state == "TieOrUnknown":
            ties.append(name)

    if not (pulls or pushes or ties):
        print("in sync")
        return 0
    for name in pulls:
        print(f"pull:  {name}")
    for name in pushes:
        print(f"push:  {name}")
    for name in ties:
        print(f"tie:   {name} (diverged within clock skew; resolve manually)")
    if args.dry_run:
        return 0
    if not args.yes:
        if sys.stdout is not sys.__stdout__ or not sys.stdin.isatty():
            # --quiet (or no TTY): the plan and prompt are invisible —
            # require an explicit --yes instead of hanging on input()
            print("sync needs confirmation; re-run with --yes",
                  file=sys.stderr)
            return 1
        answer = input("apply this plan? [y/N] ").strip().lower()
        if answer != "y":
            print("aborted")
            return 1
    for name in pulls:
        target = _safe_member(queries_dir, name)
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_bytes(base64.b64decode(remote[name]["content_b64"]))
    if pushes:
        # Push ONLY the planned files on top of the remote snapshot:
        # the server's /v1/source is full-replacement, so posting the
        # raw local snapshot would destroy the remote's copy of every
        # tie the plan just told the user to resolve manually.
        local_now = collect_source_snapshot(queries_dir)
        merged = dict(remote)
        for name in pushes:
            if name in local_now:
                merged[name] = local_now[name]
            else:
                merged.pop(name, None)
        # pulled files are already identical both sides; refresh them
        # from local so mtimes stay coherent
        for name in pulls:
            if name in local_now:
                merged[name] = local_now[name]
        _post_source(client, merged)
    print(f"synced: pulled {len(pulls)}, pushed {len(pushes)}")
    return 0


def _safe_member(root, name: str):
    """Resolve a remote-supplied file name strictly INSIDE ``root`` —
    a malicious gateway must not be able to write outside the project
    via '../' segments or absolute paths."""
    from pathlib import PurePosixPath

    pure = PurePosixPath(name)
    if pure.is_absolute() or any(p in ("..", "") for p in pure.parts):
        raise SystemExit(f"refusing unsafe remote file name: {name!r}")
    target = (root / pure).resolve()
    root_resolved = root.resolve()
    if root_resolved != target and root_resolved not in target.parents:
        raise SystemExit(f"refusing unsafe remote file name: {name!r}")
    return target
