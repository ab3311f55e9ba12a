"""CLI entry point: project + instance lifecycle and query dispatch.

Command surface mirrors the reference CLI's local workflow
(``helix-cli/src/main.rs:61-335``): init, start, stop, restart, status,
logs, query, prune, delete, deploy.  Instead of pulling a container image,
``start`` launches the engine server as a local process (SURVEY.md §7.6);
readiness uses the same real-query probe as the reference
(``local_runtime.rs:584``: a ``NWhere($label=="__HelixReadiness__")``+Count
batch against ``/v1/query``).

Port copy of ``helix_tpu/cli/main.py`` for ``helix_tpu_torch``
(``python -m helix_tpu_torch.cli``).  An instance's engine runs on
``--device`` (``cuda`` unless told otherwise): ``start`` spawns
``helix_tpu_torch.server.http_server --device <device>`` (under the
port's supervisor with a restart policy), so without a card the
server exits naming CUDA, ``start`` fails its readiness wait, and the
CPU serves only on ``--device cpu``.  The scaffolding a project gets
from ``init``, ``chef`` and ``skills`` imports ``helix_tpu_torch``.

``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:

- ``cmd_start``: takes ``--device`` into the server's argv (and into
  ``serve`` under ``--foreground``).
- ``main``: ``start`` and ``restart`` take ``--device`` (``cuda`` or
  ``cpu``, default ``cuda``).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

from ..client import Client, HelixError
from . import cloud
from .config import (
    DEFAULT_PORT, ConfigError, find_project, write_default_config,
)

READINESS_REQUEST = {
    "request_type": "read",
    "query_name": None,
    "query": {
        "queries": [
            {
                "Query": {
                    "name": "ready",
                    "steps": [
                        {"NWhere": {"Eq": ["$label", {"String": "__HelixReadiness__"}]}},
                        "Count",
                    ],
                    "condition": None,
                }
            }
        ],
        "returns": ["ready"],
    },
    "parameters": {},
}

AGENTS_MD = """# Working with this helix-tpu project

This project uses helix-tpu, a TPU-native graph-vector database speaking
the HelixDB dynamic-query wire protocol.  `helix.toml` holds the project
config; `.helix/` holds instance state (gitignored).

## Workflow

```bash
python -m helix_tpu_torch.cli start {instance}       # start the local engine
python -m helix_tpu_torch.cli query {instance} --file examples/request.json
python -m helix_tpu_torch.cli query {instance} -e 'read_batch().var_as("users", g().n_with_label("User")).returning(["users"])'
python -m helix_tpu_torch.cli status                 # instance state
python -m helix_tpu_torch.cli logs {instance}        # server logs
python -m helix_tpu_torch.cli stop {instance}        # stop (memory mode loses data; use --disk)
```

Queries are validated by the running instance; `-e` evaluates a Python
DSL expression against the SDK prelude (g, read_batch, write_batch,
Predicate, define_params, param, ...).

## Query shapes

- Dynamic JSON request: POST /v1/query with
  {{"request_type": "read"|"write", "query": {{"queries": [...], "returns": [...]}}}}
- Stored routes: deploy a queries.json bundle (python -m helix_tpu_torch.cli
  deploy) then POST /v1/query/<name> with bare parameters.
- Vector search: create_vector_index_nodes(label, property) then
  vector_search_nodes(label, property, query_vector, k); hits are
  ascending by $distance.
- Full-text: create_text_index_nodes then text_search_nodes; hits are
  descending by $score.
"""

EXAMPLE_REQUEST = {
    "request_type": "read",
    "query": {
        "queries": [
            {
                "Query": {
                    "name": "node_count",
                    "steps": [
                        {"NWhere": {"Eq": ["$label", {"String": "User"}]}},
                        "Count",
                    ],
                    "condition": None,
                }
            }
        ],
        "returns": ["node_count"],
    },
    "parameters": {},
}


def _instance_client(project, name: str | None) -> Client:
    inst = project.instance(name)
    return Client(f"http://localhost:{inst.port}")


def cmd_init(args) -> int:
    root = Path(args.path).resolve() if args.path else Path.cwd()
    root.mkdir(parents=True, exist_ok=True)
    write_default_config(root, args.name or root.name, args.instance, args.port)
    examples = root / "examples"
    examples.mkdir(exist_ok=True)
    request_path = examples / "request.json"
    if not request_path.exists():
        request_path.write_text(json.dumps(EXAMPLE_REQUEST, indent=2), encoding="utf-8")
    agents = root / "AGENTS.md"
    if not agents.exists():
        agents.write_text(AGENTS_MD.format(instance=args.instance), encoding="utf-8")
    gitignore = root / ".gitignore"
    existing = gitignore.read_text(encoding="utf-8") if gitignore.exists() else ""
    wanted = [".helix/", "*.log"]
    additions = [w for w in wanted if w not in existing]
    if additions:
        prefix = existing + ("\n" if existing and not existing.endswith("\n") else "")
        gitignore.write_text(prefix + "\n".join(additions) + "\n", encoding="utf-8")
    print(f"Initialized helix-tpu project at {root}")
    print(f"Next: cd {root} && python -m helix_tpu_torch.cli start {args.instance}")
    return 0


def _process_gone(pid: int) -> bool:
    """True when ``pid`` no longer runs.  A zombie (exited but not yet
    reaped by its parent — e.g. a supervisor started from a test
    process) counts as gone: ``os.kill(pid, 0)`` still succeeds on it."""
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return True
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        # no /proc (non-Linux) or raced a just-exited pid: kill(0)
        # above said alive, so report alive — "gone" here made every
        # live process look dead on macOS (duplicate starts, dead
        # status, no-op stops)
        return False


def _pidfile(project, instance: str) -> Path:
    return project.state_dir(instance) / "server.pid"


def _logfile(project, instance: str) -> Path:
    return project.state_dir(instance) / "server.log"


def _portfile(project, instance: str) -> Path:
    return project.state_dir(instance) / "server.port"


def _active_port(project, inst) -> int:
    """Configured port, overridden by the running server's recorded port
    (start may have fallen forward past a busy port)."""
    path = _portfile(project, inst.name)
    if path.exists():
        try:
            return int(path.read_text().strip())
        except ValueError:
            pass
    return inst.port


def _read_pid(project, instance: str) -> int | None:
    path = _pidfile(project, instance)
    if not path.exists():
        return None
    try:
        pid = int(path.read_text().strip())
    except ValueError:
        return None
    if _process_gone(pid):
        return None
    return pid


def _wait_ready(port: int, timeout: float | None = None) -> bool:
    """Readiness = the real-query probe succeeding (local_runtime.rs:558-600).

    Default budget is the reference's 30 s; HELIX_READY_TIMEOUT_S
    overrides it (CI boxes under load can take longer than 30 s just to
    import JAX in the spawned server)."""
    if timeout is None:
        timeout = float(os.environ.get("HELIX_READY_TIMEOUT_S", "30"))
    client = Client(f"http://localhost:{port}")
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            out = client.query().dynamic(READINESS_REQUEST).send()
            if "ready" in out:
                return True
        except HelixError:
            pass
        time.sleep(0.25)
    return False


def _probe_port(port: int, fallback_scan: int = 100) -> int:
    """Return ``port`` if free, else the first free port in the next 100
    (the reference's fall-forward scan, ``helix-cli/src/port.rs:11-31``)."""
    import socket

    for candidate in range(port, port + fallback_scan):
        with socket.socket() as sock:
            # TIME_WAIT remnants of a just-stopped instance are not "busy"
            # (the server binds with SO_REUSEADDR too).
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                # bind the wildcard interface like the spawned server
                # does — a service bound to a specific non-loopback
                # interface would pass a 127.0.0.1 probe and then kill
                # the server with EADDRINUSE
                sock.bind(("", candidate))
            except OSError:
                continue
            return candidate
    raise ConfigError(f"no free port in {port}..{port + fallback_scan}")


def cmd_start(args) -> int:
    project = find_project()
    inst = project.instance(args.instance)
    port = args.port or inst.port
    if _read_pid(project, inst.name) is not None:
        print(f"instance '{inst.name}' is already running")
        return 0
    state = project.state_dir(inst.name)
    state.mkdir(parents=True, exist_ok=True)

    free = _probe_port(port)
    if free != port:
        print(f"port {port} is busy; using {free}")
        port = free
    disk = args.disk or inst.storage == "disk"
    device = getattr(args, "device", None) or "cuda"
    data_dir = str(state / "data") if disk else None
    if getattr(args, "persist", False):
        # Write the *configured* settings back (reference start.rs:31-41
        # persists only the explicit overrides) — never the auto-bumped
        # probe port, which would silently rewire the instance to
        # whatever happened to be free this run.
        from .config import persist_instance_settings

        persist_port = args.port or inst.port
        persist_instance_settings(
            project.root, inst.name, persist_port,
            "disk" if disk else "memory",
        )
        print(f"persisted port={persist_port} storage="
              f"{'disk' if disk else 'memory'} to helix.toml")
    # Storage-mode notices (reference start.rs:64-82): disk mode gets a
    # one-line note every run; memory mode warns about data loss only on
    # the instance's first start (marker file).
    if disk:
        print(f"storage: disk ({data_dir})")
    else:
        marker = state / ".warned-memory"
        if not marker.exists():
            print(
                "warning: in-memory storage — data is lost when the "
                "instance stops (use --disk or storage = \"disk\" in "
                "helix.toml to persist)"
            )
            marker.write_text("")
    if args.foreground:
        from ..server import serve

        print(f"Serving instance '{inst.name}' on port {port} (Ctrl-C to stop)")
        serve("0.0.0.0", port, data_dir=data_dir, device=device)
        return 0

    log = open(_logfile(project, inst.name), "ab")
    env = dict(os.environ)
    package_root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = (
        package_root + os.pathsep + env["PYTHONPATH"]
        if env.get("PYTHONPATH")
        else package_root
    )
    restart_policy = getattr(args, "restart_policy", None) or inst.restart
    server_argv = [
            sys.executable, "-m", "helix_tpu_torch.server.http_server",
            "--port", str(port),
            *(["--data-dir", data_dir] if data_dir else []),
            *(
                ["--snapshot-store", str(inst.db["snapshot_store"])]
                if data_dir and inst.db.get("snapshot_store")
                else []
            ),
            "--telemetry-path", str(state / "metrics.jsonl"),
            "--metric", str(inst.vector.get("metric", "cosine")),
            *(
                ["--shard-threshold", str(inst.vector["shard_threshold"])]
                if inst.vector.get("shard_threshold") is not None
                else []
            ),
            *(
                ["--graph-shard-threshold",
                 str(inst.vector["graph_shard_threshold"])]
                if inst.vector.get("graph_shard_threshold") is not None
                else []
            ),
            *(
                ["--quant-candidates", str(inst.vector["quant_candidates"])]
                if inst.vector.get("quant_candidates") is not None
                else []
            ),
            *(
                ["--max-size-gb", str(inst.vector["db_max_size_gb"])]
                if inst.vector.get("db_max_size_gb") is not None
                else []
            ),
            *([] if inst.db.get("bm25", True) else ["--no-bm25"]),
            *([] if inst.db.get("mcp", True) else ["--no-mcp"]),
            *(
                arg
                for entry in inst.db.get("graph_config", {}).get(
                    "secondary_indices", []
                )
                for arg in ("--secondary-index", str(entry))
            ),
            *(
                ["--replica-of", args.replica_of]
                if getattr(args, "replica_of", None)
                else []
            ),
            "--device", device,
    ]
    if restart_policy != "no":
        # Restart-policy supervision (reference: containers run with
        # ``--restart unless-stopped``, local_runtime.rs:699-703).  The
        # pidfile tracks the supervisor; it records the engine child in
        # <state>/engine.pid and restarts it per policy.
        server_argv = [
            sys.executable, "-m", "helix_tpu_torch.cli.supervisor",
            "--policy", restart_policy,
            "--state-dir", str(state),
            "--", *server_argv,
        ]
    proc = subprocess.Popen(
        server_argv,
        stdout=log,
        stderr=subprocess.STDOUT,
        cwd=project.root,
        env=env,
        start_new_session=True,
    )
    _pidfile(project, inst.name).write_text(str(proc.pid))
    _portfile(project, inst.name).write_text(str(port))
    if not _wait_ready(port):
        print(f"instance '{inst.name}' failed to become ready in time", file=sys.stderr)
        return 1
    print(f"instance '{inst.name}' ready on localhost:{port}")
    # Auto-deploy the project's queries.json bundle if present.
    bundle = project.root / project.queries_dir / "queries.json"
    if bundle.exists():
        try:
            Client(f"http://localhost:{port}").deploy_bundle(
                json.loads(bundle.read_text())
            )
            print(f"deployed query bundle from {bundle}")
        except HelixError as exc:
            print(f"warning: bundle deploy failed: {exc}", file=sys.stderr)
    return 0


def cmd_stop(args) -> int:
    project = find_project()
    inst = project.instance(args.instance)
    pid = _read_pid(project, inst.name)
    if pid is None:
        print(f"instance '{inst.name}' is not running")
        return 0
    os.kill(pid, signal.SIGTERM)
    # Give a disk-mode server time to checkpoint before reporting stopped.
    for _ in range(100):
        if _process_gone(pid):
            break
        time.sleep(0.1)
    if not _process_gone(pid):
        # still checkpointing: unlinking the pidfile now would let a
        # second start open the same data directory while this engine
        # is mid-checkpoint (two writers on one store)
        print(
            f"instance '{inst.name}' (pid {pid}) is still shutting down; "
            "retry stop in a moment",
            file=sys.stderr,
        )
        return 1
    # Supervised instances: the pidfile tracked the supervisor; make sure
    # the engine child is gone too (it normally exits with the
    # supervisor, but a killed supervisor can orphan it).
    engine_pidfile = project.state_dir(inst.name) / "engine.pid"
    if engine_pidfile.exists():
        try:
            os.kill(int(engine_pidfile.read_text().strip()), signal.SIGTERM)
        except (ValueError, ProcessLookupError, PermissionError):
            pass
        engine_pidfile.unlink(missing_ok=True)
    _pidfile(project, inst.name).unlink(missing_ok=True)
    _portfile(project, inst.name).unlink(missing_ok=True)
    if inst.storage == "disk" or (project.state_dir(inst.name) / "data").exists():
        print(f"stopped instance '{inst.name}' (data persisted to disk)")
    else:
        print(f"stopped instance '{inst.name}' (in-memory data is lost)")
    return 0


def cmd_restart(args) -> int:
    cmd_stop(args)
    time.sleep(0.2)
    return cmd_start(args)


def cmd_control_plane(args) -> int:
    """Run the cloud control-plane service (reference:
    cloud.helix-db.com/api/cli, enterprise_cloud.rs:7-22).  Point the
    CLI at it with CLOUD_AUTHORITY=http://host:port."""
    from ..server.control_plane import main as cp_main

    return cp_main(["--port", str(args.port), "--state-dir", args.state_dir])


def cmd_gateway(args) -> int:
    """HA gateway front (reference cloud topology: single writer +
    autoscaled readers behind redundant gateways, README.md:248)."""
    from ..server.ha_front import main as ha_main

    argv = ["--port", str(args.port), "--primary", args.primary]
    for url in args.replica:
        argv += ["--replica", url]
    return ha_main(argv)


def cmd_status(args) -> int:
    project = find_project()
    any_row = False
    for name, inst in sorted(project.locals.items()):
        if args.instance and name != args.instance:
            continue
        any_row = True
        pid = _read_pid(project, name)
        if pid is None:
            print(f"{name} (local)  stopped")
            continue
        port = _active_port(project, inst)
        restarts_file = project.state_dir(name) / "restarts"
        suffix = ""
        if restarts_file.exists():
            try:
                suffix = f"  restarts={int(restarts_file.read_text().strip())}"
            except ValueError:
                pass
        try:
            health = Client(f"http://localhost:{port}").health()
            if "max_size_bytes" in health:
                # capacity envelope headroom (db_max_size_gb)
                used = health.get("approx_data_bytes", 0)
                pct = 100.0 * used / max(health["max_size_bytes"], 1)
                suffix += f"  size={used / (1 << 20):.0f}MB ({pct:.0f}% of cap)"
            print(
                f"{name} (local)  running  localhost:{port}  "
                f"pid={pid}  nodes={health['nodes']}  edges={health['edges']}"
                f"{suffix}"
            )
        except HelixError:
            print(f"{name} (local)  starting  localhost:{port}  pid={pid}{suffix}")
    if not any_row:
        print("no instances defined")
    return 0


def cmd_logs(args) -> int:
    # Historical range queries (the reference's enterprise-logs path,
    # helix-cli/src/commands/logs/mod.rs:21-50): ISO-8601 --start/--end
    # against the control plane's per-cluster query-event history.
    if getattr(args, "start", None) or getattr(args, "end", None) \
            or getattr(args, "cluster", None):
        if getattr(args, "follow", False):
            # matches the reference: live-follow is unsupported for
            # historical/enterprise log queries (logs/mod.rs:52-60)
            print("--follow is not supported with --start/--end/--cluster",
                  file=sys.stderr)
            return 2
        return _range_logs(args)
    project = find_project()
    inst = project.instance(args.instance)
    if getattr(args, "events", False):
        return _follow_events(project, inst)
    path = _logfile(project, inst.name)
    if not path.exists():
        print("no logs yet")
        return 0
    text = path.read_text(errors="replace")
    if args.tail:
        text = "\n".join(text.splitlines()[-args.tail:])
    print(text, end="" if text.endswith("\n") else "\n")
    if getattr(args, "follow", False):
        with open(path, "r", errors="replace") as fh:
            fh.seek(0, 2)
            try:
                while True:
                    line = fh.readline()
                    if line:
                        print(line, end="")
                    else:
                        time.sleep(0.5)
            except KeyboardInterrupt:
                return 0
    return 0


def _range_logs(args) -> int:
    """ISO-8601 range query against the control plane's logs API."""
    from urllib.parse import urlencode

    from .cloud import _cloud_request, cloud_authority

    if not getattr(args, "cluster", None):
        print("--start/--end need --cluster <id> (the enterprise "
              "cluster whose query history to range over)",
              file=sys.stderr)
        return 2
    if not cloud_authority():
        print("historical log queries need CLOUD_AUTHORITY set to the "
              "control plane URL", file=sys.stderr)
        return 2
    params = {}
    if args.start:
        params["start"] = args.start
    if args.end:
        params["end"] = args.end
    if getattr(args, "tail", None):
        params["limit"] = str(args.tail)
    qs = f"?{urlencode(params)}" if params else ""
    try:
        out = _cloud_request(f"/api/cli/logs/{args.cluster}{qs}")
    except SystemExit:
        raise
    except Exception as exc:
        print(f"log query failed: {exc}", file=sys.stderr)
        return 1
    for event in out.get("events", []):
        print(json.dumps(event, ensure_ascii=False))
    return 0


def _follow_events(project, inst) -> int:
    """Stream live engine events over SSE (logs --events)."""
    import urllib.request

    port = _active_port(project, inst)
    url = f"http://localhost:{port}/v1/events?after=-1"
    try:
        with urllib.request.urlopen(url) as resp:
            for raw in resp:
                line = raw.decode(errors="replace").rstrip()
                if line.startswith("data: "):
                    print(line[6:], flush=True)
    except KeyboardInterrupt:
        return 0
    except OSError as exc:
        print(f"event stream unavailable: {exc}", file=sys.stderr)
        return 1
    return 0


def _reject_unsafe_dsl_ast(tree) -> None:
    """Defense-in-depth gate for the ``query -e`` eval surface.

    The empty-``__builtins__`` namespace alone does NOT stop the
    classic escape (``().__class__.__mro__[1].__subclasses__()``
    reaches arbitrary classes through dunder attribute access), so the
    snippet AST is rejected when it contains imports or any
    dunder-prefixed name/attribute.  The restriction is documented in
    MIGRATION.md; the reference's analog (``helix-cli/src/ts_query.rs``
    evaluating arbitrary TS under Node) applies no sandbox at all —
    both are CLI-local surfaces run by the invoking user, this one just
    refuses the obvious escape idioms an agent might be prompted into.
    """
    import ast

    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            raise ValueError("imports are not allowed in DSL snippets")
        if isinstance(node, ast.Attribute) and node.attr.startswith("__"):
            raise ValueError(
                f"dunder attribute access is not allowed: {node.attr}"
            )
        if isinstance(node, ast.Name) and node.id.startswith("__"):
            raise ValueError(f"dunder name is not allowed: {node.id}")


def _eval_dsl_snippet(snippet: str):
    """Evaluate a Python DSL expression into a request (the analog of the
    reference's TS-eval bridge, ``helix-cli/src/ts_query.rs``, using our
    native SDK language instead of Node)."""
    import ast

    from .. import dsl as _dsl

    prelude = {
        name: getattr(_dsl, name)
        for name in _dsl.__all__
        if hasattr(_dsl, name)
    }
    _reject_unsafe_dsl_ast(ast.parse(snippet, mode="eval"))
    value = eval(snippet, {"__builtins__": {}}, prelude)  # noqa: S307
    if isinstance(value, _dsl.DynamicQueryRequest):
        return value.encode()
    if hasattr(value, "to_dynamic_request"):
        return value.to_dynamic_request().encode()
    raise ValueError(
        "snippet must evaluate to a read_batch()/write_batch() chain or a "
        "DynamicQueryRequest"
    )


def _eval_dsl_file(path: str) -> dict:
    """Evaluate a Python DSL FILE into a request envelope — the analog
    of the reference's ``--ts-file`` (``helix-cli/src/ts_query.rs``,
    which evaluates a TS DSL file via Node; this rebuild evaluates the
    Python DSL, MIGRATION.md 'deliberate divergences').

    A single-expression file evaluates directly; a script file runs
    with the DSL prelude in scope and must bind ``request`` to a batch
    chain or DynamicQueryRequest.
    """
    import helix_tpu_torch.dsl as _dsl

    source = Path(path).read_text()
    try:
        return _eval_dsl_snippet(source)
    except SyntaxError:
        pass  # statements, not one expression: exec + `request` binding
    prelude = {
        name: getattr(_dsl, name)
        for name in _dsl.__all__
        if hasattr(_dsl, name)
    }
    scope: dict = dict(prelude)
    # curated builtins: loop/convert helpers stay usable, imports do not
    safe_builtins = {
        name: getattr(__builtins__, name) if hasattr(__builtins__, name)
        else __builtins__[name]  # type: ignore[index]
        for name in (
            "range", "len", "enumerate", "zip", "float", "int", "str",
            "bool", "dict", "list", "tuple", "set", "min", "max", "abs",
            "round", "sorted", "sum", "reversed", "print",
        )
    }
    import ast

    _reject_unsafe_dsl_ast(ast.parse(source, path, mode="exec"))
    exec(  # noqa: S102
        compile(source, path, "exec"),
        {"__builtins__": safe_builtins}, scope,
    )
    value = scope.get("request")
    if value is None:
        raise ValueError(
            f"{path} must be a single DSL expression or bind `request`"
        )
    if isinstance(value, _dsl.DynamicQueryRequest):
        return value.encode()
    if hasattr(value, "to_dynamic_request"):
        return value.to_dynamic_request().encode()
    raise ValueError(
        "`request` must be a read_batch()/write_batch() chain or a "
        "DynamicQueryRequest"
    )


def cmd_query(args) -> int:
    project = find_project()
    inst = project.instance(args.instance)
    sources = [
        s for s in (args.file, args.json, args.expr, args.expr_file) if s
    ]
    if len(sources) != 1:
        print(
            "provide exactly one of --file, --json, -e, or --expr-file",
            file=sys.stderr,
        )
        return 2
    if args.expr or args.expr_file:
        lang = getattr(args, "lang", "python")
        try:
            if lang == "ts":
                # reference surface restored (ts_query.rs): evaluate the
                # TS DSL via Node against the in-tree zero-dep SDK —
                # gated on Node's presence, loud error otherwise
                from .ts_query import build_request_from_ts, \
                    build_request_from_ts_file

                request = (
                    build_request_from_ts(args.expr) if args.expr
                    else build_request_from_ts_file(args.expr_file)
                )
            else:
                request = (
                    _eval_dsl_snippet(args.expr) if args.expr
                    else _eval_dsl_file(args.expr_file)
                )
        except Exception as exc:
            print(f"invalid DSL expression: {exc}", file=sys.stderr)
            return 2
    else:
        raw = Path(args.file).read_text() if args.file else args.json
        try:
            request = json.loads(raw)
        except json.JSONDecodeError as exc:
            print(f"invalid request JSON: {exc}", file=sys.stderr)
            return 2
    # Preflight validation matching the reference CLI (query.rs:172-187).
    request_type = request.get("request_type")
    if request_type not in ("read", "write"):
        print('request_type must be "read" or "write" (lowercase)', file=sys.stderr)
        return 2
    if args.warm and request_type != "read":
        print("--warm applies to read requests only", file=sys.stderr)
        return 2
    if "query" not in request:
        print("request is missing the query field", file=sys.stderr)
        return 2
    host = args.host or "localhost"
    builder = Client(
        f"http://{host}:{args.port or _active_port(project, inst)}"
    ).query()
    if args.warm:
        builder = builder.warm_only()
    try:
        out = builder.dynamic(request).send()
    except HelixError as exc:
        print(f"query failed: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(out, indent=None if args.compact else 2, ensure_ascii=False))
    return 0


def cmd_deploy(args) -> int:
    project = find_project()
    inst = project.instance(args.instance)
    bundle_path = (
        Path(args.bundle)
        if args.bundle
        else project.root / project.queries_dir / "queries.json"
    )
    if not bundle_path.exists():
        print(f"bundle not found: {bundle_path}", file=sys.stderr)
        return 1
    try:
        out = Client(
            f"http://localhost:{_active_port(project, inst)}"
        ).deploy_bundle(
            json.loads(bundle_path.read_text())
        )
    except HelixError as exc:
        print(f"deploy failed: {exc}", file=sys.stderr)
        return 1
    print(f"installed routes: {', '.join(out['installed']) or '(none)'}")
    return 0


def cmd_prune(args) -> int:
    project = find_project()
    inst = project.instance(args.instance)
    if _read_pid(project, inst.name) is not None:
        print("stop the instance before pruning", file=sys.stderr)
        return 1
    state = project.state_dir(inst.name)
    if state.exists():
        import shutil

        shutil.rmtree(state)
    print(f"pruned instance state for '{inst.name}'")
    return 0


def cmd_delete(args) -> int:
    return cmd_prune(args)


def cmd_add(args) -> int:
    """Add a [local.<name>] instance to helix.toml (reference: helix add)."""
    project = find_project()
    if args.name in project.locals:
        print(f"instance '{args.name}' already exists", file=sys.stderr)
        return 1
    path = project.root / "helix.toml"
    block = f"\n[local.{args.name}]\nport = {args.port}\nstorage = \"{args.storage}\"\n"
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(block)
    print(f"added instance '{args.name}' (port {args.port}, {args.storage})")
    return 0


def cmd_metrics(args) -> int:
    """Telemetry level get/set (reference: metrics_sender.rs Full/Basic/Off)."""
    from .cloud import _credentials_path, _read_kv, _write_kv

    creds = _read_kv(_credentials_path())
    if args.level is None:
        level = creds.get("metrics_level", "basic")
        opted_out = creds.get("metrics", "true").lower() == "false"
        print(f"metrics level: {'off' if opted_out else level}")
        return 0
    if args.level == "off":
        creds["metrics"] = "false"
    else:
        creds["metrics"] = "true"
        creds["metrics_level"] = args.level
    _write_kv(_credentials_path(), creds)
    print(f"metrics level set to {args.level}")
    return 0


def cmd_version(args) -> int:
    from .. import __version__

    print(f"helix-tpu {__version__}")
    return 0


def cmd_update(args) -> int:
    """Self-update (reference: helix-cli/src/update.rs pulls GitHub
    releases).  This environment has no egress, so the command resolves
    the release source from config, reports the installed version, and
    degrades gracefully when the source is unreachable."""
    import urllib.error
    import urllib.request

    from .. import __version__

    source = os.environ.get(
        "HELIX_TPU_RELEASE_URL",
        "https://github.com/helix-tpu/helix-tpu/releases/latest",
    )
    print(f"installed: helix-tpu {__version__}")
    try:
        with urllib.request.urlopen(source, timeout=5) as resp:
            resp.read(0)
        print(f"release source reachable: {source}")
        print("re-run install.sh to fetch and install the latest release")
        return 0
    except (urllib.error.URLError, OSError, ValueError) as exc:
        print(f"could not reach release source ({exc}); "
              "you are offline or the source is down — no changes made")
        return 0


_REMOVED_COMMANDS = {
    # old command -> replacement hint (reference traps these the same
    # way: main.rs removed-command errors).
    "compile": "queries compile automatically on `deploy` and `push`",
    "check": "use `helix-tpu query --file <req> --warm` to validate "
             "against a running instance",
    "run": "use `helix-tpu start`",
    "instances": "use `helix-tpu status`",
}


def cmd_feedback(args) -> int:
    """Record feedback locally (the reference posts to its cloud)."""
    from .cloud import STATE_HOME

    path = STATE_HOME / "feedback.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(json.dumps({"ts": time.time(), "message": args.message}) + chr(10))
    print(f"thanks! feedback recorded at {path}")
    return 0


CHEF_PROMPT = """# helix-tpu chef build prompt

You are building an application on helix-tpu (a TPU-native graph-vector
database speaking the HelixDB wire protocol).  The instance '{instance}'
is running on localhost:{port}.

## Query the database

```python
from helix_tpu_torch import g, read_batch, write_batch, Predicate, define_params, param
from helix_tpu_torch.client import Client

client = Client("http://localhost:{port}")
```

## Patterns

- Schema-free writes:
  `write_batch().var_as("u", g().add_n("User", {{"name": "ann"}}))`
- Relations:
  `g().n(NodeRef.var("u")).add_e("FOLLOWS", NodeRef.var("v"))`
- Semantic search (create the index first):
  `g().create_vector_index_nodes("Doc", "embedding")` then
  `g().vector_search_nodes("Doc", "embedding", vector, k)` — hits carry
  `$id` and `$distance` (ascending).
- Full-text (BM25):
  `g().create_text_index_nodes("Contact", "bio")` then
  `g().text_search_nodes("Contact", "bio", "query text", k)` — hits
  carry `$score` (descending).
- Hybrid RAG: vector top-k -> `g().n(NodeRef.var("hits")).out("AUTHORED_BY")`.
- Stored routes: put `define_queries(...)` in db/queries.py and run
  `python -m helix_tpu_torch.cli push <cluster>` or `deploy`.
"""


CHEF_DESIGN_GUIDE = """# helix-tpu design guide

How to shape a schema that serves fast on this engine (written for the
agent building this app; reference analog: chef.rs design guide).

## Modeling

- **Nodes** carry the entities (User, Doc, Message...); **edges** carry
  typed relations (FOLLOWS, AUTHORED_BY).  Properties are schema-free —
  consistency comes from your queries, not a DDL.
- Use stable external identifiers in a property (`externalId`) with a
  **unique equality index**; engine node ids are u64s you should treat
  as opaque.
- Multitenant apps: give vector/text indexes a `tenant_property` and
  always search with `tenant_value` — missing tenants error, unknown
  tenants return empty (never another tenant's data).

## Index selection

| Access pattern | Index |
|---|---|
| exact lookup (`externalId == x`) | `IndexSpec.node_equality` (unique) |
| range scans / ORDER BY acceleration | `IndexSpec.node_range` |
| semantic / embedding search | `create_vector_index_nodes` |
| keyword search (BM25) | `create_text_index_nodes` |

Every vector search is an exact MXU scan with device re-rank — recall
is ~1.0 by construction, so tune `k`, not an ef parameter.

## Query patterns that serve fast

- **Batch everything**: one request with several named queries beats N
  round trips; later queries can reference earlier results by name.
- **Bulk ingest**: `for_each_param` over an array parameter is the
  ingest fast path (vectorized end-to-end; ~50k docs/s sustained).
- **Hybrid RAG**: vector top-k seeds a graph expansion in the same
  batch: search -> `g().n(NodeRef.var("hits")).out("AUTHORED_BY")`.
- Keep `returning([...])` tight: unreturned variables skip payload
  encoding entirely.

## Serving

- Reads scale via replicas (`start --replica-of`); writes go to one
  writer (`x-helix-require-writer`).  `x-helix-await-durable: false`
  trades durability acknowledgment for write latency.
- The seeded example data (`examples/seed.py`) shows all of the above
  end-to-end; delete it once your real schema exists.
"""

CHEF_SEED = '''"""Seed example data into the running helix-tpu instance.

Usage: python examples/seed.py [port]
Writes a small contacts+notes graph with embeddings so vector, text,
and graph queries all have something to return (chef scaffolding —
delete once your real schema exists).
"""

import sys

from helix_tpu_torch import NodeRef, g, write_batch
from helix_tpu_torch.client import Client

port = int(sys.argv[1]) if len(sys.argv) > 1 else {port}
client = Client(f"http://localhost:{{port}}")

PEOPLE = [
    ("ada", "Ada Lovelace", "wrote the first algorithm"),
    ("alan", "Alan Turing", "asked whether machines can think"),
    ("grace", "Grace Hopper", "built the first compiler"),
]
# toy embeddings: any float vector works; real apps use a model
VECS = [[1.0, 0.1, 0.0, 0.0], [0.0, 1.0, 0.1, 0.0], [0.1, 0.0, 1.0, 0.0]]

batch = (
    write_batch()
    .var_as("idx", g().create_vector_index_nodes("Contact", "embedding"))
    .var_as("txt", g().create_text_index_nodes("Contact", "bio"))
)
for (key, name, bio), vec in zip(PEOPLE, VECS):
    batch = batch.var_as(key, g().add_n("Contact", {{
        "externalId": key, "name": name, "bio": bio, "embedding": vec,
    }}))
batch = (
    batch
    .var_as("f1", g().n(NodeRef.var("ada")).add_e("KNOWS", NodeRef.var("alan")))
    .var_as("f2", g().n(NodeRef.var("alan")).add_e("KNOWS", NodeRef.var("grace")))
    .returning(["ada", "alan", "grace"])
)
out = client.query().dynamic(batch.to_dynamic_request()).send()
print(f"seeded {{len(out)}} contacts + 2 edges")

hits = client.query().dynamic(
    __import__("helix_tpu_torch").read_batch()
    .var_as("hits", g().vector_search_nodes("Contact", "embedding", VECS[0], 2)
            .value_map(["$id", "$distance", "name"]))
    .returning(["hits"]).to_dynamic_request()
).send()
print("nearest to ada:", [h["name"] for h in hits["hits"]])
'''


def cmd_chef(args) -> int:
    """Project bootstrapper: scaffold, start, seed example data, and
    write the agent prompt + design guide (reference chef,
    helix-cli/src/commands/chef.rs:293-308 seeds + guides; :978 cook)."""
    root = Path(args.path).resolve() if args.path else Path.cwd()
    if not (root / "helix.toml").exists():
        init_args = argparse.Namespace(
            path=str(root), name=None, instance=args.instance, port=args.port
        )
        cmd_init(init_args)

    # Interactive cook: ask what we're building so the agent prompt
    # starts from the user's intent (TTY only, never under --quiet —
    # the redirected prompt would be invisible and input() would
    # appear hung; --describe for scripts).
    description = getattr(args, "describe", None)
    if (
        description is None and sys.stdin.isatty()
        and sys.stdout is sys.__stdout__
        and not getattr(args, "no_agent", False)
    ):
        try:
            print("chef: what are you building? (one line, empty to skip)")
            description = input("> ").strip() or None
        except (EOFError, KeyboardInterrupt):
            description = None

    prompt_path = root / "HELIX_CHEF_PROMPT.md"
    guide_path = root / "HELIX_DESIGN_GUIDE.md"
    seed_path = root / "examples" / "seed.py"

    def _write_artifacts(port: int) -> None:
        prompt = CHEF_PROMPT.format(instance=args.instance, port=port)
        if description:
            prompt = (
                f"# Goal\n\n{description}\n\n" + prompt
                + "\nBuild toward the goal above; start from "
                "examples/seed.py and the design guide "
                "(HELIX_DESIGN_GUIDE.md).\n"
            )
        prompt_path.write_text(prompt, encoding="utf-8")
        guide_path.write_text(CHEF_DESIGN_GUIDE, encoding="utf-8")
        seed_path.parent.mkdir(parents=True, exist_ok=True)
        seed_path.write_text(CHEF_SEED.format(port=port), encoding="utf-8")

    _write_artifacts(args.port)
    print(f"wrote {prompt_path}")
    print(f"wrote {guide_path}")
    print(f"wrote {seed_path}")

    if args.start:
        import os as _os

        _os.chdir(root)
        start_args = argparse.Namespace(
            instance=args.instance, port=args.port, foreground=False, disk=False
        )
        code = cmd_start(start_args)
        if code != 0:
            return code
        # start may have fallen forward past a busy port: point the
        # seed run AND the generated artifacts at the real instance
        active_port = args.port
        try:
            active_port = int(
                (root / ".helix" / args.instance / "server.port")
                .read_text().strip()
            )
        except (OSError, ValueError):
            pass
        if active_port != args.port:
            _write_artifacts(active_port)
            print(f"port {args.port} was busy; artifacts target "
                  f"{active_port}")
        # seed the freshly started instance so the first query has data
        # (inherit this process's package location: the project dir may
        # not have helix_tpu_torch importable on its own)
        env = dict(os.environ)
        pkg_parent = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
        seed = subprocess.run(
            [sys.executable, str(seed_path), str(active_port)],
            capture_output=True, text=True, cwd=root, env=env,
        )
        if seed.returncode == 0:
            print(seed.stdout.strip())
        else:
            print(f"seed script failed (instance is still up):\n"
                  f"{seed.stderr.strip()[-500:]}")
        return 0
    # Agent handoff (reference chef.rs hands off to an agent CLI):
    # launch the first agent CLI on PATH with the prompt, or
    # print the command when none is installed / --no-agent.  Only when
    # interactive — execing an agent from scripts/CI would block on a
    # session nothing can drive (HELIX_CHEF_ASSUME_TTY overrides for
    # harnesses that drive the agent themselves).
    interactive = sys.stdin.isatty() or os.environ.get("HELIX_CHEF_ASSUME_TTY")
    if not getattr(args, "no_agent", False) and interactive:
        import shutil

        for agent, argv in (
            ("claude", ["claude", str(prompt_path)]),
            ("codex", ["codex", "--file", str(prompt_path)]),
            ("opencode", ["opencode", str(prompt_path)]),
        ):
            if shutil.which(agent):
                print(f"handing off to {agent}...")
                return subprocess.call(argv, cwd=root)
        print(
            "no agent CLI found (claude/codex/opencode); start one "
            f"yourself with the prompt at {prompt_path}"
        )
    print(f"next: cd {root} && python -m helix_tpu_torch.cli start {args.instance}")
    return 0


SKILL_MD = """---
name: helix-tpu
description: Query and manage a helix-tpu graph-vector database from this project.
---

# Working with helix-tpu

Start/stop: `python -m helix_tpu_torch.cli start {instance}` / `stop {instance}`.
Query: `python -m helix_tpu_torch.cli query {instance} --file <request.json>` or
`-e '<python dsl expression>'`.

## DSL cheatsheet

```python
from helix_tpu_torch import g, read_batch, write_batch, Predicate, NodeRef

write_batch().var_as("u", g().add_n("User", {{"name": "ann"}}))
read_batch().var_as("n", g().n_with_label("User").count()).returning(["n"])
g().n_with_label("User").where(Predicate.gt("age", 21)).order_by("age", "Desc").limit(10)
g().vector_search_nodes("Doc", "embedding", vector, k)   # $distance ascending
g().text_search_nodes("Doc", "body", "query text", k)    # $score descending
g().n(NodeRef.var("hits")).out("AUTHORED_BY").value_map(["$id", "name"])
```

Responses map each returned variable name to its payload.  Errors come
back as `{{"error": {{"kind", "message"}}}}` with HTTP 400.
"""


#: Agent config files that accept an HTTP MCP server registration
#: (reference: setup.rs:13-32 registers the docs MCP into 13
#: http-capable agents via npx; this image has no npm, so the entries
#: are written directly).  Each row: (path, top-level key, entry shape).
_MCP_TARGETS = (
    (".mcp.json", "mcpServers", "http"),           # project-level .mcp.json
    (".cursor/mcp.json", "mcpServers", "http"),    # Cursor
    (".vscode/mcp.json", "servers", "http"),       # VS Code / Copilot
    (".windsurf/mcp_config.json", "mcpServers", "http"),  # Windsurf
    (".gemini/settings.json", "mcpServers", "httpUrl"),   # Gemini CLI
    ("opencode.json", "mcp", "opencode"),          # OpenCode
)


def register_mcp(root: Path, url: str) -> list[Path]:
    """Merge a helix-tpu MCP server entry into each known agent config,
    preserving whatever else is already there."""
    written = []
    for rel, key, shape in _MCP_TARGETS:
        path = root / rel
        try:
            config = json.loads(path.read_text()) if path.exists() else {}
        except json.JSONDecodeError:
            print(f"skipping {path}: existing file is not valid JSON",
                  file=sys.stderr)
            continue
        table = config.setdefault(key, {})
        if shape == "httpUrl":
            table["helix-tpu"] = {"httpUrl": url}
        elif shape == "opencode":
            table["helix-tpu"] = {"type": "remote", "url": url,
                                  "enabled": True}
        else:
            table["helix-tpu"] = {"type": "http", "url": url}
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(config, indent=2) + "\n", encoding="utf-8")
        written.append(path)
    return written


def cmd_skills(args) -> int:
    """Install the helix-tpu agent skill into the project (the local
    analog of the reference's npx-based skills installer), and register
    the engine's /mcp endpoint into agent MCP configs."""
    from .config import find_project

    project = find_project()
    target = project.root / ".claude" / "skills" / "helix-tpu" / "SKILL.md"
    target.parent.mkdir(parents=True, exist_ok=True)
    instance = args.instance or next(iter(project.locals), "dev")
    target.write_text(SKILL_MD.format(instance=instance), encoding="utf-8")
    print(f"installed agent skill at {target}")
    if getattr(args, "register_mcp", False):
        inst = project.instance(instance)
        url = f"http://localhost:{_active_port(project, inst)}/mcp"
        for path in register_mcp(project.root, url):
            print(f"registered MCP server ({url}) in {path}")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="helix-tpu",
        description="helix-tpu: TPU-native graph-vector database",
    )
    parser.add_argument("--quiet", "-q", action="store_true",
                        help="suppress non-essential output")
    parser.add_argument("--verbose", "-v", action="store_true",
                        help="print operation details and timings")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("init", help="scaffold a project")
    p.add_argument("--path", default=None)
    p.add_argument("--name", default=None)
    p.add_argument("--instance", default="dev")
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    p.set_defaults(fn=cmd_init)

    for name, fn, help_ in (
        ("start", cmd_start, "start an instance"),
        ("stop", cmd_stop, "stop an instance"),
        ("restart", cmd_restart, "restart an instance"),
    ):
        p = sub.add_parser(name, help=help_)
        p.add_argument("instance", nargs="?", default=None)
        if name in ("start", "restart"):
            p.add_argument("--port", type=int, default=None)
            p.add_argument("--foreground", action="store_true")
            p.add_argument("--disk", action="store_true")
            p.add_argument("--replica-of", default=None,
                           help="primary gateway URL; start as a read replica")
            p.add_argument("--restart", dest="restart_policy", default=None,
                           choices=["no", "unless-stopped", "on-failure"],
                           help="supervise the engine and restart it on "
                                "exit (docker --restart analog)")
            p.add_argument("--device", default="cuda",
                           choices=["cuda", "cpu"],
                           help="torch device of the instance's engine "
                                "(cuda fails without a card)")
        if name == "start":
            p.add_argument("--persist", action="store_true",
                           help="write the effective port/storage back "
                                "to helix.toml (reference start.rs:31-41)")
        p.set_defaults(fn=fn)

    p = sub.add_parser("add", help="add an instance to helix.toml")
    p.add_argument("name")
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    p.add_argument("--storage", default="memory", choices=["memory", "disk"])
    p.set_defaults(fn=cmd_add)

    p = sub.add_parser("status", help="instance status")
    p.add_argument("instance", nargs="?", default=None)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("logs", help="instance logs")
    p.add_argument("instance", nargs="?", default=None)
    p.add_argument("--tail", type=int, default=None)
    p.add_argument("-f", "--follow", action="store_true")
    p.add_argument("--start", default=None,
                   help="ISO-8601 (or epoch ms) range start for "
                        "historical cluster logs (needs --cluster)")
    p.add_argument("--end", default=None,
                   help="ISO-8601 (or epoch ms) range end")
    p.add_argument("--cluster", default=None,
                   help="enterprise cluster id whose query history to "
                        "range over (via CLOUD_AUTHORITY)")
    p.add_argument("--events", action="store_true",
                   help="stream live engine events (SSE) instead of the log file")
    p.set_defaults(fn=cmd_logs)

    p = sub.add_parser("query", help="send a dynamic query")
    p.add_argument("instance", nargs="?", default=None)
    p.add_argument("--file", default=None)
    p.add_argument("--json", default=None)
    p.add_argument("-e", "--expr", default=None,
                   help="evaluate a DSL expression as the request "
                        "(Python by default; --lang ts for TypeScript "
                        "via Node)")
    p.add_argument("--lang", default="python", choices=["python", "ts"],
                   help="snippet language for -e/--expr-file (ts needs "
                        "Node >= 22.6 on PATH)")
    p.add_argument("--expr-file", default=None,
                   help="evaluate a Python DSL file (reference --ts-file "
                        "analog; bind `request` or be one expression)")
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--warm", action="store_true")
    p.add_argument("--compact", action="store_true")
    p.set_defaults(fn=cmd_query)

    p = sub.add_parser("deploy", help="install a queries.json bundle")
    p.add_argument("instance", nargs="?", default=None)
    p.add_argument("--bundle", default=None)
    p.set_defaults(fn=cmd_deploy)

    for name, fn, help_ in (
        ("prune", cmd_prune, "delete instance state"),
        ("delete", cmd_delete, "delete instance state"),
    ):
        p = sub.add_parser(name, help=help_)
        p.add_argument("instance", nargs="?", default=None)
        p.add_argument("--yes", action="store_true")
        p.set_defaults(fn=fn)

    p = sub.add_parser("auth", help="credentials management")
    p.add_argument("action",
                   choices=["login", "status", "logout", "create-key"])
    p.add_argument("cluster", nargs="?", default=None,
                   help="cluster id (create-key)")
    p.add_argument("--user-id", default=None)
    p.add_argument("--user-key", default=None)
    p.add_argument("--device", action="store_true",
                   help="device-code login via the CLOUD_AUTHORITY "
                        "control plane (SSE flow)")
    p.set_defaults(fn=cloud.cmd_auth)

    p = sub.add_parser(
        "control-plane", help="run the cloud control-plane service"
    )
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--state-dir",
                   default=str(cloud.STATE_HOME / "control-plane"))
    p.set_defaults(fn=cmd_control_plane)

    p = sub.add_parser("workspace", help="select the active workspace")
    p.add_argument("action", nargs="?", default="show", choices=["show", "use"])
    p.add_argument("name", nargs="?", default=None)
    p.set_defaults(fn=cloud.cmd_workspace)

    p = sub.add_parser("project", help="select/list projects")
    p.add_argument("action", nargs="?", default="show",
                   choices=["show", "use", "list"])
    p.add_argument("name", nargs="?", default=None)
    p.set_defaults(fn=cloud.cmd_project)

    p = sub.add_parser("cluster", help="cluster registry")
    p.add_argument("action", nargs="?", default="list",
                   choices=["list", "add", "remove"])
    p.add_argument("name", nargs="?", default=None)
    p.add_argument("--gateway", default=None)
    p.add_argument("--auth-env", default=None)
    p.add_argument("--format", default=None, choices=[None, "json"])
    p.set_defaults(fn=cloud.cmd_cluster)

    # Hidden grouping command (reference `Commands::Config`,
    # main.rs / commands/config.rs:19-28): `helix config workspace|
    # project|cluster ...` delegates to the top-level commands.
    p = sub.add_parser("config")
    p.add_argument("target", choices=["workspace", "project", "cluster"])
    p.add_argument("action", nargs="?", default=None)
    p.add_argument("name", nargs="?", default=None)
    p.add_argument("--gateway", default=None)
    p.add_argument("--auth-env", default=None)
    p.add_argument("--format", default=None, choices=[None, "json"])
    p.set_defaults(fn=cloud.cmd_config_group)

    p = sub.add_parser("push", help="compile + deploy queries to a cluster")
    p.add_argument("cluster")
    p.set_defaults(fn=cloud.cmd_push)

    p = sub.add_parser("sync", help="reconcile local sources with a cluster")
    p.add_argument("cluster")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--yes", action="store_true")
    p.set_defaults(fn=cloud.cmd_sync)

    p = sub.add_parser(
        "gateway",
        help="run an HA gateway front over a writer + read replicas",
    )
    p.add_argument("--port", type=int, default=7070)
    p.add_argument("--primary", required=True)
    p.add_argument("--replica", action="append", default=[])
    p.set_defaults(fn=cmd_gateway)

    p = sub.add_parser("metrics", help="telemetry level get/set")
    p.add_argument("level", nargs="?", default=None, choices=[None, "full", "basic", "off"])
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("version", help="print the version")
    p.set_defaults(fn=cmd_version)

    p = sub.add_parser("feedback", help="record feedback")
    p.add_argument("message")
    p.set_defaults(fn=cmd_feedback)

    p = sub.add_parser("skills", help="install the agent skill into the project")
    p.add_argument("action", nargs="?", default="add", choices=["add", "update"])
    p.add_argument("--instance", default=None)
    p.add_argument("--register-mcp", action="store_true",
                   help="register the engine's /mcp endpoint into agent "
                        "MCP configs (.mcp.json, .cursor, .vscode, "
                        ".windsurf, .gemini, opencode)")
    p.set_defaults(fn=cmd_skills)

    p = sub.add_parser("chef", help="bootstrap a project with an agent prompt")
    p.add_argument("--path", default=None)
    p.add_argument("--instance", default="dev")
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    p.add_argument("--start", action="store_true")
    p.add_argument("--no-agent", action="store_true",
                   help="skip the agent-CLI handoff")
    p.add_argument("--describe", default=None,
                   help="one-line app description baked into the agent "
                        "prompt (interactive chef asks when omitted)")
    p.set_defaults(fn=cmd_chef)

    p = sub.add_parser("update", help="self-update from the release source")
    p.set_defaults(fn=cmd_update)

    # Removed-command traps: fail with a pointer, not an argparse error.
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in _REMOVED_COMMANDS:
        print(
            f"`{argv[0]}` was removed: {_REMOVED_COMMANDS[argv[0]]}",
            file=sys.stderr,
        )
        return 1

    args = parser.parse_args(argv)
    if getattr(args, "quiet", False):
        import contextlib
        import io

        # Quiet tier: stdout chatter suppressed, errors still surface.
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                return args.fn(args)
            except ConfigError as exc:
                print(f"error: {exc}", file=sys.stderr)
                return 1
    start = time.perf_counter()
    try:
        code = args.fn(args)
    except ConfigError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    if getattr(args, "verbose", False):
        print(f"[{args.command} finished in {time.perf_counter() - start:.2f}s]")
    return code


if __name__ == "__main__":
    raise SystemExit(main())
