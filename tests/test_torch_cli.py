"""The reference's CLI tests (``tests/test_cli.py``) on the port's CLI.

Every scenario of the reference's file runs against
``helix_tpu_torch.cli``; an instance it starts runs on ``--device cpu``.
Added: the spawned argv names the port's server and its ``--device``;
``start`` without ``--device`` fails on a box without CUDA and the
instance's log names CUDA; a disk project filled by one package's CLI
recovers under the other's with the same answers, both ways.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import time
from pathlib import Path

import pytest

from helix_tpu_torch.cli.main import main


def run_cli(args, cwd=None):
    import contextlib
    import io
    import os

    stdout, stderr = io.StringIO(), io.StringIO()
    old_cwd = os.getcwd()
    try:
        if cwd:
            os.chdir(cwd)
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
            code = main(args)
    finally:
        os.chdir(old_cwd)
    return code, stdout.getvalue(), stderr.getvalue()


def test_init_scaffold(tmp_path):
    code, out, _ = run_cli(["init", "--path", str(tmp_path / "proj"), "--instance", "dev"])
    assert code == 0
    root = tmp_path / "proj"
    assert (root / "helix.toml").exists()
    request = json.loads((root / "examples" / "request.json").read_text())
    assert request["request_type"] == "read"
    assert request["query"]["queries"][0]["Query"]["name"] == "node_count"
    assert ".helix/" in (root / ".gitignore").read_text()


def test_init_twice_fails(tmp_path):
    assert run_cli(["init", "--path", str(tmp_path / "p")])[0] == 0
    code, _, err = run_cli(["init", "--path", str(tmp_path / "p")])
    assert code == 1 and "exists" in err


def test_query_requires_project(tmp_path):
    code, _, err = run_cli(
        ["query", "dev", "--json", "{}"], cwd=tmp_path
    )
    assert code == 1 and "helix.toml" in err


def test_query_preflight_validation(tmp_path):
    run_cli(["init", "--path", str(tmp_path / "p")])
    root = tmp_path / "p"
    code, _, err = run_cli(
        ["query", "dev", "--json", '{"request_type": "READ", "query": {}}'], cwd=root
    )
    assert code == 2 and "lowercase" in err
    code, _, err = run_cli(
        ["query", "dev", "--json", '{"request_type": "write", "query": {"queries": [], "returns": []}}', "--warm"],
        cwd=root,
    )
    assert code == 2 and "read" in err
    code, _, err = run_cli(
        ["query", "dev", "--json", '{"request_type": "read"}'], cwd=root
    )
    assert code == 2 and "query" in err


@pytest.mark.slow
def test_full_lifecycle(tmp_path):
    """start -> status -> query(file) -> write -> read count -> stop."""
    root = tmp_path / "proj"
    free_port = _free_port()
    assert run_cli(
        ["init", "--path", str(root), "--port", str(free_port)]
    )[0] == 0

    code, out, err = run_cli(["start", "dev", "--device", "cpu"],
                             cwd=root)
    assert code == 0, err
    try:
        code, out, _ = run_cli(["status"], cwd=root)
        assert "running" in out and f"localhost:{free_port}" in out

        code, out, _ = run_cli(
            ["query", "dev", "--file", "examples/request.json", "--compact"], cwd=root
        )
        assert code == 0 and "node_count" in out

        write_req = root / "write.json"
        write_req.write_text(json.dumps({
            "request_type": "write",
            "query_name": None,
            "query": {
                "queries": [{
                    "Query": {
                        "name": "created",
                        "steps": [{"AddN": {"label": "User", "properties": [
                            ["name", {"Value": {"String": "cli-user"}}]]}}],
                        "condition": None,
                    }
                }],
                "returns": ["created"],
            },
            "parameters": {},
        }))
        code, out, _ = run_cli(["query", "dev", "--file", str(write_req)], cwd=root)
        assert code == 0

        code, out, _ = run_cli(
            ["query", "dev", "--file", "examples/request.json", "--compact"], cwd=root
        )
        assert code == 0
        assert json.loads(out) == {"node_count": 1}
    finally:
        code, out, _ = run_cli(["stop", "dev"], cwd=root)
        assert code == 0

    code, out, _ = run_cli(["status"], cwd=root)
    assert "stopped" in out
    assert run_cli(["prune", "dev", "--yes"], cwd=root)[0] == 0
    assert not (root / ".helix" / "dev").exists()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_query_eval_expression(tmp_path):
    """-e evaluates a Python DSL snippet (the reference's -e TS analog)."""
    from helix_tpu_torch.cli.main import _eval_dsl_snippet

    req = _eval_dsl_snippet(
        'read_batch().var_as("c", g().n_with_label("User").count()).returning(["c"])'
    )
    assert req["request_type"] == "read"
    assert req["query"]["returns"] == ["c"]

    import pytest as _pytest
    with _pytest.raises(Exception):
        _eval_dsl_snippet("__import__('os')")


def test_query_eval_file(tmp_path):
    """--expr-file evaluates a Python DSL FILE (the reference's
    --ts-file analog, ts_query.rs): single expression, or a script
    binding `request`."""
    from helix_tpu_torch.cli.main import _eval_dsl_file

    # single-expression file
    f1 = tmp_path / "one.py"
    f1.write_text(
        'read_batch().var_as("c", g().n_with_label("User").count())'
        '.returning(["c"])'
    )
    req = _eval_dsl_file(str(f1))
    assert req["request_type"] == "read"
    assert req["query"]["returns"] == ["c"]

    # script file binding `request`
    f2 = tmp_path / "script.py"
    f2.write_text(
        "b = write_batch()\n"
        "for i in range(3):\n"
        "    b = b.var_as(f\"n{i}\", g().add_n(\"User\", {\"i\": i}))\n"
        "request = b\n"
    )
    req = _eval_dsl_file(str(f2))
    assert req["request_type"] == "write"
    assert len(req["query"]["queries"]) == 3

    # a script that binds nothing is a clear error
    f3 = tmp_path / "bad.py"
    f3.write_text("x = 1\ny = 2\n")
    import pytest as _pytest
    with _pytest.raises(ValueError, match="request"):
        _eval_dsl_file(str(f3))

    # sandboxed like -e: no builtins
    f4 = tmp_path / "evil.py"
    f4.write_text("request = __import__('os')")
    with _pytest.raises(Exception):
        _eval_dsl_file(str(f4))


def test_version_metrics_feedback_chef(tmp_path, monkeypatch):
    monkeypatch.setenv("HELIX_TPU_HOME", str(tmp_path / "home"))
    import importlib

    from helix_tpu_torch.cli import cloud as cloud_mod

    importlib.reload(cloud_mod)
    try:
        code, out, _ = run_cli(["version"])
        assert code == 0 and "helix-tpu" in out

        code, out, _ = run_cli(["metrics"])
        assert "metrics level: basic" in out
        assert run_cli(["metrics", "off"])[0] == 0
        code, out, _ = run_cli(["metrics"])
        assert "metrics level: off" in out

        assert run_cli(["feedback", "great engine"])[0] == 0
        feedback = (tmp_path / "home" / "feedback.jsonl").read_text()
        assert "great engine" in feedback

        code, out, _ = run_cli(["chef", "--path", str(tmp_path / "app")])
        assert code == 0
        prompt = (tmp_path / "app" / "HELIX_CHEF_PROMPT.md").read_text()
        assert "vector_search_nodes" in prompt
        assert (tmp_path / "app" / "helix.toml").exists()
    finally:
        importlib.reload(cloud_mod)


def test_port_fallback_scan():
    import socket

    from helix_tpu_torch.cli.main import _probe_port

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        sock.listen(1)
        busy = sock.getsockname()[1]
        free = _probe_port(busy)
        assert free != busy and busy < free <= busy + 100


def test_skills_install(tmp_path):
    run_cli(["init", "--path", str(tmp_path / "p")])
    code, out, _ = run_cli(["skills", "add"], cwd=tmp_path / "p")
    assert code == 0
    skill = tmp_path / "p" / ".claude" / "skills" / "helix-tpu" / "SKILL.md"
    assert skill.exists() and "vector_search_nodes" in skill.read_text()


def test_add_instance(tmp_path):
    run_cli(["init", "--path", str(tmp_path / "p")])
    code, out, _ = run_cli(["add", "staging", "--port", "7001", "--storage", "disk"],
                           cwd=tmp_path / "p")
    assert code == 0
    text = (tmp_path / "p" / "helix.toml").read_text()
    assert "[local.staging]" in text and "7001" in text
    # duplicate rejected
    code, _, err = run_cli(["add", "staging"], cwd=tmp_path / "p")
    assert code == 1 and "already exists" in err


def test_quiet_and_verbose_flags(tmp_path):
    code, out, _ = run_cli(["--quiet", "version"])
    assert code == 0 and out == ""
    code, out, _ = run_cli(["--verbose", "version"])
    assert "helix-tpu" in out and "finished in" in out


@pytest.mark.slow
def test_crash_recovery_kill9(tmp_path):
    """Disk mode: kill -9 (no checkpoint) must lose no acknowledged write."""
    import os
    import signal
    import time as _time

    from helix_tpu_torch.client import Client

    root = tmp_path / "proj"
    port = _free_port()
    run_cli(["init", "--path", str(root), "--port", str(port)])
    code, _, err = run_cli(["start", "dev", "--disk", "--device", "cpu"],
                           cwd=root)
    assert code == 0, err
    client = Client(f"http://127.0.0.1:{port}")
    acked = 0
    for i in range(25):
        client.execute({
            "request_type": "write",
            "query": {
                "queries": [{"Query": {"name": "u", "steps": [
                    {"AddN": {"label": "User", "properties": [
                        ["i", {"Value": {"I64": i}}]]}}
                ], "condition": None}}],
                "returns": [],
            },
        })
        acked += 1

    pid = int((root / ".helix" / "dev" / "server.pid").read_text())
    os.kill(pid, signal.SIGKILL)  # crash: no checkpoint, no clean close
    for _ in range(50):
        try:
            os.kill(pid, 0)
            _time.sleep(0.1)
        except ProcessLookupError:
            break
    (root / ".helix" / "dev" / "server.pid").unlink()

    code, _, err = run_cli(["start", "dev", "--disk", "--device", "cpu"],
                           cwd=root)
    assert code == 0, err
    try:
        out = client.execute({
            "request_type": "read",
            "query": {
                "queries": [{"Query": {"name": "n", "steps": [
                    {"NWhere": {"Eq": ["$label", {"String": "User"}]}}, "Count"
                ], "condition": None}}],
                "returns": ["n"],
            },
        })
        assert out["n"] == acked, f"lost writes: {out['n']} != {acked}"
    finally:
        run_cli(["stop", "dev"], cwd=root)


def test_update_command_degrades_offline(monkeypatch):
    monkeypatch.setenv("HELIX_TPU_RELEASE_URL", "https://127.0.0.1:1/nope")
    code, out, err = run_cli(["update"])
    assert code == 0
    assert "installed: helix-tpu" in out
    assert "no changes made" in out


def test_removed_commands_trap_with_hint():
    for cmd, hint_word in [
        ("compile", "deploy"), ("check", "query"),
        ("run", "start"), ("instances", "status"),
    ]:
        code, out, err = run_cli([cmd])
        assert code == 1, cmd
        assert "was removed" in err and hint_word in err, (cmd, err)


def test_chef_agent_handoff(tmp_path, monkeypatch):
    """chef hands off to the first agent CLI on PATH; --no-agent skips."""
    import os
    import stat

    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "claude"
    fake.write_text("#!/bin/sh\necho AGENT-LAUNCHED with $1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    # handoff is TTY-gated (a non-interactive chef must never exec an
    # agent nothing can drive); the harness opts in explicitly
    monkeypatch.setenv("HELIX_CHEF_ASSUME_TTY", "1")

    proj = tmp_path / "proj"
    code, out, err = run_cli(["chef", "--path", str(proj)])
    assert code == 0
    assert "handing off to claude" in out

    code, out, err = run_cli(["chef", "--path", str(proj), "--no-agent"])
    assert code == 0
    assert "handing off" not in out and "HELIX_CHEF_PROMPT.md" in out


def test_skills_register_mcp(tmp_path):
    """--register-mcp merges the engine's /mcp endpoint into agent MCP
    configs without clobbering existing entries (reference setup.rs
    registers its docs MCP into http-capable agents)."""
    root = tmp_path / "proj"
    assert run_cli(["init", "--path", str(root), "--port", "7001"])[0] == 0
    # pre-existing server entry must survive the merge
    (root / ".mcp.json").write_text(json.dumps({
        "mcpServers": {"other": {"type": "http", "url": "http://x/mcp"}}
    }))
    code, out, _ = run_cli(["skills", "--register-mcp"], cwd=root)
    assert code == 0
    merged = json.loads((root / ".mcp.json").read_text())
    assert merged["mcpServers"]["other"]["url"] == "http://x/mcp"
    assert merged["mcpServers"]["helix-tpu"]["url"] == "http://localhost:7001/mcp"
    for rel, key in [
        (".cursor/mcp.json", "mcpServers"),
        (".vscode/mcp.json", "servers"),
        (".windsurf/mcp_config.json", "mcpServers"),
        (".gemini/settings.json", "mcpServers"),
        ("opencode.json", "mcp"),
    ]:
        config = json.loads((root / rel).read_text())
        assert "helix-tpu" in config[key], rel


def test_chef_writes_guide_seed_and_describe(tmp_path):
    """chef writes the design guide + runnable seed script alongside the
    prompt; --describe bakes the goal into the prompt (reference chef
    seeds data + writes a design guide, chef.rs:293-308)."""
    proj = tmp_path / "app"
    code, out, _ = run_cli([
        "chef", "--path", str(proj), "--no-agent",
        "--describe", "a memory layer for support agents",
    ])
    assert code == 0
    prompt = (proj / "HELIX_CHEF_PROMPT.md").read_text()
    assert prompt.startswith("# Goal")
    assert "a memory layer for support agents" in prompt
    guide = (proj / "HELIX_DESIGN_GUIDE.md").read_text()
    assert "Index selection" in guide and "tenant_property" in guide
    seed = (proj / "examples" / "seed.py").read_text()
    assert "create_vector_index_nodes" in seed
    # the seed script must be valid python
    import ast

    ast.parse(seed)


def test_chef_seed_script_runs_against_instance(tmp_path, monkeypatch):
    """The generated seed script executes against a live engine."""
    import subprocess
    import sys as _sys

    from helix_tpu_torch.server import HelixHTTPServer

    proj = tmp_path / "app"
    code, _, _ = run_cli(["chef", "--path", str(proj), "--no-agent"])
    assert code == 0
    server = HelixHTTPServer(host="127.0.0.1", port=0, device="cpu")
    server.start()
    try:
        import os

        env = dict(os.environ)
        env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1])
        out = subprocess.run(
            [_sys.executable, str(proj / "examples" / "seed.py"),
             str(server.port)],
            capture_output=True, text=True, timeout=120, env=env,
        )
        assert out.returncode == 0, out.stderr[-800:]
        assert "seeded 3 contacts" in out.stdout
        assert "nearest to ada:" in out.stdout and "Ada" in out.stdout
    finally:
        server.stop()


def test_start_persist_writes_back(tmp_path):
    """`start --persist` writes the effective port/storage into the
    instance's helix.toml section (reference start.rs:31-41) — unit-level
    via the config helper plus the parser wiring."""
    from helix_tpu_torch.cli.config import persist_instance_settings

    root = tmp_path
    (root / "helix.toml").write_text(
        "[project]\n"
        'name = "p"\n'
        'queries = "db"\n'
        "\n"
        "[local.dev]\n"
        "port = 6969\n"
        'storage = "memory"\n'
        "\n"
        "[local.other]\n"
        "port = 7000\n",
        encoding="utf-8",
    )
    persist_instance_settings(root, "dev", 7042, "disk")
    import tomllib

    data = tomllib.loads((root / "helix.toml").read_text())
    assert data["local"]["dev"]["port"] == 7042
    assert data["local"]["dev"]["storage"] == "disk"
    # the sibling section is untouched
    assert data["local"]["other"]["port"] == 7000
    # a section missing the keys gains them
    persist_instance_settings(root, "other", 7001, "memory")
    data = tomllib.loads((root / "helix.toml").read_text())
    assert data["local"]["other"]["storage"] == "memory"
    assert data["local"]["other"]["port"] == 7001
    # an unknown instance gets a fresh section
    persist_instance_settings(root, "extra", 7100, "disk")
    data = tomllib.loads((root / "helix.toml").read_text())
    assert data["local"]["extra"] == {"port": 7100, "storage": "disk"}


def test_persist_survives_multiline_arrays(tmp_path):
    """A multi-line TOML array inside the section (a continuation line
    starting with '[') must not terminate the section scan early and
    corrupt the file (round-3 advisor finding)."""
    from helix_tpu_torch.cli.config import persist_instance_settings
    import tomllib

    root = tmp_path
    (root / "helix.toml").write_text(
        "[project]\n"
        'name = "p"\n'
        "\n"
        "[local.dev]\n"
        "port = 6969\n"
        "tags = [\n"
        '  ["a", "b"],\n'
        '  ["c"],\n'
        "]\n"
        "\n"
        "[local.other]\n"
        "port = 7000\n",
        encoding="utf-8",
    )
    persist_instance_settings(root, "dev", 7042, "disk")
    data = tomllib.loads((root / "helix.toml").read_text())
    assert data["local"]["dev"]["port"] == 7042
    assert data["local"]["dev"]["storage"] == "disk"
    assert data["local"]["dev"]["tags"] == [["a", "b"], ["c"]]
    assert data["local"]["other"]["port"] == 7000


def test_start_persist_keeps_configured_port_when_probe_bumps(tmp_path, monkeypatch):
    """When the configured port is busy and the probe auto-bumps to a
    free one, --persist must write the *configured* port back, not the
    ephemeral bumped one (round-3 advisor finding; reference
    start.rs:31-41 persists only explicit overrides)."""
    import socket
    import tomllib
    import importlib

    # helix_tpu_torch.cli re-exports the main *function* under the name
    # "main", shadowing the submodule attribute — resolve the module.
    cli_main = importlib.import_module("helix_tpu_torch.cli.main")

    root = tmp_path
    (root / "helix.toml").write_text(
        "[project]\n"
        'name = "p"\n'
        "\n"
        "[local.dev]\n"
        "port = 6969\n"
        'storage = "memory"\n',
        encoding="utf-8",
    )
    monkeypatch.chdir(root)
    # occupy the configured port so the probe bumps
    blocker = socket.socket()
    blocker.bind(("", 6969))
    blocker.listen(1)
    try:
        # run start in foreground mode with a serve stub so no real
        # server process is spawned
        import helix_tpu_torch.server as server_mod

        served = {}

        def fake_serve(host, port, **kw):
            served["port"] = port

        monkeypatch.setattr(server_mod, "serve", fake_serve)
        rc = cli_main.main(["start", "dev", "--persist", "--foreground"])
        assert rc == 0
        assert served["port"] != 6969  # probe bumped
    finally:
        blocker.close()
    data = tomllib.loads((root / "helix.toml").read_text())
    # the configured port survives — not the ephemeral bump
    assert data["local"]["dev"]["port"] == 6969


# -- the port's device ------------------------------------------------------


class _Spawned:
    pid = 1 << 22  # never a live pid: nothing is started


def _spawned_argv(tmp_path, monkeypatch, *flags) -> list[str]:
    """The argv ``start dev <flags>`` hands to ``subprocess.Popen``, with
    the spawn and the readiness wait stubbed out."""
    import importlib

    cli_main = importlib.import_module("helix_tpu_torch.cli.main")
    root = tmp_path / "proj"
    assert run_cli(["init", "--path", str(root), "--port",
                    str(_free_port())])[0] == 0
    seen = []
    monkeypatch.setattr(cli_main.subprocess, "Popen",
                        lambda argv, **kw: seen.append(argv) or _Spawned())
    monkeypatch.setattr(cli_main, "_wait_ready", lambda port: True)
    code, _, err = run_cli(["start", "dev", *flags], cwd=root)
    assert code == 0, err
    (argv,) = seen
    return argv


@pytest.mark.parametrize("flags,device", [
    ((), "cuda"), (("--device", "cpu"), "cpu"),
    (("--device", "cuda", "--disk"), "cuda"),
])
def test_start_spawns_the_port_server_on_its_device(tmp_path, monkeypatch,
                                                    flags, device):
    argv = _spawned_argv(tmp_path, monkeypatch, *flags)
    assert argv[1:3] == ["-m", "helix_tpu_torch.server.http_server"]
    assert argv[argv.index("--device") + 1] == device
    assert ("--data-dir" in argv) == ("--disk" in flags)


def test_supervised_start_spawns_the_port_supervisor(tmp_path, monkeypatch):
    argv = _spawned_argv(tmp_path, monkeypatch, "--restart",
                         "unless-stopped", "--device", "cpu")
    assert argv[1:3] == ["-m", "helix_tpu_torch.cli.supervisor"]
    server = argv[argv.index("--") + 1:]
    assert server[1:3] == ["-m", "helix_tpu_torch.server.http_server"]
    assert server[server.index("--device") + 1] == "cpu"


def test_foreground_start_serves_on_its_device(tmp_path, monkeypatch):
    import helix_tpu_torch.server as server_mod

    root = tmp_path / "proj"
    assert run_cli(["init", "--path", str(root), "--port",
                    str(_free_port())])[0] == 0
    served = []
    monkeypatch.setattr(server_mod, "serve",
                        lambda host, port, **kw: served.append(kw))
    for flags, device in (((), "cuda"), (("--device", "cpu"), "cpu")):
        code, _, err = run_cli(["start", "dev", "--foreground", *flags],
                               cwd=root)
        assert code == 0, err
        assert served.pop()["device"] == device


def test_start_without_a_device_fails_naming_cuda(tmp_path, monkeypatch):
    """No card here: the default device is CUDA, the spawned server
    exits naming it, and ``start`` fails its readiness wait; nothing
    serves on the CPU unasked."""
    import torch

    from helix_tpu_torch.cli.main import _process_gone

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("HELIX_READY_TIMEOUT_S", "3")
    root = tmp_path / "proj"
    assert run_cli(["init", "--path", str(root), "--port",
                    str(_free_port())])[0] == 0
    code, _, err = run_cli(["start", "dev"], cwd=root)
    assert code == 1 and "failed to become ready" in err
    pid = int((root / ".helix" / "dev" / "server.pid").read_text())
    deadline = time.time() + 60
    while not _process_gone(pid) and time.time() < deadline:
        time.sleep(0.2)
    try:
        assert _process_gone(pid), "the server kept running without CUDA"
        log = (root / ".helix" / "dev" / "server.log").read_text()
        assert "CUDA" in log, log[-2000:]
    finally:
        if not _process_gone(pid):
            os.kill(pid, signal.SIGKILL)


# -- data dirs across the two packages' CLIs --------------------------------


def _cross_cli_write_then_read(tmp_path, writer, reader):
    """``writer``'s CLI starts a disk instance, takes the parity corpus'
    seed writes (indexes, users, edges, docs with vectors; each durable)
    and stops; ``reader``'s CLI starts the same project and must answer
    the corpus' reads as the writer did."""
    import importlib

    from helix_tpu_torch.client import Client
    from tests.parity.replay import SEED_PREFIXES, fixture_paths
    from tests.test_parity import approx_equal

    mains = {name: importlib.import_module(f"{name}.cli.main").main
             for name in (writer, reader)}
    device = {"helix_tpu": [], "helix_tpu_torch": ["--device", "cpu"]}
    root = tmp_path / "proj"
    port = _free_port()
    assert run_cli(["init", "--path", str(root), "--port", str(port)])[0] == 0

    def cli(package, *args):
        old = os.getcwd()
        os.chdir(root)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                return mains[package](list(args))
        finally:
            os.chdir(old)

    client = Client(f"http://127.0.0.1:{port}")
    paths = fixture_paths("runtime")
    writes = [p for p in paths if p.name.startswith(SEED_PREFIXES)]
    reads = [p for p in paths if "-read-" in p.name]

    def answers():
        return {p.stem: client.execute(json.loads(p.read_text()))
                for p in reads}

    assert cli(writer, "start", "dev", "--disk", *device[writer]) == 0
    try:
        for path in writes:
            (client.query().should_await_durability(True)
             .dynamic(json.loads(path.read_text())).send())
        want = answers()
    finally:
        assert cli(writer, "stop", "dev") == 0
    assert cli(reader, "start", "dev", "--disk", *device[reader]) == 0
    try:
        got = answers()
    finally:
        assert cli(reader, "stop", "dev") == 0
    assert set(got) == set(want) and len(want) >= 20
    for name in want:
        assert approx_equal(got[name], want[name]), (
            f"{name}: {reader} {got[name]} vs {writer} {want[name]}")


@pytest.mark.parametrize("writer,reader", [
    ("helix_tpu", "helix_tpu_torch"), ("helix_tpu_torch", "helix_tpu"),
])
def test_disk_project_recovers_across_packages(tmp_path, writer, reader):
    _cross_cli_write_then_read(tmp_path, writer, reader)
