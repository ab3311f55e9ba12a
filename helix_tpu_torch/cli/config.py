"""Project configuration: ``helix.toml`` and instance workspaces.

Mirrors the reference project-config surface (``helix-cli/src/config.rs``):
``[project]`` with name + queries dir, ``[local.<name>]`` instances with
port (default 6969) and storage mode (memory | disk), plus the vector/db
tunables (``VectorConfig``/``DbConfig`` defaults, ``config.rs:148-226``).
Instance state (pidfile, logs, data) lives under ``.helix/<instance>/``
next to ``helix.toml`` (``project.rs:49-53``).

TOML is read with ``tomllib`` and written with a minimal emitter (the
schema is flat enough not to need a dependency).

Port copy of ``helix_tpu/cli/config.py`` for ``helix_tpu_torch``.

``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:
"""

from __future__ import annotations

import re
import tomllib
from pathlib import Path
from typing import Any

DEFAULT_PORT = 6969
CONFIG_NAME = "helix.toml"
STATE_DIR = ".helix"

VECTOR_DEFAULTS = {
    "m": 16,
    "ef_construction": 128,
    "ef_search": 768,
    "db_max_size_gb": 20,
    "metric": "cosine",
    # Multi-chip scale-out (None = single-device): live-vector count
    # above which partitions shard row-wise across the device mesh, and
    # node count above which traversals run edge-partitioned.
    "shard_threshold": None,
    "graph_shard_threshold": None,
    # Candidate-pool floor re-ranked in exact f32 by the quantized
    # residency tiers (ef_search analog for the int8/int4 rungs;
    # None = per-tier default: 8*k int8, 32*k int4).
    "quant_candidates": None,
}

DB_DEFAULTS = {
    "bm25": True,
    "mcp": True,
    "embedding_model": "text-embedding-ada-002",
    "graph_config": {"secondary_indices": []},
    # Object store url (s3://, file://, memory://) disk-mode checkpoints
    # mirror to and fresh nodes bootstrap from; None = local-only.
    "snapshot_store": None,
}


class ConfigError(ValueError):
    pass


class LocalInstance:
    def __init__(self, name: str, table: dict[str, Any]):
        self.name = name
        self.port = int(table.get("port", DEFAULT_PORT))
        self.storage = table.get("storage", "memory")
        if self.storage not in ("memory", "disk"):
            raise ConfigError(
                f"instance '{name}': storage must be 'memory' or 'disk'"
            )
        # Restart policy (reference runs containers with
        # ``--restart unless-stopped``, local_runtime.rs:699-703).
        self.restart = table.get("restart", "no")
        if self.restart not in ("no", "unless-stopped", "on-failure"):
            raise ConfigError(
                f"instance '{name}': restart must be 'no', "
                "'unless-stopped' or 'on-failure'"
            )
        self.vector = {**VECTOR_DEFAULTS, **table.get("vector", {})}
        # db_max_size_gb is canonically a vector-table knob (the
        # reference keeps it in vector_config, config.rs:203-205), but
        # it reads like an instance-level cap — accept it at
        # [local.<name>] level too rather than silently ignoring it.
        # An explicit [local.<name>.vector] value still wins.
        if "db_max_size_gb" in table and "db_max_size_gb" not in table.get(
            "vector", {}
        ):
            self.vector["db_max_size_gb"] = table["db_max_size_gb"]
        self.db = {**DB_DEFAULTS, **table.get("db", {})}


class ProjectConfig:
    def __init__(self, root: Path, data: dict[str, Any]):
        self.root = root
        project = data.get("project", {})
        self.name = project.get("name", root.name)
        self.queries_dir = project.get("queries", "db")
        self.locals = {
            name: LocalInstance(name, table)
            for name, table in data.get("local", {}).items()
        }

    def instance(self, name: str | None) -> LocalInstance:
        if not self.locals:
            raise ConfigError("no local instances defined in helix.toml")
        if name is None:
            if len(self.locals) == 1:
                return next(iter(self.locals.values()))
            raise ConfigError(
                f"multiple instances defined ({', '.join(sorted(self.locals))}); "
                "specify one"
            )
        try:
            return self.locals[name]
        except KeyError:
            raise ConfigError(f"unknown instance '{name}'") from None

    def state_dir(self, instance: str) -> Path:
        return self.root / STATE_DIR / instance


def find_project(start: Path | None = None) -> ProjectConfig:
    """Walk up from ``start`` to find helix.toml (``project.rs:14``)."""
    current = (start or Path.cwd()).resolve()
    for candidate in [current, *current.parents]:
        path = candidate / CONFIG_NAME
        if path.exists():
            with open(path, "rb") as fh:
                return ProjectConfig(candidate, tomllib.load(fh))
    raise ConfigError(
        f"no {CONFIG_NAME} found in {current} or any parent; run 'init' first"
    )


def persist_instance_settings(
    root: Path, instance: str, port: int, storage: str
) -> None:
    """Write port/storage back into the instance's ``[local.<name>]``
    section (reference ``start --persist``, start.rs:31-41).  Line-based
    edit so the rest of the file (comments, other sections) is kept."""
    path = root / CONFIG_NAME
    lines = path.read_text(encoding="utf-8").splitlines()
    header = f"[local.{instance}]"
    # A section header is `[dotted.name]` possibly followed by a
    # comment — NOT any line that merely starts with '[' (a multi-line
    # TOML array's continuation line can start with '[' and must not
    # terminate the section scan).
    header_re = re.compile(r'^\[[A-Za-z0-9_."\-\s]+\]\s*(#.*)?$')
    out: list[str] = []
    i, n = 0, len(lines)
    found = False
    while i < n:
        line = lines[i]
        out.append(line)
        i += 1
        if line.strip() != header:
            continue
        found = True
        wrote_port = wrote_storage = False
        while i < n and not header_re.match(lines[i].strip()):
            body = lines[i]
            key = body.split("=", 1)[0].strip()
            if key == "port":
                out.append(f"port = {port}")
                wrote_port = True
            elif key == "storage":
                out.append(f'storage = "{storage}"')
                wrote_storage = True
            else:
                out.append(body)
            i += 1
        if not wrote_port:
            out.append(f"port = {port}")
        if not wrote_storage:
            out.append(f'storage = "{storage}"')
    if not found:
        out += ["", header, f"port = {port}", f'storage = "{storage}"']
    path.write_text("\n".join(out) + "\n", encoding="utf-8")


def write_default_config(root: Path, project_name: str, instance: str, port: int) -> None:
    path = root / CONFIG_NAME
    if path.exists():
        raise ConfigError(f"{path} already exists")
    path.write_text(
        f"""[project]
name = "{project_name}"
queries = "db"

[local.{instance}]
port = {port}
storage = "memory"
""",
        encoding="utf-8",
    )
