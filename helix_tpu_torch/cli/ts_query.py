"""Node-gated TypeScript-eval bridge for ``query -e --lang ts``.

Reference analog: ``helix-cli/src/ts_query.rs:25-57`` caches an npm
install of ``@helix-db/helix-db`` under the CLI cache dir, writes a
wrapper ``.mjs`` that evaluates the snippet against the SDK prelude and
prints ``toDynamicJson()``, and runs it under Node 20+.

This rebuild improves on that recipe: the zero-dependency TypeScript
SDK ships in-tree (``sdks/typescript/src/dsl.ts``), so there is nothing
to npm-install — the wrapper imports the SDK source directly and Node's
type stripping (``--experimental-strip-types``, Node >= 22.6) runs it.
When Node is absent or too old the caller gets a clear error naming the
gap and the toolchain-free alternative (the Python DSL path, which is
the first-class SDK here).  Same gating pattern as
``sdks/verify_toolchains.sh``: run when the toolchain exists, skip
loudly otherwise.

Port copy of ``helix_tpu/cli/ts_query.py`` for ``helix_tpu_torch``
(``sdks/typescript`` is found from the repository root, as there).

``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:
"""

from __future__ import annotations

import json
import shutil
import subprocess
import tempfile
from pathlib import Path


class TsEvalError(RuntimeError):
    pass


MIN_NODE = (22, 6)  # first release with --experimental-strip-types

# Prelude names the wrapper exposes to the snippet — the reference
# wrapper's import list (ts_query.rs:147-167) plus this SDK's extras.
_PRELUDE = (
    "g", "gUnchecked", "sub", "readBatch", "writeBatch", "defineParams",
    "param", "Expr", "PropertyValue", "NodeRef", "EdgeRef", "IndexSpec",
    "BatchCondition", "Projection", "BindingTarget", "BindingRef",
    "BindingProjection",
)


def sdk_dsl_path() -> Path:
    return (
        Path(__file__).resolve().parents[2]
        / "sdks" / "typescript" / "src" / "dsl.ts"
    )


def find_node() -> str | None:
    return shutil.which("node")


def node_version(node: str) -> tuple[int, ...] | None:
    try:
        out = subprocess.run(
            [node, "--version"], capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    v = out.stdout.strip().lstrip("v")
    try:
        return tuple(int(p) for p in v.split(".")[:3])
    except ValueError:
        return None


def ensure_node() -> str:
    node = find_node()
    if node is None:
        raise TsEvalError(
            "--lang ts needs Node >= 22.6 on PATH (none found). "
            "The Python DSL path (-e without --lang ts) needs no "
            "toolchain and has the same builder surface "
            "(camelCase -> snake_case)."
        )
    ver = node_version(node)
    if ver is None or ver < MIN_NODE:
        raise TsEvalError(
            f"--lang ts needs Node >= {'.'.join(map(str, MIN_NODE))} "
            f"(found {'.'.join(map(str, ver)) if ver else 'unknown'}); "
            "its --experimental-strip-types runs the in-tree TS SDK "
            "directly. The Python DSL path needs no toolchain."
        )
    return node


def write_wrapper(snippet: str, out_dir: Path,
                  dsl_path: Path | None = None) -> Path:
    """Write the wrapper module that evaluates ``snippet`` against the
    SDK prelude and prints the dynamic-request JSON envelope on stdout
    (the reference wrapper pattern, ts_query.rs:147-167)."""
    dsl = (dsl_path or sdk_dsl_path()).resolve()
    if not dsl.exists():
        raise TsEvalError(f"TS SDK source missing: {dsl}")
    names = ", ".join(_PRELUDE)
    wrapper = f"""\
import {{ {names} }} from {json.dumps(dsl.as_uri())};

const __value = await (async () => ({snippet}
))();
if (__value && typeof __value.toDynamicJson === "function") {{
  console.log(__value.toDynamicJson());
}} else if (__value && typeof __value.toJsonString === "function") {{
  console.log(__value.toJsonString());
}} else {{
  throw new Error(
    "snippet must evaluate to a readBatch()/writeBatch() chain or a " +
    "DynamicQueryRequest"
  );
}}
"""
    path = out_dir / "helix_ts_eval.mts"
    path.write_text(wrapper)
    return path


def run_node(node: str, wrapper: Path, timeout: float = 120.0) -> str:
    proc = subprocess.run(
        [node, "--experimental-strip-types", "--no-warnings", str(wrapper)],
        capture_output=True, text=True, timeout=timeout,
    )
    if proc.returncode != 0:
        raise TsEvalError(
            f"TS snippet evaluation failed:\n{proc.stderr.strip()[-2000:]}"
        )
    return proc.stdout


def build_request_from_ts(snippet: str) -> dict:
    """Evaluate a TS DSL snippet to a dynamic-request dict.

    Gated on Node's presence (ensure_node raises a TsEvalError naming
    the gap otherwise)."""
    node = ensure_node()
    with tempfile.TemporaryDirectory(prefix="helix-ts-eval-") as td:
        wrapper = write_wrapper(snippet, Path(td))
        out = run_node(node, wrapper)
    # last non-empty stdout line is the envelope (the snippet itself may
    # console.log)
    lines = [ln for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise TsEvalError("TS snippet printed no request envelope")
    try:
        request = json.loads(lines[-1])
    except json.JSONDecodeError as exc:
        raise TsEvalError(f"TS snippet output is not JSON: {exc}") from exc
    if not isinstance(request, dict):
        raise TsEvalError("TS snippet output is not a JSON object")
    return request


def build_request_from_ts_file(path: str) -> dict:
    """--ts-file analog (``ts_query.rs`` evaluates a TS file the same
    way as a snippet): the file body must be a single TS expression —
    the prelude is injected around it exactly as for ``-e``.  Multi-
    statement files should assign through an IIFE expression."""
    source = Path(path).read_text().strip().rstrip(";")
    return build_request_from_ts(source)
