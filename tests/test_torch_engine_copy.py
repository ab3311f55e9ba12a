"""Drift guard: the port's copied host modules stay the reference's code.

``helix_tpu_torch/engine/*.py`` are copies of ``helix_tpu/engine/*.py``,
and ``helix_tpu_torch/{wire,telemetry,fastjson,client}.py``,
``helix_tpu_torch/native/__init__.py`` and ``helix_tpu_torch/server/``
copies of the same files of ``helix_tpu``.  Each copy's module docstring
lists, after "Differs from the reference in:", the functions
(``Class.method`` or module-level names, ``__main__`` for the
``if __name__ == "__main__":`` block) it changes, adds or drops.
Everything else must equal the reference once imports are resolved to
absolute module names (``helix_tpu_torch`` read as ``helix_tpu``), so a
later fix to the reference cannot silently miss the port.
``helix_tpu_torch/dsl.py`` copies ``helix_tpu/dsl.py`` statement for
statement, in the reference's order.  ``PackedMatrix``'s host methods
(growth, appends, overwrites, query preparation) in
``helix_tpu_torch/ops/distance.py`` equal the reference's.  The C++
sources under ``helix_tpu_torch/native/`` equal the reference's byte
for byte.  No module of the port, nor ``chip_smoke.py`` or
``chip_ab.py``, imports anything of ``helix_tpu`` or ``jax``.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
MODULES = [
    "batching", "engine", "errors", "exec", "expr", "frame", "objstore",
    "persist", "replication", "rwlock", "snapshot", "store", "text",
    "values", "vector",
]


def _listed(doc: str) -> set[str]:
    _, sep, tail = doc.partition("Differs from the reference in:")
    assert sep, "docstring must say what differs from the reference"
    return set(re.findall(r"^- ``([\w.]+)``", tail, flags=re.M))


def _absolute(node: ast.ImportFrom, package: str) -> str:
    if not node.level:
        return node.module
    base = package.split(".")
    base = base[: len(base) - node.level + 1]
    return ".".join(base + ([node.module] if node.module else []))


class _Normalise(ast.NodeTransformer):
    """Resolve imports to absolute names, read the port's package as the
    reference's, and drop the listed definitions."""

    def __init__(self, package: str, drop: set[str]):
        self.package = package
        self.drop = drop
        self.scope: list[str] = []

    def _name(self, name: str) -> str:
        return ".".join(self.scope + [name])

    def visit_ImportFrom(self, node):
        module = _absolute(node, self.package)
        module = re.sub(r"^helix_tpu_torch\b", "helix_tpu", module)
        return ast.ImportFrom(module=module, names=node.names, level=0)

    def visit_Import(self, node):
        # the port's own framework import (type annotations, devices)
        return None if [a.name for a in node.names] == ["torch"] else node

    def visit_FunctionDef(self, node):
        if self._name(node.name) in self.drop:
            return None
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()
        return node

    def visit_ClassDef(self, node):
        if self._name(node.name) in self.drop:
            return None
        self.scope.append(node.name)
        node.body = [n for n in (self.visit(b) for b in node.body) if n]
        self.scope.pop()
        return node

    def visit_Assign(self, node):
        names = {t.id for t in node.targets if isinstance(t, ast.Name)}
        return None if not self.scope and names & self.drop else node

    def visit_AnnAssign(self, node):
        name = getattr(node.target, "id", None)
        return None if not self.scope and name in self.drop else node

    def visit_If(self, node):
        if not self.scope and _is_main(node) and "__main__" in self.drop:
            return None
        self.generic_visit(node)
        return node


def _is_main(node: ast.stmt) -> bool:
    """``if __name__ == "__main__":``"""
    test = getattr(node, "test", None)
    return (isinstance(node, ast.If) and isinstance(test, ast.Compare)
            and getattr(test.left, "id", None) == "__name__"
            and [getattr(c, "value", None) for c in test.comparators]
            == ["__main__"])


def _definitions(tree: ast.Module) -> set[str]:
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        if isinstance(node, ast.ClassDef):
            names |= {
                f"{node.name}.{sub.name}" for sub in node.body
                if isinstance(sub, ast.FunctionDef)
            }
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names |= {t.id for t in targets if isinstance(t, ast.Name)}
        if _is_main(node):
            names.add("__main__")
    return names


def _normalised(path: Path, package: str, drop: set[str]) -> list[str]:
    tree = ast.parse(path.read_text())
    tree.body = tree.body[1:]  # the module docstring
    tree = _Normalise(package, drop).visit(tree)
    return [ast.dump(stmt) for stmt in tree.body]


def _check_copy(name: str, ref_path: Path, port_path: Path, ref_package: str,
                port_package: str) -> None:
    port_tree = ast.parse(port_path.read_text())
    drop = _listed(ast.get_docstring(port_tree) or "")
    ref_defs = _definitions(ast.parse(ref_path.read_text()))
    port_defs = _definitions(port_tree)
    stale = {name for name in drop if name not in ref_defs | port_defs}
    assert not stale, f"listed but defined in neither module: {stale}"
    ref = _normalised(ref_path, ref_package, drop)
    port = _normalised(port_path, port_package, drop)
    assert len(ref) == len(port), (
        f"{name}: {len(ref)} top-level statements in the reference, "
        f"{len(port)} in the port outside the listed functions"
    )
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"{name}: top-level statement {i} drifted:\n{a}\n{b}"


@pytest.mark.parametrize("module", MODULES)
def test_copy_matches_reference(module):
    _check_copy(module, ROOT / "helix_tpu" / "engine" / f"{module}.py",
                ROOT / "helix_tpu_torch" / "engine" / f"{module}.py",
                "helix_tpu.engine", "helix_tpu_torch.engine")


# The framework-free layers: (path under the package, its package).
HOST_MODULES = {
    "wire": ("wire.py", ""),
    "telemetry": ("telemetry.py", ""),
    "fastjson": ("fastjson.py", ""),
    "client": ("client.py", ""),
    "native": ("native/__init__.py", ".native"),
    "server": ("server/__init__.py", ".server"),
    "server.routes": ("server/routes.py", ".server"),
    "server.http_server": ("server/http_server.py", ".server"),
    "server.native_gateway": ("server/native_gateway.py", ".server"),
    "server.mcp": ("server/mcp.py", ".server"),
}


@pytest.mark.parametrize("module", sorted(HOST_MODULES))
def test_host_module_copy_matches_reference(module):
    path, sub = HOST_MODULES[module]
    _check_copy(module, ROOT / "helix_tpu" / path,
                ROOT / "helix_tpu_torch" / path, "helix_tpu" + sub,
                "helix_tpu_torch" + sub)


def test_dsl_subset_matches_reference():
    ref = _normalised(ROOT / "helix_tpu" / "dsl.py", "helix_tpu", set())
    port = _normalised(ROOT / "helix_tpu_torch" / "dsl.py", "helix_tpu_torch",
                       set())
    at = 0
    for i, stmt in enumerate(port):
        assert stmt in ref[at:], (
            f"dsl: statement {i} of the port is not the reference's (or is "
            f"out of its order):\n{stmt}")
        at = ref.index(stmt, at) + 1
    assert len(port) == len(ref), "dsl: the port copies the whole module"
    names = _definitions(ast.parse(
        (ROOT / "helix_tpu_torch" / "dsl.py").read_text()))
    # the engine, the client (DynamicQueryRequest), MCP (g, read_batch)
    # and the package's re-exports
    used = {"_require_finite", "DateTime", "millis_to_rfc3339",
            "PropertyValue", "load_query_bundle", "DynamicQueryRequest",
            "g", "read_batch", "write_batch", "define_queries"}
    assert used <= names, f"dsl: the port needs {used - names}"


# PackedMatrix's host code: growth, appends, overwrites, query prep.
PACKED_MATRIX_METHODS = [
    "_start_background_grow", "_swap_grown", "_ensure_rows",
    "_maybe_start_grow", "append", "extend", "overwrite", "prepare_query",
    "prepare_queries",
]


def _methods(path: Path, package: str, cls: str) -> dict[str, str]:
    tree = _Normalise(package, set()).visit(ast.parse(path.read_text()))
    body = next(n for n in tree.body
                if isinstance(n, ast.ClassDef) and n.name == cls).body
    return {f.name: ast.dump(f) for f in body
            if isinstance(f, ast.FunctionDef)}


@pytest.mark.parametrize("method", PACKED_MATRIX_METHODS)
def test_packed_matrix_host_methods_match_reference(method):
    ref = _methods(ROOT / "helix_tpu" / "ops" / "distance.py",
                   "helix_tpu.ops", "PackedMatrix")
    port = _methods(ROOT / "helix_tpu_torch" / "ops" / "distance.py",
                    "helix_tpu_torch.ops", "PackedMatrix")
    assert port[method] == ref[method], \
        f"PackedMatrix.{method} drifted from the reference"


NATIVE_SOURCES = ["wal.cpp", "rerank.cpp", "bfs.cpp", "gateway.cpp",
                  "hxjson.cpp", "fastdouble.h", "fastdouble_pow5.h"]


@pytest.mark.parametrize("source", NATIVE_SOURCES)
def test_native_source_matches_reference(source):
    ref = (ROOT / "helix_tpu" / "native" / source).read_bytes()
    port = (ROOT / "helix_tpu_torch" / "native" / source).read_bytes()
    assert port == ref, f"helix_tpu_torch/native/{source} drifted"


def _imports(path: Path, package: str) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            names.append(_absolute(node, package))
        elif isinstance(node, ast.Import):
            names.extend(alias.name for alias in node.names)
    return names


PORT_FILES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "helix_tpu_torch").rglob("*.py")
) + ["chip_smoke.py", "chip_ab.py"]


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_never_imports_the_reference_package(path):
    parts = Path(path).with_suffix("").parts
    package = ".".join(parts if parts[-1] == "__init__" else parts[:-1])
    package = package.removesuffix(".__init__")
    for name in _imports(ROOT / path, package):
        assert not (name in ("jax", "helix_tpu")
                    or name.startswith(("jax.", "helix_tpu."))), \
            f"{path} imports {name}"


def test_copies_never_import_the_reference_engine_or_jax():
    for module in MODULES:
        tree = ast.parse(
            (ROOT / "helix_tpu_torch" / "engine" / f"{module}.py").read_text()
        )
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                name = _absolute(node, "helix_tpu_torch.engine")
            elif isinstance(node, ast.Import):
                name = node.names[0].name
            else:
                continue
            assert not (name in ("jax", "helix_tpu")
                        or name.startswith(("jax.", "helix_tpu."))), \
                f"{module} imports {name}"
