"""Run a reference test file against the port.

``run_suite("engine_basic", globals())`` in a thin
``tests/test_torch_ref_<suite>.py`` reads ``tests/test_<suite>.py`` (the
reference's test file, never edited for the port) and executes it in
that module's namespace, so pytest collects its tests and fixtures
there.  On the way it

1. applies the suite's textual patches, each ``(old, new)`` asserted to
   occur exactly once (``(old, new, count)`` for another count), so a
   change in the reference file fails loudly instead of silently
   testing something else;
2. rewrites the package: every ``import helix_tpu[.x]`` names
   ``helix_tpu_torch[.x]``, and so does every string constant that is a
   dotted module path under ``helix_tpu`` (``python -m`` argv,
   ``monkeypatch.setattr`` targets);
3. passes ``device="cpu"`` explicitly to every call of a port
   constructor that takes a device (:data:`DEVICE_CALLS`) and does not
   name one: the port's default device is ``cuda``, and the port has no
   switch that changes it;
4. runs every test on a virtual mesh of 8 CPU devices
   (``parallel.virtual_devices("cpu", 8)``), the port's counterpart of
   the 8 virtual JAX devices ``tests/conftest.py`` gives the reference.

A suite that hands JAX arrays to the code under test takes
:data:`torch_numpy` for ``jax.numpy`` (a patch), and one that pins JAX
to one device pins the port with :func:`one_port_device`.

The code compiles under the reference file's own path, so a failure
points at the reference's line (the patches keep line counts unless a
patch says otherwise).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from helix_tpu_torch.parallel import mesh as port_mesh

TESTS = Path(__file__).resolve().parent
PORT = "helix_tpu_torch"

# Callables of the port that take ``device`` (keyword) where the
# reference's take none.
# ``Class.method`` names a call through that class.
DEVICE_CALLS = frozenset({
    "Engine", "HelixHTTPServer", "NativeGateway", "serve", "Partition",
    "VectorIndex", "VectorManager", "PackedMatrix", "SnapshotCache",
    "TextPartition", "TextIndex", "TextManager", "make_mesh",
    "DevicePostings.build", "PaddedGraph.from_csr",
})
MESH_DEVICES = 8


class torch_numpy:
    """The part of ``jax.numpy`` the reference's tests call, made of
    torch CPU tensors: the port's functions take tensors and ints where
    the reference's take JAX arrays and scalars."""

    bfloat16 = torch.bfloat16
    int32 = int

    @staticmethod
    def asarray(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype)


def one_port_device(monkeypatch) -> None:
    """Pin the port's CPU mesh to one device for the rest of the test
    (where the reference test pins ``jax.devices``)."""
    monkeypatch.setitem(port_mesh._VIRTUAL, "cpu", (torch.device("cpu"),))


@pytest.fixture(autouse=True)
def _port_mesh_of_8():
    with port_mesh.virtual_devices("cpu", MESH_DEVICES):
        yield

_MODULE_PATH = re.compile(r"helix_tpu(\.[A-Za-z_][A-Za-z_0-9]*)*")


def _port_module(name: str) -> str:
    if name == "helix_tpu" or name.startswith("helix_tpu."):
        return PORT + name[len("helix_tpu"):]
    return name


class _ToPort(ast.NodeTransformer):
    def visit_Import(self, node):
        # ``import helix_tpu.x`` binds ``helix_tpu_torch``; visit_Name
        # reads the reference's ``helix_tpu.x.y`` as the port's
        for alias in node.names:
            alias.name = _port_module(alias.name)
        return node

    def visit_ImportFrom(self, node):
        if node.module and node.level == 0:
            node.module = _port_module(node.module)
        return node

    def visit_Name(self, node):
        if node.id == "helix_tpu":
            node.id = PORT
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str) and _MODULE_PATH.fullmatch(node.value):
            node.value = _port_module(node.value)
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        func = node.func
        name = func.id if isinstance(func, ast.Name) else (
            func.attr if isinstance(func, ast.Attribute) else None)
        if isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name):
            qualified = f"{func.value.id}.{func.attr}"
            if qualified in DEVICE_CALLS:
                name = qualified
        if name in DEVICE_CALLS and not any(
                kw.arg == "device" for kw in node.keywords):
            node.keywords.append(ast.keyword(
                arg="device", value=ast.Constant("cpu")))
        return node


def port_source(suite: str, patches=()) -> tuple[str, ast.Module]:
    """The reference file's path and its AST, patched and rewritten."""
    path = TESTS / f"test_{suite}.py"
    src = path.read_text()
    for patch in patches:
        old, new, *count = patch
        want = count[0] if count else 1
        found = src.count(old)
        if found != want:
            raise AssertionError(
                f"{path.name}: patch found {found} times, want {want}: "
                f"{old!r}")
        src = src.replace(old, new)
    tree = _ToPort().visit(ast.parse(src, str(path)))
    return str(path), ast.fix_missing_locations(tree)


def run_suite(suite: str, namespace: dict, patches=()) -> None:
    """Execute the reference's ``tests/test_<suite>.py`` on the port into
    ``namespace`` (a thin test module's globals)."""
    path, tree = port_source(suite, patches)
    namespace.update(_port_mesh_of_8=_port_mesh_of_8,
                     torch_numpy=torch_numpy,
                     one_port_device=one_port_device)
    exec(compile(tree, path, "exec"), namespace)
    for name, value in namespace.items():
        origin = getattr(value, "__name__", "") if isinstance(
            value, type(ast)) else getattr(value, "__module__", "") or ""
        if origin == "helix_tpu" or origin.startswith("helix_tpu."):
            raise AssertionError(
                f"test_{suite}.py on the port still binds {name} from "
                f"{origin}")
