"""The reference's adversarial tests of the ``query -e`` eval sandbox
(``tests/test_eval_sandbox.py``) on the port's CLI.

Dunder/import/builtins escape attempts must raise cleanly and must
never execute.  The surface is CLI-local (the reference's analog
evaluates arbitrary TS under Node with no sandbox,
``helix-cli/src/ts_query.rs:25-57``); this gate refuses the classic
Python escape idioms regardless.
"""

import pytest

from helix_tpu_torch.cli.main import _eval_dsl_file, _eval_dsl_snippet


def test_legitimate_snippet_still_works():
    req = _eval_dsl_snippet(
        'read_batch().var_as("n", g().n_with_label("User").count())'
        '.returning(["n"])'
    )
    assert req["request_type"] == "read"


ESCAPES = [
    # the canonical object-graph escape
    "().__class__.__mro__[1].__subclasses__()",
    "().__class__.__bases__[0].__subclasses__()",
    # import smuggling
    "__import__('os').system('true')",
    # reaching the prelude function's module globals
    "g.__globals__",
    "read_batch.__globals__['__builtins__']",
    # generator frame escape
    "[x for x in ().__class__.__mro__]",
    # dunder via lambda default
    "(lambda f=().__class__: f)()",
    # builtins probe by name
    "__builtins__['open']('/etc/passwd')",
]


@pytest.mark.parametrize("snippet", ESCAPES)
def test_escape_snippets_rejected(snippet):
    with pytest.raises(ValueError):
        _eval_dsl_snippet(snippet)


@pytest.mark.parametrize("snippet", [
    "open('/etc/passwd')",          # no builtins in scope
    "eval('1')",
    "exec('x = 1')",
    "getattr(g, 'x')",              # getattr could spell dunders at runtime
    "globals()",
    "vars(g)",
])
def test_builtins_absent(snippet):
    with pytest.raises(NameError):
        _eval_dsl_snippet(snippet)


def test_script_file_import_rejected(tmp_path):
    f = tmp_path / "q.py"
    f.write_text("import os\nrequest = read_batch()\n")
    with pytest.raises(ValueError):
        _eval_dsl_file(str(f))


def test_script_file_dunder_rejected(tmp_path):
    f = tmp_path / "q.py"
    f.write_text("request = ().__class__\n")
    with pytest.raises(ValueError):
        _eval_dsl_file(str(f))


def test_script_file_legit_still_works(tmp_path):
    f = tmp_path / "q.py"
    f.write_text(
        "b = read_batch()\n"
        "for i in range(2):\n"
        "    b = b.var_as(f'n{i}', g().n_with_label('User').count())\n"
        "request = b.returning(['n0', 'n1'])\n"
    )
    req = _eval_dsl_file(str(f))
    assert req["request_type"] == "read"
    assert len(req["query"]["queries"]) == 2
