"""Engine error taxonomy.

Errors surface to the HTTP layer as 4xx responses with a JSON body
``{"error": {"kind": ..., "message": ...}}``.

Port copy of ``helix_tpu/engine/errors.py`` for ``helix_tpu_torch``: it
imports the port's own copies of the framework-free modules (wire, dsl,
native, telemetry, fastjson), so importing this module loads nothing of
the JAX package.  ``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in: nothing.
"""

from __future__ import annotations


class EngineError(Exception):
    kind = "EngineError"

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message

    def to_json(self) -> dict:
        return {"kind": self.kind, "message": self.message}


class QueryError(EngineError):
    """Malformed or semantically invalid query (HTTP 400)."""

    kind = "QueryError"


class WriteError(EngineError):
    """Constraint violation on the write path (HTTP 400)."""

    kind = "WriteError"


class ParamError(QueryError):
    """Missing/mistyped dynamic parameter."""

    kind = "ParamError"
