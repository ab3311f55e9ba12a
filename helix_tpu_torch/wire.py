"""Helix dynamic-query wire format: tag tables, encoding and validation.

The serde-style JSON encoding of the Helix query AST that the engine
parses and validates: which step, predicate and property-value tags
exist and which encoding style each uses.

Port copy of ``helix_tpu/wire.py`` (standard library only), so that the
port never imports the JAX package.  ``tests/test_torch_engine_copy.py``
holds the code equal to the reference's.

Differs from the reference in: nothing.
"""

from __future__ import annotations

import json
import math
from typing import Any

# ---------------------------------------------------------------------------
# Encoding styles
# ---------------------------------------------------------------------------

UNIT = "unit"        # "Count"
NEWTYPE = "newtype"  # {"Out": ...}
TUPLE = "tuple"      # {"Has": [a, b]}
STRUCT = "struct"    # {"AddN": {...}}

# ---------------------------------------------------------------------------
# Step catalog (reference: sdks/rust/src/dsl.rs:2795-3262)
# ---------------------------------------------------------------------------

STEP_STYLE: dict[str, str] = {
    # Sources
    "N": NEWTYPE,
    "NWhere": NEWTYPE,
    "E": NEWTYPE,
    "EWhere": NEWTYPE,
    "VectorSearchNodes": STRUCT,
    "TextSearchNodes": STRUCT,
    "VectorSearchEdges": STRUCT,
    "TextSearchEdges": STRUCT,
    "Inject": NEWTYPE,
    # Graph navigation
    "Out": NEWTYPE,
    "In": NEWTYPE,
    "Both": NEWTYPE,
    "OutE": NEWTYPE,
    "InE": NEWTYPE,
    "BothE": NEWTYPE,
    "OutN": UNIT,
    "InN": UNIT,
    "OtherN": UNIT,
    # Filters
    "Has": TUPLE,
    "HasLabel": NEWTYPE,
    "HasKey": NEWTYPE,
    "Where": NEWTYPE,
    "Dedup": UNIT,
    "Within": NEWTYPE,
    "Without": NEWTYPE,
    "EdgeHas": TUPLE,
    "EdgeHasLabel": NEWTYPE,
    # Stream shaping
    "Limit": NEWTYPE,
    "LimitBy": NEWTYPE,
    "Skip": NEWTYPE,
    "SkipBy": NEWTYPE,
    "Range": TUPLE,
    "RangeBy": TUPLE,
    "OrderBy": TUPLE,
    "OrderByMultiple": NEWTYPE,
    # Variables and row bindings
    "As": NEWTYPE,
    "Store": NEWTYPE,
    "Select": NEWTYPE,
    "Bind": NEWTYPE,
    "ProjectBindings": STRUCT,
    # Terminals
    "Count": UNIT,
    "Exists": UNIT,
    "Id": UNIT,
    "Label": UNIT,
    "Values": NEWTYPE,
    "ValueMap": NEWTYPE,
    "Project": NEWTYPE,
    "EdgeProperties": UNIT,
    # Index DDL
    "CreateIndex": STRUCT,
    "DropIndex": STRUCT,
    "CreateVectorIndexNodes": STRUCT,
    "CreateVectorIndexEdges": STRUCT,
    "CreateTextIndexNodes": STRUCT,
    "CreateTextIndexEdges": STRUCT,
    # Mutations
    "AddN": STRUCT,
    "AddE": STRUCT,
    "SetProperty": TUPLE,
    "RemoveProperty": NEWTYPE,
    "Drop": UNIT,
    "DropEdge": NEWTYPE,
    "DropEdgeLabeled": STRUCT,
    "DropEdgeById": NEWTYPE,
    # Control flow
    "Repeat": NEWTYPE,
    "Union": NEWTYPE,
    "Choose": STRUCT,
    "Coalesce": NEWTYPE,
    "Optional": NEWTYPE,
    # Aggregation
    "Group": NEWTYPE,
    "GroupCount": NEWTYPE,
    "AggregateBy": TUPLE,
    # Reserved no-ops (parse + round-trip, interpreter ignores;
    # reference: sdks/rust/src/dsl.rs:3214-3254)
    "Fold": UNIT,
    "Unfold": UNIT,
    "Path": UNIT,
    "SimplePath": UNIT,
    "WithSack": NEWTYPE,
    "SackSet": NEWTYPE,
    "SackAdd": NEWTYPE,
    "SackGet": UNIT,
}

RESERVED_NOOP_STEPS = frozenset(
    {"Fold", "Unfold", "Path", "SimplePath", "WithSack", "SackSet", "SackAdd", "SackGet"}
)

TERMINAL_STEPS = frozenset(
    {
        "Count", "Exists", "Id", "Label", "Values", "ValueMap", "Project",
        "ProjectBindings", "EdgeProperties", "Group", "GroupCount", "AggregateBy",
        "CreateIndex", "DropIndex", "CreateVectorIndexNodes", "CreateVectorIndexEdges",
        "CreateTextIndexNodes", "CreateTextIndexEdges",
    }
)

MUTATION_STEPS = frozenset(
    {
        "AddN", "AddE", "SetProperty", "RemoveProperty", "Drop", "DropEdge",
        "DropEdgeLabeled", "DropEdgeById", "CreateIndex", "DropIndex",
        "CreateVectorIndexNodes", "CreateVectorIndexEdges",
        "CreateTextIndexNodes", "CreateTextIndexEdges",
    }
)

# ---------------------------------------------------------------------------
# Predicate catalog (reference: sdks/rust/src/dsl.rs:1586-1648)
# ---------------------------------------------------------------------------

PREDICATE_STYLE: dict[str, str] = {
    "Eq": TUPLE, "Neq": TUPLE, "Gt": TUPLE, "Gte": TUPLE, "Lt": TUPLE, "Lte": TUPLE,
    "EqExpr": TUPLE, "NeqExpr": TUPLE, "GtExpr": TUPLE, "GteExpr": TUPLE,
    "LtExpr": TUPLE, "LteExpr": TUPLE,
    "Between": TUPLE, "BetweenExpr": TUPLE,
    "HasKey": NEWTYPE, "IsNull": NEWTYPE, "IsNotNull": NEWTYPE,
    "StartsWith": TUPLE, "EndsWith": TUPLE,
    "Contains": TUPLE, "ContainsExpr": TUPLE,
    "IsIn": TUPLE, "IsInExpr": TUPLE,
    "And": NEWTYPE, "Or": NEWTYPE, "Not": NEWTYPE,
    "Compare": STRUCT,
}

# Planner-friendly subset usable in NWhere / EWhere sources
# (reference: sdks/rust/src/dsl.rs:1650-1697).
SOURCE_PREDICATE_TAGS = frozenset(
    {
        "Eq", "Neq", "Gt", "Gte", "Lt", "Lte",
        "EqExpr", "NeqExpr", "GtExpr", "GteExpr", "LtExpr", "LteExpr",
        "Between", "BetweenExpr", "HasKey", "StartsWith", "And", "Or",
    }
)

# ---------------------------------------------------------------------------
# Expr catalog (reference: sdks/rust/src/dsl.rs:1390-1422)
# ---------------------------------------------------------------------------

EXPR_STYLE: dict[str, str] = {
    "Property": NEWTYPE,
    "Constant": NEWTYPE,
    "Param": NEWTYPE,
    "Id": UNIT,
    "Timestamp": UNIT,
    "DateTimeNow": UNIT,
    "Add": TUPLE, "Sub": TUPLE, "Mul": TUPLE, "Div": TUPLE, "Mod": TUPLE,
    "Neg": NEWTYPE,
    "Case": STRUCT,
}

# ---------------------------------------------------------------------------
# PropertyValue catalog (reference: sdks/rust/src/dsl.rs:973-1002)
# ---------------------------------------------------------------------------

PROPERTY_VALUE_TAGS = frozenset(
    {
        "Null", "Bool", "I64", "DateTime", "F64", "F32", "String", "Bytes",
        "I64Array", "F64Array", "F32Array", "StringArray", "Array", "Object",
    }
)

INDEX_SPEC_TAGS = frozenset(
    {
        "NodeEquality", "NodeRange", "EdgeEquality", "EdgeRange",
        "NodeVector", "NodeText", "EdgeVector", "EdgeText",
    }
)

QUERY_PARAM_TYPE_TAGS = frozenset(
    {"Bool", "I64", "F64", "F32", "String", "DateTime", "Bytes", "Value",
     "Object", "Array"}
)

# Query-bundle versions (reference: sdks/rust/src/query_generator.rs:6-13).
QUERY_BUNDLE_VERSION = 5
QUERY_BUNDLE_LEGACY_VERSIONS = frozenset({4})


class WireError(ValueError):
    """Raised for malformed wire-format payloads."""


def tag_of(node: Any, catalog: dict[str, str] | frozenset, kind: str) -> str:
    """Extract the variant tag of an externally tagged enum value."""
    if isinstance(node, str):
        tag = node
    elif isinstance(node, dict) and len(node) == 1:
        tag = next(iter(node))
    else:
        raise WireError(f"malformed {kind}: {node!r}")
    known = catalog if isinstance(catalog, frozenset) else catalog.keys()
    if tag not in known:
        raise WireError(f"unknown {kind} variant: {tag!r}")
    return tag


def payload_of(node: Any) -> Any:
    """Payload of an externally tagged enum value (None for unit variants)."""
    if isinstance(node, str):
        return None
    return next(iter(node.values()))


def _json_default(value: Any) -> Any:
    if type(value).__name__ == "array":
        # fast-parsed numeric vectors (array('d')) ride payloads
        # un-boxed; serialize them as the list they represent
        return value.tolist()
    raise TypeError(
        f"Object of type {type(value).__name__} is not JSON serializable"
    )


def dumps(value: Any, pretty: bool = False) -> str:
    """Serialize an already-encoded wire value to compact (or pretty) JSON."""
    _reject_non_finite(value)
    if pretty:
        return json.dumps(value, ensure_ascii=False, indent=2,
                          allow_nan=False, default=_json_default)
    return json.dumps(value, ensure_ascii=False, separators=(",", ":"),
                      allow_nan=False, default=_json_default)


def _reject_non_finite(value: Any) -> None:
    if isinstance(value, float) and not math.isfinite(value):
        raise WireError("non-finite numbers cannot be serialized as JSON")
    if isinstance(value, list):
        for entry in value:
            _reject_non_finite(entry)
    elif isinstance(value, dict):
        for entry in value.values():
            _reject_non_finite(entry)
    elif type(value).__name__ == "array":
        # fast-parsed numeric vectors ride payloads as array('d'):
        # skipping them would let NaN/inf through the guard
        for entry in value:
            _reject_non_finite(entry)


def canonical(value: Any) -> Any:
    """Key-sorted deep copy for structural JSON comparison."""
    if isinstance(value, list):
        return [canonical(v) for v in value]
    if isinstance(value, dict):
        return {k: canonical(value[k]) for k in sorted(value)}
    return value


def structural_equal(left: Any, right: Any) -> bool:
    if isinstance(left, (str, bytes)):
        left = json.loads(left)
    if isinstance(right, (str, bytes)):
        right = json.loads(right)
    return canonical(left) == canonical(right)


# ---------------------------------------------------------------------------
# Request envelope validation (reference: sdks/rust/src/dsl.rs:4769-4784 and
# helix-cli/src/commands/query.rs:172-187)
# ---------------------------------------------------------------------------

def validate_request(req: Any) -> None:
    """Validate the shape of a DynamicQueryRequest JSON object.

    Raises :class:`WireError` with a human-readable message on malformed
    envelopes.  Does not type-check parameters against ``parameter_types``;
    that happens at bind time in the engine.
    """
    if not isinstance(req, dict):
        raise WireError("request must be a JSON object")
    rt = req.get("request_type")
    if rt not in ("read", "write"):
        raise WireError("request_type must be \"read\" or \"write\"")
    if "query" not in req:
        raise WireError("request is missing the query field")
    validate_batch(req["query"], write=(rt == "write"))
    params = req.get("parameters")
    if params is not None and not isinstance(params, dict):
        raise WireError("parameters must be an object")


def validate_batch(batch: Any, write: bool) -> None:
    if not isinstance(batch, dict) or "queries" not in batch:
        raise WireError("query must be an object with a queries list")
    queries = batch["queries"]
    if not isinstance(queries, list):
        raise WireError("queries must be a list")
    for entry in queries:
        _validate_entry(entry, write)
    returns = batch.get("returns", [])
    if not isinstance(returns, list) or not all(isinstance(r, str) for r in returns):
        raise WireError("returns must be a list of variable names")


def _validate_entry(entry: Any, write: bool) -> None:
    tag = tag_of(entry, frozenset({"Query", "ForEach"}), "batch entry")
    body = payload_of(entry)
    if tag == "ForEach":
        if not isinstance(body, dict) or "param" not in body or "body" not in body:
            raise WireError("ForEach entry must carry param and body")
        if not isinstance(body["body"], list):
            raise WireError("ForEach body must be a list of entries")
        for sub_entry in body["body"]:
            _validate_entry(sub_entry, write)
        return
    if not isinstance(body, dict) or "steps" not in body:
        raise WireError("Query entry must carry steps")
    if not isinstance(body["steps"], list):
        raise WireError("Query steps must be a list")
    for step in body["steps"]:
        tag_ = tag_of(step, STEP_STYLE, "step")
        if not write and tag_ in MUTATION_STEPS:
            raise WireError(f"step {tag_} is not allowed in a read batch")
