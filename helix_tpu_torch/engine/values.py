"""Runtime property-value model and comparison semantics.

Properties are stored in their tagged wire encoding (``{"I64": 3}``,
``"Null"`` — reference ``sdks/rust/src/dsl.rs:973-1002``) so that writes are
lossless (F32 vs F64, DateTime millis, typed arrays).  This module provides
the unwrap/compare/render helpers the interpreter uses, plus dotted-path
lookup (``metadata.externalID`` — reference ``sdks/rust/src/lib.rs:842-881``).

Engine comparison semantics (the reference engine is opaque; these rules
are the rebuild's documented contract):

- numeric family (I64, F64, F32, DateTime) compares numerically across tags
- String compares with String, Bool with Bool, lexicographic arrays with
  same-family arrays
- mismatched families never match (``Eq`` false, orderings sort last)
- a missing property fails every predicate except ``IsNull`` (true) and
  ``Not``-wrapped forms

Port copy of ``helix_tpu/engine/values.py`` for ``helix_tpu_torch``: it
imports the port's own copies of the framework-free modules (wire, dsl,
native, telemetry, fastjson), so importing this module loads nothing of
the JAX package.  ``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in: nothing.
"""

from __future__ import annotations

from typing import Any

from ..dsl import millis_to_rfc3339

Tagged = Any  # "Null" | {tag: payload}

NUMERIC_TAGS = ("I64", "F64", "F32")
ARRAY_TAGS = ("I64Array", "F64Array", "F32Array", "StringArray", "Array")

# Sentinel distinct from Null: the property is absent entirely.
MISSING = object()


def tag_of(value: Tagged) -> str:
    if value == "Null":
        return "Null"
    return next(iter(value))


def payload_of(value: Tagged) -> Any:
    if value == "Null":
        return None
    return next(iter(value.values()))


def is_null(value: Tagged) -> bool:
    return value == "Null"


def as_number(value: Tagged) -> float | int | None:
    """Numeric view of a tagged value; DateTime exposes its millis."""
    if value == "Null" or not isinstance(value, dict):
        return None
    tag, payload = next(iter(value.items()))
    if tag in NUMERIC_TAGS or tag == "DateTime":
        return payload
    return None


def as_comparable(value: Tagged) -> tuple[str, Any] | None:
    """(family, python value) used for cross-tag comparisons."""
    if value == "Null":
        return None
    tag, payload = next(iter(value.items()))
    if tag in NUMERIC_TAGS or tag == "DateTime":
        return ("num", payload)
    if tag == "String":
        return ("str", payload)
    if tag == "Bool":
        return ("bool", payload)
    if tag == "Bytes":
        return ("bytes", tuple(payload))
    if tag in ("I64Array", "F64Array", "F32Array"):
        return ("numarr", tuple(payload))
    if tag == "StringArray":
        return ("strarr", tuple(payload))
    return None


def compare(left: Tagged, right: Tagged) -> int | None:
    """Three-way compare; None when incomparable (different families)."""
    a, b = as_comparable(left), as_comparable(right)
    if a is None or b is None or a[0] != b[0]:
        return None
    av, bv = a[1], b[1]
    if av < bv:
        return -1
    if av > bv:
        return 1
    return 0


def equals(left: Tagged, right: Tagged) -> bool:
    if is_null(left) and is_null(right):
        return True
    cmp = compare(left, right)
    if cmp is not None:
        return cmp == 0
    # Deep equality for Array/Object values.
    return _deep_plain(left) == _deep_plain(right) and tag_family(left) == tag_family(right)


def tag_family(value: Tagged) -> str:
    tag = tag_of(value)
    if tag in NUMERIC_TAGS or tag == "DateTime":
        return "num"
    if tag in ("I64Array", "F64Array", "F32Array"):
        return "numarr"
    return tag


def _deep_plain(value: Tagged) -> Any:
    if value == "Null":
        return None
    tag, payload = next(iter(value.items()))
    if tag == "Array":
        return [_deep_plain(v) for v in payload]
    if tag == "Object":
        return {k: _deep_plain(v) for k, v in payload.items()}
    return payload


def contains_member(haystack: Tagged, needle: Tagged) -> bool:
    """Membership for IsIn: haystack is an array-tagged value."""
    tag = tag_of(haystack)
    if tag in ("I64Array", "F64Array", "F32Array"):
        n = as_number(needle)
        return n is not None and any(n == v for v in payload_of(haystack))
    if tag == "StringArray":
        return tag_of(needle) == "String" and payload_of(needle) in payload_of(haystack)
    if tag == "Array":
        return any(equals(v, needle) for v in payload_of(haystack))
    return False


def to_plain(value: Tagged) -> Any:
    """Render a tagged value as dynamic-response JSON.

    DateTime renders as RFC3339 (matching parameter rendering), Bytes as a
    list of ints, nested Array/Object recurse.
    """
    if value == "Null":
        return None
    tag, payload = next(iter(value.items()))
    if tag == "DateTime":
        return millis_to_rfc3339(payload)
    if tag == "Array":
        return [to_plain(v) for v in payload]
    if tag == "Object":
        return {k: to_plain(v) for k, v in payload.items()}
    if type(payload).__name__ == "array":
        return payload.tolist()  # fast-parsed vector: render as a list
    return payload


def from_plain(value: Any) -> Tagged:
    """Coerce plain JSON (dynamic parameters) to a tagged value."""
    from ..dsl import PropertyValue

    return PropertyValue.of(value)


def get_path(props: dict[str, Tagged], path: str) -> Any:
    """Dotted-path property lookup; returns MISSING when absent.

    ``a.b.c`` walks Object payloads.  A plain key containing no dot is a
    direct lookup.
    """
    if path in props:
        return props[path]
    if "." not in path:
        return MISSING
    head, _, rest = path.partition(".")
    current = props.get(head, MISSING)
    for part in (rest.split(".") if rest else []):
        if current is MISSING or not isinstance(current, dict):
            return MISSING
        if tag_of(current) != "Object":
            return MISSING
        current = payload_of(current).get(part, MISSING)
    return current


def f32_vector(value: Tagged) -> list[float] | None:
    """Extract a float vector from any numeric-array tagged value."""
    if not isinstance(value, dict):
        return None
    tag, payload = next(iter(value.items()))
    if tag in ("F32Array", "F64Array", "I64Array"):
        return [float(v) for v in payload]
    if tag == "Array":
        out = []
        for item in payload:
            n = as_number(item)
            if n is None:
                return None
            out.append(float(n))
        return out
    return None


def text_of(value: Tagged) -> str | None:
    return payload_of(value) if tag_of(value) == "String" else None
