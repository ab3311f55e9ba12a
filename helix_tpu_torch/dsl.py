"""The part of the query DSL that the port's engine uses.

Port copy of a subset of ``helix_tpu/dsl.py``: the engine needs the
wire's property-value coercion and the bundle loader, not the
query-construction SDK that makes up the rest of that module.  Copied, in
the reference's order, are ``JsonValue`` (``:28``), ``DslError``
(``:44``), ``_require_int`` (``:48``), ``_require_finite`` (``:54``),
``DateTime`` (``:64``), ``millis_to_rfc3339`` (``:103``), ``_Typed``
(``:112``), ``PropertyValue`` (``:140``) and ``load_query_bundle``
(``:1866``), with the imports they need.
``tests/test_torch_engine_copy.py`` holds every statement here equal to
the reference's.
"""

from __future__ import annotations

import json
from collections.abc import Iterable, Mapping, Sequence
from datetime import datetime as _datetime, timezone as _timezone
from pathlib import Path
from typing import Any

from . import wire

JsonValue = Any


class DslError(ValueError):
    """Raised on invalid builder usage or parameter conversion failure."""


def _require_int(value: Any, what: str = "integer") -> int:
    if isinstance(value, bool) or not isinstance(value, int):
        raise DslError(f"expected {what}, got {value!r}")
    return value


def _require_finite(value: Any, what: str = "float") -> float:
    import math
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise DslError(f"expected {what}, got {value!r}")
    out = float(value)
    if not math.isfinite(out):
        raise DslError("non-finite floats cannot be serialized as JSON")
    return out


class DateTime:
    """Millisecond epoch timestamp; rendered as RFC3339 UTC in parameters."""

    __slots__ = ("millis",)

    def __init__(self, millis: int):
        self.millis = _require_int(millis, "millis")

    @classmethod
    def from_millis(cls, millis: int) -> "DateTime":
        return cls(millis)

    @classmethod
    def from_datetime(cls, value: _datetime) -> "DateTime":
        if value.tzinfo is None:
            value = value.replace(tzinfo=_timezone.utc)
        return cls(int(value.astimezone(_timezone.utc).timestamp() * 1000))

    @classmethod
    def parse_rfc3339(cls, text: str) -> "DateTime":
        body = text[:-1] + "+00:00" if text.endswith("Z") else text
        try:
            return cls.from_datetime(_datetime.fromisoformat(body))
        except ValueError as exc:
            raise DslError(f"invalid RFC3339 datetime: {text}") from exc

    def to_rfc3339(self) -> str:
        return millis_to_rfc3339(self.millis)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, DateTime) and other.millis == self.millis

    def __hash__(self) -> int:
        return hash(("DateTime", self.millis))

    def __repr__(self) -> str:
        return f"DateTime({self.millis})"


def millis_to_rfc3339(millis: int) -> str:
    try:
        dt = _datetime.fromtimestamp(millis / 1000, _timezone.utc)
    except (OverflowError, OSError, ValueError) as exc:
        raise DslError(f"datetime millis {millis} cannot be rendered as RFC3339") from exc
    return dt.isoformat(timespec="milliseconds").replace("+00:00", "Z")


# Typed literal wrappers to pin a non-default PropertyValue variant.
class _Typed:
    __slots__ = ("tag", "value")

    def __init__(self, tag: str, value: Any):
        self.tag = tag
        self.value = value



class PropertyValue:
    """Constructors for encoded ``PropertyValue`` wire dicts.

    Wire encoding is externally tagged (``{"String": "x"}``, bare ``"Null"``)
    per reference ``sdks/rust/src/dsl.rs:973-1002``.
    """

    null: JsonValue = "Null"

    @staticmethod
    def bool(value: bool) -> JsonValue:
        if not isinstance(value, bool):
            raise DslError(f"expected bool, got {value!r}")
        return {"Bool": value}

    @staticmethod
    def i64(value: int) -> JsonValue:
        return {"I64": _require_int(value)}

    @staticmethod
    def f64(value: float) -> JsonValue:
        return {"F64": _require_finite(value)}

    @staticmethod
    def f32(value: float) -> JsonValue:
        return {"F32": _require_finite(value)}

    @staticmethod
    def string(value: str) -> JsonValue:
        if not isinstance(value, str):
            raise DslError(f"expected string, got {value!r}")
        return {"String": value}

    @staticmethod
    def date_time(value: "DateTime | int") -> JsonValue:
        millis = value.millis if isinstance(value, DateTime) else _require_int(value)
        return {"DateTime": millis}

    @staticmethod
    def bytes(value: bytes | bytearray | Sequence[int]) -> JsonValue:
        return {"Bytes": [int(b) & 0xFF for b in value]}

    @staticmethod
    def i64_array(values: Iterable[int]) -> JsonValue:
        return {"I64Array": [_require_int(v) for v in values]}

    @staticmethod
    def f64_array(values: Iterable[float]) -> JsonValue:
        return {"F64Array": [_require_finite(v) for v in values]}

    @staticmethod
    def f32_array(values: Iterable[float]) -> JsonValue:
        return {"F32Array": [_require_finite(v) for v in values]}

    @staticmethod
    def string_array(values: Iterable[str]) -> JsonValue:
        return {"StringArray": [str(v) for v in values]}

    @staticmethod
    def array(values: Iterable[Any]) -> JsonValue:
        return {"Array": [PropertyValue.of(v) for v in values]}

    @staticmethod
    def object(values: Mapping[str, Any]) -> JsonValue:
        return {"Object": {str(k): PropertyValue.of(v) for k, v in values.items()}}

    @staticmethod
    def is_encoded(value: Any) -> bool:
        # NB: the bare string "Null" IS the wire encoding of null
        # (externally tagged unit variant), so coercion treats it as
        # already-encoded — store the literal text "Null" with
        # PropertyValue.string("Null").  The engine's plain-value
        # conversion follows the same convention, so every path agrees.
        if value == "Null":
            return True
        return (
            isinstance(value, dict)
            and len(value) == 1
            and next(iter(value)) in wire.PROPERTY_VALUE_TAGS
        )

    @staticmethod
    def of(value: Any) -> JsonValue:
        """Coerce a Python value to an encoded PropertyValue.

        Coercion rules mirror the reference SDKs (``dsl.py:355-395`` in the
        reference Python SDK): homogeneous string/int lists become typed
        arrays, mixed numeric lists become ``F64Array``, anything else
        becomes a heterogeneous ``Array``.
        """
        if type(value).__name__ == "array" and getattr(value, "typecode", "") == "d":
            # fast-parsed numeric vector (fastjson fast_arrays): already
            # a homogeneous double array — tag without boxing
            return {"F64Array": value}
        if PropertyValue.is_encoded(value):
            return value
        if isinstance(value, _Typed):
            return {value.tag: value.value}
        if isinstance(value, DateTime):
            return {"DateTime": value.millis}
        if value is None:
            return "Null"
        if isinstance(value, bool):
            return {"Bool": value}
        if isinstance(value, str):
            return {"String": value}
        if isinstance(value, int):
            return {"I64": value}
        if isinstance(value, float):
            return {"F64": _require_finite(value)}
        if isinstance(value, (bytes, bytearray)):
            return {"Bytes": list(value)}
        if isinstance(value, Mapping):
            return PropertyValue.object(value)
        if isinstance(value, (list, tuple)):
            seq = list(value)
            # Type sniff via set(map(type, ...)): both C-speed, ~2 us on a
            # 128-d embedding vs ~12 us for a Python element loop — this
            # is the bulk-ingest hot path.  bool is excluded naturally
            # (type(True) is bool, not int).
            kinds = set(map(type, seq)) if seq else set()
            if kinds == {str}:
                return {"StringArray": seq}
            if kinds == {int}:
                return {"I64Array": seq}
            if kinds == {float}:
                # elements are already Python floats; share the list
                # (values are immutable downstream)
                return {"F64Array": seq}
            if kinds and kinds <= {int, float}:
                return {"F64Array": [float(v) for v in seq]}
            return PropertyValue.array(seq)
        raise DslError(f"unsupported property value {type(value).__name__}")


def load_query_bundle(data: str | bytes | Path) -> JsonValue:
    """Parse a queries.json bundle, accepting wire v5 and legacy v4."""
    if isinstance(data, Path):
        data = data.read_text(encoding="utf-8")
    parsed = json.loads(data)
    version = parsed.get("version", -1) if isinstance(parsed, dict) else -1
    if version != wire.QUERY_BUNDLE_VERSION and version not in wire.QUERY_BUNDLE_LEGACY_VERSIONS:
        raise DslError(
            f"unsupported query bundle version {version} "
            f"(expected {wire.QUERY_BUNDLE_VERSION})"
        )
    return parsed
