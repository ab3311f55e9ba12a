"""Builder DSL for Helix dynamic queries, emitting wire-format JSON directly.

Port copy of ``helix_tpu/dsl.py`` for ``helix_tpu_torch``, the whole
module: the engine's property-value coercion and bundle loader, and the
query-construction SDK that the client (``DynamicQueryRequest``) and the
MCP endpoint (``g``, ``read_batch``) use.  It encodes each step with the
tag tables of the port's own :mod:`helix_tpu_torch.wire`.
``tests/test_torch_engine_copy.py`` holds every statement here equal to
the reference's, in the reference's order.
"""

from __future__ import annotations

import json
from collections.abc import Iterable, Mapping, Sequence
from datetime import datetime as _datetime, timezone as _timezone
from pathlib import Path
from typing import Any

from . import wire

JsonValue = Any

__all__ = [
    "DateTime", "PropertyValue", "PropertyInput", "NodeRef", "EdgeRef",
    "Expr", "StreamBound", "Predicate", "SourcePredicate", "Projection",
    "BindingTarget", "BindingRef", "BindingProjection",
    "Order", "EmitBehavior", "AggregateFunction", "CompareOp",
    "RepeatConfig", "IndexSpec", "Traversal", "SubTraversal",
    "ReadBatch", "WriteBatch", "BatchCondition", "DynamicQueryRequest",
    "QueryParamType", "ParamSchema", "ParamRef", "DefinedParams",
    "g", "sub", "read_batch", "write_batch", "define_params", "param",
    "define_queries", "register_read", "register_write", "i64", "f32", "f64",
    "bytes_", "DslError",
]


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


def i64(value: int) -> _Typed:
    return _Typed("I64", _require_int(value))


def f32(value: float) -> _Typed:
    return _Typed("F32", _require_finite(value, "f32"))


def f64(value: float) -> _Typed:
    return _Typed("F64", _require_finite(value, "f64"))


def bytes_(value: bytes | bytearray | Sequence[int]) -> _Typed:
    if isinstance(value, str):
        # iterating a str would misencode digit characters silently
        # (int('1') -> 1) and crash on anything else
        raise DslError("bytes_ takes bytes or a sequence of ints, not str")
    return _Typed("Bytes", [int(b) & 0xFF for b in value])


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


class Expr:
    """Constructors for encoded ``Expr`` wire dicts (``dsl.rs:1390-1422``)."""

    __slots__ = ("node",)

    def __init__(self, node: JsonValue):
        self.node = node

    @classmethod
    def prop(cls, name: str) -> "Expr":
        return cls({"Property": name})

    @classmethod
    def val(cls, value: Any) -> "Expr":
        return cls({"Constant": PropertyValue.of(value)})

    @classmethod
    def id(cls) -> "Expr":
        return cls("Id")

    @classmethod
    def timestamp(cls) -> "Expr":
        return cls("Timestamp")

    @classmethod
    def date_time_now(cls) -> "Expr":
        return cls("DateTimeNow")

    @classmethod
    def param(cls, name: str) -> "Expr":
        return cls({"Param": name})

    @classmethod
    def case(
        cls,
        when_then: Iterable[tuple["Predicate", "Expr"]],
        else_expr: "Expr | None" = None,
    ) -> "Expr":
        return cls(
            {
                "Case": {
                    "when_then": [[p.node, e.node] for p, e in when_then],
                    "else_expr": None if else_expr is None else else_expr.node,
                }
            }
        )

    def _bin(self, tag: str, other: "Expr") -> "Expr":
        return Expr({tag: [self.node, _as_expr(other).node]})

    def add(self, other: "Expr") -> "Expr":
        return self._bin("Add", other)

    def sub(self, other: "Expr") -> "Expr":
        return self._bin("Sub", other)

    def mul(self, other: "Expr") -> "Expr":
        return self._bin("Mul", other)

    def div(self, other: "Expr") -> "Expr":
        return self._bin("Div", other)

    def mod(self, other: "Expr") -> "Expr":
        return self._bin("Mod", other)

    modulo = mod

    def neg(self) -> "Expr":
        return Expr({"Neg": self.node})

    __add__ = add
    __sub__ = sub
    __mul__ = mul
    __truediv__ = div
    __mod__ = mod
    __neg__ = neg

    def __repr__(self) -> str:
        return f"Expr({self.node!r})"


def _as_expr(value: Any) -> Expr:
    if isinstance(value, Expr):
        return value
    if isinstance(value, ParamRef):
        return Expr.param(value.name)
    return Expr.val(value)


def _is_exprish(value: Any) -> bool:
    return isinstance(value, (Expr, ParamRef))


class _Input:
    """PropertyInput: a value-or-expression slot (``dsl.rs`` ``PropertyInput``)."""

    @staticmethod
    def of(value: Any) -> JsonValue:
        if isinstance(value, dict) and set(value) <= {"Value", "Expr"} and len(value) == 1:
            return value
        if _is_exprish(value):
            return {"Expr": _as_expr(value).node}
        return {"Value": PropertyValue.of(value)}


PropertyInput = _Input


class NodeRef:
    """Encoded node source references (``dsl.rs:1263``)."""

    all: JsonValue = "All"

    @staticmethod
    def id(node_id: int) -> JsonValue:
        return {"Ids": [_require_int(node_id)]}

    @staticmethod
    def ids(node_ids: Iterable[int]) -> JsonValue:
        return {"Ids": [_require_int(v) for v in node_ids]}

    @staticmethod
    def var(name: str) -> JsonValue:
        return {"Var": name}

    @staticmethod
    def param(name: str) -> JsonValue:
        return {"Param": name}

    @staticmethod
    def of(value: Any) -> JsonValue:
        if value == "All":
            return "All"
        if isinstance(value, dict) and len(value) == 1 and next(iter(value)) in (
            "Ids", "Var", "Param"
        ):
            return value
        if isinstance(value, str):
            return {"Var": value}
        if isinstance(value, (bytes, bytearray)):
            # iterating bytes would silently target arbitrary small
            # node ids (EdgeRef.of already guards this)
            raise DslError("node reference cannot be bytes")
        if isinstance(value, Iterable):
            return NodeRef.ids(value)
        return NodeRef.id(value)


class EdgeRef:
    """Encoded edge source references (``dsl.rs:1330``)."""

    @staticmethod
    def id(edge_id: int) -> JsonValue:
        return {"Ids": [_require_int(edge_id)]}

    @staticmethod
    def ids(edge_ids: Iterable[int]) -> JsonValue:
        return {"Ids": [_require_int(v) for v in edge_ids]}

    @staticmethod
    def var(name: str) -> JsonValue:
        return {"Var": name}

    @staticmethod
    def param(name: str) -> JsonValue:
        return {"Param": name}

    @staticmethod
    def of(value: Any) -> JsonValue:
        if isinstance(value, dict) and len(value) == 1 and next(iter(value)) in (
            "Ids", "Var", "Param"
        ):
            return value
        if isinstance(value, str):
            return {"Var": value}
        if isinstance(value, Iterable) and not isinstance(value, (bytes, bytearray)):
            return EdgeRef.ids(value)
        return EdgeRef.id(value)


class StreamBound:
    """Literal-or-expression stream bound (``dsl.rs:1496``)."""

    @staticmethod
    def literal(value: int) -> JsonValue:
        return {"Literal": _require_int(value)}

    @staticmethod
    def expr(value: Any) -> JsonValue:
        return {"Expr": _as_expr(value).node}

    @staticmethod
    def of(value: Any) -> JsonValue:
        if isinstance(value, dict) and len(value) == 1 and next(iter(value)) in (
            "Literal", "Expr"
        ):
            return value
        if _is_exprish(value):
            return StreamBound.expr(value)
        if isinstance(value, int) and not isinstance(value, bool) and value < 0:
            return StreamBound.expr(Expr.val(value))
        return StreamBound.literal(value)


class CompareOp:
    Eq = "Eq"
    Neq = "Neq"
    Gt = "Gt"
    Gte = "Gte"
    Lt = "Lt"
    Lte = "Lte"


class Order:
    Asc = "Asc"
    Desc = "Desc"


class EmitBehavior:
    NONE = "None"
    Before = "Before"
    After = "After"
    All = "All"


class AggregateFunction:
    Count = "Count"
    Sum = "Sum"
    Min = "Min"
    Max = "Max"
    Mean = "Mean"


class Predicate:
    """Encoded filter predicates (``dsl.rs:1586-1648``).

    A comparison against a plain value encodes as ``{"Eq": [prop, value]}``;
    against an expression or parameter it becomes the ``...Expr`` variant.
    """

    __slots__ = ("node",)

    def __init__(self, node: JsonValue):
        self.node = node

    @classmethod
    def _cmp(cls, tag: str, prop: str, value: Any) -> "Predicate":
        if _is_exprish(value):
            return cls({f"{tag}Expr": [prop, _as_expr(value).node]})
        return cls({tag: [prop, PropertyValue.of(value)]})

    @classmethod
    def eq(cls, prop: str, value: Any) -> "Predicate":
        return cls._cmp("Eq", prop, value)

    @classmethod
    def neq(cls, prop: str, value: Any) -> "Predicate":
        return cls._cmp("Neq", prop, value)

    @classmethod
    def gt(cls, prop: str, value: Any) -> "Predicate":
        return cls._cmp("Gt", prop, value)

    @classmethod
    def gte(cls, prop: str, value: Any) -> "Predicate":
        return cls._cmp("Gte", prop, value)

    @classmethod
    def lt(cls, prop: str, value: Any) -> "Predicate":
        return cls._cmp("Lt", prop, value)

    @classmethod
    def lte(cls, prop: str, value: Any) -> "Predicate":
        return cls._cmp("Lte", prop, value)

    @classmethod
    def between(cls, prop: str, lo: Any, hi: Any) -> "Predicate":
        if _is_exprish(lo) or _is_exprish(hi):
            return cls({"BetweenExpr": [prop, _as_expr(lo).node, _as_expr(hi).node]})
        return cls({"Between": [prop, PropertyValue.of(lo), PropertyValue.of(hi)]})

    @classmethod
    def has_key(cls, prop: str) -> "Predicate":
        return cls({"HasKey": prop})

    @classmethod
    def is_null(cls, prop: str) -> "Predicate":
        return cls({"IsNull": prop})

    @classmethod
    def is_not_null(cls, prop: str) -> "Predicate":
        return cls({"IsNotNull": prop})

    @classmethod
    def starts_with(cls, prop: str, prefix: str) -> "Predicate":
        return cls({"StartsWith": [prop, prefix]})

    @classmethod
    def ends_with(cls, prop: str, suffix: str) -> "Predicate":
        return cls({"EndsWith": [prop, suffix]})

    @classmethod
    def contains(cls, prop: str, needle: str) -> "Predicate":
        return cls({"Contains": [prop, needle]})

    @classmethod
    def contains_expr(cls, prop: str, expr: Any) -> "Predicate":
        return cls({"ContainsExpr": [prop, _as_expr(expr).node]})

    @classmethod
    def contains_param(cls, prop: str, name: str) -> "Predicate":
        return cls.contains_expr(prop, Expr.param(name))

    @classmethod
    def is_in(cls, prop: str, values: Any) -> "Predicate":
        return cls({"IsIn": [prop, PropertyValue.of(values)]})

    @classmethod
    def is_in_expr(cls, prop: str, values: Any) -> "Predicate":
        return cls({"IsInExpr": [prop, _as_expr(values).node]})

    @classmethod
    def is_in_param(cls, prop: str, name: str) -> "Predicate":
        return cls.is_in_expr(prop, Expr.param(name))

    @classmethod
    def and_(cls, predicates: Iterable["Predicate"]) -> "Predicate":
        return cls({"And": [p.node for p in predicates]})

    @classmethod
    def or_(cls, predicates: Iterable["Predicate"]) -> "Predicate":
        return cls({"Or": [p.node for p in predicates]})

    @classmethod
    def not_(cls, predicate: "Predicate") -> "Predicate":
        return cls({"Not": predicate.node})

    @classmethod
    def compare(cls, left: Expr, op: str, right: Expr) -> "Predicate":
        return cls({"Compare": {"left": left.node, "op": op, "right": right.node}})

    # *_param sugar, matching the reference builder surface.
    @classmethod
    def eq_param(cls, prop: str, name: str) -> "Predicate":
        return cls({"EqExpr": [prop, Expr.param(name).node]})

    @classmethod
    def neq_param(cls, prop: str, name: str) -> "Predicate":
        return cls({"NeqExpr": [prop, Expr.param(name).node]})

    @classmethod
    def gt_param(cls, prop: str, name: str) -> "Predicate":
        return cls({"GtExpr": [prop, Expr.param(name).node]})

    @classmethod
    def gte_param(cls, prop: str, name: str) -> "Predicate":
        return cls({"GteExpr": [prop, Expr.param(name).node]})

    @classmethod
    def lt_param(cls, prop: str, name: str) -> "Predicate":
        return cls({"LtExpr": [prop, Expr.param(name).node]})

    @classmethod
    def lte_param(cls, prop: str, name: str) -> "Predicate":
        return cls({"LteExpr": [prop, Expr.param(name).node]})


class SourcePredicate(Predicate):
    """Index-friendly predicate subset for ``NWhere``/``EWhere`` sources.

    Same encodings as :class:`Predicate`, restricted to the variants the
    planner can push into index lookups (``dsl.rs:1650-1697``): no Not,
    Contains/EndsWith, IsNull, IsIn, or Compare.
    """

    def __init__(self, node: JsonValue):
        tag = wire.tag_of(node, wire.PREDICATE_STYLE, "predicate")
        if tag not in wire.SOURCE_PREDICATE_TAGS:
            raise DslError(f"{tag} is not a valid source predicate")
        super().__init__(node)

    @classmethod
    def and_(cls, predicates: Iterable["Predicate"]) -> "SourcePredicate":
        return cls({"And": [cls._member(p) for p in predicates]})

    @classmethod
    def or_(cls, predicates: Iterable["Predicate"]) -> "SourcePredicate":
        return cls({"Or": [cls._member(p) for p in predicates]})

    @classmethod
    def _member(cls, predicate: "Predicate") -> JsonValue:
        """Members must stay inside the source subset too — the outer
        tag check alone let Not/IsNull/... smuggle into NWhere, which
        the reference's restricted enum rejects server-side."""
        cls._check_node(predicate.node)
        return predicate.node

    @classmethod
    def _check_node(cls, node: JsonValue) -> None:
        tag = wire.tag_of(node, wire.PREDICATE_STYLE, "predicate")
        if tag not in wire.SOURCE_PREDICATE_TAGS:
            raise DslError(f"{tag} is not a valid source predicate")
        if tag in ("And", "Or"):
            for sub_node in node[tag]:
                cls._check_node(sub_node)


class Projection:
    """Terminal projection entries (untagged union, ``dsl.rs:2038-2063``)."""

    @staticmethod
    def property(source: str, alias: str | None = None) -> JsonValue:
        return {"source": source, "alias": alias if alias is not None else source}

    @staticmethod
    def from_endpoint(source: str, alias: str | None = None) -> JsonValue:
        full = f"$from.{source}"
        return Projection.property(full, alias if alias is not None else full)

    @staticmethod
    def to_endpoint(source: str, alias: str | None = None) -> JsonValue:
        full = f"$to.{source}"
        return Projection.property(full, alias if alias is not None else full)

    @staticmethod
    def expr(alias: str, expr: Expr) -> JsonValue:
        return {"alias": alias, "expr": expr.node}

    @staticmethod
    def of(value: Any) -> JsonValue:
        if isinstance(value, dict):
            return value
        raise DslError(f"invalid projection: {value!r}")


class BindingTarget:
    """Row-binding target: current element or a named binding (``dsl.rs:2082``)."""

    current: JsonValue = "Current"

    @staticmethod
    def binding(name: str) -> JsonValue:
        return {"Binding": name}


class BindingRef:
    """A (target, source) reference used by binding coalesce projections."""

    @staticmethod
    def current(source: str) -> JsonValue:
        return {"target": "Current", "source": source}

    @staticmethod
    def binding(name: str, source: str) -> JsonValue:
        return {"target": {"Binding": name}, "source": source}


class BindingProjection:
    """Row-binding projections, internally tagged with ``kind``
    (``dsl.rs:2132-2150``)."""

    @staticmethod
    def property(target: JsonValue, source: str, alias: str) -> JsonValue:
        return {"kind": "Property", "target": target, "source": source, "alias": alias}

    @staticmethod
    def current(source: str, alias: str) -> JsonValue:
        return BindingProjection.property("Current", source, alias)

    @staticmethod
    def binding(name: str, source: str, alias: str) -> JsonValue:
        return BindingProjection.property({"Binding": name}, source, alias)

    @staticmethod
    def coalesce(refs: Iterable[JsonValue], alias: str) -> JsonValue:
        return {"kind": "Coalesce", "refs": list(refs), "alias": alias}


class IndexSpec:
    """Index DDL specifications (``dsl.rs:2580-2658``)."""

    @staticmethod
    def node_equality(label: str, prop: str) -> JsonValue:
        return {"NodeEquality": {"label": label, "property": prop, "unique": False}}

    @staticmethod
    def node_unique_equality(label: str, prop: str) -> JsonValue:
        return {"NodeEquality": {"label": label, "property": prop, "unique": True}}

    @staticmethod
    def _range(tag: str, label: str, prop: str, direction: str) -> JsonValue:
        fields: dict[str, Any] = {"label": label, "property": prop}
        if direction != "Asc":
            fields["direction"] = direction
        return {tag: fields}

    @staticmethod
    def node_range(label: str, prop: str, direction: str = "Asc") -> JsonValue:
        return IndexSpec._range("NodeRange", label, prop, direction)

    @staticmethod
    def node_range_desc(label: str, prop: str) -> JsonValue:
        return IndexSpec._range("NodeRange", label, prop, "Desc")

    @staticmethod
    def edge_equality(label: str, prop: str) -> JsonValue:
        return {"EdgeEquality": {"label": label, "property": prop}}

    @staticmethod
    def edge_range(label: str, prop: str, direction: str = "Asc") -> JsonValue:
        return IndexSpec._range("EdgeRange", label, prop, direction)

    @staticmethod
    def edge_range_desc(label: str, prop: str) -> JsonValue:
        return IndexSpec._range("EdgeRange", label, prop, "Desc")

    @staticmethod
    def _tenant(tag: str, label: str, prop: str, tenant_property: str | None) -> JsonValue:
        fields: dict[str, Any] = {"label": label, "property": prop}
        if tenant_property is not None:
            fields["tenant_property"] = tenant_property
        return {tag: fields}

    @staticmethod
    def node_vector(label: str, prop: str, tenant_property: str | None = None) -> JsonValue:
        return IndexSpec._tenant("NodeVector", label, prop, tenant_property)

    @staticmethod
    def node_text(label: str, prop: str, tenant_property: str | None = None) -> JsonValue:
        return IndexSpec._tenant("NodeText", label, prop, tenant_property)

    @staticmethod
    def edge_vector(label: str, prop: str, tenant_property: str | None = None) -> JsonValue:
        return IndexSpec._tenant("EdgeVector", label, prop, tenant_property)

    @staticmethod
    def edge_text(label: str, prop: str, tenant_property: str | None = None) -> JsonValue:
        return IndexSpec._tenant("EdgeText", label, prop, tenant_property)


class RepeatConfig:
    """Builder for ``Repeat`` step configuration (``dsl.rs:2503-2576``)."""

    def __init__(self, traversal: "SubTraversal"):
        self._traversal = traversal
        self._times: int | None = None
        self._until: Predicate | None = None
        self._emit: str = EmitBehavior.NONE
        self._emit_predicate: Predicate | None = None
        self._max_depth: int = 100

    @classmethod
    def new(cls, traversal: "SubTraversal") -> "RepeatConfig":
        return cls(traversal)

    def times(self, n: int) -> "RepeatConfig":
        self._times = _require_int(n)
        return self

    def until(self, predicate: Predicate) -> "RepeatConfig":
        self._until = predicate
        return self

    def emit_all(self) -> "RepeatConfig":
        self._emit = EmitBehavior.All
        return self

    def emit_before(self) -> "RepeatConfig":
        self._emit = EmitBehavior.Before
        return self

    def emit_after(self) -> "RepeatConfig":
        self._emit = EmitBehavior.After
        return self

    def emit_if(self, predicate: Predicate) -> "RepeatConfig":
        self._emit = EmitBehavior.After
        self._emit_predicate = predicate
        return self

    def max_depth(self, depth: int) -> "RepeatConfig":
        self._max_depth = _require_int(depth)
        return self

    def encode(self) -> JsonValue:
        return {
            "traversal": {"steps": list(self._traversal.steps)},
            "times": self._times,
            "until": None if self._until is None else self._until.node,
            "emit": self._emit,
            "emit_predicate": (
                None if self._emit_predicate is None else self._emit_predicate.node
            ),
            "max_depth": self._max_depth,
        }


def _search_struct(
    tag: str,
    label: str,
    prop: str,
    query_key: str,
    query: Any,
    k: Any,
    tenant_value: Any,
) -> JsonValue:
    fields: dict[str, Any] = {"label": label, "property": prop}
    if tenant_value is not None:
        fields["tenant_value"] = _Input.of(tenant_value)
    fields[query_key] = _Input.of(query)
    fields["k"] = StreamBound.of(k)
    return {tag: fields}


class _Steps:
    """Shared step-emitting mixin for Traversal and SubTraversal."""

    steps: tuple[JsonValue, ...]

    def _push(self, step: JsonValue, **meta: Any) -> Any:
        raise NotImplementedError

    # --- navigation ---
    def out(self, label: str | None = None) -> Any:
        return self._push({"Out": label}, state="nodes")

    def in_(self, label: str | None = None) -> Any:
        return self._push({"In": label}, state="nodes")

    def both(self, label: str | None = None) -> Any:
        return self._push({"Both": label}, state="nodes")

    def out_e(self, label: str | None = None) -> Any:
        return self._push({"OutE": label}, state="edges")

    def in_e(self, label: str | None = None) -> Any:
        return self._push({"InE": label}, state="edges")

    def both_e(self, label: str | None = None) -> Any:
        return self._push({"BothE": label}, state="edges")

    def out_n(self) -> Any:
        return self._push("OutN", state="nodes")

    def in_n(self) -> Any:
        return self._push("InN", state="nodes")

    def other_n(self) -> Any:
        return self._push("OtherN", state="nodes")

    # --- filters ---
    def has(self, prop: str, value: Any) -> Any:
        return self._push({"Has": [prop, PropertyValue.of(value)]})

    def has_label(self, label: str) -> Any:
        return self._push({"HasLabel": label})

    def has_key(self, prop: str) -> Any:
        return self._push({"HasKey": prop})

    def where(self, predicate: Predicate) -> Any:
        return self._push({"Where": predicate.node})

    where_ = where

    def dedup(self) -> Any:
        return self._push("Dedup")

    def within(self, name: str) -> Any:
        return self._push({"Within": name})

    def without(self, name: str) -> Any:
        return self._push({"Without": name})

    def edge_has(self, prop: str, value: Any) -> Any:
        return self._push({"EdgeHas": [prop, _Input.of(value)]})

    def edge_has_label(self, label: str) -> Any:
        return self._push({"EdgeHasLabel": label})

    # --- stream shaping ---
    def limit(self, n: Any) -> Any:
        bound = StreamBound.of(n)
        if "Literal" in bound:
            return self._push({"Limit": bound["Literal"]})
        return self._push({"LimitBy": bound["Expr"]})

    def skip(self, n: Any) -> Any:
        bound = StreamBound.of(n)
        if "Literal" in bound:
            return self._push({"Skip": bound["Literal"]})
        return self._push({"SkipBy": bound["Expr"]})

    def range(self, start: Any, end: Any) -> Any:
        lo, hi = StreamBound.of(start), StreamBound.of(end)
        if "Literal" in lo and "Literal" in hi:
            return self._push({"Range": [lo["Literal"], hi["Literal"]]})
        return self._push({"RangeBy": [lo, hi]})

    def order_by(self, prop: str, order: str = Order.Asc) -> Any:
        return self._push({"OrderBy": [prop, order]})

    def order_by_multiple(self, orderings: Iterable[tuple[str, str]]) -> Any:
        return self._push({"OrderByMultiple": [[p, o] for p, o in orderings]})

    # --- variables / bindings ---
    def as_(self, name: str) -> Any:
        return self._push({"As": name})

    def store(self, name: str) -> Any:
        return self._push({"Store": name})

    def select(self, name: str) -> Any:
        return self._push({"Select": name})

    def bind(self, name: str) -> Any:
        if not name:
            raise DslError("binding name must not be empty")
        return self._push({"Bind": name})

    # --- reserved no-ops ---
    def fold(self) -> Any:
        return self._push("Fold")

    def unfold(self) -> Any:
        return self._push("Unfold")

    def path(self) -> Any:
        return self._push("Path")

    def simple_path(self) -> Any:
        return self._push("SimplePath")

    def with_sack(self, initial: Any) -> Any:
        return self._push({"WithSack": PropertyValue.of(initial)})

    def sack_set(self, prop: str) -> Any:
        return self._push({"SackSet": prop})

    def sack_add(self, prop: str) -> Any:
        return self._push({"SackAdd": prop})

    def sack_get(self) -> Any:
        return self._push("SackGet")


class SubTraversal(_Steps):
    """A branch traversal for union/choose/coalesce/optional/repeat bodies."""

    __slots__ = ("steps",)

    def __init__(self, steps: tuple[JsonValue, ...] = ()):
        self.steps = steps

    def _push(self, step: JsonValue, **_meta: Any) -> "SubTraversal":
        return SubTraversal((*self.steps, step))

    def encode(self) -> JsonValue:
        return {"steps": list(self.steps)}


class Traversal(_Steps):
    """A top-level traversal: an encoded step list plus read/write mode."""

    __slots__ = ("steps", "state", "mode")

    def __init__(
        self,
        steps: tuple[JsonValue, ...] = (),
        state: str = "empty",
        mode: str = "read",
    ):
        self.steps = steps
        self.state = state
        self.mode = mode

    def _push(
        self, step: JsonValue, state: str | None = None, mode: str | None = None
    ) -> "Traversal":
        if self.state == "terminal":
            # the recorded typestate is enforced, not decorative: steps
            # chained after a terminal (count().out(...)) would
            # serialize and only fail at the engine
            tag = step if isinstance(step, str) else next(iter(step))
            raise DslError(
                f"cannot chain step {tag} after a terminal step"
            )
        return Traversal(
            (*self.steps, step),
            self.state if state is None else state,
            self.mode if mode is None else mode,
        )

    # --- sources ---
    def n(self, nodes: Any = "All") -> "Traversal":
        return self._push({"N": NodeRef.of(nodes)}, state="nodes")

    def n_where(self, predicate: Predicate) -> "Traversal":
        return self._push({"NWhere": predicate.node}, state="nodes")

    def n_with_label(self, label: str) -> "Traversal":
        return self.n_where(SourcePredicate.eq("$label", label))

    def n_with_label_where(self, label: str, predicate: Predicate) -> "Traversal":
        return self.n_where(
            SourcePredicate.and_([SourcePredicate.eq("$label", label), predicate])
        )

    def e(self, edges: Any) -> "Traversal":
        return self._push({"E": EdgeRef.of(edges)}, state="edges")

    def e_where(self, predicate: Predicate) -> "Traversal":
        return self._push({"EWhere": predicate.node}, state="edges")

    def e_with_label(self, label: str) -> "Traversal":
        return self.e_where(SourcePredicate.eq("$label", label))

    def e_with_label_where(self, label: str, predicate: Predicate) -> "Traversal":
        return self.e_where(
            SourcePredicate.and_([SourcePredicate.eq("$label", label), predicate])
        )

    def inject(self, name: str) -> "Traversal":
        return self._push({"Inject": name}, state="nodes")

    def vector_search_nodes(
        self,
        label: str,
        prop: str,
        query_vector: Any,
        k: Any,
        tenant_value: Any = None,
    ) -> "Traversal":
        if isinstance(query_vector, (list, tuple)):
            query_vector = PropertyValue.f32_array(query_vector)
        return self._push(
            _search_struct(
                "VectorSearchNodes", label, prop, "query_vector",
                query_vector, k, tenant_value,
            ),
            state="nodes",
        )

    def text_search_nodes(
        self, label: str, prop: str, query_text: Any, k: Any, tenant_value: Any = None
    ) -> "Traversal":
        return self._push(
            _search_struct(
                "TextSearchNodes", label, prop, "query_text", query_text, k, tenant_value
            ),
            state="nodes",
        )

    def vector_search_edges(
        self, label: str, prop: str, query_vector: Any, k: Any, tenant_value: Any = None
    ) -> "Traversal":
        if isinstance(query_vector, (list, tuple)):
            query_vector = PropertyValue.f32_array(query_vector)
        return self._push(
            _search_struct(
                "VectorSearchEdges", label, prop, "query_vector",
                query_vector, k, tenant_value,
            ),
            state="edges",
        )

    def text_search_edges(
        self, label: str, prop: str, query_text: Any, k: Any, tenant_value: Any = None
    ) -> "Traversal":
        return self._push(
            _search_struct(
                "TextSearchEdges", label, prop, "query_text", query_text, k, tenant_value
            ),
            state="edges",
        )

    # --- terminals ---
    def count(self) -> "Traversal":
        return self._push("Count", state="terminal")

    def exists(self) -> "Traversal":
        return self._push("Exists", state="terminal")

    def id(self) -> "Traversal":
        return self._push("Id", state="terminal")

    def label(self) -> "Traversal":
        return self._push("Label", state="terminal")

    def values(self, properties: Iterable[str]) -> "Traversal":
        return self._push({"Values": list(properties)}, state="terminal")

    def value_map(self, properties: Iterable[str] | None = None) -> "Traversal":
        return self._push(
            {"ValueMap": None if properties is None else list(properties)},
            state="terminal",
        )

    def project(self, projections: Iterable[Any]) -> "Traversal":
        return self._push(
            {"Project": [Projection.of(p) for p in projections]}, state="terminal"
        )

    def project_bindings(
        self, projections: Iterable[JsonValue], distinct: bool = False
    ) -> "Traversal":
        return self._push(
            {"ProjectBindings": {"projections": list(projections), "distinct": distinct}},
            state="terminal",
        )

    def project_bindings_distinct(self, projections: Iterable[JsonValue]) -> "Traversal":
        return self.project_bindings(projections, distinct=True)

    def edge_properties(self) -> "Traversal":
        return self._push("EdgeProperties", state="terminal")

    def group(self, prop: str) -> "Traversal":
        return self._push({"Group": prop}, state="terminal")

    def group_count(self, prop: str) -> "Traversal":
        return self._push({"GroupCount": prop}, state="terminal")

    def aggregate_by(self, fn: str, prop: str) -> "Traversal":
        return self._push({"AggregateBy": [fn, prop]}, state="terminal")

    # --- control flow ---
    def repeat(self, config: RepeatConfig) -> "Traversal":
        return self._push({"Repeat": config.encode()})

    def union(self, traversals: Iterable[SubTraversal]) -> "Traversal":
        return self._push({"Union": [t.encode() for t in traversals]})

    def choose(
        self,
        condition: Predicate,
        then_traversal: SubTraversal,
        else_traversal: SubTraversal | None = None,
    ) -> "Traversal":
        return self._push(
            {
                "Choose": {
                    "condition": condition.node,
                    "then_traversal": then_traversal.encode(),
                    "else_traversal": (
                        None if else_traversal is None else else_traversal.encode()
                    ),
                }
            }
        )

    def coalesce(self, traversals: Iterable[SubTraversal]) -> "Traversal":
        return self._push({"Coalesce": [t.encode() for t in traversals]})

    def optional(self, traversal: SubTraversal) -> "Traversal":
        return self._push({"Optional": traversal.encode()})

    # --- index DDL ---
    def create_index_if_not_exists(self, spec: JsonValue) -> "Traversal":
        return self._push(
            {"CreateIndex": {"spec": spec, "if_not_exists": True}},
            state="terminal", mode="write",
        )

    def create_index(self, spec: JsonValue, if_not_exists: bool = True) -> "Traversal":
        return self._push(
            {"CreateIndex": {"spec": spec, "if_not_exists": bool(if_not_exists)}},
            state="terminal", mode="write",
        )

    def drop_index(self, spec: JsonValue) -> "Traversal":
        return self._push(
            {"DropIndex": {"spec": spec}}, state="terminal", mode="write"
        )

    def create_vector_index_nodes(
        self, label: str, prop: str, tenant_property: str | None = None
    ) -> "Traversal":
        return self.create_index_if_not_exists(
            IndexSpec.node_vector(label, prop, tenant_property)
        )

    def create_vector_index_edges(
        self, label: str, prop: str, tenant_property: str | None = None
    ) -> "Traversal":
        return self.create_index_if_not_exists(
            IndexSpec.edge_vector(label, prop, tenant_property)
        )

    def create_text_index_nodes(
        self, label: str, prop: str, tenant_property: str | None = None
    ) -> "Traversal":
        return self.create_index_if_not_exists(
            IndexSpec.node_text(label, prop, tenant_property)
        )

    def create_text_index_edges(
        self, label: str, prop: str, tenant_property: str | None = None
    ) -> "Traversal":
        return self.create_index_if_not_exists(
            IndexSpec.edge_text(label, prop, tenant_property)
        )

    # --- mutations ---
    def add_n(self, label: str, properties: Any = None) -> "Traversal":
        return self._push(
            {"AddN": {"label": label, "properties": _prop_entries(properties)}},
            state="nodes", mode="write",
        )

    def add_e(self, label: str, to: Any, properties: Any = None) -> "Traversal":
        return self._push(
            {
                "AddE": {
                    "label": label,
                    "to": NodeRef.of(to),
                    "properties": _prop_entries(properties),
                }
            },
            state="nodes", mode="write",
        )

    def set_property(self, name: str, value: Any) -> "Traversal":
        return self._push(
            {"SetProperty": [name, _Input.of(value)]}, state="nodes", mode="write"
        )

    def remove_property(self, name: str) -> "Traversal":
        return self._push({"RemoveProperty": name}, state="nodes", mode="write")

    def drop(self) -> "Traversal":
        return self._push("Drop", state="nodes", mode="write")

    def drop_edge(self, to: Any) -> "Traversal":
        return self._push({"DropEdge": NodeRef.of(to)}, state="nodes", mode="write")

    def drop_edge_labeled(self, to: Any, label: str) -> "Traversal":
        return self._push(
            {"DropEdgeLabeled": {"to": NodeRef.of(to), "label": label}},
            state="nodes", mode="write",
        )

    def drop_edge_by_id(self, edges: Any) -> "Traversal":
        return self._push(
            {"DropEdgeById": EdgeRef.of(edges)}, state="nodes", mode="write"
        )


def _prop_entries(properties: Any) -> list[list[Any]]:
    if properties is None:
        return []
    entries = properties.items() if isinstance(properties, Mapping) else properties
    try:
        return [[key, _Input.of(value)] for key, value in entries]
    except (TypeError, ValueError) as exc:
        raise DslError(
            "properties must be a mapping or an iterable of "
            f"(name, value) pairs: {exc}"
        ) from exc


def _check_read_only_entries(entries) -> None:
    """Reject mutation steps anywhere in a batch-entry list (nested
    ForEach bodies included)."""
    for entry in entries:
        if not isinstance(entry, dict):
            continue
        tag = next(iter(entry), None)
        body = entry.get(tag)
        if tag == "ForEach" and isinstance(body, dict):
            _check_read_only_entries(body.get("body", []))
            continue
        if not isinstance(body, dict):
            continue
        for step in body.get("steps", []):
            step_tag = step if isinstance(step, str) else next(iter(step), "")
            if step_tag in wire.MUTATION_STEPS:
                raise DslError(
                    f"ReadBatch only accepts read-only traversals "
                    f"(found {step_tag})"
                )


def g() -> Traversal:
    return Traversal()


def sub() -> SubTraversal:
    return SubTraversal()


class BatchCondition:
    """Conditional gates for batch entries (``dsl.rs:4432-4441``)."""

    prev_not_empty: JsonValue = "PrevNotEmpty"

    @staticmethod
    def var_not_empty(name: str) -> JsonValue:
        return {"VarNotEmpty": name}

    @staticmethod
    def var_empty(name: str) -> JsonValue:
        return {"VarEmpty": name}

    @staticmethod
    def var_min_size(name: str, size: int) -> JsonValue:
        return {"VarMinSize": [name, _require_int(size)]}


class _Batch:
    """Shared assembly for read/write batches (``dsl.rs:4480``, ``:4570``)."""

    kind = "read"

    def __init__(
        self, queries: tuple[JsonValue, ...] = (), returns: tuple[str, ...] = ()
    ):
        self.queries = queries
        self.returns = returns

    def _check(self, traversal: Traversal) -> None:
        pass

    def _with(self, queries: tuple[JsonValue, ...], returns: tuple[str, ...]) -> Any:
        return type(self)(queries, returns)

    def var_as(self, name: str, traversal: Traversal) -> Any:
        self._check(traversal)
        entry = {"Query": {"name": name, "steps": list(traversal.steps), "condition": None}}
        return self._with((*self.queries, entry), self.returns)

    def var_as_if(self, name: str, condition: JsonValue, traversal: Traversal) -> Any:
        self._check(traversal)
        entry = {
            "Query": {"name": name, "steps": list(traversal.steps), "condition": condition}
        }
        return self._with((*self.queries, entry), self.returns)

    def for_each_param(self, param_name: str, body: "_Batch") -> Any:
        if self.kind == "read":
            # the typestate guarantee var_as enforces must hold for
            # nested bodies too — a WriteBatch of mutations used to
            # nest into a ReadBatch and only fail server-side
            _check_read_only_entries(body.queries)
        entry = {"ForEach": {"param": param_name, "body": list(body.queries)}}
        return self._with((*self.queries, entry), self.returns)

    def returning(self, vars: Iterable[str]) -> Any:
        return self._with(self.queries, tuple(vars))

    def encode(self) -> JsonValue:
        return {"queries": list(self.queries), "returns": list(self.returns)}

    def to_json_string(self) -> str:
        return wire.dumps(self.encode())

    def to_json_bytes(self) -> bytes:
        return self.to_json_string().encode("utf-8")

    def to_dynamic_request(
        self,
        params: "DefinedParams | None" = None,
        values: Mapping[str, Any] | None = None,
        query_name: str | None = None,
    ) -> "DynamicQueryRequest":
        request = DynamicQueryRequest(self.kind, self.encode(), query_name=query_name)
        if params is None:
            if values is not None:
                raise DslError("dynamic parameter values require a parameter schema")
            return request
        if values is None:
            raise DslError(
                "dynamic parameter values are required when a parameter schema is provided"
            )
        for key in values:
            if key not in params.schema:
                raise DslError(f"unknown parameter: {key}")
        for name, schema in params.schema.items():
            if name not in values:
                raise DslError(f"missing required parameter: {name}")
            request.parameter_types[name] = schema.encode_type()
            request.parameters[name] = schema.convert(values[name], name)
        return request

    def to_dynamic_json(
        self,
        params: "DefinedParams | None" = None,
        values: Mapping[str, Any] | None = None,
        query_name: str | None = None,
    ) -> str:
        return self.to_dynamic_request(params, values, query_name).to_json_string()


class ReadBatch(_Batch):
    kind = "read"

    def _check(self, traversal: Traversal) -> None:
        if traversal.mode != "read":
            raise DslError("ReadBatch only accepts read-only traversals")


class WriteBatch(_Batch):
    kind = "write"


def read_batch() -> ReadBatch:
    return ReadBatch()


def write_batch() -> WriteBatch:
    return WriteBatch()


class DynamicQueryRequest:
    """The ``POST /v1/query`` envelope (``dsl.rs:4769-4784``).

    ``query_name`` serializes even when null (it is diagnostic metadata for
    gateway logs); ``parameters``/``parameter_types`` are omitted when empty
    unless explicitly set.
    """

    def __init__(
        self,
        request_type: str,
        query: JsonValue,
        query_name: str | None = None,
        parameters: dict[str, JsonValue] | None = None,
        parameter_types: dict[str, JsonValue] | None = None,
    ):
        if request_type not in ("read", "write"):
            raise DslError("request_type must be 'read' or 'write'")
        self.request_type = request_type
        self.query = query.encode() if isinstance(query, _Batch) else query
        self.query_name = query_name
        self.parameters: dict[str, JsonValue] = dict(parameters or {})
        self.parameter_types: dict[str, JsonValue] = dict(parameter_types or {})
        self._has_params = parameters is not None
        self._has_types = parameter_types is not None

    @classmethod
    def read(cls, query: ReadBatch, query_name: str | None = None) -> "DynamicQueryRequest":
        return cls("read", query, query_name)

    @classmethod
    def write(cls, query: WriteBatch, query_name: str | None = None) -> "DynamicQueryRequest":
        return cls("write", query, query_name)

    def with_parameter_value(self, name: str, value: JsonValue) -> "DynamicQueryRequest":
        self.parameters[name] = value
        self._has_params = True
        return self

    def with_parameter_type(self, name: str, ty: JsonValue) -> "DynamicQueryRequest":
        self.parameter_types[name] = ty
        self._has_types = True
        return self

    def with_query_name(self, name: str | None) -> "DynamicQueryRequest":
        self.query_name = name
        return self

    def encode(self) -> JsonValue:
        out: dict[str, JsonValue] = {
            "request_type": self.request_type,
            "query_name": self.query_name,
            "query": self.query,
        }
        if self.parameters or self._has_params:
            out["parameters"] = self.parameters
        if self.parameter_types or self._has_types:
            out["parameter_types"] = self.parameter_types
        return out

    def to_json_string(self) -> str:
        return wire.dumps(self.encode())

    def to_json_bytes(self) -> bytes:
        return self.to_json_string().encode("utf-8")


# ---------------------------------------------------------------------------
# Parameter schemas (reference: query_generator.rs:17-38 and dsl.py param ns)
# ---------------------------------------------------------------------------

class QueryParamType:
    Bool: JsonValue = "Bool"
    I64: JsonValue = "I64"
    F64: JsonValue = "F64"
    F32: JsonValue = "F32"
    String: JsonValue = "String"
    DateTime: JsonValue = "DateTime"
    Bytes: JsonValue = "Bytes"
    Value: JsonValue = "Value"
    Object: JsonValue = "Object"

    @staticmethod
    def array(inner: JsonValue) -> JsonValue:
        return {"Array": inner}


class ParamSchema:
    """A parameter schema: validates/converts bind values and emits its
    wire ``QueryParamType``."""

    __slots__ = ("kind", "inner", "object_inner")

    def __init__(
        self,
        kind: str,
        inner: "ParamSchema | None" = None,
        object_inner: "ParamSchema | None" = None,
    ):
        self.kind = kind
        self.inner = inner
        self.object_inner = object_inner

    def encode_type(self) -> JsonValue:
        if self.kind == "Array":
            assert self.inner is not None
            return {"Array": self.inner.encode_type()}
        return self.kind

    def convert(self, value: Any, path: str) -> JsonValue:
        """Convert a user bind value to dynamic-parameter JSON.

        DateTime renders as RFC3339; Bytes is rejected on the JSON route
        (reference ``dsl.rs:846-848``).
        """
        kind = self.kind
        if kind == "Bool":
            if not isinstance(value, bool):
                raise DslError(f"parameter '{path}' must be boolean")
            return value
        if kind == "I64":
            return _require_int(value, f"parameter '{path}' (integer)")
        if kind in ("F64", "F32"):
            return _require_finite(value, f"parameter '{path}' (float)")
        if kind == "String":
            if not isinstance(value, str):
                raise DslError(f"parameter '{path}' must be string")
            return value
        if kind == "DateTime":
            if isinstance(value, DateTime):
                dt = value
            elif isinstance(value, _datetime):
                dt = DateTime.from_datetime(value)
            elif isinstance(value, str):
                dt = DateTime.parse_rfc3339(value)
            else:
                dt = DateTime.from_millis(value)
            return dt.to_rfc3339()
        if kind == "Bytes":
            raise DslError(
                f"parameter '{path}' uses bytes, which the dynamic query JSON "
                "route cannot represent"
            )
        if kind == "Value":
            return _dynamic_value(PropertyValue.of(value), path)
        if kind == "Object":
            if not isinstance(value, Mapping):
                raise DslError(f"parameter '{path}' must be object")
            inner = self.object_inner or ParamSchema("Value")
            return {k: inner.convert(v, f"{path}.{k}") for k, v in value.items()}
        if kind == "Array":
            if not isinstance(value, Sequence) or isinstance(value, (str, bytes, bytearray)):
                raise DslError(f"parameter '{path}' must be array")
            assert self.inner is not None
            return [
                self.inner.convert(v, f"{path}[{i}]") for i, v in enumerate(value)
            ]
        raise DslError(f"unknown parameter schema: {kind}")


def _dynamic_value(encoded: JsonValue, path: str) -> JsonValue:
    """Flatten an encoded PropertyValue to plain dynamic-parameter JSON."""
    if encoded == "Null":
        return None
    tag = next(iter(encoded))
    body = encoded[tag]
    if tag in ("Bool", "I64", "F64", "F32", "String"):
        return body
    if tag == "DateTime":
        return millis_to_rfc3339(body)
    if tag == "Bytes":
        raise DslError(
            f"parameter '{path}' uses bytes, which the dynamic query JSON "
            "route cannot represent"
        )
    if tag in ("I64Array", "F64Array", "F32Array", "StringArray"):
        return body
    if tag == "Array":
        return [_dynamic_value(v, f"{path}[{i}]") for i, v in enumerate(body)]
    if tag == "Object":
        return {k: _dynamic_value(v, f"{path}.{k}") for k, v in body.items()}
    raise DslError(f"unsupported property value variant: {tag}")


class _ParamNamespace:
    def bool(self) -> ParamSchema:
        return ParamSchema("Bool")

    def i64(self) -> ParamSchema:
        return ParamSchema("I64")

    def f64(self) -> ParamSchema:
        return ParamSchema("F64")

    def f32(self) -> ParamSchema:
        return ParamSchema("F32")

    def string(self) -> ParamSchema:
        return ParamSchema("String")

    def date_time(self) -> ParamSchema:
        return ParamSchema("DateTime")

    datetime = date_time

    def bytes(self) -> ParamSchema:
        return ParamSchema("Bytes")

    def value(self) -> ParamSchema:
        return ParamSchema("Value")

    def object(self, inner: ParamSchema | None = None) -> ParamSchema:
        return ParamSchema("Object", object_inner=inner or self.value())

    def array(self, inner: ParamSchema) -> ParamSchema:
        return ParamSchema("Array", inner=inner)


param = _ParamNamespace()


class ParamRef:
    """A named parameter reference usable wherever a value or bound goes."""

    __slots__ = ("name", "schema")

    def __init__(self, name: str, schema: ParamSchema):
        self.name = name
        self.schema = schema

    def to_expr(self) -> Expr:
        return Expr.param(self.name)

    def input(self) -> JsonValue:
        return {"Expr": Expr.param(self.name).node}

    def bound(self) -> JsonValue:
        return {"Expr": Expr.param(self.name).node}


class DefinedParams:
    """Schema-bound parameter namespace returned by :func:`define_params`."""

    def __init__(self, schema: Mapping[str, ParamSchema]):
        self.schema = dict(schema)
        self._refs = {name: ParamRef(name, s) for name, s in self.schema.items()}

    def __getattr__(self, name: str) -> ParamRef:
        try:
            return self._refs[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __getitem__(self, name: str) -> ParamRef:
        return self._refs[name]


def define_params(schema: Mapping[str, ParamSchema]) -> DefinedParams:
    return DefinedParams(schema)


# ---------------------------------------------------------------------------
# Stored-query registration and bundles (reference: query_generator.rs)
# ---------------------------------------------------------------------------

class RegisteredQuery:
    __slots__ = ("kind", "params", "builder")

    def __init__(self, kind: str, params: DefinedParams, builder: Any):
        self.kind = kind
        self.params = params
        self.builder = builder

    def build(self) -> _Batch:
        return self.builder(self.params)


def register_read(builder: Any, params: DefinedParams) -> RegisteredQuery:
    return RegisteredQuery("read", params, builder)


def register_write(builder: Any, params: DefinedParams) -> RegisteredQuery:
    return RegisteredQuery("write", params, builder)


class DefinedQueries:
    """A named-route table that can emit a queries.json bundle (wire v5)."""

    def __init__(self, definitions: Mapping[str, Mapping[str, RegisteredQuery]]):
        unknown = set(definitions) - {"read", "write"}
        if unknown:
            # a typo ("reads", "Write") would silently drop the whole
            # section and deploy a bundle with missing routes
            raise DslError(
                f"unknown query section {sorted(unknown)[0]!r} "
                "(expected 'read' / 'write')"
            )
        self.reads = dict(definitions.get("read", {}))
        self.writes = dict(definitions.get("write", {}))
        for name, rq in self.reads.items():
            if getattr(rq, "kind", "read") != "read":
                raise DslError(
                    f"query '{name}' was registered with register_write "
                    "but filed under 'read'"
                )
        for name, rq in self.writes.items():
            if getattr(rq, "kind", "write") != "write":
                raise DslError(
                    f"query '{name}' was registered with register_read "
                    "but filed under 'write'"
                )
        dupes = set(self.reads) & set(self.writes)
        if dupes:
            raise DslError(f"duplicate generated query name: {sorted(dupes)[0]}")
        self.call = _CallMap(self)

    def build_query_bundle(self) -> JsonValue:
        def routes(table, want_kind: str) -> JsonValue:
            out = {}
            for name in sorted(table):
                batch = table[name].build()
                if getattr(batch, "kind", want_kind) != want_kind:
                    raise DslError(
                        f"query '{name}' builds a {batch.kind} batch but "
                        f"is filed under '{want_kind}'"
                    )
                out[name] = batch.encode()
            return out

        def parameters(table: Mapping[str, RegisteredQuery]) -> JsonValue:
            return {
                name: [
                    {"name": pname, "ty": schema.encode_type()}
                    for pname, schema in table[name].params.schema.items()
                ]
                for name in sorted(table)
            }

        return {
            "version": wire.QUERY_BUNDLE_VERSION,
            "read_routes": routes(self.reads, "read"),
            "write_routes": routes(self.writes, "write"),
            "read_parameters": parameters(self.reads),
            "write_parameters": parameters(self.writes),
        }

    def generate(self, path: str | Path = "queries.json") -> str:
        Path(path).write_text(
            wire.dumps(self.build_query_bundle(), pretty=True), encoding="utf-8"
        )
        return str(path)


class _CallMap:
    def __init__(self, queries: DefinedQueries):
        self._queries = queries

    def __getattr__(self, name: str):
        route = self._queries.reads.get(name) or self._queries.writes.get(name)
        if route is None:
            raise AttributeError(name)

        def call(values: Mapping[str, Any] | None = None) -> DynamicQueryRequest:
            built = route.build()
            return built.to_dynamic_request(route.params, values or {}, query_name=name)

        return call

    def __getitem__(self, name: str):
        return getattr(self, name)


def define_queries(
    definitions: Mapping[str, Mapping[str, RegisteredQuery]]
) -> DefinedQueries:
    return DefinedQueries(definitions)


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
