"""Predicate and expression evaluation.

Two execution paths, chosen per predicate:

- **Vectorized**: predicates over stream elements whose right-hand sides
  are element-independent (constants or parameters) evaluate as NumPy mask
  ops over snapshot property columns — the scan path for ``Where``/
  ``NWhere`` full scans.
- **Elementwise**: anything element-dependent (``Compare`` over property
  arithmetic, ``Case``) falls back to per-traverser evaluation over the
  row store.

Virtual fields follow the reference contract (``dsl.rs:129-155``):
``$id``, ``$label``, ``$from``, ``$to``, ``$distance``, ``$score``, plus
``$from.prop`` / ``$to.prop`` endpoint reads used by projections.

Port copy of ``helix_tpu/engine/expr.py`` for ``helix_tpu_torch``: it
imports the port's own copies of the framework-free modules (wire, dsl,
native, telemetry, fastjson), so importing this module loads nothing of
the JAX package.  ``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in: nothing.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from . import values as V
from .errors import QueryError
from .frame import Frame
from .snapshot import GraphSnapshot
from .store import GraphStore

Tagged = Any
MISSING = V.MISSING

#: marker tag for deferred bulk-ingest arrays; payload is (raw,
#: declared_ty).  Lives here (not exec.py) so both the lazy
#: ``EvalContext.param`` conversion and exec's ForEach bulk fast path
#: import the same name — a rename on either side fails at import time.
_RAW_DOCS_TAG = "__HxRawDocs__"


class EvalContext:
    """Per-request evaluation state: bound parameters + batch clock."""

    __slots__ = ("params", "now_ms")

    def __init__(self, params: dict[str, Tagged] | None = None):
        self.params = params or {}
        self.now_ms = int(time.time() * 1000)

    def _materialize(self, name: str, value: Tagged) -> Tagged:
        """Deferred bulk arrays (exec._RAW_DOCS_TAG markers) convert on
        first generic access; the ForEach bulk path reads them raw."""
        if isinstance(value, dict) and len(value) == 1 and _RAW_DOCS_TAG in value:
            from .exec import _convert_param

            raw, ty = value[_RAW_DOCS_TAG]
            value = _convert_param(raw, ty, name)
            self.params[name] = value
        return value

    def param(self, path: str) -> Tagged:
        if path in self.params:
            return self._materialize(path, self.params[path])
        head, _, rest = path.partition(".")
        if head not in self.params:
            raise QueryError(f"unknown parameter: {path}")
        value = self._materialize(head, self.params[head])
        for part in rest.split(".") if rest else []:
            if isinstance(value, dict) and V.tag_of(value) == "Object":
                inner = V.payload_of(value)
                if part in inner:
                    value = inner[part]
                    continue
            raise QueryError(f"unknown parameter path: {path}")
        return value

    def child(self, name: str, value: Tagged) -> "EvalContext":
        params = dict(self.params)
        params[name] = value
        ctx = EvalContext(params)
        ctx.now_ms = self.now_ms
        return ctx


class Element:
    """Elementwise accessor for one traverser."""

    __slots__ = ("kind", "id", "store", "dist", "score")

    def __init__(self, kind: str, element_id: int, store: GraphStore,
                 dist: float | None = None, score: float | None = None):
        self.kind = kind
        self.id = element_id
        self.store = store
        self.dist = dist
        self.score = score

    def _record(self):
        return (
            self.store.node(self.id) if self.kind == "nodes"
            else self.store.edge(self.id)
        )

    def get(self, path: str) -> Tagged:
        if path.startswith("$"):
            return self._virtual(path)
        return V.get_path(self._record().props, path)

    def _virtual(self, path: str) -> Tagged:
        if path == "$id":
            return {"I64": self.id}
        if path == "$label":
            return {"String": self._record().label}
        if path == "$distance":
            return MISSING if self.dist is None or np.isnan(self.dist) else {"F64": float(self.dist)}
        if path == "$score":
            return MISSING if self.score is None or np.isnan(self.score) else {"F64": float(self.score)}
        if path == "$from" or path == "$to":
            if self.kind != "edges":
                return MISSING
            edge = self._record()
            return {"I64": edge.src if path == "$from" else edge.dst}
        if path.startswith("$from.") or path.startswith("$to."):
            if self.kind != "edges":
                return MISSING
            edge = self._record()
            endpoint = edge.src if path.startswith("$from.") else edge.dst
            sub = path.split(".", 1)[1]
            return Element("nodes", endpoint, self.store).get(sub)
        return MISSING


def eval_expr(node: Any, element: Element | None, ctx: EvalContext) -> Tagged:
    """Evaluate an Expr AST node to a tagged value (or MISSING)."""
    if node == "Id":
        if element is None:
            return MISSING
        return {"I64": element.id}
    if node == "Timestamp":
        return {"I64": ctx.now_ms}
    if node == "DateTimeNow":
        return {"DateTime": ctx.now_ms}
    if not isinstance(node, dict) or not node:
        # bare-string unit variants other than the three above (wire
        # validation passes expr payloads through): typed error, not a
        # TypeError-500 from indexing a string
        raise QueryError(f"unknown expression variant: {node!r}")
    tag = next(iter(node))
    body = node[tag]
    if tag == "Property":
        return element.get(body) if element is not None else MISSING
    if tag == "Constant":
        return body
    if tag == "Param":
        return ctx.param(body)
    if tag in ("Add", "Sub", "Mul", "Div", "Mod"):
        left = eval_expr(body[0], element, ctx)
        right = eval_expr(body[1], element, ctx)
        a, b = V.as_number(left) if left is not MISSING else None, (
            V.as_number(right) if right is not MISSING else None
        )
        if a is None or b is None:
            return MISSING
        try:
            if tag == "Add":
                out = a + b
            elif tag == "Sub":
                out = a - b
            elif tag == "Mul":
                out = a * b
            elif tag == "Div":
                if isinstance(a, float) or isinstance(b, float):
                    out = a / b
                else:
                    # Rust/C truncating division (the reference engine is
                    # Rust; -7/2 == -3, not Python's floor -4)
                    q = abs(a) // abs(b)
                    out = q if (a >= 0) == (b >= 0) else -q
            else:
                if isinstance(a, float) or isinstance(b, float):
                    out = a % b
                else:
                    # truncating remainder: sign follows the dividend
                    r = abs(a) % abs(b)
                    out = r if a >= 0 else -r
        except ZeroDivisionError:
            raise QueryError("division by zero in expression") from None
        if isinstance(out, int):
            return {"I64": out}
        return {"F64": float(out)}
    if tag == "Neg":
        inner = eval_expr(body, element, ctx)
        n = V.as_number(inner) if inner is not MISSING else None
        if n is None:
            return MISSING
        return {"I64": -n} if isinstance(n, int) else {"F64": -n}
    if tag == "Case":
        for pred, expr in body["when_then"]:
            if eval_predicate(pred, element, ctx):
                return eval_expr(expr, element, ctx)
        else_expr = body.get("else_expr")
        if else_expr is None:
            return "Null"
        return eval_expr(else_expr, element, ctx)
    raise QueryError(f"unknown expression variant: {tag}")


def expr_is_static(node: Any) -> bool:
    """True when an Expr AST node never reads the current element —
    it can be evaluated once per query (planner folds, stream bounds)
    instead of per row."""
    if node in ("Timestamp", "DateTimeNow"):
        return True
    if not isinstance(node, dict):
        return False  # "Id" and any unknown unit tag are element-bound
    tag = next(iter(node))
    body = node[tag]
    if tag in ("Constant", "Param"):
        return True
    if tag in ("Add", "Sub", "Mul", "Div", "Mod"):
        return expr_is_static(body[0]) and expr_is_static(body[1])
    if tag == "Neg":
        return expr_is_static(body)
    return False  # Property, Case, unknown tags


def _cmp_tagged(op: str, left: Tagged, right: Tagged) -> bool:
    if left is MISSING or right is MISSING:
        return False
    if op == "Eq":
        return V.equals(left, right)
    if op == "Neq":
        return not V.is_null(left) and not V.is_null(right) and not V.equals(left, right)
    cmp = V.compare(left, right)
    if cmp is None:
        return False
    if op == "Gt":
        return cmp > 0
    if op == "Gte":
        return cmp >= 0
    if op == "Lt":
        return cmp < 0
    if op == "Lte":
        return cmp <= 0
    raise QueryError(f"unknown comparison op: {op}")


def eval_predicate(node: Any, element: Element | None, ctx: EvalContext) -> bool:
    """Elementwise predicate evaluation."""
    tag = next(iter(node)) if isinstance(node, dict) else node
    body = node[tag] if isinstance(node, dict) else None
    if element is None and tag not in ("And", "Or", "Not"):
        # static contexts (stream bounds, property inputs) have no
        # element to read properties from — a clear 400, not a crash
        raise QueryError(
            f"element-dependent predicate '{tag}' is not valid in a "
            "static expression context"
        )
    if tag in ("Eq", "Neq", "Gt", "Gte", "Lt", "Lte"):
        prop, value = body
        return _cmp_tagged(tag, element.get(prop), value)
    if tag in ("EqExpr", "NeqExpr", "GtExpr", "GteExpr", "LtExpr", "LteExpr"):
        prop, expr = body
        return _cmp_tagged(tag[:-4], element.get(prop), eval_expr(expr, element, ctx))
    if tag == "Between":
        prop, lo, hi = body
        got = element.get(prop)
        return _cmp_tagged("Gte", got, lo) and _cmp_tagged("Lte", got, hi)
    if tag == "BetweenExpr":
        prop, lo, hi = body
        got = element.get(prop)
        return _cmp_tagged("Gte", got, eval_expr(lo, element, ctx)) and _cmp_tagged(
            "Lte", got, eval_expr(hi, element, ctx)
        )
    if tag == "HasKey":
        return element.get(body) is not MISSING
    if tag == "IsNull":
        got = element.get(body)
        return got is MISSING or V.is_null(got)
    if tag == "IsNotNull":
        got = element.get(body)
        return got is not MISSING and not V.is_null(got)
    if tag in ("StartsWith", "EndsWith", "Contains"):
        prop, needle = body
        got = element.get(prop)
        text = V.text_of(got) if got is not MISSING else None
        if text is None:
            return False
        if tag == "StartsWith":
            return text.startswith(needle)
        if tag == "EndsWith":
            return text.endswith(needle)
        return needle in text
    if tag == "ContainsExpr":
        prop, expr = body
        got = element.get(prop)
        text = V.text_of(got) if got is not MISSING else None
        needle = eval_expr(expr, element, ctx)
        needle_text = V.text_of(needle) if needle is not MISSING else None
        return text is not None and needle_text is not None and needle_text in text
    if tag == "IsIn":
        prop, values = body
        got = element.get(prop)
        return got is not MISSING and V.contains_member(values, got)
    if tag == "IsInExpr":
        prop, expr = body
        got = element.get(prop)
        values = eval_expr(expr, element, ctx)
        return (
            got is not MISSING and values is not MISSING
            and V.contains_member(values, got)
        )
    if tag == "And":
        return all(eval_predicate(p, element, ctx) for p in body)
    if tag == "Or":
        return any(eval_predicate(p, element, ctx) for p in body)
    if tag == "Not":
        return not eval_predicate(body, element, ctx)
    if tag == "Compare":
        left = eval_expr(body["left"], element, ctx)
        right = eval_expr(body["right"], element, ctx)
        return _cmp_tagged(body["op"], left, right)
    raise QueryError(f"unknown predicate variant: {tag}")


# ---------------------------------------------------------------------------
# Vectorized path
# ---------------------------------------------------------------------------

def _resolve_static(node: Any, ctx: EvalContext) -> Tagged:
    """Evaluate an element-independent expr; MISSING if element-dependent.

    Shares ``expr_is_static`` with the planner's predicate fold
    (exec._fold_static_expr) so the two paths agree on what counts as
    static — including arithmetic over params/constants."""
    if not expr_is_static(node):
        return MISSING
    return eval_expr(node, None, ctx)


def predicate_mask(
    snap: GraphSnapshot,
    store: GraphStore,
    frame: Frame,
    slots: np.ndarray,
    node: Any,
    ctx: EvalContext,
) -> np.ndarray:
    """Vectorized predicate mask over an element frame, with elementwise
    fallback for the variants the columnar path cannot express."""
    kind = "node" if frame.kind == "nodes" else "edge"
    mask = _try_vector_mask(snap, kind, frame, slots, node, ctx)
    if mask is not None:
        return mask
    out = np.empty(len(frame), bool)
    for i in range(len(frame)):
        element = Element(
            frame.kind,
            int(frame.ids[i]),
            store,
            None if frame.dist is None else float(frame.dist[i]),
            None if frame.score is None else float(frame.score[i]),
        )
        out[i] = eval_predicate(node, element, ctx)
    return out


def _label_codes(snap: GraphSnapshot, kind: str, slots: np.ndarray) -> np.ndarray:
    if kind == "node":
        return snap.node_label_codes[slots]
    return snap.edge_label_codes[slots]


def _try_vector_mask(
    snap: GraphSnapshot,
    kind: str,
    frame: Frame,
    slots: np.ndarray,
    node: Any,
    ctx: EvalContext,
) -> np.ndarray | None:
    tag = next(iter(node)) if isinstance(node, dict) else node
    body = node[tag] if isinstance(node, dict) else None

    if tag == "And" or tag == "Or":
        parts = []
        for sub in body:
            m = _try_vector_mask(snap, kind, frame, slots, sub, ctx)
            if m is None:
                return None
            parts.append(m)
        if not parts:
            # identity elements: all([]) is True, any([]) is False —
            # must match the elementwise fallback
            return (
                np.ones(len(slots), bool) if tag == "And"
                else np.zeros(len(slots), bool)
            )
        out = parts[0]
        for m in parts[1:]:
            out = (out & m) if tag == "And" else (out | m)
        return out
    if tag == "Not":
        m = _try_vector_mask(snap, kind, frame, slots, body, ctx)
        return None if m is None else ~m

    if tag in ("Eq", "Neq", "Gt", "Gte", "Lt", "Lte",
               "EqExpr", "NeqExpr", "GtExpr", "GteExpr", "LtExpr", "LteExpr"):
        if tag.endswith("Expr"):
            op = tag[:-4]
            prop, expr = body
            value = _resolve_static(expr, ctx)
            if value is MISSING:
                return None
        else:
            op = tag
            prop, value = body
        return _column_cmp(snap, kind, frame, slots, prop, op, value)

    if tag == "Between" or tag == "BetweenExpr":
        if tag == "Between":
            prop, lo, hi = body
        else:
            prop, lo_e, hi_e = body
            lo = _resolve_static(lo_e, ctx)
            hi = _resolve_static(hi_e, ctx)
            if lo is MISSING or hi is MISSING:
                return None
        m1 = _column_cmp(snap, kind, frame, slots, prop, "Gte", lo)
        m2 = _column_cmp(snap, kind, frame, slots, prop, "Lte", hi)
        if m1 is None or m2 is None:
            return None
        return m1 & m2

    if tag in ("HasKey", "IsNull", "IsNotNull"):
        if body.startswith("$"):
            return None
        col = snap.column(kind, body)
        present = col.present[slots]
        if tag == "HasKey":
            # present[] misses explicit Nulls; HasKey must also count those.
            return _haskey_mask(snap, kind, frame, slots, body, present)
        if tag == "IsNull":
            return ~present
        return present

    if tag in ("StartsWith", "EndsWith", "Contains"):
        prop, needle = body
        if prop.startswith("$"):
            return None
        col = snap.column(kind, prop)
        if col.strings is None:
            return np.zeros(len(slots), bool)
        sub = col.strings[slots]
        out = np.zeros(len(slots), bool)
        for i, s in enumerate(sub):
            if s is None:
                continue
            if tag == "StartsWith":
                out[i] = s.startswith(needle)
            elif tag == "EndsWith":
                out[i] = s.endswith(needle)
            else:
                out[i] = needle in s
        return out

    return None


def _haskey_mask(snap, kind, frame, slots, prop, present):
    # present = any non-null value; null_mask = explicit Null.  Their
    # union is exactly "the key exists" — no per-row store lookups (the
    # old loop did one dict hit per absent row, ~1M/query on sparse
    # props; the column already tracks explicit Nulls).
    col = snap.column(kind, prop)
    return present | col.null_mask[slots]


def _column_cmp(
    snap: GraphSnapshot,
    kind: str,
    frame: Frame,
    slots: np.ndarray,
    prop: str,
    op: str,
    value: Tagged,
) -> np.ndarray | None:
    if prop == "$label":
        text = V.text_of(value)
        if text is None:
            return np.zeros(len(slots), bool)
        code_map = snap.label_code if kind == "node" else snap.edge_label_code
        code = code_map.get(text, -1)
        codes = _label_codes(snap, kind, slots)
        if op == "Eq":
            return codes == code
        if op == "Neq":
            return codes != code
        return None
    if prop == "$id":
        num = V.as_number(value)
        if num is None:
            return np.zeros(len(slots), bool)
        return _id_cmp(frame.ids, op, num)
    if prop == "$distance" or prop == "$score":
        colv = frame.dist if prop == "$distance" else frame.score
        if colv is None:
            # the stream has no distances HERE, but a caller resolving
            # masks position-independently (the device planner uses an
            # all-nodes frame) must fall back, not bake all-False
            return None
        num = V.as_number(value)
        if num is None:
            return np.zeros(len(slots), bool)
        return _np_cmp(op, colv, float(num), ~np.isnan(colv))
    if prop.startswith("$"):
        return None

    col = snap.column(kind, prop)
    num = V.as_number(value)
    if num is not None:
        data = col.numeric[slots]
        valid = col.numeric_mask[slots]
        if op == "Neq":
            # elementwise semantics: any PRESENT value of a different
            # family (e.g. a string) is not-equal to a number — masking
            # on numeric_mask alone would wrongly drop those rows
            eq = np.zeros(len(slots), bool)
            eq[valid] = data[valid] == float(num)
            return col.present[slots] & ~eq
        return _np_cmp(op, data, float(num), valid)
    text = V.text_of(value)
    if text is not None:
        if col.strings is None:
            if op == "Neq":
                # no string ever stored: every present value is a
                # different family, hence not-equal
                return col.present[slots].copy()
            return np.zeros(len(slots), bool)
        sub = col.strings[slots]
        out = np.zeros(len(slots), bool)
        for i, s in enumerate(sub):
            if s is None:
                if op == "Neq" and col.present[slots[i]]:
                    out[i] = True  # present non-string value != text
                continue
            if op == "Eq":
                out[i] = s == text
            elif op == "Neq":
                out[i] = s != text
            elif op == "Gt":
                out[i] = s > text
            elif op == "Gte":
                out[i] = s >= text
            elif op == "Lt":
                out[i] = s < text
            elif op == "Lte":
                out[i] = s <= text
        return out
    if V.tag_of(value) == "Bool":
        # Bools live in the numeric column as 0/1 but only when the stored
        # tag was Bool; fall back elementwise to respect family rules.
        return None
    return None


_U64_MAX = (1 << 64) - 1


def _id_cmp(ids: np.ndarray, op: str, num) -> np.ndarray:
    """Exact comparison of uint64 ids against a numeric literal.

    ids >= 2^53 do not survive a float64 cast (the rest of the module
    guards this boundary; see ``_order_fast``), so order ops reduce to
    integer thresholds computed in Python's exact arithmetic."""
    import math

    n = len(ids)
    if num != num:  # NaN never compares equal/ordered; Neq is all-True
        return np.ones(n, bool) if op == "Neq" else np.zeros(n, bool)
    if num == math.inf:
        ones = op in ("Neq", "Lt", "Lte")
        return np.ones(n, bool) if ones else np.zeros(n, bool)
    if num == -math.inf:
        ones = op in ("Neq", "Gt", "Gte")
        return np.ones(n, bool) if ones else np.zeros(n, bool)
    is_int = num == int(num)
    if op == "Eq":
        if not is_int or num < 0 or num > _U64_MAX:
            return np.zeros(n, bool)
        return ids == np.uint64(int(num))
    if op == "Neq":
        if not is_int or num < 0 or num > _U64_MAX:
            return np.ones(n, bool)
        return ids != np.uint64(int(num))
    # Order ops: ids OP num  <=>  ids >= / <= an integer threshold.
    if op == "Gt":
        lo = math.floor(num) + 1
    elif op == "Gte":
        lo = math.ceil(num)
    else:
        lo = None
    if lo is not None:
        if lo <= 0:
            return np.ones(n, bool)
        if lo > _U64_MAX:
            return np.zeros(n, bool)
        return ids >= np.uint64(lo)
    if op == "Lt":
        hi = math.ceil(num) - 1
    elif op == "Lte":
        hi = math.floor(num)
    else:
        return np.zeros(n, bool)
    if hi < 0:
        return np.zeros(n, bool)
    if hi >= _U64_MAX:
        return np.ones(n, bool)
    return ids <= np.uint64(hi)


def _np_cmp(op: str, data: np.ndarray, rhs: float, valid: np.ndarray) -> np.ndarray:
    if op == "Eq":
        out = data == rhs
    elif op == "Neq":
        out = data != rhs
    elif op == "Gt":
        out = data > rhs
    elif op == "Gte":
        out = data >= rhs
    elif op == "Lt":
        out = data < rhs
    else:
        out = data <= rhs
    return out & valid
