"""The batch query interpreter.

Executes a ``DynamicQueryRequest`` against a :class:`GraphStore`: entries
run sequentially in one transaction (write batches roll back on failure),
each ``NamedQuery`` compiles its step list into a stream pipeline over
:class:`Frame` bags, and variables flow between entries through a batch
scope (reference execution model: ``sdks/rust/src/dsl.rs:4443-4649``).

Hot paths are vectorized: sources resolve through indexes or label lists,
expansions are CSR range-gathers (``snapshot.gather_ranges``), filters are
column masks, and vector/text search delegates to the TPU-backed index
managers.

Documented engine-semantics decisions (the reference engine is opaque;
these define this rebuild's contract):

- ``Both``/``BothE`` emit the out-expansion block then the in-expansion
  block; within each block results are grouped by source traverser in
  stream order.
- ``AddE`` links every node in the current stream to every resolved target
  (cartesian) and leaves the *source-node* stream current (matching the
  reference builder's typestate, reference ``dsl.py:2018``).
- ``Union``/``Choose``/``Coalesce`` branch outputs concatenate in branch
  order; ``Coalesce`` resolves per traverser (first branch with output).
- ``Repeat`` without ``times``/``until`` loops until the frontier is empty
  or ``max_depth``.
- ``ForEach`` iterations share the batch variable scope; later iterations
  overwrite earlier variables of the same name.
- ``Group`` keys are the property's plain-JSON rendering as a string.

Port copy of ``helix_tpu/engine/exec.py`` for ``helix_tpu_torch``: it
imports the port's own copies of the framework-free modules (wire, dsl,
native, telemetry, fastjson), so importing this module loads nothing of
the JAX package.  ``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:

- ``_accelerator_present``: dropped.  The reference asks the process's
  default backend; the port's engine holds its own device, so the engine
  tells its router instead.
- ``_DEVICE_BACKEND``: dropped with it (its cache).
- ``TraversalRouter.__init__``: takes ``device_first``, which
  ``Engine.__init__`` sets when the engine's device is CUDA.
- ``TraversalRouter.choose``: bootstraps device first when
  ``device_first`` is set, native first otherwise.
- ``Executor._run_device_plan``: runs the plan on the snapshot's device
  with the port's ``ops/csr.py``.
- ``Executor._run_sharded_traversal``: counts the mesh's devices with
  ``parallel.device_count`` over the snapshot's device type.
- ``_QueryState._sharded_hop``: as ``_run_sharded_traversal``.
- ``_QueryState._sharded_edge_hop``: as ``_run_sharded_traversal``.
"""

from __future__ import annotations

import json
from typing import Any, Callable

import numpy as np

from array import array as _pyarray

from .. import wire
from ..dsl import DateTime, PropertyValue, _require_finite
from . import values as V
from .errors import ParamError, QueryError
from .expr import (
    _RAW_DOCS_TAG, Element, EvalContext, eval_expr, eval_predicate,
    expr_is_static, predicate_mask,
)
from .frame import Frame, concat_frames
from .snapshot import GraphSnapshot, SnapshotCache, gather_ranges
from .store import GraphStore

Tagged = Any
MISSING = V.MISSING
UINT64 = np.uint64


_UNSET = object()


class VarValue:
    """A batch variable: the payload plus emptiness metadata and, for
    element streams, the frame for re-seeding (``NodeRef::Var``).

    Stream payloads encode lazily (``thunk``): most write-batch vars are
    never returned or selected, so their full-props JSON rendering is
    skipped entirely on the hot ingest path."""

    __slots__ = ("_payload", "size", "frame", "_thunk")

    def __init__(
        self,
        payload: Any,
        size: int,
        frame: Frame | None = None,
        thunk: Any = None,
    ):
        self._payload = payload
        self.size = size
        self.frame = frame
        self._thunk = thunk

    @property
    def payload(self) -> Any:
        if self._payload is _UNSET:
            self._payload = self._thunk()
            self._thunk = None
        return self._payload


class Terminal:
    """Marker wrapper returned by terminal step handlers."""

    __slots__ = ("payload", "size")

    def __init__(self, payload: Any, size: int):
        self.payload = payload
        self.size = size


def convert_parameters(
    parameters: dict[str, Any] | None,
    parameter_types: dict[str, Any] | None,
    skip: frozenset | set = frozenset(),
) -> dict[str, Tagged]:
    """Convert plain dynamic-parameter JSON into tagged runtime values,
    honoring declared types (reference types: query_generator.rs:17-38).
    Names in ``skip`` are left to the caller (deferred bulk arrays)."""
    out: dict[str, Tagged] = {}
    parameters = parameters or {}
    types = parameter_types or {}
    for name in types:
        if name not in parameters:
            raise ParamError(f"missing required parameter: {name}")
    for name, value in parameters.items():
        if name not in skip:
            out[name] = _convert_param(value, types.get(name), name)
    return out




def _bulk_add_n_columns(body: dict, param_name: str):
    """Shape test for the ForEach bulk fast path: body == one
    unconditional AddN whose property inputs are loop-param fields or
    constants.  Returns (query, add_n, columns) or None; columns entries
    are (prop_name, field|''|None, const) — field '' binds the whole loop
    item, None marks a constant."""
    entries = body.get("body") or []
    if len(entries) != 1 or not isinstance(entries[0], dict):
        return None
    if "Query" not in entries[0]:
        return None
    q = entries[0]["Query"]
    if q.get("condition") is not None:
        return None
    steps = q.get("steps") or []
    if len(steps) != 1 or not isinstance(steps[0], dict):
        return None
    if "AddN" not in steps[0]:
        return None
    add_n = steps[0]["AddN"]
    prefix = param_name + "."
    columns: list[tuple] = []
    for prop in add_n.get("properties", []):
        if not (isinstance(prop, (list, tuple)) and len(prop) == 2):
            return None
        name, node = prop
        if not isinstance(node, dict) or len(node) != 1:
            return None
        tag = next(iter(node))
        inner = node[tag]
        if tag == "Expr" and isinstance(inner, dict) and len(inner) == 1:
            tag, inner = next(iter(inner.items()))
        if tag == "Value":
            columns.append((name, None, inner))
        elif tag == "Param" and isinstance(inner, str):
            if inner == param_name:
                columns.append((name, "", None))
            elif inner.startswith(prefix) and "." not in inner[len(prefix):]:
                columns.append((name, inner[len(prefix):], None))
            else:
                return None  # outer params / deep paths: loop path
        else:
            return None
    return q, add_n, columns


def _deferrable_bulk_params(request: dict) -> set:
    """Names of array params safe to leave unconverted: consumed by a
    top-level ForEach whose body is the bulk AddN shape, declared (or
    defaulting to) a generic object/value array."""
    try:
        entries = request["query"]["queries"]
    except (KeyError, TypeError):
        return set()
    parameters = request.get("parameters") or {}
    types = request.get("parameter_types") or {}
    out: set = set()
    for entry in entries:
        if not (isinstance(entry, dict) and "ForEach" in entry):
            continue
        body = entry["ForEach"]
        name = body.get("param")
        if not isinstance(name, str) or name in out:
            continue
        ty = types.get(name)
        if ty is not None and ty not in ({"Array": "Object"}, {"Array": "Value"}):
            continue
        raw = parameters.get(name)
        if not (isinstance(raw, list) and len(raw) >= 64):
            continue  # small batches: eager conversion is cheap
        if _bulk_add_n_columns(body, name) is None:
            continue
        out.add(name)
    return out


def _convert_param(value: Any, ty: Any, path: str) -> Tagged:
    if ty is None:
        return V.from_plain(value)
    tag = ty if isinstance(ty, str) else next(iter(ty))
    if tag == "Bool":
        if not isinstance(value, bool):
            raise ParamError(f"parameter '{path}' must be boolean")
        return {"Bool": value}
    if tag == "I64":
        if isinstance(value, bool) or not isinstance(value, int):
            raise ParamError(f"parameter '{path}' must be an integer")
        return {"I64": value}
    if tag in ("F64", "F32"):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ParamError(f"parameter '{path}' must be a number")
        return {tag: float(value)}
    if tag == "String":
        if not isinstance(value, str):
            raise ParamError(f"parameter '{path}' must be a string")
        return {"String": value}
    if tag == "DateTime":
        if isinstance(value, str):
            return {"DateTime": DateTime.parse_rfc3339(value).millis}
        if isinstance(value, int) and not isinstance(value, bool):
            return {"DateTime": value}
        raise ParamError(f"parameter '{path}' must be an RFC3339 datetime")
    if tag == "Bytes":
        raise ParamError(
            f"parameter '{path}' uses bytes, which the dynamic query JSON "
            "route cannot represent"
        )
    if tag == "Value":
        return V.from_plain(value)
    if tag == "Object":
        if not isinstance(value, dict):
            raise ParamError(f"parameter '{path}' must be an object")
        return {"Object": {k: V.from_plain(v) for k, v in value.items()}}
    if tag == "Array":
        if not isinstance(value, list):
            if type(value).__name__ == "array":  # fast-parsed numeric vector
                value = value.tolist()
            else:
                raise ParamError(f"parameter '{path}' must be an array")
        inner = ty["Array"]
        inner_tag = inner if isinstance(inner, str) else next(iter(inner))
        # cells validate like the scalar paths above: coercion silently
        # accepted strings/bools into numeric arrays and turned null
        # into the string "None"
        if inner_tag in ("F32", "F64"):
            out = []
            for i, v in enumerate(value):
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise ParamError(
                        f"parameter '{path}[{i}]' must be a number"
                    )
                out.append(float(v))
            return {f"{inner_tag}Array": out}
        if inner_tag == "I64":
            out = []
            for i, v in enumerate(value):
                if isinstance(v, bool) or not isinstance(v, int):
                    raise ParamError(
                        f"parameter '{path}[{i}]' must be an integer"
                    )
                out.append(v)
            return {"I64Array": out}
        if inner_tag == "String":
            for i, v in enumerate(value):
                if not isinstance(v, str):
                    raise ParamError(
                        f"parameter '{path}[{i}]' must be a string"
                    )
            return {"StringArray": list(value)}
        return {
            "Array": [
                _convert_param(v, inner, f"{path}[{i}]") for i, v in enumerate(value)
            ]
        }
    raise ParamError(f"unknown parameter type: {tag}")


class UndoLog:
    """Reverse-replay transaction log over the store's raw primitives."""

    def __init__(self, store: GraphStore):
        self.store = store
        self.ops: list[Callable[[], None]] = []
        self.counters = store.save_counters()

    def record(self, op: Callable[[], None]) -> None:
        self.ops.append(op)

    def rollback(self) -> None:
        for op in reversed(self.ops):
            op()
        self.store.restore_counters(self.counters)


_INVALIDATING_TAGS = frozenset(
    {
        "Drop",
        "DropEdge",
        "DropEdgeLabeled",
        "DropEdgeById",
        "SetProperty",
        "RemoveProperty",
    }
)


def _has_invalidating_steps(entries: Any) -> bool:
    """True if any step anywhere in the batch can change what an existing
    frame encodes to (drops/property mutations).  Generic recursive key
    scan so nested ForEach bodies and sub-traversals are covered; a
    false positive (a user property literally named "Drop") only costs
    the lazy-encode optimization, never correctness."""
    stack = [entries]
    while stack:
        item = stack.pop()
        if isinstance(item, dict):
            for key, val in item.items():
                if key in _INVALIDATING_TAGS:
                    return True
                stack.append(val)
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
        elif isinstance(item, str) and item in _INVALIDATING_TAGS:
            return True
    return False


class TraversalRouter:
    """Measured-cost device-vs-native routing for set-reduced traversals.

    Round 3 routed device-first purely on backend identity, and the
    round-3 bench caught a config where the device path measured slower
    than the host sweep (remote-attached chips pay per-query H2D for the
    frontier mask).  This router times the paths it actually runs and
    picks the cheaper one:

    - each path's first run warms up (device: XLA compile) and is not
      recorded;
    - afterwards an EWMA of wall ms per path decides;
    - every 64th decision re-samples the losing path so a cold estimate
      or changed conditions (snapshot growth, tunnel latency) can flip
      the route back.

    ``HELIX_TRAVERSAL_BACKEND=device|native`` still forces a path;
    ``auto`` (default) uses measurement.
    """

    EXPLORE_EVERY = 64
    ALPHA = 0.3

    def __init__(self, device_first: bool = False):
        self.device_first = device_first
        self.ewma: dict[str, float] = {}
        self.runs: dict[str, int] = {"device": 0, "native": 0}
        self.decisions = 0

    def choose(self, device_available: bool, native_available: bool) -> str:
        import os

        mode = os.environ.get("HELIX_TRAVERSAL_BACKEND", "auto")
        if mode == "device" and device_available:
            return "device"
        if mode == "native" and native_available:
            return "native"
        if not device_available:
            return "native"
        if not native_available:
            return "device"
        # bootstrap: run each path until it has a recorded sample
        # (accelerators first — the common win at serving scale)
        for path in (
            ("device", "native") if self.device_first
            else ("native", "device")
        ):
            if path not in self.ewma:
                return path
        self.decisions += 1
        best = min(self.ewma, key=self.ewma.get)
        if self.decisions % self.EXPLORE_EVERY == 0:
            worst = max(self.ewma, key=self.ewma.get)
            if worst != best:
                return worst
        return best

    def record(self, path: str, elapsed_s: float) -> None:
        self.runs[path] = self.runs.get(path, 0) + 1
        if self.runs[path] == 1:
            return  # warm-up (compile/caches) — not representative
        ms = elapsed_s * 1000.0
        prev = self.ewma.get(path)
        self.ewma[path] = (
            ms if prev is None else prev + self.ALPHA * (ms - prev)
        )


class Executor:
    """Executes one request; owns no long-lived state beyond the engine."""

    _eager_names: Any = frozenset()

    def __init__(self, engine: Any):
        self.engine = engine
        self.store: GraphStore = engine.store
        self.snapshots: SnapshotCache = engine.snapshots

    # ------------------------------------------------------------------
    # Request entry point
    # ------------------------------------------------------------------

    def execute(
        self,
        request: dict,
        now_ms: int | None = None,
        trace: list | None = None,
    ) -> dict:
        wire.validate_request(request)
        deferred = _deferrable_bulk_params(request)
        params = convert_parameters(
            request.get("parameters"), request.get("parameter_types"),
            skip=deferred,
        )
        for name in deferred:
            # Bulk-ingest arrays skip eager tagging: the ForEach bulk
            # path consumes the raw JSON rows directly (the generic
            # per-item Object conversion costs more than the insert at
            # 100k+ docs).  Any OTHER access converts lazily through
            # EvalContext.param, so semantics are unchanged.
            params[name] = {
                _RAW_DOCS_TAG: (
                    request["parameters"][name],
                    (request.get("parameter_types") or {}).get(name),
                )
            }
        ctx = EvalContext(params)
        if now_ms is not None:
            ctx.now_ms = now_ms  # deterministic WAL replay clock
        batch = request["query"]
        is_write = request["request_type"] == "write"
        undo = UndoLog(self.store) if is_write else None
        scope: dict[str, VarValue] = {}
        order: list[str] = []
        self.trace = trace
        # Lazy stream payloads encode against the live store. In a write
        # batch whose later entries can invalidate earlier frames (Drop /
        # SetProperty / ...), returned vars must be materialized at
        # assignment time, not batch end — else `n <- AddN; DROP n` fails
        # mid-encode AFTER mutations survive, diverging memory from
        # WAL/replicas. Pure-add batches keep the lazy fast path (adds
        # never change what an existing frame encodes to).
        returns = batch.get("returns")
        self._eager_names = (
            (frozenset(returns) if returns else None)
            if is_write and _has_invalidating_steps(batch["queries"])
            else frozenset()
        )
        # Bulk ingests allocate millions of containers while the request's
        # own object graph is live; CPython's cyclic GC re-traverses it on
        # every generation threshold, measured at ~2/3 of ingest wall time
        # at 100k docs.  Nothing in a batch creates cycles — pause
        # collection (refcounting still frees) for the duration.
        import gc as _gc

        pause_gc = bool(deferred) and _gc.isenabled()
        if pause_gc:
            _gc.disable()
        try:
            self._run_entries(batch["queries"], ctx, scope, order, undo)
            # Encode inside the rollback window: a payload-encode failure
            # must roll mutations back before the WAL/replication decision.
            names = returns or order
            return {name: self._payload_for(scope.get(name)) for name in names}
        except Exception:
            if undo is not None:
                undo.rollback()
            raise
        finally:
            if pause_gc:
                _gc.enable()

    def _payload_for(self, var: VarValue | None) -> Any:
        if var is None:
            return None
        return var.payload

    def _run_entries(
        self,
        entries: list,
        ctx: EvalContext,
        scope: dict[str, VarValue],
        order: list[str],
        undo: UndoLog | None,
    ) -> None:
        prev: VarValue | None = None
        for entry in entries:
            tag = wire.tag_of(entry, frozenset({"Query", "ForEach"}), "batch entry")
            body = wire.payload_of(entry)
            if tag == "ForEach":
                self._run_foreach(body, ctx, scope, order, undo)
                prev = None
                continue
            name = body.get("name")
            condition = body.get("condition")
            if condition is not None and not self._condition(condition, scope, prev):
                result = VarValue([], 0, Frame.empty())
            else:
                result = self._run_query(body["steps"], ctx, scope, undo)
            if name:
                if name not in scope:
                    order.append(name)
                scope[name] = result
                eager = self._eager_names
                if eager is None or name in eager:
                    result.payload  # materialize at assignment time
            prev = result

    def _run_foreach(
        self,
        body: dict,
        ctx: EvalContext,
        scope: dict[str, VarValue],
        order: list[str],
        undo: UndoLog | None,
    ) -> None:
        param_name = body["param"]
        # Deferred bulk arrays: try the raw fast path before the lazy
        # conversion that ctx.param() would trigger.
        marker = ctx.params.get(param_name)
        if (
            isinstance(marker, dict)
            and len(marker) == 1
            and _RAW_DOCS_TAG in marker
        ):
            raw_items = marker[_RAW_DOCS_TAG][0]
            if self._foreach_bulk_add_n(
                body, raw_items, param_name, scope, order, undo, raw=True
            ):
                return
        value = ctx.param(param_name)
        tag = V.tag_of(value)
        if tag == "Array":
            items = V.payload_of(value)
        elif tag in ("I64Array", "F64Array", "F32Array", "StringArray"):
            base = tag[:-5]
            items = [{base: v} for v in V.payload_of(value)]
        else:
            raise QueryError(
                f"ForEach parameter '{param_name}' must be an array"
            )
        if self._foreach_bulk_add_n(
            body, items, param_name, scope, order, undo
        ):
            return
        for item in items:
            child = ctx.child(param_name, item)
            self._run_entries(body["body"], child, scope, order, undo)

    def _foreach_bulk_add_n(
        self,
        body: dict,
        items: list,
        param_name: str,
        scope: dict[str, VarValue],
        order: list[str],
        undo: UndoLog | None,
        raw: bool = False,
    ) -> bool:
        """Vectorized ForEach: a body that is exactly one unconditional
        ``AddN`` whose property inputs are loop-param fields or constants
        becomes ONE bulk store insert (shared column extraction, one
        vector-hook matrix extend, one undo record) instead of N
        interpreter iterations.  Returns False — caller falls back to the
        loop — for any other shape, so semantics stay identical.

        ``raw=True``: items are unconverted JSON dicts (deferred bulk
        param); field values tag through ``PropertyValue.of``, the same
        coercion the eager Object conversion applies.
        """
        shape = _bulk_add_n_columns(body, param_name)
        if shape is None or undo is None:
            return False  # (read batch: loop path raises the proper error)
        q, add_n, columns = shape
        prefix = param_name + "."
        # items must all be single-level objects for field extraction
        rows: list[dict] = []
        if raw:
            for item in items:
                if type(item) is not dict:
                    return False
                rows.append(item)
        else:
            for item in items:
                if not (isinstance(item, dict) and V.tag_of(item) == "Object"):
                    return False
                rows.append(V.payload_of(item))
        of = PropertyValue.of
        # Column-major tagging: pull each field's column in one pass,
        # sniff the column's element type once (set(map(type, ...)) is
        # C-speed), and tag homogeneous columns with a specialized
        # comprehension instead of per-cell ``of()`` dispatch — the
        # measured ingest hot path (~1.5 us/doc at 128-d).
        missing = object()
        names: list[str] = []
        tagged_cols: list[list] = []
        n_rows = len(rows)
        for name, field, const in columns:
            names.append(name)
            if field is None:
                tagged_cols.append([const] * n_rows)
                continue
            if field == "":
                tagged_cols.append(
                    [of(item) for item in items] if raw else list(items)
                )
                continue
            col = []
            append = col.append
            for row in rows:
                value = row.get(field, missing)
                if value is missing:
                    # match the loop path: eval_expr raises on
                    # unknown parameter paths
                    raise QueryError(
                        f"unknown parameter path: {prefix}{field}"
                    )
                append(value)
            if raw:
                kinds = set(map(type, col))
                if kinds == {str}:
                    # the wire encodes null as the bare string "Null";
                    # PropertyValue.of (the eager path) maps it to the
                    # null value — the bulk column must agree or the
                    # SAME request stores different data by batch size
                    col = [
                        "Null" if v == "Null" else {"String": v}
                        for v in col
                    ]
                elif kinds == {_pyarray}:
                    # fastjson fast_arrays rows: of()'s first branch,
                    # inlined (typecode check stays — of() requires 'd')
                    col = [
                        {"F64Array": v} if v.typecode == "d" else of(v)
                        for v in col
                    ]
                elif kinds == {int}:
                    col = [{"I64": v} for v in col]
                elif kinds == {float}:
                    col = [{"F64": _require_finite(v)} for v in col]
                else:
                    col = [of(v) for v in col]
            tagged_cols.append(col)
        if tagged_cols:
            props_list: list[dict] = [
                dict(zip(names, vals)) for vals in zip(*tagged_cols)
            ]
        else:
            # zero-property AddN: zip(*[]) is empty, but the loop path
            # still creates one (bare) node per item
            props_list = [{} for _ in rows]
        node_ids = self.store.add_nodes_bulk(
            add_n["label"], props_list, copy_props=False
        )
        undo.record(
            lambda ids=tuple(node_ids): [
                self.store.raw_remove_node(i) for i in reversed(ids)
            ]
        )
        name = q.get("name")
        if name and node_ids:
            # loop semantics: the body var ends holding the LAST iteration's
            # created node
            frame = Frame.nodes(np.array([node_ids[-1]], UINT64))
            result = VarValue(
                _UNSET, 1, frame, thunk=lambda f=frame: self.encode_frame(f)
            )
            if name not in scope:
                order.append(name)
            scope[name] = result
            eager = self._eager_names
            if eager is None or name in eager:
                result.payload
        return True

    def _condition(
        self, condition: Any, scope: dict[str, VarValue], prev: VarValue | None
    ) -> bool:
        tag = next(iter(condition)) if isinstance(condition, dict) else condition
        if tag == "PrevNotEmpty":
            return prev is not None and prev.size > 0
        body = condition[tag]
        if tag == "VarNotEmpty":
            var = scope.get(body)
            return var is not None and var.size > 0
        if tag == "VarEmpty":
            var = scope.get(body)
            return var is None or var.size == 0
        if tag == "VarMinSize":
            name, size = body
            var = scope.get(name)
            return var is not None and var.size >= size
        raise QueryError(f"unknown batch condition: {tag}")

    # ------------------------------------------------------------------
    # Query pipeline
    # ------------------------------------------------------------------

    def _run_query(
        self,
        steps: list,
        ctx: EvalContext,
        scope: dict[str, VarValue],
        undo: UndoLog | None,
    ) -> VarValue:
        trace_active = getattr(self, "trace", None) is not None
        if not trace_active:
            # traced requests take the host pipeline so $trace carries
            # real per-step timings (the fused device plan has no
            # per-step boundaries to report)
            device_result = self._try_device_traversal(steps, ctx, scope)
            if device_result is not None:
                return device_result
        state = _QueryState(self, ctx, scope, undo)
        frame = Frame.empty()
        trace = getattr(self, "trace", None)
        if trace is None:
            for step in steps:
                result = state.apply(frame, step)
                if isinstance(result, Terminal):
                    return VarValue(result.payload, result.size, None)
                frame = result
            return VarValue(
                _UNSET, len(frame), frame,
                thunk=lambda f=frame: self.encode_frame(f),
            )
        import time as _time

        for step in steps:
            tag = wire.tag_of(step, wire.STEP_STYLE, "step")
            start = _time.perf_counter()
            result = state.apply(frame, step)
            elapsed_us = int((_time.perf_counter() - start) * 1e6)
            if isinstance(result, Terminal):
                trace.append({"step": tag, "us": elapsed_us, "rows": result.size})
                return VarValue(result.payload, result.size, None)
            frame = result
            trace.append({"step": tag, "us": elapsed_us, "rows": len(frame)})
        return VarValue(
            _UNSET, len(frame), frame,
            thunk=lambda f=frame: self.encode_frame(f),
        )

    # ------------------------------------------------------------------
    # Device traversal planner
    # ------------------------------------------------------------------

    # Node count below which the host CSR gather path is always used
    # (device dispatch overhead dominates tiny graphs).
    device_traversal_min_nodes = 10_000

    def _try_device_traversal(
        self, steps: list, ctx: EvalContext, scope: dict[str, VarValue]
    ):
        """Compile set-reduced node traversals onto the padded-adjacency
        BFS kernels (ops/csr.py).

        Grammar: ``(N|NWhere) -> body* -> Dedup -> (Count|Exists)`` where
        body steps are hops (``Out``/``In``/``Both``), vectorizable
        elementwise filters (``Where``/``Has``/``HasLabel``), or interior
        ``Dedup`` s.  The trailing Dedup is required: the mask kernels
        compute set semantics, which only matches the bag interpreter
        after deduplication — and under that final set reduction,
        per-element filters commute with dedup (they are pure functions
        of the node) and interior Dedups are no-ops, so the whole body
        evaluates as alternating frontier expansion and masking.
        Returns a VarValue, or None to fall back to the host pipeline.
        """
        if len(steps) < 4:
            return None
        snap = self.snapshots.get()
        if snap.n_nodes < self.device_traversal_min_nodes:
            return None
        tags = [wire.tag_of(s, wire.STEP_STYLE, "step") for s in steps]
        if tags[0] not in ("NWhere", "N", "VectorSearchNodes", "TextSearchNodes"):
            return None
        # Tail grammar.  Set-reduced: ``Dedup -> Count|Exists`` (order
        # free).  Membership-returning: ``Dedup -> OrderBy[Multiple] ->
        # (Limit|Skip|Range)* -> Id|Label|Values|ValueMap`` — the sort
        # re-establishes a total order the mask kernels lost, PROVIDED
        # the sort keys are collision-free (the interpreter's stable
        # sort preserves dedup order among ties, which the set kernels
        # cannot reproduce; ties fall back to the host pipeline).
        tail_start: int | None = None
        if tags[-1] in ("Count", "Exists"):
            if tags[-2] != "Dedup":
                return None
            body_end = len(steps) - 2
        elif tags[-1] in ("Id", "Label", "Values", "ValueMap"):
            i = len(steps) - 2
            while i > 0 and tags[i] in ("Limit", "Skip", "Range"):
                i -= 1
            if i <= 0 or tags[i] not in ("OrderBy", "OrderByMultiple"):
                return None
            if tags[i - 1] != "Dedup":
                return None
            tail_start = i
            body_end = i - 1
        else:
            return None
        body: list[tuple] = []  # ("hop", directions, label) | ("filter", pred)
        for tag, step in zip(tags[1:body_end], steps[1:body_end]):
            payload = wire.payload_of(step)
            if tag in ("Out", "In"):
                body.append(("hop", (tag.lower(),), payload))
            elif tag == "Both":
                body.append(("hop", ("out", "in"), payload))
            elif tag == "Where":
                body.append(("filter", payload))
            elif tag == "Has":
                prop, value = payload
                body.append(("filter", {"Eq": [prop, value]}))
            elif tag == "HasLabel":
                body.append(("filter", {"Eq": ["$label", {"String": payload}]}))
            elif tag == "Dedup":
                continue
            else:
                return None
        if not any(op[0] == "hop" for op in body):
            return None

        from .expr import _try_vector_mask

        def finish(count: int):
            if tags[-1] == "Exists":
                return VarValue(count > 0, 1 if count else 0, None)
            return VarValue(count, count, None)

        def complete(mask_bool: np.ndarray):
            """Reduce (Count/Exists) or materialize the node set and run
            the ordered tail through the normal pipeline."""
            if tail_start is None:
                return finish(int(mask_bool.sum()))
            ids = snap.node_ids[mask_bool]
            frame = Frame("nodes", np.asarray(ids, UINT64))
            state = _QueryState(self, ctx, scope, None)
            # Collision check on the ordering keys: the interpreter's
            # stable sort keeps dedup-stream order among equal keys,
            # which the set kernels cannot reconstruct.
            order_payload = wire.payload_of(steps[tail_start])
            orderings = (
                [(order_payload[0], order_payload[1])]
                if tags[tail_start] == "OrderBy"
                else [(p, o) for p, o in order_payload]
            )
            if len(frame) > 1:
                codes = state._order_codes(frame, orderings)
                if codes is not None:
                    # vectorized tie test: equal (fam, code) rows are
                    # exactly the per-row comparator's ties (1 vs 1.0,
                    # 0.0 vs -0.0 share a code; NaN/2^53 already bailed)
                    comp = np.stack(
                        [a for cf in codes for a in cf], axis=1
                    )
                    if len(np.unique(comp, axis=0)) < len(comp):
                        return None  # host pipeline decides order
                else:
                    # per-row fallback; normalize missing keys so the
                    # comparison sort can't hit None-vs-tuple TypeError
                    composite = [
                        tuple(
                            (k is None, () if k is None else k)
                            for k in row
                        )
                        for row in zip(*(
                            state._sort_keys(frame, prop)
                            for prop, _ in orderings
                        ))
                    ]
                    srt = sorted(composite)
                    if any(
                        not (a < b) and not (b < a)
                        for a, b in zip(srt, srt[1:])
                    ):
                        return None  # tied keys: host pipeline decides
            result: Any = frame
            for step in steps[tail_start:]:
                result = state.apply(result, step)
                if isinstance(result, Terminal):
                    return VarValue(result.payload, result.size, None)
            return VarValue(
                _UNSET, len(result), result,
                thunk=lambda f=result: self.encode_frame(f),
            )

        # Backend choice: measured cost (TraversalRouter).  Round 3
        # routed device-first on backend identity alone; the bench then
        # caught a config where the device path was slower than the
        # native sweep (per-query H2D on a remote-attached chip).  Both
        # paths compute identical set-semantics masks, so the router
        # times the one it runs and converges on the cheaper.
        try:
            from ..native import bfs_khop
        except Exception:
            bfs_khop = None

        # Resolve every body op up front; any non-vectorizable filter or
        # missing adjacency falls back to the host pipeline before any
        # kernel work is issued.
        all_nodes = None
        slots_all = None
        empty_hop = False  # unknown edge label: frontier goes empty
        plan: list[tuple] = []  # ("hop", [(dir, code)...]) | ("mask", arr)
        for op in body:
            if op[0] == "hop":
                _, directions, label = op
                expansions = []
                for direction in directions:
                    if bfs_khop is None and snap.padded_graph(direction) is None:
                        return None
                    if label is None:
                        code = -1
                    else:
                        code = snap.edge_label_code.get(label)
                        if code is None:
                            # keep going: the SOURCE must still resolve
                            # (it can raise, e.g. unknown variable) and
                            # membership tails need an empty FRAME, not
                            # a count-shaped 0
                            empty_hop = True
                    expansions.append((direction, code))
                plan.append(("hop", expansions))
            else:
                if all_nodes is None:
                    all_nodes = Frame("nodes", snap.node_ids)
                    slots_all = np.arange(snap.n_nodes, dtype=np.int64)
                keep = _try_vector_mask(
                    snap, "node", all_nodes, slots_all, op[1], ctx
                )
                if keep is None:
                    return None
                plan.append(("mask", keep))

        # Source frame through the normal pipeline (index-backed).
        state = _QueryState(self, ctx, scope, None)
        source_frame = state.apply(Frame.empty(), steps[0])
        if not isinstance(source_frame, Frame) or source_frame.kind != "nodes":
            return None
        slots = snap.node_slots_or_neg(source_frame.ids)
        slots = slots[slots >= 0]
        start = np.zeros(snap.n_nodes, bool)
        start[slots] = True

        if empty_hop:
            # an unknown edge label empties the frontier after the
            # (now validated) source; complete() shapes the empty result
            # per the tail (0 / false / [])
            return complete(np.zeros(snap.n_nodes, bool))

        # Multi-chip route: when the engine opts in (graph_shard_threshold)
        # and a device mesh is present, the whole plan executes as one
        # edge-partitioned sharded traversal with a psum frontier
        # exchange per hop (parallel/graph.py) — the scale-out path for
        # graphs beyond a single chip/host.
        gst = getattr(self.engine, "graph_shard_threshold", None)
        if gst is not None and snap.n_nodes >= gst:
            mask = self._run_sharded_traversal(snap, plan, start)
            if mask is not None:
                return complete(mask)

        device_ok = all(
            snap.padded_graph(direction) is not None
            for op in plan if op[0] == "hop"
            for direction, _ in op[1]
        )
        if not device_ok and bfs_khop is None:
            return None  # no vectorized backend: host pipeline
        router = getattr(self.engine, "_traversal_router", None)
        if router is None:
            router = TraversalRouter()
            self.engine._traversal_router = router
        choice = router.choose(
            device_available=device_ok,
            native_available=bfs_khop is not None,
        )
        import time as _time

        t0 = _time.perf_counter()
        if choice == "device":
            mask = self._run_device_plan(snap, plan, start)
        else:
            mask_u8 = start.astype(np.uint8)
            for op in plan:
                if op[0] == "hop":
                    frontier = np.zeros(snap.n_nodes, np.uint8)
                    for direction, code in op[1]:
                        indptr, targets, codes = snap.csr_arrays(direction)
                        image, _ = bfs_khop(
                            indptr, targets, codes, mask_u8, code, 1
                        )
                        frontier |= image
                    mask_u8 = frontier
                else:
                    mask_u8 = mask_u8 & np.asarray(op[1], np.uint8)
            mask = mask_u8.astype(bool)
        router.record(choice, _time.perf_counter() - t0)
        return complete(mask)

    def _run_device_plan(
        self, snap, plan: list, start: np.ndarray
    ) -> np.ndarray:
        """Single-device adaptive-kernel plan execution (ops/csr.py) on
        the snapshot's device."""
        import torch

        from ..ops.csr import khop_mask

        mask = torch.from_numpy(start).to(snap.device)
        for op in plan:
            if op[0] == "hop":
                frontier = None
                for direction, code in op[1]:
                    graph = snap.padded_graph(direction)
                    image = khop_mask(
                        graph.neighbors, graph.edge_labels, mask, code, 1,
                    )
                    frontier = image if frontier is None else frontier | image
                mask = frontier
            else:
                keep = np.asarray(op[1], bool)
                mask = mask & torch.from_numpy(keep).to(snap.device)
        return mask.cpu().numpy()

    def _run_sharded_traversal(self, snap, plan: list, start: np.ndarray):
        """Translate the resolved plan onto the multi-device executor;
        None (fall through to the single-host backends) when the mesh
        over the snapshot's device type has one device or the adjacency
        exceeds the padding degree cap."""
        from ..parallel import device_count

        if device_count(snap.device) < 2:
            return None
        directions: set[str] = set()
        for op in plan:
            if op[0] == "hop":
                directions.update(d for d, _ in op[1])
        sgraph = snap.sharded_graph(tuple(sorted(directions)))
        if sgraph is None:
            return None
        plan_ops: list = []
        codes: list[int] = []
        masks: list[np.ndarray] = []
        for op in plan:
            if op[0] == "hop":
                # all expansions of one hop share the label payload
                # (Both = out+in with the same label filter)
                plan_ops.append(("hop", tuple(d for d, _ in op[1])))
                codes.append(op[1][0][1])
            else:
                plan_ops.append(("mask", len(masks)))
                masks.append(np.asarray(op[1], bool))
        return sgraph.run(plan_ops, start, codes, masks)

    # ------------------------------------------------------------------
    # Encoding
    # ------------------------------------------------------------------

    def encode_frame(self, frame: Frame) -> Any:
        """Default stream payload: per element, virtual ids + all props."""
        if frame.kind == "rows":
            return list(frame.rows or [])
        out = []
        for i in range(len(frame)):
            out.append(self.encode_element(frame, i, None))
        return out

    def encode_element(
        self, frame: Frame, i: int, props: list[str] | None
    ) -> dict:
        element_id = int(frame.ids[i])
        if frame.kind == "nodes":
            record = self.store.node(element_id)
            row: dict[str, Any] = {"$id": element_id, "$label": record.label}
        else:
            record = self.store.edge(element_id)
            row = {
                "$id": element_id,
                "$label": record.label,
                "$from": record.src,
                "$to": record.dst,
            }
        if frame.dist is not None and not np.isnan(frame.dist[i]):
            row["$distance"] = float(frame.dist[i])
        if frame.score is not None and not np.isnan(frame.score[i]):
            row["$score"] = float(frame.score[i])
        if props is None:
            for key, value in record.props.items():
                row[key] = V.to_plain(value)
        return row

    def element_at(self, frame: Frame, i: int) -> Element:
        return Element(
            frame.kind,
            int(frame.ids[i]),
            self.store,
            None if frame.dist is None else float(frame.dist[i]),
            None if frame.score is None else float(frame.score[i]),
        )


class _QueryState:
    """Step dispatch with traversal-local aliases (``As``/``Select``)."""

    def __init__(
        self,
        executor: Executor,
        ctx: EvalContext,
        scope: dict[str, VarValue],
        undo: UndoLog | None,
    ):
        self.ex = executor
        self.store = executor.store
        self.ctx = ctx
        self.scope = scope
        self.undo = undo
        self.aliases: dict[str, Frame] = {}

    @property
    def snap(self) -> GraphSnapshot:
        return self.ex.snapshots.get()

    # -- dispatch ------------------------------------------------------

    # tag -> unbound handler, built lazily; requests were validated
    # against the step catalog by validate_request before execution.
    _dispatch: dict[str, Any] = {}

    def apply(self, frame: Frame, step: Any) -> Frame | Terminal:
        if type(step) is dict and len(step) == 1:
            tag, payload = next(iter(step.items()))
        elif isinstance(step, str):
            tag, payload = step, None
        else:
            tag = wire.tag_of(step, wire.STEP_STYLE, "step")
            payload = wire.payload_of(step)
        handler = self._dispatch.get(tag)
        if handler is None:
            if tag in wire.RESERVED_NOOP_STEPS:
                return frame  # parsed, round-tripped, ignored (dsl.rs:3214-3254)
            handler = getattr(type(self), f"_step_{tag}", None)
            if handler is None:
                if tag not in wire.STEP_STYLE:
                    raise QueryError(f"unknown step variant: {tag!r}")
                raise QueryError(f"step {tag} is not implemented")
            self._dispatch[tag] = handler
        return handler(self, frame, payload)

    def run_sub(self, frame: Frame, sub: dict) -> Frame:
        """Run a sub-traversal's steps over a frame (read-only steps)."""
        out = frame
        for step in sub["steps"]:
            result = self.apply(out, step)
            if isinstance(result, Terminal):
                raise QueryError("terminal steps are not allowed in sub-traversals")
            out = result
        return out

    # -- helpers -------------------------------------------------------

    def _resolve_bound(self, bound: Any) -> int:
        """Bound -> int.  Accepts a literal int, a StreamBound dict
        (``{"Literal": n}`` / ``{"Expr": node}``), or a bare Expr node
        (``LimitBy``/``SkipBy`` carry the expr directly)."""
        if isinstance(bound, int):
            return bound
        node = bound
        if isinstance(bound, dict) and len(bound) == 1:
            tag = next(iter(bound))
            if tag == "Literal":
                return bound[tag]
            if tag == "Expr":
                node = bound[tag]
        value = eval_expr(node, None, self.ctx)
        num = V.as_number(value) if value is not MISSING else None
        if num is None:
            raise QueryError("stream bound must resolve to an integer")
        return int(num)

    def _resolve_input(self, node: Any) -> Tagged:
        """PropertyInput -> tagged value using static context."""
        tag = next(iter(node))
        if tag == "Value":
            return node[tag]
        value = eval_expr(node[tag], None, self.ctx)
        if value is MISSING:
            raise QueryError("expression input did not resolve to a value")
        return value

    def _input_per_element(self, frame: Frame, node: Any) -> list[Tagged]:
        tag = next(iter(node))
        if tag == "Value":
            return [node[tag]] * len(frame)
        out = []
        for i in range(len(frame)):
            value = eval_expr(node[tag], self.ex.element_at(frame, i), self.ctx)
            out.append("Null" if value is MISSING else value)
        return out

    def _var_frame(self, name: str) -> Frame:
        if name in self.aliases:
            return self.aliases[name].copy()
        var = self.scope.get(name)
        if var is None:
            raise QueryError(f"unknown variable: {name}")
        if var.frame is not None:
            return var.frame.copy()
        # Terminal payload: row lists with $id fields can re-seed streams
        # (reference pattern: value_map rows -> NodeRef::var, dsl.rs:247-268).
        payload = var.payload
        if isinstance(payload, list):
            ids = []
            for row in payload:
                if isinstance(row, dict) and "$id" in row:
                    ids.append(int(row["$id"]))
            return Frame.nodes(np.array(ids, UINT64))
        raise QueryError(f"variable '{name}' does not hold a re-seedable stream")

    def _node_ids_from_ref(self, ref: Any, strict: bool = False) -> np.ndarray:
        """Resolve a NodeRef to ids.  Sources silently drop unknown ids
        (a stale id simply matches nothing); strict resolution (AddE
        targets) errors on unknown ids."""
        tag = "All" if ref == "All" else next(iter(ref))
        if tag == "All":
            return np.array(self.store.node_order, UINT64)
        body = ref[tag]
        if tag == "Ids":
            if strict:
                for i in body:
                    if not self.store.has_node(int(i)):
                        raise QueryError(f"unknown node id {int(i)}")
            return np.array(
                [i for i in body if self.store.has_node(int(i))], UINT64
            )
        if tag == "Var":
            frame = self._var_frame(body)
            if frame.kind == "edges":
                raise QueryError(f"variable '{body}' holds edges, not nodes")
            return frame.ids
        if tag == "Param":
            value = self.ctx.param(body)
            return self._ids_from_tagged(value, node=True, strict=strict)
        raise QueryError(f"unknown node ref: {tag}")

    def _ids_from_tagged(
        self, value: Tagged, node: bool, strict: bool = False
    ) -> np.ndarray:
        has = self.store.has_node if node else self.store.has_edge
        tag = V.tag_of(value)
        if tag in ("I64", "F64", "F32"):
            candidate = [int(V.payload_of(value))]
        elif tag in ("I64Array", "F64Array", "F32Array"):
            candidate = [int(v) for v in V.payload_of(value)]
        elif tag == "Array":
            candidate = []
            for item in V.payload_of(value):
                num = V.as_number(item)
                if num is None:
                    raise QueryError("id parameter array must contain numbers")
                candidate.append(int(num))
        else:
            raise QueryError("id parameter must be an integer or integer array")
        if strict:
            # AddE targets (the documented strict contract): a stale id
            # must error + roll back, not silently write nothing
            for i in candidate:
                if not has(i):
                    kind = "node" if node else "edge"
                    raise QueryError(f"unknown {kind} id {i}")
        return np.array([i for i in candidate if has(i)], UINT64)

    # ==================================================================
    # Sources
    # ==================================================================

    def _step_N(self, frame: Frame, ref: Any) -> Frame:
        return Frame.nodes(self._node_ids_from_ref(ref))

    def _step_E(self, frame: Frame, ref: Any) -> Frame:
        tag = next(iter(ref))
        body = ref[tag]
        if tag == "Ids":
            ids = np.array([i for i in body if self.store.has_edge(int(i))], UINT64)
        elif tag == "Var":
            sub = self._var_frame(body)
            if sub.kind != "edges":
                raise QueryError(f"variable '{body}' holds nodes, not edges")
            ids = sub.ids
        elif tag == "Param":
            ids = self._ids_from_tagged(self.ctx.param(body), node=False)
        else:
            raise QueryError(f"unknown edge ref: {tag}")
        return Frame.edges(ids)

    def _source_where(self, kind: str, predicate: Any) -> Frame:
        """NWhere/EWhere with index-backed planning."""
        snap = self.snap
        candidates = self._plan_source(kind, predicate)
        if candidates is None:
            ids = np.array(
                self.store.node_order if kind == "nodes" else self.store.edge_order,
                UINT64,
            )
        else:
            ids = candidates
        frame = Frame(kind, ids)
        if len(frame) == 0:
            return frame
        slots = (
            snap.node_slots(frame.ids) if kind == "nodes" else snap.edge_slots(frame.ids)
        )
        keep = predicate_mask(snap, self.store, frame, slots, predicate, self.ctx)
        return frame.mask(keep)

    def _plan_source(self, kind: str, predicate: Any) -> np.ndarray | None:
        """Pick an index-backed candidate set from a source predicate.

        Handles the common shapes: ``Eq($label, L)`` alone or inside a
        top-level ``And``, plus property Eq/range over declared indexes.
        Returns None when no index applies (full scan).
        """
        store_kind = "node" if kind == "nodes" else "edge"
        conjuncts = [predicate]
        tag = next(iter(predicate)) if isinstance(predicate, dict) else predicate
        if tag == "And":
            conjuncts = predicate["And"]
        # Fold element-independent *Expr conjuncts into literal form so
        # the index planner sees them: the stored-route point-lookup
        # pattern (reference `#[register] fn get_user(email)`) arrives
        # as EqExpr(prop, Param), and without the fold it full-scans
        # (measured 57 ms/lookup at 100k rows vs ~30 us indexed).
        conjuncts = [self._fold_static_expr(part) for part in conjuncts]
        # Pick the SMALLEST candidate set by length before materializing
        # any of them: the `$label` conjunct's table holds every row of
        # the label, and building that array per query costs ~4 ms at
        # 100k rows — 1000x the point-lookup it was losing to anyway.
        best_len: int | None = None
        best_rows: Any = None
        def consider(rows) -> None:
            nonlocal best_len, best_rows
            if best_len is None or len(rows) < best_len:
                best_len, best_rows = len(rows), rows
        for part in conjuncts:
            ptag = next(iter(part)) if isinstance(part, dict) else part
            if ptag not in ("Eq", "Gt", "Gte", "Lt", "Lte", "Between"):
                continue
            body = part[ptag]
            prop = body[0]
            if prop == "$label" and ptag == "Eq":
                label = V.text_of(body[1])
                if label is None:
                    continue
                # snapshot-cached uint64 array, extended per append
                # epoch — np.array(list-of-100k-ints) per query was a
                # 4 ms tax on every labeled scan
                consider(self.snap.label_ids(store_kind, label))
                continue
            if prop.startswith("$"):
                continue
            label = self._conjunct_label(conjuncts)
            if label is None:
                continue
            for idx in self.store.scalar_indexes_for(store_kind, label, prop):
                if ptag == "Eq" and idx.spec_tag.endswith("Equality"):
                    consider(idx.impl.lookup(body[1]))
                elif idx.spec_tag.endswith("Range"):
                    if ptag == "Eq":
                        consider(idx.impl.scan(body[1], body[1]))
                    elif ptag == "Between":
                        consider(idx.impl.scan(body[1], body[2]))
                    elif ptag in ("Gt", "Gte"):
                        consider(
                            idx.impl.scan(lo=body[1], lo_strict=(ptag == "Gt"))
                        )
                    else:
                        consider(
                            idx.impl.scan(hi=body[1], hi_strict=(ptag == "Lt"))
                        )
        if best_rows is None:
            return None
        if isinstance(best_rows, np.ndarray):
            # cached snapshot array: callers treat frames as immutable
            return best_rows
        return np.array(best_rows, UINT64)

    _STATIC_EXPR_FOLD = {
        "EqExpr": "Eq", "GtExpr": "Gt", "GteExpr": "Gte",
        "LtExpr": "Lt", "LteExpr": "Lte", "BetweenExpr": "Between",
    }

    def _fold_static_expr(self, part: Any) -> Any:
        """Rewrite an ``*Expr`` predicate whose expressions don't read
        the element (Param/Constant/Timestamp/arithmetic) into its
        literal twin, evaluated once against the query parameters.
        The full predicate still re-verifies each candidate row after
        planning, so the rewrite only ever narrows the scan."""
        if not isinstance(part, dict):
            return part
        tag = next(iter(part))
        lit = self._STATIC_EXPR_FOLD.get(tag)
        if lit is None:
            return part
        body = part[tag]
        exprs = body[1:]
        if not all(expr_is_static(e) for e in exprs):
            return part
        vals = [eval_expr(e, None, self.ctx) for e in exprs]
        if any(v is MISSING for v in vals):
            return part
        return {lit: [body[0], *vals]}

    @staticmethod
    def _conjunct_label(conjuncts: list) -> str | None:
        for part in conjuncts:
            if isinstance(part, dict) and "Eq" in part:
                prop, value = part["Eq"]
                if prop == "$label":
                    return V.text_of(value)
        return None

    def _step_NWhere(self, frame: Frame, predicate: Any) -> Frame:
        return self._source_where("nodes", predicate)

    def _step_EWhere(self, frame: Frame, predicate: Any) -> Frame:
        return self._source_where("edges", predicate)

    def _step_Inject(self, frame: Frame, name: str) -> Frame:
        return self._var_frame(name)

    def _vector_search(self, body: dict, kind: str) -> Frame:
        query = self._resolve_input(body["query_vector"])
        vec = V.f32_vector(query)
        if vec is None:
            raise QueryError("query_vector must be a numeric array")
        k = self._resolve_bound(body["k"])
        tenant = (
            self._resolve_input(body["tenant_value"])
            if "tenant_value" in body and body["tenant_value"] is not None
            else None
        )
        ids, dists = self.ex.engine.vectors.search(
            kind, body["label"], body["property"], vec, k, tenant
        )
        frame = Frame(kind, np.asarray(ids, UINT64), dist=np.asarray(dists, np.float64))
        return frame

    def _step_VectorSearchNodes(self, frame: Frame, body: dict) -> Frame:
        return self._vector_search(body, "nodes")

    def _step_VectorSearchEdges(self, frame: Frame, body: dict) -> Frame:
        return self._vector_search(body, "edges")

    def _text_search(self, body: dict, kind: str) -> Frame:
        query = self._resolve_input(body["query_text"])
        text = V.text_of(query)
        if text is None:
            raise QueryError("query_text must be a string")
        k = self._resolve_bound(body["k"])
        tenant = (
            self._resolve_input(body["tenant_value"])
            if "tenant_value" in body and body["tenant_value"] is not None
            else None
        )
        ids, scores = self.ex.engine.texts.search(
            kind, body["label"], body["property"], text, k, tenant
        )
        return Frame(
            kind, np.asarray(ids, UINT64), score=np.asarray(scores, np.float64)
        )

    def _step_TextSearchNodes(self, frame: Frame, body: dict) -> Frame:
        return self._text_search(body, "nodes")

    def _step_TextSearchEdges(self, frame: Frame, body: dict) -> Frame:
        return self._text_search(body, "edges")

    # ==================================================================
    # Navigation
    # ==================================================================

    def _expand_edges(
        self, frame: Frame, label: str | None, direction: str
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (src_rows, edge_slot_indices, anchor_node_ids)."""
        if frame.kind != "nodes":
            raise QueryError("edge expansion requires a node stream")
        snap = self.snap
        slots = snap.node_slots_or_neg(frame.ids)
        valid = slots >= 0
        rows = np.nonzero(valid)[0]
        vslots = slots[rows]
        indptr = snap.out_indptr if direction == "out" else snap.in_indptr
        data = snap.out_edges if direction == "out" else snap.in_edges
        src_local, positions = gather_ranges(indptr, vslots)
        edge_idx = data[positions]
        src_rows = rows[src_local]
        if label is not None:
            code = snap.edge_label_code.get(label, -1)
            keep = snap.edge_label_codes[edge_idx] == code
            src_rows = src_rows[keep]
            edge_idx = edge_idx[keep]
        anchor = frame.ids[src_rows]
        return src_rows, edge_idx, anchor

    def _sharded_hop(self, frame: Frame, label: Any, direction: str):
        """Mesh-scale ORDERED hop (round 4): when the engine opted into
        graph sharding and a mesh is present, node hops run through the
        edge-partitioned executor's frame expansion
        (``parallel/graph.py:expand_frame``) — order, multiplicity, and
        row bindings all carry exactly as the host gather path, so the
        full step catalog (filters, terminals, value_map) works at mesh
        scale, not just membership counts.  Returns
        ``(src_rows, dst_ids)`` or None to take the host path."""
        engine = getattr(self.ex, "engine", None)
        gst = getattr(engine, "graph_shard_threshold", None)
        snap = self.snap
        if gst is None or snap.n_nodes < gst or len(frame) == 0:
            return None
        if frame.kind != "nodes":
            return None
        if label is not None and label not in snap.edge_label_code:
            return None  # unknown label: host path yields the empty frame
        from ..parallel import device_count

        if device_count(snap.device) < 2:
            return None
        sgraph = snap.sharded_graph((direction,))
        if sgraph is None:
            return None
        code = -1 if label is None else snap.edge_label_code[label]
        slots = snap.node_slots_or_neg(frame.ids)
        rows = np.nonzero(slots >= 0)[0]
        parent_local, target_slots = sgraph.expand_frame(
            direction, code, slots[rows].astype(np.int32)
        )
        # expand_frame pads slots to n_pad; targets are real node slots
        return rows[parent_local], snap.node_ids[target_slots]

    def _step_Out(self, frame: Frame, label: Any) -> Frame:
        sharded = self._sharded_hop(frame, label, "out")
        if sharded is not None:
            return frame.expand(sharded[0], "nodes", sharded[1])
        src_rows, edge_idx, _ = self._expand_edges(frame, label, "out")
        dst = self.snap.node_ids[self.snap.edge_dst[edge_idx]]
        return frame.expand(src_rows, "nodes", dst)

    def _step_In(self, frame: Frame, label: Any) -> Frame:
        sharded = self._sharded_hop(frame, label, "in")
        if sharded is not None:
            return frame.expand(sharded[0], "nodes", sharded[1])
        src_rows, edge_idx, _ = self._expand_edges(frame, label, "in")
        src = self.snap.node_ids[self.snap.edge_src[edge_idx]]
        return frame.expand(src_rows, "nodes", src)

    def _step_Both(self, frame: Frame, label: Any) -> Frame:
        return concat_frames([self._step_Out(frame, label), self._step_In(frame, label)])

    def _sharded_edge_hop(self, frame: Frame, label: Any, direction: str):
        """Mesh-scale ORDERED edge hop (round 4): OutE/InE through the
        edge-partitioned executor's edge-plane expansion
        (``parallel/graph.py:expand_frame_edges``) — same gating as
        ``_sharded_hop``.  Returns ``(src_rows, edge_slots)`` or None
        to take the host path."""
        engine = getattr(self.ex, "engine", None)
        gst = getattr(engine, "graph_shard_threshold", None)
        snap = self.snap
        if gst is None or snap.n_nodes < gst or len(frame) == 0:
            return None
        if frame.kind != "nodes":
            return None
        if label is not None and label not in snap.edge_label_code:
            return None
        from ..parallel import device_count

        if device_count(snap.device) < 2:
            return None
        sgraph = snap.sharded_graph((direction,), with_edges=True)
        if sgraph is None:
            return None
        code = -1 if label is None else snap.edge_label_code[label]
        slots = snap.node_slots_or_neg(frame.ids)
        rows = np.nonzero(slots >= 0)[0]
        parent_local, edge_slots, _targets = sgraph.expand_frame_edges(
            direction, code, slots[rows].astype(np.int32)
        )
        return rows[parent_local], edge_slots

    def _step_OutE(self, frame: Frame, label: Any) -> Frame:
        sharded = self._sharded_edge_hop(frame, label, "out")
        if sharded is not None:
            src_rows, edge_idx = sharded
            return frame.expand(
                src_rows, "edges", self.snap.edge_ids[edge_idx],
                anchor=frame.ids[src_rows],
            )
        src_rows, edge_idx, anchor = self._expand_edges(frame, label, "out")
        return frame.expand(src_rows, "edges", self.snap.edge_ids[edge_idx], anchor=anchor)

    def _step_InE(self, frame: Frame, label: Any) -> Frame:
        sharded = self._sharded_edge_hop(frame, label, "in")
        if sharded is not None:
            src_rows, edge_idx = sharded
            return frame.expand(
                src_rows, "edges", self.snap.edge_ids[edge_idx],
                anchor=frame.ids[src_rows],
            )
        src_rows, edge_idx, anchor = self._expand_edges(frame, label, "in")
        return frame.expand(src_rows, "edges", self.snap.edge_ids[edge_idx], anchor=anchor)

    def _step_BothE(self, frame: Frame, label: Any) -> Frame:
        return concat_frames([self._step_OutE(frame, label), self._step_InE(frame, label)])

    def _edge_endpoints(self, frame: Frame) -> tuple[np.ndarray, np.ndarray]:
        if frame.kind != "edges":
            raise QueryError("endpoint step requires an edge stream")
        snap = self.snap
        slots = snap.edge_slots(frame.ids)
        src = snap.node_ids[snap.edge_src[slots]]
        dst = snap.node_ids[snap.edge_dst[slots]]
        return src, dst

    def _step_OutN(self, frame: Frame, _=None) -> Frame:
        src, _dst = self._edge_endpoints(frame)
        rows = np.arange(len(frame), dtype=np.int64)
        return frame.expand(rows, "nodes", src)

    def _step_InN(self, frame: Frame, _=None) -> Frame:
        _src, dst = self._edge_endpoints(frame)
        rows = np.arange(len(frame), dtype=np.int64)
        return frame.expand(rows, "nodes", dst)

    def _step_OtherN(self, frame: Frame, _=None) -> Frame:
        src, dst = self._edge_endpoints(frame)
        rows = np.arange(len(frame), dtype=np.int64)
        if frame.anchor is None:
            # Direct edge sources carry no traversal anchor; the far side
            # defaults to the destination endpoint.
            return frame.expand(rows, "nodes", dst)
        other = np.where(frame.anchor == src, dst, src)
        return frame.expand(rows, "nodes", other)

    # ==================================================================
    # Filters
    # ==================================================================

    def _mask_step(self, frame: Frame, predicate: Any) -> Frame:
        if len(frame) == 0:
            return frame
        if frame.kind == "rows":
            raise QueryError("filters require an element stream")
        snap = self.snap
        slots = (
            snap.node_slots_or_neg(frame.ids)
            if frame.kind == "nodes"
            else snap.edge_slots_or_neg(frame.ids)
        )
        keep_valid = slots >= 0
        sub = frame.mask(keep_valid)
        if len(sub) == 0:
            return sub
        sub_slots = slots[keep_valid]
        keep = predicate_mask(snap, self.store, sub, sub_slots, predicate, self.ctx)
        return sub.mask(keep)

    def _step_Where(self, frame: Frame, predicate: Any) -> Frame:
        return self._mask_step(frame, predicate)

    def _step_Has(self, frame: Frame, body: list) -> Frame:
        prop, value = body
        return self._mask_step(frame, {"Eq": [prop, value]})

    def _step_HasLabel(self, frame: Frame, label: str) -> Frame:
        return self._mask_step(frame, {"Eq": ["$label", {"String": label}]})

    def _step_HasKey(self, frame: Frame, prop: str) -> Frame:
        return self._mask_step(frame, {"HasKey": prop})

    def _step_EdgeHas(self, frame: Frame, body: list) -> Frame:
        prop, input_node = body
        value = self._resolve_input(input_node)
        return self._mask_step(frame, {"Eq": [prop, value]})

    def _step_EdgeHasLabel(self, frame: Frame, label: str) -> Frame:
        return self._step_HasLabel(frame, label)

    def _step_Dedup(self, frame: Frame, _=None) -> Frame:
        if frame.kind == "rows":
            seen = set()
            keep = []
            for i, row in enumerate(frame.rows or []):
                key = json.dumps(row, sort_keys=True, default=str)
                if key not in seen:
                    seen.add(key)
                    keep.append(i)
            return frame.take(np.array(keep, np.int64))
        _, first = np.unique(frame.ids, return_index=True)
        return frame.take(np.sort(first))

    def _membership_ids(self, name: str) -> np.ndarray:
        # read-only id probe: skip _var_frame's defensive full-frame
        # copy (dist/score/binding columns) — np.isin never mutates
        if name in self.aliases:
            return self.aliases[name].ids
        var = self.scope.get(name)
        if var is not None and var.frame is not None:
            return var.frame.ids
        return self._var_frame(name).ids

    def _step_Within(self, frame: Frame, name: str) -> Frame:
        members = self._membership_ids(name)
        return frame.mask(np.isin(frame.ids, members))

    def _step_Without(self, frame: Frame, name: str) -> Frame:
        members = self._membership_ids(name)
        return frame.mask(~np.isin(frame.ids, members))

    # ==================================================================
    # Stream shaping
    # ==================================================================

    def _step_Limit(self, frame: Frame, n: Any) -> Frame:
        count = self._resolve_bound(n)
        return frame.take(np.arange(min(max(count, 0), len(frame)), dtype=np.int64))

    _step_LimitBy = _step_Limit

    def _step_Skip(self, frame: Frame, n: Any) -> Frame:
        count = self._resolve_bound(n)
        return frame.take(np.arange(min(max(count, 0), len(frame)), len(frame), dtype=np.int64))

    _step_SkipBy = _step_Skip

    def _step_Range(self, frame: Frame, body: list) -> Frame:
        start = self._resolve_bound(body[0])
        end = self._resolve_bound(body[1])
        start = min(max(start, 0), len(frame))
        end = min(max(end, start), len(frame))
        return frame.take(np.arange(start, end, dtype=np.int64))

    _step_RangeBy = _step_Range

    def _frame_column(self, frame: Frame, prop: str):
        """(column, slots) for a node/edge frame whose ids all resolve
        in the snapshot; None -> caller uses the per-row path (rows
        frames, $-virtuals, ids not yet snapshotted mid-write)."""
        if frame.kind not in ("nodes", "edges") or prop.startswith("$"):
            return None
        snap = self.snap
        kind = "node" if frame.kind == "nodes" else "edge"
        slots = (
            snap.node_slots_or_neg(frame.ids)
            if kind == "node"
            else snap.edge_slots_or_neg(frame.ids)
        )
        if (slots < 0).any():
            return None
        return snap.column(kind, prop), slots

    def _order_codes(
        self, frame: Frame, orderings: list[tuple[str, str]]
    ) -> list[tuple[np.ndarray, np.ndarray]] | None:
        """Per-ordering ``(code, fam)`` sort-key arrays over the
        property columns, or None when the columns can't represent the
        ordering exactly (bool/bytes/array values, NaNs, ints past
        2^53, unresolvable ids).  ``fam`` ranks family (num < str <
        missing); equal ``(fam, code)`` pairs are exactly the rows the
        per-row comparator would call tied."""
        per_key = []
        for prop, direction in orderings:
            got = self._frame_column(frame, prop)
            if got is None:
                return None
            col, slots = got
            present = col.present[slots]
            nmask = col.numeric_mask[slots]
            smask = (
                col.string_mask[slots]
                if col.string_mask is not None
                else np.zeros(len(slots), bool)
            )
            if (present & ~(nmask | smask)).any():
                return None
            code = np.zeros(len(slots), np.float64)
            if nmask.any():
                vals = col.numeric[slots]
                if np.isnan(vals[nmask]).any():
                    return None
                im = nmask & col.int_mask[slots]
                # distinct i64s past 2^53 collapse to equal f64 keys
                if im.any() and np.abs(vals[im]).max() >= 2.0**53:
                    return None
                code[nmask] = vals[nmask]
            if smask.any():
                svals = np.asarray(col.strings[slots][smask], dtype=str)
                _, inv = np.unique(svals, return_inverse=True)
                code[smask] = inv
            if direction == "Desc":
                code = -code
            fam = np.full(len(slots), 2, np.int8)  # missing: always last
            fam[nmask] = 0
            fam[smask] = 1
            per_key.append((code, fam))
        return per_key

    def _order_fast(
        self, frame: Frame, orderings: list[tuple[str, str]]
    ) -> Frame | None:
        """Vectorized multi-key ordering over property columns.  Exactly
        mirrors the per-row path's semantics: stable, missing last in
        either direction, cross-family order by family name ("num" <
        "str"), within-family inversion on Desc.  Bails (None) on
        bool/bytes/array values, NaNs, or unresolvable ids."""
        per_key = self._order_codes(frame, orderings)
        if per_key is None:
            return None
        # np.lexsort: last key is primary; within one ordering the
        # family outranks the value code
        seq: list[np.ndarray] = []
        for code, fam in reversed(per_key):
            seq.append(code)
            seq.append(fam)
        order = np.lexsort(seq)
        return frame.take(order.astype(np.int64))

    def _sort_keys(self, frame: Frame, prop: str) -> list:
        keys = []
        for i in range(len(frame)):
            value = self.ex.element_at(frame, i).get(prop)
            comp = None if value is MISSING else V.as_comparable(value)
            keys.append(comp)
        return keys

    def _order(self, frame: Frame, orderings: list[tuple[str, str]]) -> Frame:
        if len(frame) <= 1 or frame.kind == "rows":
            return frame
        fast = self._order_fast(frame, orderings)
        if fast is not None:
            return fast
        idx = list(range(len(frame)))
        # Stable multi-key ordering: apply keys in reverse significance;
        # missing/incomparable values sort last regardless of direction.
        for prop, direction in reversed(orderings):
            keys = self._sort_keys(frame, prop)
            desc = direction == "Desc"

            def keyfn(i, keys=keys, desc=desc):
                k = keys[i]
                if k is None:
                    return ("~missing", 0)
                return _neg_key(k) if desc else k

            idx = sorted(idx, key=keyfn)
        return frame.take(np.array(idx, np.int64))

    def _step_OrderBy(self, frame: Frame, body: list) -> Frame:
        return self._order(frame, [(body[0], body[1])])

    def _step_OrderByMultiple(self, frame: Frame, body: list) -> Frame:
        return self._order(frame, [(p, o) for p, o in body])

    # ==================================================================
    # Variables / bindings
    # ==================================================================

    def _step_As(self, frame: Frame, name: str) -> Frame:
        self.aliases[name] = frame.copy()
        return frame

    def _step_Store(self, frame: Frame, name: str) -> Frame:
        self.scope[name] = VarValue(self.ex.encode_frame(frame), len(frame), frame.copy())
        return frame

    def _step_Select(self, frame: Frame, name: str) -> Frame:
        return self._var_frame(name)

    def _step_Bind(self, frame: Frame, name: str) -> Frame:
        return frame.with_binding(name)

    # ==================================================================
    # Terminals
    # ==================================================================

    def _step_Count(self, frame: Frame, _=None) -> Terminal:
        return Terminal(len(frame), len(frame))

    def _step_Exists(self, frame: Frame, _=None) -> Terminal:
        return Terminal(len(frame) > 0, 1 if len(frame) else 0)

    def _step_Id(self, frame: Frame, _=None) -> Terminal:
        return Terminal([int(i) for i in frame.ids], len(frame))

    def _step_Label(self, frame: Frame, _=None) -> Terminal:
        labels = []
        for i in range(len(frame)):
            record = (
                self.store.node(int(frame.ids[i]))
                if frame.kind == "nodes"
                else self.store.edge(int(frame.ids[i]))
            )
            labels.append(record.label)
        return Terminal(labels, len(frame))

    def _plain_columns(self, frame: Frame, props: list[str]):
        """Per-prop (plain-value object array, presence mask) pairs via
        the snapshot columns, or None when any prop holds something the
        columns can't render exactly (DateTime -> RFC3339, bools,
        bytes, arrays, objects) or an id is unsnapshotted."""
        per_prop = []
        for prop in props:
            got = self._frame_column(frame, prop)
            if got is None:
                return None
            col, slots = got
            present = col.present[slots]
            nmask = col.numeric_mask[slots]
            smask = (
                col.string_mask[slots]
                if col.string_mask is not None
                else np.zeros(len(slots), bool)
            )
            if (present & ~(nmask | smask)).any() or col.dt_mask[slots].any():
                return None
            plain = np.empty(len(slots), dtype=object)
            vals = col.numeric[slots]
            im = nmask & col.int_mask[slots]
            fm = nmask & ~col.int_mask[slots]
            # float64 cells round i64 magnitudes past 2^53: exact path
            if im.any() and np.abs(vals[im]).max() >= 2.0**53:
                return None
            if im.any():
                plain[np.nonzero(im)[0]] = vals[im].astype(np.int64).tolist()
            if fm.any():
                plain[np.nonzero(fm)[0]] = vals[fm].tolist()
            if smask.any():
                plain[smask] = col.strings[slots][smask]
            # explicit Nulls export as None (the per-row path's
            # to_plain("Null")), distinct from absent properties
            nulls = col.null_mask[slots]
            if nulls.any():
                plain[nulls] = None
                present = present | nulls
            per_prop.append((plain, present))
        return per_prop

    def _step_Values(self, frame: Frame, props: list[str]) -> Terminal:
        if not props:
            # no properties selected: empty export at any row count
            # (np.stack over zero columns would crash the dense path)
            return Terminal([], len(frame))
        if len(frame) > 64:
            per_prop = self._plain_columns(frame, props)
            if per_prop is not None:
                if len(per_prop) == 1:
                    plain, present = per_prop[0]
                    return Terminal(plain[present].tolist(), len(frame))
                mat = np.stack([p for p, _ in per_prop], axis=1)
                pres = np.stack([m for _, m in per_prop], axis=1)
                flat = pres.ravel()
                return Terminal(
                    mat.ravel()[flat].tolist(), len(frame)
                )
        out = []
        for i in range(len(frame)):
            element = self.ex.element_at(frame, i)
            for prop in props:
                value = element.get(prop)
                if value is not MISSING:
                    out.append(V.to_plain(value))
        return Terminal(out, len(frame))

    def _value_map_row(self, frame: Frame, i: int, props: list[str] | None) -> dict:
        if props is None:
            return self.ex.encode_element(frame, i, None)
        element = self.ex.element_at(frame, i)
        row = {}
        for prop in props:
            value = element.get(prop)
            if value is not MISSING:
                row[prop] = V.to_plain(value)
        return row

    def _step_ValueMap(self, frame: Frame, props: Any) -> Terminal:
        if props is not None and len(props) == 0:
            # empty selection: one empty row per element (the dense
            # zip(*[]) path silently produced ZERO rows)
            return Terminal([{} for _ in range(len(frame))], len(frame))
        if props is not None and len(frame) > 64:
            per_prop = self._plain_columns(frame, props)
            if per_prop is not None:
                if all(m.all() for _, m in per_prop):
                    # dense: one zip over the converted columns
                    cols = [p.tolist() for p, _ in per_prop]
                    rows: list = [
                        dict(zip(props, t)) for t in zip(*cols)
                    ]
                else:
                    plains = [p for p, _ in per_prop]
                    masks = [m for _, m in per_prop]
                    rows = [
                        {
                            prop: plains[j][i]
                            for j, prop in enumerate(props)
                            if masks[j][i]
                        }
                        for i in range(len(frame))
                    ]
                return Terminal(rows, len(frame))
        rows = [self._value_map_row(frame, i, props) for i in range(len(frame))]
        return Terminal(rows, len(frame))

    def _step_Project(self, frame: Frame, projections: list) -> Terminal:
        rows = []
        for i in range(len(frame)):
            element = self.ex.element_at(frame, i)
            row = {}
            for proj in projections:
                if "expr" in proj:
                    value = eval_expr(proj["expr"], element, self.ctx)
                    row[proj["alias"]] = None if value is MISSING else V.to_plain(value)
                else:
                    value = element.get(proj["source"])
                    if value is not MISSING:
                        row[proj["alias"]] = V.to_plain(value)
            # A projection row always appears, even when every source is
            # missing (the row is simply sparse).
            rows.append(row)
        return Terminal(rows, len(frame))

    def _step_ProjectBindings(self, frame: Frame, body: dict) -> Terminal:
        rows = []
        for i in range(len(frame)):
            row: dict[str, Any] = {}
            for proj in body["projections"]:
                alias = proj["alias"]
                if proj["kind"] == "Property":
                    value = self._binding_value(frame, i, proj["target"], proj["source"])
                    row[alias] = None if value is MISSING else V.to_plain(value)
                else:  # Coalesce
                    row[alias] = None
                    for ref in proj["refs"]:
                        value = self._binding_value(
                            frame, i, ref["target"], ref["source"]
                        )
                        if value is not MISSING and not V.is_null(value):
                            row[alias] = V.to_plain(value)
                            break
            rows.append(row)
        if body.get("distinct"):
            seen = set()
            unique_rows = []
            for row in rows:
                key = json.dumps(row, sort_keys=True, default=str)
                if key not in seen:
                    seen.add(key)
                    unique_rows.append(row)
            rows = unique_rows
        return Terminal(rows, len(rows))

    def _binding_value(self, frame: Frame, i: int, target: Any, source: str) -> Tagged:
        if target == "Current":
            return self.ex.element_at(frame, i).get(source)
        name = target["Binding"]
        binding = frame.bindings.get(name)
        if binding is None:
            raise QueryError(f"unknown row binding: {name}")
        element = Element(
            binding.kind,
            int(binding.ids[i]),
            self.store,
            None if binding.dist is None else float(binding.dist[i]),
            None if binding.score is None else float(binding.score[i]),
        )
        return element.get(source)

    def _step_EdgeProperties(self, frame: Frame, _=None) -> Terminal:
        if frame.kind != "edges":
            raise QueryError("edge_properties requires an edge stream")
        rows = [self.ex.encode_element(frame, i, None) for i in range(len(frame))]
        return Terminal(rows, len(frame))

    def _step_Group(self, frame: Frame, prop: str) -> Terminal:
        groups: dict[str, list] = {}
        for i in range(len(frame)):
            value = self.ex.element_at(frame, i).get(prop)
            key = _group_key(value)
            groups.setdefault(key, []).append(self.ex.encode_element(frame, i, None))
        return Terminal(groups, len(frame))

    def _step_GroupCount(self, frame: Frame, prop: str) -> Terminal:
        # Vectorized path for the common all-strings (category) column:
        # unique + counts in first-occurrence order, missing -> "null"
        # (a literal "null" string merges with missing exactly like the
        # per-row dict would).
        got = self._frame_column(frame, prop) if len(frame) else None
        if got is not None:
            col, slots = got
            present = col.present[slots]
            smask = (
                col.string_mask[slots]
                if col.string_mask is not None
                else np.zeros(len(slots), bool)
            )
            if not (present & ~smask).any():
                arr = np.empty(len(slots), dtype=object)
                arr[:] = "null"
                if col.strings is not None:
                    arr[smask] = col.strings[slots][smask]
                su = np.asarray(arr, dtype=str)
                uniq, first, cnt = np.unique(
                    su, return_index=True, return_counts=True
                )
                order = np.argsort(first, kind="stable")
                return Terminal(
                    {str(uniq[i]): int(cnt[i]) for i in order}, len(frame)
                )
        counts: dict[str, int] = {}
        for i in range(len(frame)):
            value = self.ex.element_at(frame, i).get(prop)
            key = _group_key(value)
            counts[key] = counts.get(key, 0) + 1
        return Terminal(counts, len(frame))

    def _step_AggregateBy(self, frame: Frame, body: list) -> Terminal:
        fn, prop = body
        if fn == "Count":
            return Terminal(len(frame), len(frame))
        got = self._frame_column(frame, prop) if len(frame) else None
        if got is not None and fn in ("Sum", "Min", "Max", "Mean"):
            col, slots = got
            nmask = col.numeric_mask[slots]
            vals = col.numeric[slots][nmask]
            if len(vals) == 0:
                return Terminal(None, len(frame))
            ints = col.int_mask[slots][nmask]
            # float64 cells are exact only below 2^53; above that the
            # column itself is rounded — delegate to the per-row path
            # (which reads the original tagged ints)
            maxabs = float(np.abs(vals).max())
            # int64 accumulation is exact only while the running total
            # cannot overflow; past that delegate to Python-int sums
            int_sum_ok = ints.all() and len(vals) * max(maxabs, 1.0) < 2.0**62
            if not (ints.any() and np.abs(vals[ints]).max() >= 2.0**53):
                if fn == "Mean":
                    if int_sum_ok:
                        # int64 accumulation is exact (the sum itself
                        # can cross 2^53 where float64 accumulation
                        # starts dropping ulps); division of the exact
                        # int matches Python's sum(ints)/len
                        total_i = int(vals.astype(np.int64).sum())
                        return Terminal(total_i / len(vals), len(frame))
                    if ints.all():
                        pass  # exact-overflow risk: per-row path below
                    else:
                        return Terminal(
                            float(vals.sum() / len(vals)), len(frame)
                        )
                elif fn == "Sum":
                    if int_sum_ok:
                        return Terminal(
                            int(vals.astype(np.int64).sum()), len(frame)
                        )
                    if not ints.all():
                        return Terminal(float(vals.sum()), len(frame))
                else:
                    i = int(vals.argmin() if fn == "Min" else vals.argmax())
                    v = vals[i]
                    return Terminal(
                        int(v) if ints[i] else float(v), len(frame)
                    )
        nums = []
        for i in range(len(frame)):
            value = self.ex.element_at(frame, i).get(prop)
            num = None if value is MISSING else V.as_number(value)
            if num is not None:
                nums.append(num)
        if not nums:
            return Terminal(None, len(frame))
        if fn == "Sum":
            out: Any = sum(nums)
        elif fn == "Min":
            out = min(nums)
        elif fn == "Max":
            out = max(nums)
        elif fn == "Mean":
            out = sum(nums) / len(nums)
        else:
            raise QueryError(f"unknown aggregate function: {fn}")
        return Terminal(out, len(frame))

    # ==================================================================
    # Index DDL
    # ==================================================================

    def _require_write(self) -> UndoLog:
        if self.undo is None:
            raise QueryError("mutations require a write batch")
        return self.undo

    def _step_CreateIndex(self, frame: Frame, body: dict) -> Terminal:
        undo = self._require_write()
        spec = body["spec"]
        tag = next(iter(spec))
        if tag in ("NodeText", "EdgeText") and not getattr(
            self.ex.engine, "bm25_enabled", True
        ):
            raise QueryError(
                "BM25 full-text search is disabled for this instance "
                "(db.bm25 = false in helix.toml)"
            )
        existed = self._index_exists(spec)
        self.store.create_index(spec, bool(body.get("if_not_exists", False)))
        if not existed:
            undo.record(lambda: self.store.drop_index(spec))
        return Terminal(True, 1)

    def _index_exists(self, spec: dict) -> bool:
        tag = next(iter(spec))
        fields = spec[tag]
        return (tag, fields["label"], fields["property"]) in self.store.indexes

    def _step_DropIndex(self, frame: Frame, body: dict) -> Terminal:
        undo = self._require_write()
        spec = body["spec"]
        tag = next(iter(spec))
        fields = spec[tag]
        existing = self.store.indexes.get((tag, fields["label"], fields["property"]))
        self.store.drop_index(spec)
        if existing is not None:
            undo.record(lambda: self.store.create_index(spec, True))
        return Terminal(True, 1)

    def _legacy_index(self, frame: Frame, body: dict, tag: str) -> Terminal:
        spec_fields: dict[str, Any] = {
            "label": body["label"],
            "property": body["property"],
        }
        if body.get("tenant_property") is not None:
            spec_fields["tenant_property"] = body["tenant_property"]
        return self._step_CreateIndex(
            frame, {"spec": {tag: spec_fields}, "if_not_exists": True}
        )

    def _step_CreateVectorIndexNodes(self, frame: Frame, body: dict) -> Terminal:
        return self._legacy_index(frame, body, "NodeVector")

    def _step_CreateVectorIndexEdges(self, frame: Frame, body: dict) -> Terminal:
        return self._legacy_index(frame, body, "EdgeVector")

    def _step_CreateTextIndexNodes(self, frame: Frame, body: dict) -> Terminal:
        return self._legacy_index(frame, body, "NodeText")

    def _step_CreateTextIndexEdges(self, frame: Frame, body: dict) -> Terminal:
        return self._legacy_index(frame, body, "EdgeText")

    # ==================================================================
    # Mutations
    # ==================================================================

    def _step_AddN(self, frame: Frame, body: dict) -> Frame:
        undo = self._require_write()
        props = {name: self._resolve_input(node) for name, node in body["properties"]}
        node_id = self.store.add_node(body["label"], props)
        undo.record(lambda: self.store.raw_remove_node(node_id))
        return Frame.nodes(np.array([node_id], UINT64))

    def _step_AddE(self, frame: Frame, body: dict) -> Frame:
        undo = self._require_write()
        if frame.kind != "nodes":
            raise QueryError("add_e requires a node stream as the edge source")
        targets = self._node_ids_from_ref(body["to"], strict=True)
        props = {name: self._resolve_input(node) for name, node in body["properties"]}
        for src in frame.ids:
            for dst in targets:
                edge_id = self.store.add_edge(body["label"], int(src), int(dst), dict(props))
                undo.record(lambda eid=edge_id: self.store.raw_remove_edge(eid))
        return frame

    def _step_SetProperty(self, frame: Frame, body: list) -> Frame:
        undo = self._require_write()
        name, input_node = body
        kind = "node" if frame.kind == "nodes" else "edge"
        values = self._input_per_element(frame, input_node)
        for i in range(len(frame)):
            element_id = int(frame.ids[i])
            record = (
                self.store.node(element_id) if kind == "node" else self.store.edge(element_id)
            )
            old = record.props.get(name)
            self.store.set_property(kind, element_id, name, values[i])
            undo.record(
                lambda k=kind, e=element_id, n=name, o=old: self.store.raw_restore_prop(
                    k, e, n, o
                )
            )
        return frame

    def _step_RemoveProperty(self, frame: Frame, name: str) -> Frame:
        undo = self._require_write()
        kind = "node" if frame.kind == "nodes" else "edge"
        for i in range(len(frame)):
            element_id = int(frame.ids[i])
            record = (
                self.store.node(element_id) if kind == "node" else self.store.edge(element_id)
            )
            old = record.props.get(name)
            self.store.remove_property(kind, element_id, name)
            undo.record(
                lambda k=kind, e=element_id, n=name, o=old: self.store.raw_restore_prop(
                    k, e, n, o
                )
            )
        return frame

    def _drop_edge_logged(self, undo: UndoLog, edge_id: int) -> None:
        edge = self.store.edges.get(edge_id)
        if edge is None:
            return
        self.store.drop_edge(edge_id)
        undo.record(lambda e=edge: self.store.raw_restore_edge(e))

    def _step_Drop(self, frame: Frame, _=None) -> Frame:
        undo = self._require_write()
        if frame.kind == "edges":
            for eid in frame.ids:
                self._drop_edge_logged(undo, int(eid))
        else:
            for raw_nid in frame.ids:
                nid = int(raw_nid)
                node = self.store.nodes.get(nid)
                if node is None:
                    continue
                # capture incident edges for undo, then let the store
                # drop them (its >64-edge batched path removes them in
                # ONE pass over edge_order — per-edge drop_edge here
                # was quadratic for high-degree nodes, held under the
                # exclusive write lock)
                incident = list(dict.fromkeys(
                    list(self.store.out_adj.get(nid, ()))
                    + list(self.store.in_adj.get(nid, ()))
                ))
                dropped = [
                    self.store.edges[e] for e in incident
                    if e in self.store.edges
                ]
                # record BEFORE dropping: a drop that fails partway must
                # still roll back the edges it already removed (the raw
                # restores are idempotent, so entries for edges the
                # failed drop never reached are no-ops)
                for edge in dropped:
                    undo.record(
                        lambda e=edge: self.store.raw_restore_edge(e)
                    )
                undo.record(lambda n=node: self.store.raw_restore_node(n))
                self.store.drop_node(nid)
        return Frame.empty(frame.kind)

    def _step_DropEdge(self, frame: Frame, to_ref: Any) -> Frame:
        return self._drop_edges_to(frame, to_ref, label=None)

    def _step_DropEdgeLabeled(self, frame: Frame, body: dict) -> Frame:
        return self._drop_edges_to(frame, body["to"], label=body["label"])

    def _drop_edges_to(self, frame: Frame, to_ref: Any, label: str | None) -> Frame:
        undo = self._require_write()
        targets = set(int(i) for i in self._node_ids_from_ref(to_ref))
        for nid in frame.ids:
            for eid in list(self.store.out_adj.get(int(nid), ())):
                edge = self.store.edges[eid]
                if edge.dst in targets and (label is None or edge.label == label):
                    self._drop_edge_logged(undo, eid)
        return frame

    def _step_DropEdgeById(self, frame: Frame, ref: Any) -> Frame:
        undo = self._require_write()
        tag = next(iter(ref))
        if tag == "Ids":
            ids = [int(i) for i in ref[tag]]
        elif tag == "Var":
            ids = [int(i) for i in self._var_frame(ref[tag]).ids]
        elif tag == "Param":
            ids = [int(i) for i in self._ids_from_tagged(self.ctx.param(ref[tag]), node=False)]
        else:
            raise QueryError(f"unknown edge ref: {tag}")
        for eid in ids:
            self._drop_edge_logged(undo, eid)
        return frame

    # ==================================================================
    # Control flow
    # ==================================================================

    def _step_Union(self, frame: Frame, subs: list) -> Frame:
        outputs = [self.run_sub(frame.copy(), sub) for sub in subs]
        outputs = [o for o in outputs if len(o) > 0]
        if not outputs:
            return Frame.empty(frame.kind)
        return concat_frames(outputs)

    def _step_Choose(self, frame: Frame, body: dict) -> Frame:
        matches = self._elementwise_mask(frame, body["condition"])
        then_frame = frame.mask(matches)
        else_frame = frame.mask(~matches)
        outputs = []
        if len(then_frame):
            outputs.append(self.run_sub(then_frame, body["then_traversal"]))
        if len(else_frame):
            else_sub = body.get("else_traversal")
            outputs.append(
                self.run_sub(else_frame, else_sub) if else_sub is not None else else_frame
            )
        outputs = [o for o in outputs if len(o) > 0]
        return concat_frames(outputs) if outputs else Frame.empty(frame.kind)

    def _step_Coalesce(self, frame: Frame, subs: list) -> Frame:
        pending = np.arange(len(frame), dtype=np.int64)
        outputs = []
        for sub in subs:
            if len(pending) == 0:
                break
            attempt = frame.take(pending).reset_src()
            out = self.run_sub(attempt, sub)
            if len(out) == 0:
                continue
            covered_local = np.unique(out.src)
            # Remap provenance out of the attempt-local basis before the
            # merge: pending-row -> frame-row -> the frame's OWN src, so
            # an enclosing per-traverser construct (Optional/Coalesce)
            # sees coverage in its basis, not indices into our subset.
            out.src = frame.src[pending[out.src]]
            outputs.append(out)
            covered_abs = set(int(i) for i in pending[covered_local])
            pending = np.array(
                [i for i in pending if int(i) not in covered_abs], np.int64
            )
        outputs = [o for o in outputs if len(o) > 0]
        return concat_frames(outputs) if outputs else Frame.empty(frame.kind)

    def _step_Optional(self, frame: Frame, sub: dict) -> Frame:
        out = self.run_sub(frame.reset_src(), sub)
        covered = set(int(i) for i in np.unique(out.src)) if len(out) else set()
        missing_rows = np.array(
            [i for i in range(len(frame)) if i not in covered], np.int64
        )
        keep = frame.take(missing_rows)
        if len(out):
            # out.src is frame-row-local (reset above); keep.src is in
            # the frame's own basis (via take) — compose so the merged
            # stream has ONE provenance basis for enclosing constructs
            out.src = frame.src[out.src]
        parts = [p for p in (out, keep) if len(p) > 0]
        if not parts:
            return Frame.empty(frame.kind)
        return concat_frames(parts)

    def _step_Repeat(self, frame: Frame, config: dict) -> Frame:
        times = config.get("times")
        until = config.get("until")
        emit = config.get("emit", "None")
        emit_pred = config.get("emit_predicate")
        max_depth = config.get("max_depth", 100)
        bound = min(times, max_depth) if times is not None else max_depth
        traversal = config["traversal"]

        # Emit semantics: every frontier state is emitted at most once.
        # Before = frontier before each body application (includes initial);
        # After  = frontier after each application (includes final);
        # All    = initial + after each application (every distinct state).
        frontier = frame
        emitted: list[Frame] = []
        finished: list[Frame] = []
        if emit == "All" and len(frontier):
            emitted.append(self._emit_filter(frontier, emit_pred))
        for _ in range(bound):
            if len(frontier) == 0:
                break
            if emit == "Before":
                emitted.append(self._emit_filter(frontier, emit_pred))
            frontier = self.run_sub(frontier, traversal)
            if emit in ("After", "All"):
                emitted.append(self._emit_filter(frontier, emit_pred))
            if until is not None and len(frontier):
                done = self._elementwise_mask(frontier, until)
                finished.append(frontier.mask(done))
                frontier = frontier.mask(~done)
                if len(frontier) == 0:
                    break
        # After/All already emitted post-iteration frontiers, which include
        # both until-finishers and the final frontier; adding them again
        # would double-count.
        parts = list(emitted)
        if emit in ("None", None, "Before"):
            parts += finished + [frontier]
        parts = [p for p in parts if len(p) > 0]
        if not parts:
            return Frame.empty(frame.kind)
        return concat_frames(parts)

    def _emit_filter(self, frame: Frame, emit_pred: Any) -> Frame:
        if emit_pred is None:
            return frame.copy()
        return frame.mask(self._elementwise_mask(frame, emit_pred))

    def _elementwise_mask(self, frame: Frame, predicate: Any) -> np.ndarray:
        out = np.empty(len(frame), bool)
        for i in range(len(frame)):
            out[i] = eval_predicate(predicate, self.ex.element_at(frame, i), self.ctx)
        return out


def _neg_key(key: Any):
    """Invert a comparable key for descending sorts."""
    family, value = key
    if family == "num":
        return (family, -value)
    if family in ("str", "bytes", "numarr", "strarr"):
        # _InvertedStr flips any comparable payload, incl. array
        # families (tuple payloads compare lexicographically)
        return (family, _InvertedStr(value))
    if family == "bool":
        return (family, not value)
    return (family, value)


class _InvertedStr:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __lt__(self, other):
        return self.value > other.value

    def __eq__(self, other):
        return self.value == other.value


def _group_key(value: Tagged) -> str:
    if value is MISSING or V.is_null(value):
        return "null"
    plain = V.to_plain(value)
    if isinstance(plain, str):
        return plain
    return json.dumps(plain, sort_keys=True, default=str)
