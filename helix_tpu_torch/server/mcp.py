"""MCP (Model Context Protocol) endpoint over the engine.

The reference enables MCP per database (``DbConfig.mcp`` default true,
``helix-cli/src/config.rs:173,243``) so coding agents can query the
instance directly; its CLI separately registers a docs-MCP
(``setup.rs``).  helix-tpu exposes the database itself as an MCP server:
``POST /mcp`` speaks JSON-RPC 2.0 (the streamable-HTTP MCP transport's
request/response subset) and offers the query surface as tools.

Tools:

- ``query``         — run a full DynamicQueryRequest (read or write)
- ``vector_search`` — top-k ANN over a vector index
- ``text_search``   — BM25 over a text index
- ``graph_schema``  — labels, counts, declared indexes, stored routes

Transport notes: requests are single JSON-RPC messages (no batching,
no SSE stream — results fit in one response); notifications return no
body.  Tool results use the standard ``content: [{type: "text", ...}]``
shape with ``isError`` on failure so any MCP client renders them.

Port copy of ``helix_tpu/server/mcp.py`` for ``helix_tpu_torch``.
``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:
"""

from __future__ import annotations

import json
from typing import Any

from .. import __version__
from ..engine.errors import EngineError

PROTOCOL_VERSION = "2025-03-26"

TOOLS = [
    {
        "name": "query",
        "description": (
            "Run a helix-tpu dynamic query request (graph traversal, "
            "vector/text search, mutations). The request body is the "
            "same JSON accepted by POST /v1/query: {request_type: "
            "'read'|'write', query: {queries: [...], returns: [...]}}."
        ),
        "inputSchema": {
            "type": "object",
            "properties": {
                "request": {
                    "type": "object",
                    "description": "DynamicQueryRequest envelope",
                }
            },
            "required": ["request"],
        },
    },
    {
        "name": "vector_search",
        "description": "Top-k nearest-neighbor search over a vector index.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "label": {"type": "string"},
                "property": {"type": "string"},
                "vector": {"type": "array", "items": {"type": "number"}},
                "k": {"type": "integer", "default": 10},
                "tenant": {"type": "string"},
            },
            "required": ["label", "property", "vector"],
        },
    },
    {
        "name": "text_search",
        "description": "BM25 full-text search over a text index.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "label": {"type": "string"},
                "property": {"type": "string"},
                "query": {"type": "string"},
                "k": {"type": "integer", "default": 10},
            },
            "required": ["label", "property", "query"],
        },
    },
    {
        "name": "graph_schema",
        "description": (
            "Describe the database: node/edge labels with counts, "
            "declared indexes, deployed query routes."
        ),
        "inputSchema": {"type": "object", "properties": {}},
    },
]


def _text_result(payload: Any, is_error: bool = False) -> dict:
    return {
        "content": [{
            "type": "text",
            "text": json.dumps(payload, ensure_ascii=False, default=str),
        }],
        "isError": is_error,
    }


def _tool_query(engine: Any, args: dict, read_only: bool = False) -> dict:
    request = args["request"]
    if read_only and isinstance(request, dict) and request.get("request_type") == "write":
        return _text_result(
            {"error": "read-only replica: writes must go to the primary"},
            is_error=True,
        )
    return _text_result(engine.execute(request))


def _search_request(kind: str, args: dict) -> dict:
    from ..dsl import g, read_batch

    k = int(args.get("k", 10))
    if kind == "vector":
        t = g().vector_search_nodes(
            args["label"], args["property"],
            [float(x) for x in args["vector"]], k,
            tenant_value=args.get("tenant"),
        ).value_map(None)
    else:
        t = g().text_search_nodes(
            args["label"], args["property"], args["query"], k,
        ).value_map(None)
    return {
        "request_type": "read",
        "query_name": f"mcp_{kind}_search",
        "query": read_batch().var_as("hits", t).returning(["hits"]).encode(),
    }


def _tool_vector_search(engine: Any, args: dict) -> dict:
    return _text_result(engine.execute(_search_request("vector", args))["hits"])


def _tool_text_search(engine: Any, args: dict) -> dict:
    return _text_result(engine.execute(_search_request("text", args))["hits"])


def _tool_graph_schema(engine: Any, args: dict) -> dict:
    store = engine.store
    return _text_result({
        "node_labels": {
            label: len(ids) for label, ids in sorted(store.nodes_by_label.items())
        },
        "edge_labels": {
            label: len(ids) for label, ids in sorted(store.edges_by_label.items())
        },
        "indexes": [
            {
                "kind": defn.spec_tag,
                "label": defn.label,
                "property": defn.prop,
                **({"tenant_property": defn.tenant_property}
                   if defn.tenant_property else {}),
            }
            for defn in store.indexes.values()
        ],
        "routes": sorted(engine.routes),
    })


_TOOL_HANDLERS = {
    "query": _tool_query,
    "vector_search": _tool_vector_search,
    "text_search": _tool_text_search,
    "graph_schema": _tool_graph_schema,
}


def handle_mcp(engine: Any, message: dict, read_only: bool = False) -> dict | None:
    """Process one JSON-RPC message; returns the response object, or
    None for notifications (no reply).  ``read_only`` (replica gateways)
    rejects write requests through the query tool."""
    if not isinstance(message, dict) or message.get("jsonrpc") != "2.0":
        return {
            "jsonrpc": "2.0", "id": None,
            "error": {"code": -32600, "message": "invalid JSON-RPC request"},
        }
    method = message.get("method")
    msg_id = message.get("id")
    if msg_id is None:  # notification (e.g. notifications/initialized)
        return None

    def ok(result: Any) -> dict:
        return {"jsonrpc": "2.0", "id": msg_id, "result": result}

    def err(code: int, text: str) -> dict:
        return {"jsonrpc": "2.0", "id": msg_id,
                "error": {"code": code, "message": text}}

    if method == "initialize":
        return ok({
            "protocolVersion": PROTOCOL_VERSION,
            "capabilities": {"tools": {}},
            "serverInfo": {"name": "helix-tpu", "version": __version__},
        })
    if method == "ping":
        return ok({})
    if method == "tools/list":
        return ok({"tools": TOOLS})
    if method == "tools/call":
        params = message.get("params") or {}
        name = params.get("name")
        handler = _TOOL_HANDLERS.get(name)
        if handler is None:
            return err(-32602, f"unknown tool: {name}")
        try:
            arguments = params.get("arguments") or {}
            if name == "query":
                return ok(_tool_query(engine, arguments, read_only=read_only))
            return ok(handler(engine, arguments))
        except EngineError as exc:
            return ok(_text_result({"error": str(exc)}, is_error=True))
        except (KeyError, TypeError, ValueError) as exc:
            return ok(_text_result(
                {"error": f"bad arguments: {exc}"}, is_error=True,
            ))
    return err(-32601, f"method not found: {method}")
