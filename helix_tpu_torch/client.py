"""HTTP client SDK.

Python client with the same surface as the reference SDK clients
(reference: ``sdks/python/src/helixdb/client.py``, ``sdks/rust/src/lib.rs``):
``Client(url).query()`` → ``.dynamic(request)`` or ``.stored(name)`` →
``.send()``, with the three engine-behavior header toggles.

Uses only the standard library (urllib) so the SDK stays dependency-free,
matching the reference's zero-dep TS SDK design (``ts_query.rs:8``).

Port copy of ``helix_tpu/client.py`` for ``helix_tpu_torch`` (it
builds requests with the port's own ``dsl``).
``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any

from .dsl import DynamicQueryRequest


class HelixError(Exception):
    """Transport or remote error from the engine."""

    def __init__(self, message: str, status: int | None = None, body: Any = None):
        super().__init__(message)
        self.status = status
        self.body = body


class Client:
    """Engine HTTP client bound to a base URL."""

    def __init__(self, url: str = "http://localhost:6969", api_key: str | None = None):
        self.url = url.rstrip("/")
        self.api_key = api_key

    def query(self) -> "QueryBuilder":
        return QueryBuilder(self)

    # Convenience shortcuts -------------------------------------------------

    def execute(self, request: DynamicQueryRequest | dict) -> Any:
        return self.query().dynamic(request).send()

    def call(self, name: str, parameters: dict | None = None) -> Any:
        return self.query().stored(name).body(parameters or {}).send()

    def deploy_bundle(self, bundle: dict) -> Any:
        return _post(f"{self.url}/v1/bundle", bundle, {}, self.api_key)

    def health(self) -> Any:
        req = urllib.request.Request(f"{self.url}/v1/health", method="GET")
        if self.api_key:
            req.add_header("Authorization", f"Bearer {self.api_key}")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            # before URLError (its base class): callers branch on
            # .status to tell an unhealthy server from a network fault
            raise HelixError(
                f"HTTP {exc.code}", status=exc.code
            ) from exc
        except urllib.error.URLError as exc:
            raise HelixError(f"transport error: {exc}") from exc


class QueryBuilder:
    """Route + header assembly; finish with dynamic()/stored() then send()."""

    def __init__(self, client: Client):
        self._client = client
        self._headers: dict[str, str] = {"Content-Type": "application/json"}
        self._body: Any = None
        self._route: str | None = None

    def writer_only(self) -> "QueryBuilder":
        self._headers["x-helix-require-writer"] = "true"
        return self

    def warm_only(self) -> "QueryBuilder":
        self._headers["x-helix-warm"] = "true"
        return self

    def should_await_durability(self, should: bool) -> "QueryBuilder":
        self._headers["x-helix-await-durable"] = "true" if should else "false"
        return self

    def body(self, data: Any) -> "QueryBuilder":
        self._body = data
        return self

    def dynamic(self, request: DynamicQueryRequest | dict) -> "QueryBuilder":
        self._route = "/v1/query"
        self._body = request.encode() if isinstance(request, DynamicQueryRequest) else request
        return self

    def stored(self, name: str) -> "QueryBuilder":
        from urllib.parse import quote

        # percent-encode: a name with '/', '?', '#', spaces, or control
        # characters must not target a different route or crash urllib
        self._route = f"/v1/query/{quote(name, safe='')}"
        return self

    def send(self) -> Any:
        if self._route is None:
            raise HelixError("choose dynamic() or stored() before send()")
        return _post(
            f"{self._client.url}{self._route}",
            self._body if self._body is not None else {},
            self._headers,
            self._client.api_key,
        )


def _json_default(value: Any) -> Any:
    if type(value).__name__ == "array":
        return value.tolist()  # fast-parsed numeric vectors
    raise TypeError(
        f"Object of type {type(value).__name__} is not JSON serializable"
    )


def _post(url: str, body: Any, headers: dict[str, str], api_key: str | None) -> Any:
    data = json.dumps(
        body, ensure_ascii=False, default=_json_default
    ).encode("utf-8")
    req = urllib.request.Request(url, data=data, method="POST")
    req.add_header("Content-Type", "application/json")
    for key, value in headers.items():
        req.add_header(key, value)
    if api_key:
        req.add_header("Authorization", f"Bearer {api_key}")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        try:
            payload = json.loads(exc.read())
        except Exception:
            payload = None
        message = f"HTTP {exc.code}"
        if isinstance(payload, dict):
            err = payload.get("error")
            if isinstance(err, dict):
                # kind-only envelopes (HA 503 fallback) have no message
                message = err.get("message") or err.get("kind") or message
            elif isinstance(err, str):
                message = err  # control-plane shape: {"error": "text"}
        raise HelixError(message, status=exc.code, body=payload) from exc
    except urllib.error.URLError as exc:
        raise HelixError(f"transport error: {exc}") from exc
