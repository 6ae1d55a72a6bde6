from __future__ import annotations

import json
from typing import Any, Optional
from urllib.parse import parse_qsl, unquote

from ics_tpu_torch.web.exceptions import HTTPException
from ics_tpu_torch.web.multipart import FormData, parse_multipart, parse_urlencoded


class State(dict):
    """Attribute-style scratch space (``request.state.db`` etc.)."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value


class Request:
    def __init__(self, scope: dict, receive, app=None) -> None:
        self.scope = scope
        self._receive = receive
        self.app = app
        self.method: str = scope.get("method", "GET").upper()
        self.path: str = scope.get("path", "/")
        self.path_params: dict[str, str] = {}
        self.state = State()
        self._body: Optional[bytes] = None
        self._headers: Optional[dict[str, str]] = None
        self._query: Optional[dict[str, str]] = None
        self._cookies: Optional[dict[str, str]] = None

    @property
    def headers(self) -> dict[str, str]:
        if self._headers is None:
            self._headers = {}
            for k, v in self.scope.get("headers", []):
                key = k.decode("latin-1").lower()
                val = v.decode("latin-1")
                if key in self._headers:
                    # RFC 9110 §5.2: repeated field lines combine with a
                    # comma — last-wins would silently DROP earlier lines
                    # (e.g. each proxy in a chain appends its own
                    # X-Forwarded-For line). Cookie is the RFC-carved
                    # exception: its pair separator is '; ' (RFC 6265),
                    # and HTTP/2→1.1 intermediaries legitimately split it
                    # into multiple lines — a ', ' join would corrupt the
                    # session token value.
                    sep = "; " if key == "cookie" else ", "
                    self._headers[key] += sep + val
                else:
                    self._headers[key] = val
        return self._headers

    @property
    def query_params(self) -> dict[str, str]:
        if self._query is None:
            qs = self.scope.get("query_string", b"").decode("latin-1")
            self._query = dict(parse_qsl(qs, keep_blank_values=True))
        return self._query

    def query_int(self, key: str, default: int, lo: int = None, hi: int = None) -> int:
        raw = self.query_params.get(key)
        if raw is None or raw == "":
            value = default
        else:
            try:
                value = int(raw)
            except ValueError:
                raise HTTPException(422, f"Parâmetro '{key}' deve ser inteiro")
        if lo is not None and value < lo:
            raise HTTPException(422, f"Parâmetro '{key}' deve ser >= {lo}")
        if hi is not None and value > hi:
            value = hi
        return value

    @property
    def cookies(self) -> dict[str, str]:
        if self._cookies is None:
            self._cookies = {}
            raw = self.headers.get("cookie", "")
            for item in raw.split(";"):
                if "=" in item:
                    k, _, v = item.partition("=")
                    self._cookies[k.strip()] = unquote(v.strip())
        return self._cookies

    async def body(self) -> bytes:
        if self._body is None:
            chunks: list[bytes] = []
            while True:
                message = await self._receive()
                chunks.append(message.get("body", b""))
                if not message.get("more_body", False):
                    break
            self._body = b"".join(chunks)
        return self._body

    async def json(self) -> Any:
        """Parse the body as a JSON OBJECT (dict) or 422.

        Every route body in this app is an object; the reference stack
        (FastAPI + pydantic models) likewise rejects a top-level array /
        scalar with 422, so enforcing it here keeps the contract AND
        stops a crafted ``[1,2]`` body from reaching ``body.get(...)``
        and turning into a 500.
        """
        raw = await self.body()
        if not raw:
            raise HTTPException(422, "Corpo JSON ausente")
        try:
            parsed = json.loads(raw)
        except json.JSONDecodeError:
            raise HTTPException(422, "JSON inválido")
        if not isinstance(parsed, dict):
            raise HTTPException(422, "Corpo JSON deve ser um objeto")
        return parsed

    async def form(self) -> FormData:
        ctype = self.headers.get("content-type", "")
        raw = await self.body()
        # media types are case-insensitive (RFC 2045): a legal
        # 'Multipart/Form-Data' must not fall through to urlencoded
        if ctype.lower().startswith("multipart/form-data"):
            try:
                return parse_multipart(raw, ctype)
            except ValueError:
                # malformed CLIENT payload (missing boundary, broken part
                # structure) — 422, never the generic 500 handler
                raise HTTPException(422, "Corpo multipart inválido.")
        return parse_urlencoded(raw)
