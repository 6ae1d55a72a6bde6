from __future__ import annotations

import json
from datetime import datetime
from typing import Any, AsyncIterator, Iterable, Mapping, Optional
from uuid import UUID

STATUS_PHRASES = {
    200: "OK", 201: "Created", 204: "No Content", 301: "Moved Permanently",
    302: "Found", 304: "Not Modified", 307: "Temporary Redirect",
    400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed", 408: "Request Timeout",
    409: "Conflict", 413: "Payload Too Large", 415: "Unsupported Media Type",
    422: "Unprocessable Entity", 429: "Too Many Requests",
    500: "Internal Server Error", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
}


def _json_default(obj: Any) -> Any:
    if isinstance(obj, datetime):
        return obj.isoformat()
    if isinstance(obj, UUID):
        return str(obj)
    if isinstance(obj, bytes):
        return obj.decode("utf-8", "replace")
    if hasattr(obj, "model_dump"):
        return obj.model_dump()
    raise TypeError(f"not JSON serializable: {type(obj)!r}")


def json_dumps(content: Any) -> bytes:
    return json.dumps(
        content, ensure_ascii=False, separators=(",", ":"), default=_json_default
    ).encode("utf-8")


class Response:
    media_type: Optional[str] = None

    def __init__(
        self,
        content: Any = b"",
        status_code: int = 200,
        headers: Optional[Mapping[str, str]] = None,
        media_type: Optional[str] = None,
    ) -> None:
        self.status_code = status_code
        self.body = self.render(content)
        self.raw_headers: list[tuple[bytes, bytes]] = []
        if media_type is not None:
            self.media_type = media_type
        populated = set()
        if headers:
            for k, v in headers.items():
                self.raw_headers.append((k.lower().encode(), str(v).encode()))
                populated.add(k.lower())
        if self.media_type and "content-type" not in populated:
            self.raw_headers.append((b"content-type", self.media_type.encode()))
        if "content-length" not in populated and not isinstance(
            self, StreamingResponse
        ) and self.status_code not in (204, 304):
            self.raw_headers.append(
                (b"content-length", str(len(self.body)).encode())
            )

    def render(self, content: Any) -> bytes:
        if content is None:
            return b""
        if isinstance(content, bytes):
            return content
        return str(content).encode("utf-8")

    def set_header(self, key: str, value: str) -> None:
        self.raw_headers.append((key.lower().encode(), value.encode()))

    def set_cookie(
        self,
        key: str,
        value: str = "",
        max_age: Optional[int] = None,
        expires: Optional[str] = None,
        path: str = "/",
        domain: Optional[str] = None,
        secure: bool = False,
        httponly: bool = False,
        samesite: Optional[str] = "lax",
    ) -> None:
        parts = [f"{key}={value}", f"Path={path}"]
        if max_age is not None:
            parts.append(f"Max-Age={max_age}")
        if expires is not None:
            parts.append(f"Expires={expires}")
        if domain:
            parts.append(f"Domain={domain}")
        if secure:
            parts.append("Secure")
        if httponly:
            parts.append("HttpOnly")
        if samesite:
            parts.append(f"SameSite={samesite}")
        self.raw_headers.append((b"set-cookie", "; ".join(parts).encode()))

    def delete_cookie(
        self,
        key: str,
        path: str = "/",
        domain: Optional[str] = None,
        secure: bool = False,
        httponly: bool = False,
        samesite: Optional[str] = "lax",
    ) -> None:
        self.set_cookie(
            key, "", max_age=0, expires="Thu, 01 Jan 1970 00:00:00 GMT",
            path=path, domain=domain, secure=secure, httponly=httponly,
            samesite=samesite,
        )

    async def __call__(self, send) -> None:
        await send(
            {
                "type": "http.response.start",
                "status": self.status_code,
                "headers": self.raw_headers,
            }
        )
        await send({"type": "http.response.body", "body": self.body})


class JSONResponse(Response):
    media_type = "application/json"

    def render(self, content: Any) -> bytes:
        return json_dumps(content)


class PlainTextResponse(Response):
    media_type = "text/plain; charset=utf-8"


class StreamingResponse(Response):
    """Chunked streaming body from an (a)sync iterator of bytes."""

    def __init__(
        self,
        content: Iterable[bytes] | AsyncIterator[bytes],
        status_code: int = 200,
        headers: Optional[Mapping[str, str]] = None,
        media_type: Optional[str] = None,
    ) -> None:
        self.iterator = content
        super().__init__(b"", status_code, headers, media_type)

    def render(self, content: Any) -> bytes:
        return b""

    async def __call__(self, send) -> None:
        await send(
            {
                "type": "http.response.start",
                "status": self.status_code,
                "headers": self.raw_headers,
            }
        )
        it = self.iterator
        if hasattr(it, "__aiter__"):
            async for chunk in it:  # type: ignore[union-attr]
                if chunk:
                    await send(
                        {
                            "type": "http.response.body",
                            "body": bytes(chunk),
                            "more_body": True,
                        }
                    )
        else:
            for chunk in it:  # type: ignore[union-attr]
                if chunk:
                    await send(
                        {
                            "type": "http.response.body",
                            "body": bytes(chunk),
                            "more_body": True,
                        }
                    )
        await send({"type": "http.response.body", "body": b""})
