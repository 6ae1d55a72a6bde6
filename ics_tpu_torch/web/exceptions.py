from __future__ import annotations

from typing import Any, Optional


class HTTPException(Exception):
    """Raise from any handler to produce an error response.

    Serialized as ``{"detail": ...}``, matching the reference's error contract
    (FastAPI-style), so existing clients keep working.
    """

    def __init__(
        self,
        status_code: int,
        detail: Any = None,
        headers: Optional[dict[str, str]] = None,
    ) -> None:
        super().__init__(detail)
        self.status_code = status_code
        self.detail = detail if detail is not None else "Internal Server Error"
        self.headers = headers or {}


class RequestValidationError(Exception):
    """Request payload failed schema validation -> 422 with error list."""

    def __init__(self, errors: Any) -> None:
        super().__init__("validation error")
        self.errors = errors
