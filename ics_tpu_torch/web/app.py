from __future__ import annotations

import logging
import traceback
from typing import Awaitable, Callable, Optional

from ics_tpu_torch.web.exceptions import HTTPException, RequestValidationError
from ics_tpu_torch.web.requests import Request, State
from ics_tpu_torch.web.responses import JSONResponse, Response
from ics_tpu_torch.web.routing import Router

logger = logging.getLogger(__name__)

Middleware = Callable[[Request, Callable[[Request], Awaitable[Response]]], Awaitable[Response]]


class App:
    """ASGI 3 application: routing + middleware + lifespan + error handling.

    Error contract mirrors the reference's global handlers
    (``app/main.py:325-347``): ``HTTPException`` -> ``{"detail": ...}``,
    validation errors -> 422 ``{"detail": [...]}``, anything else -> 500.
    """

    def __init__(
        self,
        title: str = "ics_tpu_torch",
        lifespan: Optional[Callable] = None,
        cors_origins: Optional[list[str]] = None,
    ) -> None:
        self.title = title
        self.router = Router()
        self.state = State()
        self._lifespan = lifespan
        self._middleware: list[Middleware] = []
        self.cors_origins = cors_origins or []
        self._lifespan_cm = None

    # -- composition ------------------------------------------------------
    def include_router(self, router: Router, prefix: str = "") -> None:
        self.router.include_router(router, prefix)

    def add_middleware(self, mw: Middleware) -> None:
        self._middleware.append(mw)

    def get(self, path: str):
        return self.router.get(path)

    def post(self, path: str):
        return self.router.post(path)

    # -- lifespan (manual, for tests/servers without lifespan protocol) ---
    async def startup(self) -> None:
        if self._lifespan is not None and self._lifespan_cm is None:
            self._lifespan_cm = self._lifespan(self)
            await self._lifespan_cm.__aenter__()

    async def shutdown(self) -> None:
        if self._lifespan_cm is not None:
            await self._lifespan_cm.__aexit__(None, None, None)
            self._lifespan_cm = None

    # -- request handling --------------------------------------------------
    def _cors_headers(self, origin: Optional[str]) -> dict[str, str]:
        if not origin or (origin not in self.cors_origins and "*" not in self.cors_origins):
            return {}
        return {
            "access-control-allow-origin": origin,
            "access-control-allow-credentials": "true",
            "vary": "Origin",
        }

    async def _dispatch(self, request: Request) -> Response:
        route, params = self.router.find(request.method, request.path)
        if route is None and request.method == "HEAD":
            # HEAD is served by the GET handler; the HTTP server suppresses
            # the response body for HEAD requests
            route, params = self.router.find("GET", request.path)
        if route is None:
            if request.method == "OPTIONS":
                # CORS preflight
                headers = self._cors_headers(request.headers.get("origin"))
                headers.update(
                    {
                        "access-control-allow-methods": ", ".join(sorted(params)) or "*",
                        "access-control-allow-headers": request.headers.get(
                            "access-control-request-headers", "*"
                        ),
                        "access-control-max-age": "600",
                    }
                )
                return Response(b"", 204 if params else 404, headers=headers)
            if params:
                return JSONResponse({"detail": "Method Not Allowed"}, 405)
            return JSONResponse({"detail": "Not Found"}, 404)
        request.path_params = params  # type: ignore[assignment]
        return await route.handler(request)

    async def handle(self, request: Request) -> Response:
        handler = self._dispatch
        for mw in reversed(self._middleware):
            nxt = handler

            def bound(req, mw=mw, nxt=nxt):
                return mw(req, nxt)

            handler = bound
        try:
            response = await handler(request)
        except HTTPException as exc:
            response = JSONResponse(
                {"detail": exc.detail}, exc.status_code, headers=exc.headers
            )
        except RequestValidationError as exc:
            response = JSONResponse({"detail": exc.errors}, 422)
        except Exception:
            logger.error("Unhandled error on %s %s\n%s", request.method,
                         request.path, traceback.format_exc())
            response = JSONResponse({"detail": "Erro interno do servidor"}, 500)
        for k, v in self._cors_headers(request.headers.get("origin")).items():
            response.set_header(k, v)
        return response

    # -- ASGI entry ---------------------------------------------------------
    async def __call__(self, scope, receive, send) -> None:
        if scope["type"] == "lifespan":
            while True:
                message = await receive()
                if message["type"] == "lifespan.startup":
                    try:
                        await self.startup()
                        await send({"type": "lifespan.startup.complete"})
                    except Exception as exc:
                        await send(
                            {"type": "lifespan.startup.failed", "message": str(exc)}
                        )
                elif message["type"] == "lifespan.shutdown":
                    await self.shutdown()
                    await send({"type": "lifespan.shutdown.complete"})
                    return
        elif scope["type"] == "http":
            request = Request(scope, receive, app=self)
            response = await self.handle(request)
            await response(send)
        else:  # pragma: no cover - websockets unsupported
            raise RuntimeError(f"unsupported scope type {scope['type']}")
