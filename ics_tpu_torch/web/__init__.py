"""ics_tpu_torch.web — a from-scratch async web framework (ASGI 3).

The reference leaned on FastAPI/Starlette/uvicorn; none of those are part of
this framework. This package provides the equivalent tier natively:

- :mod:`ics_tpu_torch.web.app`        — application object, routing, middleware,
                                   exception handlers, lifespan
- :mod:`ics_tpu_torch.web.routing`     — router with ``{param}`` / ``{param:path}``
- :mod:`ics_tpu_torch.web.requests`    — request object (json/form/multipart/cookies)
- :mod:`ics_tpu_torch.web.responses`   — JSON / plain / streaming responses, cookies
- :mod:`ics_tpu_torch.web.exceptions`  — ``HTTPException``
- :mod:`ics_tpu_torch.web.server`      — asyncio HTTP/1.1 server speaking ASGI
"""

from ics_tpu_torch.web.app import App, Router  # noqa: F401
from ics_tpu_torch.web.exceptions import HTTPException  # noqa: F401
from ics_tpu_torch.web.requests import Request  # noqa: F401
from ics_tpu_torch.web.responses import (  # noqa: F401
    JSONResponse,
    PlainTextResponse,
    Response,
    StreamingResponse,
)
