from __future__ import annotations

import re
from typing import Awaitable, Callable, Optional

from ics_tpu_torch.web.requests import Request
from ics_tpu_torch.web.responses import Response

Handler = Callable[[Request], Awaitable[Response]]

_PARAM_RE = re.compile(r"{([a-zA-Z_][a-zA-Z0-9_]*)(?::(path|int))?}")


def compile_path(path: str) -> re.Pattern:
    """``/ambientes/{id_amb}`` -> regex with named groups.

    ``{x}`` matches one segment; ``{x:path}`` greedily matches the rest;
    ``{x:int}`` matches digits.
    """
    pattern = "^"
    last = 0
    for m in _PARAM_RE.finditer(path):
        pattern += re.escape(path[last:m.start()])
        name, kind = m.group(1), m.group(2)
        if kind == "path":
            pattern += f"(?P<{name}>.+)"
        elif kind == "int":
            pattern += f"(?P<{name}>\\d+)"
        else:
            pattern += f"(?P<{name}>[^/]+)"
        last = m.end()
    pattern += re.escape(path[last:]) + "$"
    return re.compile(pattern)


class Route:
    def __init__(self, path: str, methods: set[str], handler: Handler) -> None:
        self.path = path
        self.methods = methods
        self.handler = handler
        self.pattern = compile_path(path)
        self.is_static = "{" not in path

    def match(self, path: str) -> Optional[dict[str, str]]:
        if self.is_static:
            return {} if path == self.path else None
        m = self.pattern.match(path)
        if m is None:
            return None
        return {k: v for k, v in m.groupdict().items()}


class Router:
    """Route registry; composable via ``include_router`` with a prefix."""

    def __init__(self, prefix: str = "", tags: Optional[list[str]] = None) -> None:
        if prefix and not prefix.startswith("/"):
            raise ValueError("prefix must start with '/'")
        self.prefix = prefix.rstrip("/")
        self.tags = tags or []
        self.routes: list[Route] = []

    def add_route(self, path: str, handler: Handler, methods: list[str]) -> None:
        full = (self.prefix + path).replace("//", "/") or "/"
        self.routes.append(Route(full, {m.upper() for m in methods}, handler))

    def route(self, path: str, methods: list[str]):
        def decorator(fn: Handler) -> Handler:
            self.add_route(path, fn, methods)
            return fn

        return decorator

    def get(self, path: str):
        return self.route(path, ["GET"])

    def post(self, path: str):
        return self.route(path, ["POST"])

    def put(self, path: str):
        return self.route(path, ["PUT"])

    def patch(self, path: str):
        return self.route(path, ["PATCH"])

    def delete(self, path: str):
        return self.route(path, ["DELETE"])

    def include_router(self, other: "Router", prefix: str = "") -> None:
        prefix = prefix.rstrip("/")
        for r in other.routes:
            path = (self.prefix + prefix + r.path) or "/"
            self.routes.append(Route(path, r.methods, r.handler))

    def find(self, method: str, path: str):
        """Return (route, params) or (None, allowed_methods).

        Trailing slashes are not significant: ``/items`` and ``/items/``
        resolve to the same route (reference clients use both forms).
        """
        candidates = [path]
        if path != "/":
            candidates.append(path[:-1] if path.endswith("/") else path + "/")
        allowed: set[str] = set()
        for candidate in candidates:
            for route in self.routes:
                params = route.match(candidate)
                if params is None:
                    continue
                if method in route.methods:
                    return route, params
                allowed |= route.methods
            # NO early break on a method mismatch: the slash-variant
            # candidate may hold the route that DOES accept this method —
            # breaking here returned a spurious 405 (self-review r3)
        return None, allowed
