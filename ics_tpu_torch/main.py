"""Application factory and entry point of the port (counterpart of ``ics_tpu/main.py``).

The app mounts every ``ics_tpu`` router whose handlers reach no JAX, the
port's ``/inferencia`` router in place of the JAX one, and the monitor
routes. Startup: database schema and seed as in ``ics_tpu`` (by ``ENV``),
then the inference service on the GPU. An engine that fails to build fails
startup; a service already placed in ``app.state.engine`` is used as it is.

Run: ``python -m ics_tpu_torch.main [--host H] [--port P]``.
"""

from __future__ import annotations

import argparse
import contextlib
import logging

from ics_tpu.core.config import settings
from ics_tpu.db.engine import Database, get_database
from ics_tpu.main import _db_session_middleware, _observability_middleware, _prepare_schema
from ics_tpu.web import App, JSONResponse, Request, Router

logger = logging.getLogger(__name__)

# handlers of classificacoes that reach the JAX embedding index, the
# trained-weight engines or the explain lane: they wait for later slices
_DEFERRED_ROUTES = {
    ("GET", "/classificacoes/ambiente/{id_amb}/sugerir-vizinhos/{content_hash}"),
    ("POST", "/classificacoes/ambiente/{id_amb}/classificar-tpu"),
    ("POST", "/classificacoes/ambiente/{id_amb}/explicar"),
}


def _without_deferred(router: Router) -> Router:
    kept = Router()
    kept.routes = [
        r for r in router.routes
        if not any((m, r.path) in _DEFERRED_ROUTES for m in r.methods)
    ]
    return kept


@contextlib.asynccontextmanager
async def lifespan(app: App):
    db = app.state.get("db") or get_database()
    app.state.db = db
    _prepare_schema(db)

    owned = None
    if app.state.get("engine") is None:
        app.state.engine = None
        app.state.engine_pool = None
        if settings.TPU_ENABLE_INFERENCE:
            from ics_tpu_torch.runtime.service import (
                InferenceService,
                InferenceServicePool,
            )

            service = InferenceService.from_settings()
            await service.start(warm=settings.TPU_WARMUP_ON_STARTUP)
            pool = InferenceServicePool(
                default_model=settings.TPU_DEFAULT_MODEL,
                deadline_us=settings.TPU_BATCH_DEADLINE_US,
                max_deadline_us=settings.TPU_BATCH_MAX_DEADLINE_US,
                pipelined=settings.TPU_PIPELINED_FLUSH,
                num_classes=settings.TPU_NUM_CLASSES,
                precision=settings.TPU_PRECISION,
                buckets=settings.get_batch_buckets(),
                canvas=settings.TPU_CANVAS,
            )
            pool.add(settings.TPU_DEFAULT_MODEL, service)
            app.state.engine = service
            app.state.engine_pool = pool
            owned = pool
            logger.info("inference service started: %s", service.engine.status())
    try:
        yield
    finally:
        if owned is not None:
            await owned.stop()


def create_app(db: Database | None = None) -> App:
    app = App(
        title="Sistema de Classificação de Imagens (GPU)",
        lifespan=lifespan,
        cors_origins=settings.get_cors_origins_list(),
    )
    if db is not None:
        app.state.db = db
    app.add_middleware(_observability_middleware)
    app.add_middleware(_db_session_middleware)

    from ics_tpu.api.routes import (
        ambientes,
        auditoria,
        auth as auth_routes,
        classificacoes,
        nextcloud_images,
        opcoes,
        test_sync,
        usuarios,
        usuarios_ambientes,
        whitelist,
    )
    from ics_tpu_torch.api.routes import inferencia

    for module in (
        auth_routes, usuarios, whitelist, ambientes, opcoes,
        usuarios_ambientes, auditoria, nextcloud_images, test_sync, inferencia,
    ):
        app.include_router(module.router)
    app.include_router(_without_deferred(classificacoes.router))

    @app.get("/")
    async def root(request: Request):
        return JSONResponse({
            "message": "Sistema de Classificação de Imagens (PyTorch/CUDA)",
            "version": __import__("ics_tpu_torch").__version__,
            "docs": "/docs",
        })

    @app.get("/docs")
    async def docs(request: Request):
        from ics_tpu.web import Response
        from ics_tpu.web.console import CONSOLE_HTML

        return Response(CONSOLE_HTML, media_type="text/html; charset=utf-8")

    @app.get("/openapi.json")
    async def openapi(request: Request):
        from ics_tpu.web.console import build_openapi

        return JSONResponse(build_openapi(
            request.app, title="Sistema de Classificação de Imagens (GPU)",
            version=__import__("ics_tpu_torch").__version__,
        ))

    @app.get("/health")
    async def health(request: Request):
        return JSONResponse({
            "status": "healthy",
            "service": "image-classification-system-gpu",
            "environment": settings.ENV,
        })

    @app.get("/monitor/metrics")
    async def monitor_metrics(request: Request):
        from ics_tpu.utils.metrics import registry
        from ics_tpu.web import PlainTextResponse

        engine = request.app.state.get("engine")
        if engine is not None:
            stats = engine.status()
            registry.gauge("gpu_images_total", "images inferred").set(stats["images"])
            registry.gauge("gpu_batches_total", "batches executed").set(stats["batches"])
            for name, count in stats["kernel_launches"].items():
                registry.gauge(
                    f"gpu_kernel_launches_{name}_total", f"launches of the {name} kernel"
                ).set(count)
            lat = stats.get("latency") or {}
            if lat:
                registry.gauge("classify_p50_ms", "classify p50").set(lat["p50_ms"])
                registry.gauge("classify_p99_ms", "classify p99").set(lat["p99_ms"])
        return PlainTextResponse(registry.expose())

    return app


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default=settings.API_HOST)
    parser.add_argument("--port", type=int, default=settings.API_PORT)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    from ics_tpu.web.server import run

    run(
        create_app(), args.host, args.port,
        idle_timeout_s=settings.SERVER_IDLE_TIMEOUT_S,
        header_timeout_s=settings.SERVER_HEADER_TIMEOUT_S,
        body_timeout_s=settings.SERVER_BODY_TIMEOUT_S,
        max_connections=settings.SERVER_MAX_CONNECTIONS,
    )


if __name__ == "__main__":
    main()
