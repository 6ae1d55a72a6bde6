"""Application factory and entry point of the port (counterpart of ``ics_tpu/main.py``).

The app mounts the port's own copies of the host routers (everything whose
handlers need no device), its ``/inferencia`` router, and the monitor
routes; nothing of the JAX package is imported. Startup: database schema
and seed as in ``ics_tpu`` (by ``ENV``), then the inference service on the
GPU. An engine that fails to build fails
startup, and so does an entropy decoder that cannot be built while
``TPU_DEVICE_DECODE`` is on; a service already placed in ``app.state.engine``
is used as it is.

Run: ``python -m ics_tpu_torch.main [--host H] [--port P]``.
"""

from __future__ import annotations

import argparse
import contextlib
import logging

import time
import uuid

from ics_tpu_torch.core.config import settings
from ics_tpu_torch.db import migrate, seed
from ics_tpu_torch.db.engine import Database, get_database
from ics_tpu_torch.utils.metrics import registry
from ics_tpu_torch.web import App, JSONResponse, PlainTextResponse, Request, Response
from ics_tpu_torch.web.exceptions import HTTPException, RequestValidationError

logger = logging.getLogger(__name__)


def _prepare_schema(db: Database) -> None:
    if not db.wait_until_ready():
        raise RuntimeError("database unreachable")
    env = settings.ENV.lower()
    if env == "production":
        db.create_all()
        migrate.upgrade_head(db)
    elif env == "development":
        db.drop_all()
        db.create_all()
        migrate.stamp_head(db)
    else:  # test and anything else: non-destructive
        db.create_all()
        migrate.stamp_head(db)
    seed.seed_all(db)


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
                warn_unserved_settings,
            )

            warn_unserved_settings()
            service = InferenceService.from_settings()
            await service.start(warm=settings.TPU_WARMUP_ON_STARTUP)
            pool = InferenceServicePool(
                default_model=settings.TPU_DEFAULT_MODEL,
                deadline_us=settings.TPU_BATCH_DEADLINE_US,
                max_deadline_us=settings.TPU_BATCH_MAX_DEADLINE_US,
                pipelined=settings.TPU_PIPELINED_FLUSH,
                device_decode=settings.TPU_DEVICE_DECODE,
                num_classes=settings.TPU_NUM_CLASSES,
                precision=settings.TPU_PRECISION,
                buckets=settings.get_batch_buckets(),
                canvas=settings.TPU_CANVAS,
                fused_chains=settings.TPU_FUSED_CHAINS,
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


async def _observability_middleware(request: Request, call_next):
    """Request id, structured access log and latency histogram."""
    request_id = request.headers.get("x-request-id") or uuid.uuid4().hex[:12]
    request.state.request_id = request_id
    t0 = time.perf_counter()
    # the default covers BaseExceptions the clauses below do not: a request
    # cancelled while the server drains raises CancelledError (not an
    # Exception). 499 = closed before a response.
    status = 499
    try:
        response = await call_next(request)
        status = response.status_code
        return response
    except HTTPException as exc:
        # converted to a response above the middleware stack; record the
        # real status here so 401/404/422 do not pass for 500s
        status = exc.status_code
        raise
    except RequestValidationError:
        status = 422
        raise
    except Exception:
        status = 500
        raise
    finally:
        dt_ms = (time.perf_counter() - t0) * 1000
        registry.counter("http_requests_total", "total HTTP requests").inc()
        if status >= 500:
            registry.counter("http_errors_total", "5xx responses").inc()
        registry.histogram("http_request_ms", "request latency (ms)").observe(dt_ms)
        logger.info(
            'rid=%s method=%s path=%s status=%s ms=%.2f',
            request_id, request.method, request.path, status, dt_ms,
        )


async def _db_session_middleware(request: Request, call_next):
    """One unit of work per request."""
    db = request.app.state.db
    session = db.open_session()
    request.state.db = session
    try:
        response = await call_next(request)
        session.commit()
        return response
    except Exception:
        session.rollback()
        raise
    finally:
        session.close()


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

    # explicit imports: a broken route module must fail startup loudly
    from ics_tpu_torch.api.routes import (
        ambientes,
        auditoria,
        auth as auth_routes,
        classificacoes,
        inferencia,
        nextcloud_images,
        opcoes,
        test_sync,
        usuarios,
        usuarios_ambientes,
        whitelist,
    )

    for module in (
        auth_routes, usuarios, whitelist, ambientes, opcoes, classificacoes,
        usuarios_ambientes, auditoria, nextcloud_images, test_sync, inferencia,
    ):
        app.include_router(module.router)

    @app.get("/")
    async def root(request: Request):
        return JSONResponse({
            "message": "Sistema de Classificação de Imagens (PyTorch/CUDA)",
            "version": __import__("ics_tpu_torch").__version__,
            "docs": "/docs",
        })

    @app.get("/docs")
    async def docs(request: Request):
        from ics_tpu_torch.web.console import CONSOLE_HTML

        return Response(CONSOLE_HTML, media_type="text/html; charset=utf-8")

    @app.get("/openapi.json")
    async def openapi(request: Request):
        from ics_tpu_torch.web.console import build_openapi

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
        engine = request.app.state.get("engine")
        if engine is not None:
            stats = engine.status()
            # the scrape keeps the JAX package's names: one dashboard reads both
            registry.gauge("tpu_images_total", "images inferred").set(stats["images"])
            registry.gauge("tpu_batches_total", "batches executed").set(stats["batches"])
            for key in ("device_decoded", "host_decoded"):
                registry.gauge(f"tpu_{key}_total", f"images via {key} lane").set(
                    stats.get(key, 0))
            batcher = stats.get("batcher") or {}
            registry.gauge(
                "tpu_pipelined_flushes_total",
                "flushes whose staging/H2D overlapped prior compute",
            ).set(batcher.get("pipelined", 0))
            # per-lane flush counters: the pixel lane and every device-decode lane
            for lane_name, lane_stats in (
                ("pixel", batcher), *sorted((stats.get("coeff_lanes") or {}).items()),
            ):
                registry.gauge(
                    f"tpu_lane_flushes_{lane_name}_total", f"batch flushes on the {lane_name} lane"
                ).set(lane_stats.get("flushes", 0))
                registry.gauge(
                    f"tpu_lane_pipelined_{lane_name}_total",
                    f"pipelined (overlapped) flushes on the {lane_name} lane",
                ).set(lane_stats.get("pipelined", 0))
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
    from ics_tpu_torch.web.server import run

    run(
        create_app(), args.host, args.port,
        idle_timeout_s=settings.SERVER_IDLE_TIMEOUT_S,
        header_timeout_s=settings.SERVER_HEADER_TIMEOUT_S,
        body_timeout_s=settings.SERVER_BODY_TIMEOUT_S,
        max_connections=settings.SERVER_MAX_CONNECTIONS,
    )


if __name__ == "__main__":
    main()
