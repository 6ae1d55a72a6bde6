"""Application factory and entry point of the port (counterpart of ``ics_tpu/main.py``).

The app mounts the port's own copies of the host routers, its
``/inferencia`` and ``/images`` routers, and the monitor routes; nothing of
the JAX package is imported. Startup: database schema and seed as in
``ics_tpu`` (by ``ENV``), then the inference service on the GPU, then, with
``NEXTCLOUD_BASE_URL`` set, the NextCloud sync engine, whose downloads feed
classify-on-sync (``TPU_CLASSIFY_ON_SYNC``) and embed-on-sync
(``TPU_EMBED_ON_SYNC``). ``POST /monitor/latency-budget`` (admin) measures
the serving latency components against the engine
(``runtime.latency_budget``). With inference on, ``app.state.trainer`` (the
fine-tune job manager, ``train.job``) trains on the engine's device and
checkpoints under ``TPU_WEIGHTS_DIR``, its bytes from NextCloud where
``NEXTCLOUD_BASE_URL`` is set; the ``/treinamento`` routes and
``POST /inferencia/indexar`` read it; ``GET /monitor/painel`` (admin) is the
operator's dashboard. With ``TPU_SERVING_REPLICAS`` above 1 the service is
hedged over that many replicas (``runtime.hedging``), and the pool builds
every other model the same way; ``/monitor/metrics`` then carries the
``tpu_hedges_*`` gauges. An engine that fails to build fails startup, and so
does an entropy decoder that cannot be built while ``TPU_DEVICE_DECODE`` is
on; a service already placed in ``app.state.engine`` is used as it is.
Shutdown: the sync scheduler, then the on-sync tasks still pending (a short
wait, then cancelled), then the inference pool.

Run: ``python -m ics_tpu_torch.main [--host H] [--port P]``.
"""

from __future__ import annotations

import argparse
import asyncio
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
            from ics_tpu_torch.runtime.service import InferenceService, InferenceServicePool

            if settings.TPU_SERVING_REPLICAS > 1:
                # replica-level serving with request hedging: the cards are
                # partitioned into independent engines; a straggler is
                # duplicated onto the next replica, the first result wins
                from ics_tpu_torch.runtime.hedging import HedgedInferenceService

                service = HedgedInferenceService.from_settings()
            else:
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
                # under PP, pool engines take the configured microbatch count
                pp_microbatches=settings.TPU_PP_MICROBATCHES,
                mesh=service.engine.mesh,  # pool models share the mesh
                # hedged boot: the models the pool builds get one engine a
                # replica device group too, so they are hedged as well
                replica_meshes=[
                    r.engine.mesh for r in getattr(service, "replicas", [])
                ] or None,
                hedge_ms=settings.TPU_HEDGE_MS,
            )
            pool.add(settings.TPU_DEFAULT_MODEL, service)
            app.state.engine = service
            app.state.engine_pool = pool
            owned = pool
            logger.info("inference service started: %s", service.engine.status())

    # fine-tune job manager (specialist labels -> versioned weights), on the
    # serving engine's device
    app.state.trainer = None
    if settings.TPU_ENABLE_INFERENCE and app.state.engine is not None:
        from ics_tpu_torch.train.job import TrainingJobManager, nextcloud_bytes_provider

        fetch = None
        if settings.NEXTCLOUD_BASE_URL:
            from ics_tpu_torch.sync.nextcloud_client import NextCloudClient

            fetch = nextcloud_bytes_provider(NextCloudClient)
        app.state.trainer = TrainingJobManager(
            db, settings.TPU_WEIGHTS_DIR, fetch_bytes=fetch,
            device=app.state.engine.engine.device,
        )

    # NextCloud sync engine
    app.state.sync = None
    on_image_bytes = None
    if settings.NEXTCLOUD_BASE_URL:
        try:
            from ics_tpu_torch.sync.scheduler import SyncScheduler
            from ics_tpu_torch.sync.service import NextCloudSyncService

            if settings.TPU_CLASSIFY_ON_SYNC and app.state.engine is not None:
                on_image_bytes = _make_classify_on_sync(app)
            sync_service = NextCloudSyncService.from_settings(
                db, on_image_bytes=on_image_bytes
            )
            scheduler = SyncScheduler(sync_service)
            app.state.sync = scheduler
            await scheduler.start(initial=settings.NEXTCLOUD_SYNC_INITIAL_ON_STARTUP)
            logger.info("NextCloud sync engine started")
        except Exception as exc:
            logger.warning("NextCloud sync disabled: %s", exc)
    try:
        yield
    finally:
        if app.state.get("sync") is not None:
            await app.state.sync.stop()
        if on_image_bytes is not None:
            await on_image_bytes.drain()
        if owned is not None:
            await owned.stop()


class _ClassifyOnSync:
    """The sync engine's ``on_image_bytes`` hook: classify-on-sync, and
    embed-on-sync under ``TPU_EMBED_ON_SYNC``.

    Called synchronously by the sync engine (event-loop thread) with each
    downloaded image's bytes; schedules the classification and stores the
    model suggestion (and the embedding). Unlike the reference's hook, which
    keeps no reference to the task it creates, every task stays in
    ``tasks`` until it ends: the loop holds tasks weakly, and a task that is
    collected while pending leaves its image without a suggestion."""

    DRAIN_S = 10.0  # how long shutdown waits for pending tasks

    def __init__(self, app: App):
        self.app = app
        self.tasks: set[asyncio.Task] = set()

    def __call__(self, content_hash: str, data: bytes) -> None:
        task = asyncio.get_running_loop().create_task(
            self.classify_and_store(content_hash, data)
        )
        self.tasks.add(task)
        task.add_done_callback(self.tasks.discard)

    async def classify_and_store(self, content_hash: str, data: bytes) -> None:
        app = self.app
        try:
            service = app.state.get("engine")
            if service is None:
                return
            result = await service.classify_bytes(data)
            db = app.state.db
            from ics_tpu_torch.crud.modelo_crud import registrar_sugestao

            with db.session() as s:
                registrar_sugestao(
                    s, content_hash,
                    modelo=result["model"],
                    classes=[
                        {"classe": int(c), "score": float(sc)}
                        for c, sc in zip(result["top_classes"], result["scores"])
                    ],
                    score=float(result["scores"][0]) if result["scores"] else None,
                )
                s.commit()
            if settings.TPU_EMBED_ON_SYNC:
                # the similarity tier rides the same ingestion front: the
                # image's embedding is current the moment sync lands it
                from ics_tpu_torch.crud.embedding_crud import upsert_embedding

                vec = await service.embed_bytes(data)
                with db.session() as s:
                    upsert_embedding(s, content_hash, service.engine.model_name, vec)
                    s.commit()
        except Exception:  # never let suggestions break the sync engine
            logger.exception("classify-on-sync failed for %s", content_hash[:12])

    async def drain(self) -> None:
        """Let the pending tasks finish for up to ``DRAIN_S``, then cancel
        the rest; returns once every task has ended."""
        if not self.tasks:
            return
        _, pending = await asyncio.wait(set(self.tasks), timeout=self.DRAIN_S)
        for task in pending:
            task.cancel()
        if pending:
            logger.warning("shutdown cancelled %d pending classify-on-sync tasks",
                           len(pending))
            await asyncio.wait(pending)


def _make_classify_on_sync(app: App) -> _ClassifyOnSync:
    """Classify-on-sync consumer: the sync engine becomes the ingestion
    front that streams bytes to the device."""
    return _ClassifyOnSync(app)


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
        images,
        inferencia,
        nextcloud_images,
        opcoes,
        test_sync,
        treinamento,
        usuarios,
        usuarios_ambientes,
        whitelist,
    )

    for module in (
        auth_routes, usuarios, whitelist, ambientes, opcoes, classificacoes,
        usuarios_ambientes, auditoria, nextcloud_images, test_sync, images,
        inferencia, treinamento,
    ):
        app.include_router(module.router)

    @app.get("/")
    async def root(request: Request):
        return JSONResponse({
            "message": "Sistema de Classificação de Imagens (PyTorch/CUDA)",
            "version": __import__("ics_tpu_torch").__version__,
            "docs": "/docs",
            "painel": "/monitor/painel",
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

    @app.get("/monitor/painel")
    async def monitor_painel(request: Request):
        """Operator dashboard: sync, engine, latency and lanes live, and the
        training job list with an SSE loss sparkline (``web/painel.py``).
        Admin-gated: it shows training-job parameters and sync folder
        paths. ``/health`` and ``/monitor/metrics`` stay public: the load
        balancer's probe and the Prometheus scrape target."""
        from ics_tpu_torch.services.auth_service import require_admin
        from ics_tpu_torch.web.painel import PAINEL_HTML

        require_admin(request)
        return Response(PAINEL_HTML, media_type="text/html; charset=utf-8")

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
            hedging = stats.get("hedging")
            if hedging:  # replica serving (TPU_SERVING_REPLICAS >= 2)
                for key in ("hedges_fired", "hedges_won", "hedge_failures"):
                    registry.gauge(f"tpu_{key}", f"request hedging: {key}").set(
                        hedging.get(key, 0))
                registry.gauge("tpu_serving_replicas", "independent engine replicas").set(
                    stats.get("serving_replicas", 1))
        return PlainTextResponse(registry.expose())

    @app.post("/monitor/latency-budget")
    async def monitor_latency_budget(request: Request):
        """Measure the serving latency components against this process's
        engine and hold them to the budget lines of its device type; the
        results are exported as the ``latency_budget_*`` gauges of
        ``/monitor/metrics``."""
        from ics_tpu_torch.services.auth_service import require_admin

        require_admin(request)
        service = request.app.state.get("engine")
        if service is None:
            raise HTTPException(503, "Serviço de inferência indisponível.")
        from ics_tpu_torch.runtime import latency_budget

        engine = service.engine
        measured = await asyncio.get_running_loop().run_in_executor(
            None, lambda: latency_budget.measure(engine))
        latency_budget.export_metrics(measured)
        platform = engine.device.type
        violations = latency_budget.check(measured, platform)
        return JSONResponse({
            "componentes": measured,
            "orcamento": latency_budget.budget_lines(platform),
            "violacoes": violations,
            "dentro_do_orcamento": not violations,
        })

    @app.get("/monitor/status")
    async def monitor_status(request: Request):
        # admin-gated: exposes sync folder paths and engine internals
        from ics_tpu_torch.services.auth_service import require_admin

        require_admin(request)
        sync = request.app.state.get("sync")
        engine = request.app.state.get("engine")
        return JSONResponse({
            "sync": sync.status() if sync else {"enabled": False},
            "tpu": engine.status() if engine else {"enabled": False},
        })

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
