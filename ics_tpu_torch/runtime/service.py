"""Inference service: image bytes in -> classes and scores out (counterpart
of ``ics_tpu/runtime/service.py``, host-decode lane).

Host decode (``runtime.decode``) -> dynamic batcher (``runtime.batcher``)
-> the engine. The batcher, decode and staging are the port's own copies
of the JAX package's host code.

Not ported yet: the JPEG-coefficient (device decode) lanes, hedged
replicas, trained-weight engines, and the TTA/embed/explain requests.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional, Sequence

import numpy as np

from ics_tpu_torch.core.config import settings
from ics_tpu_torch.runtime.batcher import DynamicBatcher
from ics_tpu_torch.runtime.decode import decode_image, stage_batch
from ics_tpu_torch.utils.metrics import registry as metrics_registry
from ics_tpu_torch.runtime.engine import InferenceEngine

logger = logging.getLogger(__name__)

_warned: set[str] = set()  # notices already given in this process


def _warn_once(key: str, message: str) -> None:
    if key not in _warned:
        _warned.add(key)
        logger.warning(message)


def warn_unserved_settings() -> None:
    """Say once, at warning level, each setting that the port takes and does
    not serve yet, so that a deployment that relies on one is not left to
    find out from its traffic."""
    if settings.TPU_DEVICE_DECODE:
        _warn_once("device_decode",
                   "TPU_DEVICE_DECODE is set, but the device-decode lane is not "
                   "ported yet (ROADMAP.md slice 4): images are decoded on the host")
    if settings.TPU_SERVING_REPLICAS > 1:
        _warn_once("serving_replicas",
                   f"TPU_SERVING_REPLICAS={settings.TPU_SERVING_REPLICAS}, but hedged "
                   "replicas are not ported yet: one engine serves, without hedging")
    if settings.get_mesh_shape() is not None:
        _warn_once("mesh_shape",
                   f"TPU_MESH_SHAPE={settings.TPU_MESH_SHAPE!r}, but the device mesh is "
                   "not ported yet: the engine runs on one GPU")
    if settings.TPU_PP_STAGES >= 2:
        _warn_once("pp_stages",
                   f"TPU_PP_STAGES={settings.TPU_PP_STAGES}, but pipeline parallelism is "
                   "not ported yet: the whole model runs on one GPU")
    if settings.TPU_EMBED_ON_SYNC:
        _warn_once("embed_on_sync",
                   "TPU_EMBED_ON_SYNC is set, but the embed lane is not ported yet: "
                   "synced images are not embedded")
    if settings.NEXTCLOUD_BASE_URL.strip() and settings.TPU_CLASSIFY_ON_SYNC:
        _warn_once("classify_on_sync",
                   "NEXTCLOUD_BASE_URL is set with TPU_CLASSIFY_ON_SYNC, but the sync "
                   "engine and classify-on-sync are not ported yet: synced images get "
                   "no suggestion")


class InferenceService:
    def __init__(self, engine: InferenceEngine, deadline_us: int = 2000,
                 max_deadline_us: int = 50_000, pipelined: bool = True):
        self.engine = engine
        self.batcher = DynamicBatcher(
            # canvas=None: each flush stages on the smallest canvas bucket
            # (256/512/1024) that fits its largest image
            predict_staged=self._predict_resilient,
            stage_batch=lambda imgs: stage_batch(imgs, canvas=None),
            max_batch=max(engine.buckets),
            deadline_us=deadline_us,
            max_deadline_us=max_deadline_us,
            predict_dispatch=self._dispatch_resilient if pipelined else None,
        )
        self._latencies_ms: list[float] = []
        self._device_errors = 0
        self._stats = {"host_decoded": 0}

    @classmethod
    def from_settings(cls) -> "InferenceService":
        """The serving engine and service the ``TPU_*`` settings describe."""
        warn_unserved_settings()
        engine = InferenceEngine(
            model_name=settings.TPU_DEFAULT_MODEL,
            num_classes=settings.TPU_NUM_CLASSES,
            precision=settings.TPU_PRECISION,
            buckets=settings.get_batch_buckets(),
            canvas=settings.TPU_CANVAS,
            fused_chains=settings.TPU_FUSED_CHAINS,
        )
        return cls(
            engine,
            deadline_us=settings.TPU_BATCH_DEADLINE_US,
            max_deadline_us=settings.TPU_BATCH_MAX_DEADLINE_US,
            pipelined=settings.TPU_PIPELINED_FLUSH,
        )

    # -- device-error resilience: one retry, then the error propagates -------
    def _retry_once(self, fn, what: str):
        try:
            return fn()
        except Exception:
            self._device_errors += 1
            logger.exception("%s failed; retrying once", what)
            return fn()

    def _predict_resilient(self, canvas, sizes):
        return self._retry_once(
            lambda: self.engine.predict_staged(canvas, sizes), "device step"
        )

    def _dispatch_resilient(self, canvas, sizes):
        """Pipelined flavour: the dispatch is retried once inline; a failure
        while resolving falls back to one synchronous retry."""
        resolve = self._retry_once(
            lambda: self.engine.predict_staged_async(canvas, sizes),
            "device step dispatch",
        )

        def resolve_resilient():
            try:
                return resolve()
            except Exception:
                self._device_errors += 1
                logger.exception("device step resolve failed; retrying once")
                return self.engine.predict_staged(canvas, sizes)

        return resolve_resilient

    async def start(self, warm: bool = False) -> None:
        if warm:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, self.engine.warmup)
        await self.batcher.start()

    async def stop(self) -> None:
        await self.batcher.stop()

    async def classify_bytes(self, data: bytes) -> dict:
        t0 = time.perf_counter()
        loop = asyncio.get_running_loop()
        # announced while decoding: the flusher holds its batch open for it
        self.batcher.announce()
        announced = True
        try:
            self._stats["host_decoded"] += 1
            image = await loop.run_in_executor(None, decode_image, data)
            metrics_registry.histogram(
                "decode_ms", "host decode latency (ms)",
                buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50),
            ).observe((time.perf_counter() - t0) * 1000)
            announced = False  # submit() consumes the announcement
            idx, scores = await self.batcher.submit(image, announced=True)
        finally:
            if announced:
                self.batcher.retract()
        dt_ms = (time.perf_counter() - t0) * 1000
        self._record_latency(dt_ms)
        return {
            "top_classes": [int(i) for i in idx],
            "scores": [float(s) for s in scores],
            "latency_ms": round(dt_ms, 3),
            "model": self.engine.model_name,
            "decode": "host",
        }

    async def classify_many(self, blobs: Sequence[bytes]) -> list[dict]:
        return list(await asyncio.gather(*(self.classify_bytes(b) for b in blobs)))

    def _record_latency(self, ms: float) -> None:
        self._latencies_ms.append(ms)
        if len(self._latencies_ms) > 10_000:
            self._latencies_ms = self._latencies_ms[-5_000:]

    def latency_percentiles(self) -> dict:
        if not self._latencies_ms:
            return {}
        arr = np.asarray(self._latencies_ms)
        return {
            "p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99)),
            "n": len(arr),
        }

    def status(self) -> dict:
        return {
            **self.engine.status(),
            "batcher": self.batcher.stats,
            "latency": self.latency_percentiles(),
            "device_errors": self._device_errors,
            "device_decode": False,  # the lane is not ported: every image is host-decoded
            **self._stats,
        }


class InferenceServicePool:
    """Per-model services created on first use; the default model serves
    ``/inferencia/classificar`` without ``?modelo=``."""

    def __init__(self, default_model: str, deadline_us: int = 2000,
                 max_deadline_us: int = 50_000, pipelined: bool = True,
                 **engine_kwargs):
        self.default_model = default_model
        self.deadline_us = deadline_us
        self.max_deadline_us = max_deadline_us
        self.pipelined = pipelined
        self.engine_kwargs = engine_kwargs
        self._services: dict[str, InferenceService] = {}
        # one lock per model: a cold build of one model must not hold up another
        self._locks: dict[str, asyncio.Lock] = {}
        self._stopped = False

    def add(self, name: str, service: InferenceService) -> None:
        """Register an already started service (the default model's)."""
        self._services[name] = service

    def built(self, model_name: str) -> Optional[InferenceService]:
        """The service of ``model_name`` if it has been built, else None."""
        return self._services.get(model_name)

    async def get(self, model_name: Optional[str] = None) -> InferenceService:
        name = model_name or self.default_model
        service = self._services.get(name)
        if service is not None:
            return service
        if self._stopped:
            raise RuntimeError("pool de inferência encerrado")
        async with self._locks.setdefault(name, asyncio.Lock()):
            service = self._services.get(name)
            if service is not None:
                return service
            loop = asyncio.get_running_loop()
            # weight init and the copy to the device block: off the event loop
            engine = await loop.run_in_executor(
                None, lambda: InferenceEngine(model_name=name, **self.engine_kwargs)
            )
            service = InferenceService(
                engine, deadline_us=self.deadline_us,
                max_deadline_us=self.max_deadline_us, pipelined=self.pipelined,
            )
            await service.start()
            if self._stopped:  # stop() ran while the engine was being built
                await service.stop()
                raise RuntimeError("pool de inferência encerrado")
            self._services[name] = service
            return service

    async def stop(self) -> None:
        self._stopped = True
        services, self._services = dict(self._services), {}
        for service in services.values():
            await service.stop()
