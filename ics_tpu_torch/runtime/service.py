"""Inference service: image bytes in -> classes and scores out (counterpart
of ``ics_tpu/runtime/service.py``).

Two kinds of lane, each a dynamic batcher (``runtime.batcher``) in front of
the engine, all sharing one ``IncomingCounter``:

- the device-decode lanes (``device_decode``, on by default): a JPEG is
  entropy-decoded on the host by the port's own decoder
  (``native.imgcodec.jpeg_coefficients``) and goes to the lane of its
  (sampling mode, luma bucket), whose step decodes, preprocesses and
  classifies the batch on the device (``runtime.device_decode``);
- the pixel lane: everything else (PNG, JPEGs the decoder declines, over
  1024 px, or in another sampling) is decoded on the host
  (``runtime.decode``) and staged as uint8 canvases.

With ``device_decode`` on, a decoder library that cannot be built fails
the service's construction: no request is quietly host-decoded instead.

Embeddings (``embed_bytes``), flip-averaged classification
(``classify_bytes_tta``) and saliency maps (``explain_bytes``) take neither
lane: host decode, then one staged batch of 1 straight to the engine's
step, at most two at a time (``_diag_sem``), as in the reference, which
never serves them from coefficients.

The pool serves the registry's models by name and, for an ambiente with an
active trained version (a ``modelos_treinados`` row), that version's
weights from the port's checkpoints (``get_trained``), the calibrated
temperature folded into the head. Promoting a version evicts the older ones
of the ambiente; they stop once their work in flight has drained.

Not ported: hedged replicas (``TPU_SERVING_REPLICAS``). On one GPU a
replica is a stream or a process of its own, which needs its own design.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional, Sequence

import numpy as np

from ics_tpu_torch.core.config import settings
from ics_tpu_torch.native import imgcodec
from ics_tpu_torch.runtime.batcher import DynamicBatcher, IncomingCounter
from ics_tpu_torch.runtime.decode import decode_image, stage_batch
from ics_tpu_torch.runtime.device_decode import (
    LUMA_BUCKETS,
    classify_coefficients,
    stage_coefficient_batch,
)
from ics_tpu_torch.utils.metrics import registry as metrics_registry
from ics_tpu_torch.runtime.engine import InferenceEngine
from ics_tpu_torch.train.checkpoint import UnconvertedCheckpointError

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


class InferenceService:
    def __init__(self, engine: InferenceEngine, deadline_us: int = 2000,
                 max_deadline_us: int = 50_000, pipelined: bool = True,
                 device_decode: bool = True):
        self.engine = engine
        self._deadline_us = deadline_us
        self._max_deadline_us = max_deadline_us
        self._pipelined = pipelined
        # one service-wide load signal: any lane's flusher holds its batch
        # open while requests are still in host entropy or pixel decode
        self._incoming = IncomingCounter()
        self.batcher = DynamicBatcher(
            # canvas=None: each flush stages on the smallest canvas bucket
            # (256/512/1024) that fits its largest image
            predict_staged=self._predict_resilient,
            stage_batch=lambda imgs: stage_batch(imgs, canvas=None),
            max_batch=max(engine.buckets),
            deadline_us=deadline_us,
            max_deadline_us=max_deadline_us,
            incoming=self._incoming,
            predict_dispatch=self._dispatch_resilient if pipelined else None,
        )
        self.device_decode = bool(device_decode)
        if self.device_decode:
            # no fallback that hides the lane: a decoder that cannot be built
            # fails here, with the compiler's output
            imgcodec.load_entropy()
        # one lane (batcher + step) per (sampling mode, luma bucket), made on
        # first use: 4:2:0/4:2:2/4:4:4/gray x <=512/<=1024 px
        self.coeff_batchers: dict[tuple[str, int], DynamicBatcher] = {}
        # requests inside classify_bytes (decoding, queued or awaiting a
        # flush): the background warm-up waits for this to be 0
        self._inflight = 0
        self._latencies_ms: list[float] = []
        self._device_errors = 0
        self._stats = {"device_decoded": 0, "host_decoded": 0}
        self._started = False
        self._lane_warm_task: Optional[asyncio.Task] = None
        # admission for the requests that bypass the batchers with a batch
        # of 1 (embed): at most 2 in flight, so a burst of them cannot queue
        # unbounded device work ahead of the serving lanes
        self._diag_sem = asyncio.Semaphore(2)

    def _make_coeff_lane(self, mode: str, luma_blocks: int) -> DynamicBatcher:
        def stage(coeff_list):
            staged = stage_coefficient_batch(coeff_list, luma_blocks=luma_blocks, mode=mode)
            if staged is None:  # routed by classify_coefficients upstream
                raise RuntimeError("coefficient batch not stageable")
            return staged, None

        def predict(staged, _):
            return self._predict_coeff_resilient(staged, mode)

        def dispatch(staged, _):
            return self._dispatch_coeff_resilient(staged, mode)

        return DynamicBatcher(
            predict_staged=predict,
            stage_batch=stage,
            max_batch=max(self.engine.buckets),
            deadline_us=self._deadline_us,
            max_deadline_us=self._max_deadline_us,
            incoming=self._incoming,
            predict_dispatch=dispatch if self._pipelined else None,
        )

    async def _get_coeff_lane(self, mode: str, luma_blocks: int) -> DynamicBatcher:
        if not self._started:
            # racing stop(): a lane made now would never get a running
            # flusher and its submits would hang
            raise RuntimeError("batcher stopped before request was served")
        key = (mode, luma_blocks)
        lane = self.coeff_batchers.get(key)
        if lane is None:
            lane = self._make_coeff_lane(mode, luma_blocks)
            await lane.start()
            self.coeff_batchers[key] = lane
        return lane

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
            device_decode=settings.TPU_DEVICE_DECODE,
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

    def _resilient_dispatch(self, dispatch, predict, what: str):
        """Pipelined flavour: the dispatch is retried once inline; a failure
        while resolving falls back to one synchronous retry."""
        resolve = self._retry_once(dispatch, f"{what} dispatch")

        def resolve_resilient():
            try:
                return resolve()
            except Exception:
                self._device_errors += 1
                logger.exception("%s resolve failed; retrying once", what)
                return predict()

        return resolve_resilient

    def _dispatch_resilient(self, canvas, sizes):
        return self._resilient_dispatch(
            lambda: self.engine.predict_staged_async(canvas, sizes),
            lambda: self.engine.predict_staged(canvas, sizes), "device step",
        )

    def _predict_coeff_resilient(self, staged, mode: str):
        return self._retry_once(
            lambda: self.engine.predict_coeff_staged(staged, mode=mode), "device coeff step"
        )

    def _dispatch_coeff_resilient(self, staged, mode: str):
        return self._resilient_dispatch(
            lambda: self.engine.predict_coeff_staged_async(staged, mode=mode),
            lambda: self.engine.predict_coeff_staged(staged, mode=mode), "device coeff step",
        )

    async def start(self, warm: bool = False) -> None:
        if warm:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, self.engine.warmup)
            if self.device_decode:
                # 4:2:0 at 512 px, the dominant JPEG shape, at every batch
                # bucket before the first request; every other lane at the
                # smallest bucket in the background, so boot does not wait
                await loop.run_in_executor(None, self.engine.warmup_coeff)
                self._lane_warm_task = asyncio.ensure_future(self._warm_remaining_lanes())
        await self.batcher.start()
        for lane in self.coeff_batchers.values():
            await lane.start()
        self._started = True

    async def _await_idle_window(self, max_wait_s: float = 120.0) -> None:
        """Wait for ~0.5 s with no request in flight (capped) before a lane's
        warm-up step: the foreground goes first. Under constant load the cap
        lets the warm-up proceed anyway."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + max_wait_s
        idle_checks = 0
        while loop.time() < deadline:
            busy = self._inflight > 0 or self._incoming.value > 0
            idle_checks = 0 if busy else idle_checks + 1
            if idle_checks >= 3:
                return
            await asyncio.sleep(0.25)

    async def _warm_remaining_lanes(self) -> None:
        loop = asyncio.get_running_loop()
        min_bucket = (min(self.engine.buckets),)
        for mode in ("420", "422", "444", "gray"):
            for luma in LUMA_BUCKETS:
                if mode == "420" and luma == 64:
                    continue  # warmed before the first request
                await self._await_idle_window()
                try:
                    await loop.run_in_executor(
                        None, lambda m=mode, lb=luma: self.engine.warmup_coeff(
                            m, lb, buckets=min_bucket))
                except asyncio.CancelledError:  # the service is stopping
                    raise
                except Exception:  # the lane then starts cold on its first flush
                    logger.exception("background warm-up of decode lane %s/%d failed",
                                     mode, luma)
        logger.info("all decode lanes warm")

    async def stop(self) -> None:
        self._started = False
        task = self._lane_warm_task
        if task is not None and not task.done():
            # cancel and detach: a warm-up step already in an executor thread
            # cannot be interrupted, and stop() must not wait for it
            task.cancel()
            task.add_done_callback(lambda t: t.exception() if not t.cancelled() else None)
        await self.batcher.stop()
        for lane in list(self.coeff_batchers.values()):
            await lane.stop()

    async def classify_bytes(self, data: bytes) -> dict:
        self._inflight += 1
        try:
            return await self._classify_bytes(data)
        finally:
            self._inflight -= 1

    async def _classify_bytes(self, data: bytes) -> dict:
        t0 = time.perf_counter()
        loop = asyncio.get_running_loop()
        # announced while decoding: every lane's flusher holds its batch open
        self.batcher.announce()
        announced = True
        decode = "host"
        try:
            if self.device_decode and imgcodec.probe(data) == "jpeg":
                coeffs = await loop.run_in_executor(
                    None, imgcodec.jpeg_coefficients, data, settings.TPU_DECODE_THREADS)
                lane_key = classify_coefficients(coeffs)
                if lane_key is not None:
                    mode, luma_blocks = lane_key
                    lane = await self._get_coeff_lane(mode, luma_blocks)
                    self._stats["device_decoded"] += 1
                    key = f"device_decoded_{mode}_{luma_blocks * 8}px"
                    self._stats[key] = self._stats.get(key, 0) + 1
                    announced = False  # submit() consumes the announcement
                    idx, scores = await lane.submit(coeffs, announced=True)
                    decode = f"device:{mode}"
            if decode == "host":
                self._stats["host_decoded"] += 1
                image = await loop.run_in_executor(None, decode_image, data)
                metrics_registry.histogram(
                    "decode_ms", "host decode latency (ms)",
                    buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50),
                ).observe((time.perf_counter() - t0) * 1000)
                announced = False
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
            "decode": decode,
        }

    async def classify_many(self, blobs: Sequence[bytes]) -> list[dict]:
        return list(await asyncio.gather(*(self.classify_bytes(b) for b in blobs)))

    async def _stage_one(self, data: bytes):
        """Host decode and staging of one image, off the event loop."""
        loop = asyncio.get_running_loop()
        image = await loop.run_in_executor(None, decode_image, data)
        return await loop.run_in_executor(None, lambda: stage_batch([image], canvas=None))

    async def classify_bytes_tta(self, data: bytes) -> dict:
        """Flip-averaged classification (test-time augmentation): steadier
        scores at twice the device work. Asked for per request and rare
        beside plain traffic, so it stages a batch of 1 directly instead of
        holding a batcher lane open."""
        t0 = time.perf_counter()
        canvas, sizes = await self._stage_one(data)
        async with self._diag_sem:
            idx, scores = await asyncio.get_running_loop().run_in_executor(
                None, self.engine.predict_staged_tta, canvas, sizes
            )
        dt_ms = (time.perf_counter() - t0) * 1000
        self._record_latency(dt_ms)
        return {
            "top_classes": [int(i) for i in idx[0]],
            "scores": [float(s) for s in scores[0]],
            "latency_ms": round(dt_ms, 3),
            "model": self.engine.model_name,
            "decode": "host",
            "tta": True,
        }

    async def explain_bytes(self, data: bytes, class_idx: int = -1,
                            smooth_samples: int = 1) -> dict:
        """bytes -> top-k and the input-gradient saliency map of the engine's
        ``explain_staged``. ``class_idx=-1`` explains the model's own top
        class; ``smooth_samples > 1`` averages the gradients of that many
        noisy copies in one batched pass (SmoothGrad). A batch of 1, staged
        directly; decode and the device step run off the event loop."""
        t0 = time.perf_counter()
        canvas, sizes = await self._stage_one(data)
        async with self._diag_sem:
            idx, scores, heat = await asyncio.get_running_loop().run_in_executor(
                None, lambda: self.engine.explain_staged(
                    canvas, sizes, class_idx, smooth_samples=smooth_samples)
            )
        dt_ms = (time.perf_counter() - t0) * 1000
        self._record_latency(dt_ms)
        out = {
            "top_classes": [int(i) for i in idx],
            "scores": [float(s) for s in scores],
            "mapa_saliencia": np.round(heat, 4).tolist(),
            "grade": int(heat.shape[0]),
            "metodo": "smoothgrad" if smooth_samples > 1 else "gradiente-entrada",
            "latency_ms": round(dt_ms, 3),
            "model": self.engine.model_name,
        }
        if smooth_samples > 1:
            # the sample count the engine used
            out["suavizacao"] = self.engine.quantize_smooth(smooth_samples)
        return out

    async def embed_bytes(self, data: bytes) -> np.ndarray:
        """bytes -> L2-normalized backbone embedding [D] float32.

        Similarity queries are rare next to classification traffic, so this
        stages a batch of 1 directly (no batcher lane); decode and the device
        step both run off the event loop."""
        canvas, sizes = await self._stage_one(data)
        async with self._diag_sem:
            feats = await asyncio.get_running_loop().run_in_executor(
                None, self.engine.embed_staged, canvas, sizes
            )
        return feats[0]

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
            "coeff_lanes": {
                f"{mode}_{lb * 8}px": lane.stats
                for (mode, lb), lane in self.coeff_batchers.items()
            },
            "device_errors": self._device_errors,
            "device_decode": self.device_decode,
            # scans of this process's JPEGs decoded on TPU_DECODE_THREADS threads
            "entropy_threaded_scans": imgcodec.threaded_scans() if self.device_decode else 0,
            "decode_lanes_warming": (self._lane_warm_task is not None
                                     and not self._lane_warm_task.done()),
            **self._stats,
        }


async def _drain_and_stop(service: InferenceService, grace_s: float = 30.0,
                          hurry: Optional[asyncio.Event] = None) -> None:
    """Stop an evicted service once its work in flight has drained (at most
    ``grace_s``): stopping at once would fail the futures that requests are
    awaiting. Idle is ``_inflight`` (a request's whole life: decode, any
    lane's queue, the flush) and no lane's resolve still running; ``hurry``
    (the pool's shutdown) cuts the wait short."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + grace_s
    batchers = [service.batcher, *service.coeff_batchers.values()]
    while loop.time() < deadline and not (hurry and hurry.is_set()):
        busy = service._inflight > 0 or service._incoming.value > 0 or any(
            not t.done() for b in batchers for t in b._resolve_tasks)
        if not busy:
            break
        await asyncio.sleep(0.25)
    await service.stop()
    logger.info("stopped evicted service of %s", service.engine.model_name)


class InferenceServicePool:
    """Per-model services created on first use; the default model serves
    ``/inferencia/classificar`` without ``?modelo=``, and trained versions
    serve ``classificar-tpu`` and ``explicar`` (``get_trained``)."""

    def __init__(self, default_model: str, deadline_us: int = 2000,
                 max_deadline_us: int = 50_000, pipelined: bool = True,
                 device_decode: bool = True, **engine_kwargs):
        self.default_model = default_model
        self.device_decode = device_decode
        self.deadline_us = deadline_us
        self.max_deadline_us = max_deadline_us
        self.pipelined = pipelined
        self.engine_kwargs = engine_kwargs
        self._services: dict[str, InferenceService] = {}
        # one lock per key: a cold build of one model must not hold up another
        self._locks: dict[str, asyncio.Lock] = {}
        self._stopped = False
        # the eviction drains: held here (the loop holds tasks weakly) and
        # hurried and awaited by stop()
        self._drain_tasks: set = set()
        self._hurry = asyncio.Event()

    def add(self, name: str, service: InferenceService) -> None:
        """Register an already started service (the default model's)."""
        self._services[name] = service

    def built(self, model_name: str) -> Optional[InferenceService]:
        """The service of ``model_name`` if it has been built, else None."""
        return self._services.get(model_name)

    def _build_service(self, make_engine) -> InferenceService:
        """A service around ``make_engine(engine_kwargs)``, the pool's settings."""
        return InferenceService(
            make_engine(dict(self.engine_kwargs)), deadline_us=self.deadline_us,
            max_deadline_us=self.max_deadline_us, pipelined=self.pipelined,
            device_decode=self.device_decode,
        )

    async def _register(self, key: str, service: InferenceService) -> InferenceService:
        """Insert a service that was built and started, unless the pool
        stopped while the build ran: then stop it instead."""
        if self._stopped:
            await service.stop()
            raise RuntimeError("pool de inferência encerrado")
        self._services[key] = service
        return service

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
            # weight init and the copy to the device block: off the event loop
            service = await asyncio.get_running_loop().run_in_executor(
                None, lambda: self._build_service(
                    lambda kw: InferenceEngine(model_name=name, **kw)))
            await service.start()
            return await self._register(name, service)

    async def get_trained(self, modelo_row) -> InferenceService:
        """The service of a registered version (a ``modelos_treinados`` row):
        its weights restored from the port's checkpoint in
        ``dir_checkpoint``, the class count and multi-label scoring from the
        row, the calibrated temperature folded into the head unless the model
        is multi-label. Keyed by (ambiente, version, model id), so promoting a
        version swaps services; the older versions of the ambiente are evicted
        and stopped in the background once drained (a request still holding a
        demoted row never evicts a newer version). A version the JAX trainer
        wrote (orbax steps alone) raises ``UnconvertedCheckpointError``, which
        names the conversion tool; the routes answer it with a 503."""
        key = f"trained:{modelo_row.id_amb}:{modelo_row.versao}:{modelo_row.id_mod}"
        service = self._services.get(key)
        if service is not None:
            return service
        if self._stopped:
            raise RuntimeError("pool de inferência encerrado")
        async with self._locks.setdefault(key, asyncio.Lock()):
            service = self._services.get(key)
            if service is not None:
                return service
            metricas = modelo_row.metricas or {}
            multi_label = bool(metricas.get("multi_rotulo"))

            def build() -> InferenceService:
                from ics_tpu_torch.train.checkpoint import CheckpointManager
                from ics_tpu_torch.train.finetune import fold_temperature

                mgr = CheckpointManager(modelo_row.dir_checkpoint)
                try:
                    state_dict = mgr.restore()["state_dict"]
                finally:
                    mgr.close()
                if not multi_label:
                    state_dict = fold_temperature(state_dict, metricas.get("temperatura"))

                def make_engine(kw):
                    kw.update(num_classes=modelo_row.num_classes, multi_label=multi_label)
                    return InferenceEngine(model_name=modelo_row.nome_modelo,
                                           state_dict=state_dict, **kw)

                return self._build_service(make_engine)

            try:
                service = await asyncio.get_running_loop().run_in_executor(None, build)
            except UnconvertedCheckpointError as exc:
                _warn_once(key, f"{key} cannot be served: {exc}")
                raise
            await service.start()
            service = await self._register(key, service)
            prefix = f"trained:{modelo_row.id_amb}:"
            for k in list(self._services):
                if k.startswith(prefix) and k != key and int(k.split(":")[2]) < modelo_row.versao:
                    logger.info("evicted %s: version %d serves", k, modelo_row.versao)
                    task = asyncio.ensure_future(
                        _drain_and_stop(self._services.pop(k), hurry=self._hurry))
                    self._drain_tasks.add(task)
                    task.add_done_callback(self._drain_tasks.discard)
            return service

    async def stop(self) -> None:
        # the flag first: a build that ends after this stops itself in
        # _register; the dict is swapped out before the first await
        self._stopped = True
        self._hurry.set()
        services, self._services = dict(self._services), {}
        for service in services.values():
            await service.stop()
        if self._drain_tasks:
            await asyncio.gather(*list(self._drain_tasks), return_exceptions=True)
