"""Dynamic request batcher.

Concurrent classify requests are coalesced into padded fixed-shape batches
sharing one device step (north star: "dynamic request batching so
concurrent API calls share one XLA-compiled step").

Design: an asyncio queue + a single flusher task. A flush fires when either
(a) the oldest queued request has waited ``deadline_us`` or (b) a full
largest-bucket batch is ready. Device work runs in a worker thread so the
event loop (and therefore host CRUD latency) never blocks on the device —
SURVEY.md §7.2 hard-part 5.

Each flush is timed into the registry (``utils.metrics``): ``dispatch_wait``,
from the hand-off of its stage-and-dispatch to the executor until a worker
starts it; the span ``dispatch`` around the whole of it, with ``stage``
around the staging inside (the engine adds ``copy`` and ``launch``, and
``pad`` on the pixel lane); ``resolve_wait`` and the span ``resolve`` for
the fetch. Without pipelining, ``dispatch`` holds the fetch too. A flush
dispatched while an earlier one of the lane is unresolved counts in
``stats["pipelined"]`` and in the registry's ``pipelined_flushes``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from ics_tpu_torch.utils.metrics import registry, span, waited

logger = logging.getLogger(__name__)

PIPELINED_FLUSHES = ("pipelined_flushes",
                     "flushes dispatched while an earlier flush of their lane was unresolved")


@dataclass
class _Pending:
    image: np.ndarray                       # decoded uint8 HWC
    future: asyncio.Future = None           # resolves to (idx, scores)
    enqueued_at: float = field(default_factory=time.perf_counter)
    # True once the batch holding this request was handed to a resolve
    # task (pipelined flush) — its fate then belongs to that task, not
    # to the flusher's cancellation handler
    dispatched: bool = False


class IncomingCounter:
    """Announced-but-not-yet-submitted request count. Shareable across the
    batchers of one service so every lane's flusher sees service-wide load
    (a request in host decode may land on any lane)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0


class DynamicBatcher:
    def __init__(
        self,
        predict_staged: Callable[[np.ndarray, np.ndarray], tuple],
        stage_batch: Callable,
        max_batch: int = 128,
        deadline_us: int = 2000,
        max_deadline_us: int = 50_000,
        incoming: Optional[IncomingCounter] = None,
        predict_dispatch: Optional[Callable] = None,
        lane: str = "pixel",
    ):
        self.predict_staged = predict_staged
        self.lane = lane                # named in the profiler's args of a flush's spans
        self.stage_batch = stage_batch
        self.max_batch = max_batch
        self.deadline_s = deadline_us / 1e6
        # adaptive extension cap: with ANNOUNCED requests still in their
        # host-decode phase, the flusher may wait up to this long for them.
        # Under closed-loop load the fixed deadline alone collapses to
        # batch-of-1 (docs/benchmarks.md r1 measurement): arrivals are
        # staggered by serialized host decode, so each flush catches one.
        self.max_deadline_s = max(max_deadline_us, deadline_us) / 1e6
        self._queue: asyncio.Queue[_Pending] = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._stopping = False
        self._incoming_counter = incoming or IncomingCounter()
        # two-deep pipelined flush (SURVEY §7 step 8 "H2D overlap"):
        # predict_dispatch(canvas, sizes) -> zero-arg resolver. When set,
        # each dispatched batch gets its own RESOLVE TASK immediately (the
        # blocking D2H fetch rides an executor thread and completes the
        # moment device compute does), while the flusher already collects,
        # stages and H2D-enqueues the NEXT batch. Depth is bounded at two:
        # before a third dispatch the oldest resolve is awaited, so device
        # work and parked host batches can't pile up unboundedly. A lone
        # batch resolves as soon as its compute finishes — sparse-traffic
        # latency is unchanged, and a finished batch's latency is never
        # coupled to the next batch's coalescing window.
        self.predict_dispatch = predict_dispatch
        self._resolve_tasks: list[asyncio.Task] = []
        self.stats = {"flushes": 0, "queued": 0, "max_batch_seen": 0,
                      "pipelined": 0}
        registry.counter(*PIPELINED_FLUSHES)    # the registry's mirror of "pipelined", from 0

    @property
    def _incoming(self) -> int:
        return self._incoming_counter.value

    def announce(self) -> None:
        """A request exists but hasn't reached submit() yet (host decode in
        flight). The flusher extends its coalescing window while any are
        outstanding — that's the load signal fixed deadlines lack."""
        self._incoming_counter.value += 1

    def retract(self) -> None:
        self._incoming_counter.value = max(0, self._incoming_counter.value - 1)

    async def start(self) -> None:
        if self._task is None:
            self._stopping = False
            self._task = asyncio.ensure_future(self._flusher())

    async def stop(self) -> None:
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # outstanding resolve tasks: give them a brief chance to finish
        # (results may already be on their way back), then cancel — the
        # _resolve_batch CancelledError handler fails their futures
        if self._resolve_tasks:
            tasks, self._resolve_tasks = list(self._resolve_tasks), []
            done, pending = await asyncio.wait(tasks, timeout=1.0)
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.wait(pending)
        # fail anything still queued so callers don't await forever
        while not self._queue.empty():
            pending = self._queue.get_nowait()
            if not pending.future.done():
                pending.future.set_exception(
                    RuntimeError("batcher stopped before request was served")
                )

    async def submit(
        self, image: np.ndarray, announced: bool = False
    ) -> tuple[np.ndarray, np.ndarray]:
        if self._stopping:
            # a submit racing stop() would enqueue AFTER the drain loop
            # already failed the queue — that future never resolves and
            # the client connection hangs forever (self-review r3)
            if announced:
                self.retract()
            raise RuntimeError("batcher stopped before request was served")
        loop = asyncio.get_running_loop()
        pending = _Pending(image=image, future=loop.create_future())
        self.stats["queued"] += 1
        await self._queue.put(pending)
        if announced:
            # retract AFTER the put: the item is visible to the flusher
            # before the incoming count drops, so no window where neither
            # signal holds the batch open
            self.retract()
        return await pending.future

    async def _flusher(self) -> None:
        while not self._stopping:
            first = await self._queue.get()
            batch = [first]
            try:
                # drain whatever is already queued (requests that piled up
                # during the previous flush) — without this, sustained load
                # collapses to batch-of-1 because the head is always older
                # than the deadline
                while len(batch) < self.max_batch and not self._queue.empty():
                    batch.append(self._queue.get_nowait())
                # then coalesce new arrivals until deadline or full batch;
                # while ANNOUNCED requests are still decoding, the window
                # extends (bounded by max_deadline) so staggered closed-loop
                # arrivals coalesce instead of flushing one-by-one
                deadline = first.enqueued_at + self.deadline_s
                hard_deadline = first.enqueued_at + self.max_deadline_s
                while len(batch) < self.max_batch:
                    now = time.perf_counter()
                    limit = hard_deadline if self._incoming > 0 else deadline
                    timeout = limit - now
                    if timeout <= 0:
                        break
                    try:
                        nxt = await asyncio.wait_for(
                            self._queue.get(),
                            # short poll while extended, so the window
                            # re-shrinks as soon as _incoming drains
                            min(timeout, 0.002) if self._incoming else timeout,
                        )
                        batch.append(nxt)
                    except asyncio.TimeoutError:
                        # a request put while this poll timed out stays in
                        # the queue with its announcement already retracted:
                        # take it before reading _incoming, or it waits for
                        # the next flush
                        while len(batch) < self.max_batch and not self._queue.empty():
                            batch.append(self._queue.get_nowait())
                        if self._incoming > 0 and limit - time.perf_counter() > 0:
                            continue
                        break
                await self._flush(batch)
            except asyncio.CancelledError:
                # a batch already handed to its own resolve task is NOT
                # failed here — its resolve may still complete within
                # stop()'s grace window (stop() cancels stragglers, whose
                # handler fails any remaining futures)
                for p in batch:
                    if not p.future.done() and not p.dispatched:
                        p.future.set_exception(
                            RuntimeError("batcher stopped mid-flight")
                        )
                raise
            except Exception as exc:
                # the flusher must never die: fail this batch, keep serving
                logger.exception("flusher iteration failed")
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(exc)

    async def _flush(self, batch: list[_Pending]) -> None:
        self.stats["flushes"] += 1
        self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], len(batch))
        registry.histogram(
            "batch_occupancy", "images per flushed batch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128),
        ).observe(len(batch))
        queue_ms = (time.perf_counter() - batch[0].enqueued_at) * 1000
        registry.histogram(
            "batch_queue_ms", "oldest-request queue wait (ms)"
        ).observe(queue_ms)
        loop = asyncio.get_running_loop()
        images = [p.image for p in batch]

        if self.predict_dispatch is not None:
            # pipelined: stage + H2D + enqueue compute off the event loop,
            # then hand the batch to its own resolve task — the blocking
            # D2H fetch rides an executor thread and completes the moment
            # device compute does, while this flusher already collects and
            # dispatches the NEXT batch (its staging/H2D overlaps this
            # one's compute).
            def stage_and_dispatch():
                waited("dispatch_wait", handed)
                with span("dispatch", lane=self.lane, images=len(images)):
                    with span("stage"):
                        canvas, sizes = self.stage_batch(images)
                    return self.predict_dispatch(canvas, sizes)

            try:
                handed = time.perf_counter()
                resolve = await loop.run_in_executor(None, stage_and_dispatch)
            except Exception as exc:
                logger.exception("batch dispatch failed")
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(exc)
                return
            self._resolve_tasks = [
                t for t in self._resolve_tasks if not t.done()
            ]
            if self._resolve_tasks:
                # a prior batch is still computing/fetching while this one
                # was staged + dispatched: that's the overlap working
                self.stats["pipelined"] += 1
                registry.counter(*PIPELINED_FLUSHES).inc()
            for p in batch:
                p.dispatched = True
            self._resolve_tasks.append(
                asyncio.ensure_future(self._resolve_batch((batch, resolve)))
            )
            # depth bound (two-deep): never let a third batch start
            # collecting while two are still unresolved — device work and
            # parked host batches must not pile up unboundedly
            while len(self._resolve_tasks) > 1:
                oldest = self._resolve_tasks.pop(0)
                await oldest
            return

        try:
            # staging (numpy canvas assembly) AND device work run off the
            # event loop — host CRUD latency must never couple to either
            def stage_and_predict():
                waited("dispatch_wait", handed)
                with span("dispatch", lane=self.lane, images=len(images)):
                    with span("stage"):
                        canvas, sizes = self.stage_batch(images)
                    return self.predict_staged(canvas, sizes)

            handed = time.perf_counter()
            idx, scores = await loop.run_in_executor(None, stage_and_predict)
            for i, p in enumerate(batch):
                if not p.future.done():
                    p.future.set_result((idx[i], scores[i]))
        except Exception as exc:
            logger.exception("batch flush failed")
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(exc)

    async def _resolve_batch(self, parked: tuple[list, Callable]) -> None:
        batch, resolve = parked
        loop = asyncio.get_running_loop()

        def timed_resolve():
            waited("resolve_wait", handed)
            with span("resolve"):
                return resolve()

        try:
            # the D2H fetch blocks until device compute finishes — off-loop
            handed = time.perf_counter()
            idx, scores = await loop.run_in_executor(None, timed_resolve)
            for i, p in enumerate(batch):
                if not p.future.done():
                    p.future.set_result((idx[i], scores[i]))
        except asyncio.CancelledError:
            # stop() cancelled this resolve task: fail the batch's futures
            # here or their clients hang forever
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(
                        RuntimeError("batcher stopped mid-flight")
                    )
            raise
        except Exception as exc:
            logger.exception("batch resolve failed")
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(exc)
