"""The classify entry: the program's in-process service
(``InferenceService.classify_bytes``: no HTTP), driven by the traffic's
loop with seeded JPEGs, and judged by ``chipbench.correct``.

Set-up makes the traffic's images and the weights from the seed (with the
plain reference's data-dependent start, timed apart as ``reference_s``),
builds the service that the configuration's ``TPU_*`` settings describe
with those weights, and warms the 4:2:0 decode lanes that the images take
at the buckets that the traffic file's ``warm_buckets`` lists: the
buckets its flushes reach. A traced run warms every bucket, because the
profiler slows the host and the queue then fills flushes up to the
largest. Every thread of the loop's default executor, where the service
dispatches its flushes, runs one decode step too: a thread's first CUDA
work makes its cuBLAS and cuDNN handles, some 100 ms that would otherwise
land inside the window.
"""

from __future__ import annotations

import gc
import math
import os
import threading
import time
from typing import Awaitable, Callable, Optional

from chipbench import correct, load, scenes, trace, weights


def luma_lanes(traffic: dict, seed: int) -> list[int]:
    """The 4:2:0 luma buckets (in 8x8 blocks) the traffic's images take:
    an image of up to 512 px a side stages on 64 blocks, of up to 1024 on 128."""
    lanes = set()
    for h, w in scenes.image_sizes(traffic["images"], seed):
        blocks = 2 * math.ceil(max(h, w) / 16)
        lanes.add(64 if blocks <= 64 else 128)
    return sorted(lanes)


class Probe:
    """The harness's spans around the program's calls in a traced run: each
    decode step's dispatch (with its flush's bucket) and each entropy
    decode, on ``time.time_ns`` (the profiler's clock)."""

    def __init__(self, service) -> None:
        self.spans: list[trace.Span] = []
        self._lock = threading.Lock()
        engine = service.engine
        dispatch = engine.predict_coeff_staged_async

        def traced_dispatch(staged, mode="420", record=True):
            n = staged["y"].shape[0]
            t0 = time.time_ns()
            try:
                return dispatch(staged, mode, record)
            finally:
                self._add(trace.Span(f"dispatch {mode}/{staged['y'].shape[1] * 8}px",
                                     t0, time.time_ns(), threading.get_native_id(),
                                     bucket=engine.bucket_for(n)))

        engine.predict_coeff_staged_async = traced_dispatch
        from ics_tpu_torch.native import imgcodec
        self._imgcodec = imgcodec
        self._entropy = imgcodec.jpeg_coefficients

        def traced_entropy(data, threads=1):
            t0 = time.time_ns()
            try:
                return self._entropy(data, threads)
            finally:
                self._add(trace.Span("entropy decode", t0, time.time_ns(),
                                     threading.get_native_id()))

        imgcodec.jpeg_coefficients = traced_entropy

    def _add(self, span: trace.Span) -> None:
        with self._lock:
            self.spans.append(span)

    def remove(self) -> None:
        self._imgcodec.jpeg_coefficients = self._entropy


class Session:
    """One run's system under test, from set-up to the check."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, warm_all: bool = False,
                 hook: Optional[Callable] = None) -> None:
        import torch

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.blobs = scenes.make_images(traffic["images"], seed)
        self.lanes = luma_lanes(traffic, seed)
        self.weights = weights.Weights(config, seed, device)
        t0 = time.perf_counter()
        self.weights.calibrate(self.blobs)
        if device != "cpu":
            torch.cuda.synchronize()
        self.reference_s = time.perf_counter() - t0
        from ics_tpu_torch.core.config import reload_settings
        from ics_tpu_torch.runtime.service import InferenceService

        reload_settings()       # this configuration's TPU_*, also in a process's second run
        self.service = InferenceService.from_settings(state_dict=self.weights.state_dict(),
                                                      device=device)
        self.weights.to_host()
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        engine = self.service.engine
        self.buckets = [b for b in engine.buckets if warm_all or b in traffic["warm_buckets"]]
        if hook is not None:
            hook(self.service)

    async def start(self) -> None:
        """Warm the traffic's lanes at its buckets and every executor thread,
        then start the service without its own warm-up."""
        import asyncio

        engine = self.service.engine
        for luma in self.lanes:
            engine.warmup_coeff("420", luma, self.buckets)
        loop = asyncio.get_running_loop()
        workers = min(32, (os.cpu_count() or 1) + 4)        # ThreadPoolExecutor's default
        barrier = threading.Barrier(workers, timeout=60)

        def one() -> None:                  # the barrier gives each of the pool's threads one
            try:
                barrier.wait()
            except threading.BrokenBarrierError:
                pass
            for luma in self.lanes:
                engine.warmup_coeff("420", luma, (min(engine.buckets),))

        await asyncio.gather(*(loop.run_in_executor(None, one) for _ in range(workers)))
        await self.service.start(warm=False)

    async def drive(self, seconds: float, seed: int,
                    on_open: Optional[Callable[[float], Awaitable]] = None,
                    traffic: Optional[dict] = None) -> load.Window:
        traffic = traffic or self.traffic
        return await load.loop(traffic["loop"]).run(self.service.classify_bytes, self.blobs,
                                                    traffic, seconds, seed, on_open=on_open)

    def counters(self) -> dict:
        """``queued`` and ``flushes`` summed over every batcher of the service,
        and the sum and count of the ``batch_queue_ms`` histogram."""
        from ics_tpu_torch.utils.metrics import registry

        batchers = [self.service.batcher, *self.service.coeff_batchers.values()]
        hist = registry.histogram("batch_queue_ms", "oldest-request queue wait (ms)")
        return {
            "queued": sum(b.stats["queued"] for b in batchers),
            "flushes": sum(b.stats["flushes"] for b in batchers),
            "queue_ms_sum": hist._sum, "queue_ms_count": hist._total,
        }

    def probe(self) -> Probe:
        return Probe(self.service)

    def status(self) -> str:
        s = self.service.status()
        return (f"batcher {s['batcher']}, lanes {s['coeff_lanes']}, "
                f"kernels {s['kernel_launches']}")

    async def stop(self) -> None:
        await self.service.stop()

    def describe(self, window: load.Window) -> str:
        """Answers a second of the window and its slowest requests."""
        per_s = [0] * max(1, math.ceil(window.end - window.start))
        for r in window.requests:
            if r.ok and window.start <= r.done < window.end:
                per_s[int(r.done - window.start)] += 1
        slowest = sorted((r for r in window.in_window() if r.ok), key=lambda r: r.due - r.done)[:8]
        rows = [(round(r.due - window.start, 2), round((r.done - r.due) * 1e3, 1),
                 len(self.blobs[r.image])) for r in slowest]
        return f"answers a second: {per_s}; slowest (due s, ms, bytes): {rows}"

    def close(self) -> None:
        """Free the program before the reference runs."""
        import torch

        del self.service
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def check(self, limits: dict, window: load.Window, control: bool = False,
              record: bool = False) -> tuple[dict, Optional[dict]]:
        host_decoded = sum(1 for r in window.in_window()
                           if r.ok and not str(r.answer.get("decode", "")).startswith("device"))
        return correct.check(self.config, limits, self.weights, self.blobs, window, self.seed,
                             self.device, host_decoded, control=control, record=record)
