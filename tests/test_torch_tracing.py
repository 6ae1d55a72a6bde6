"""The serving path's spans, waits and counters (``utils.metrics``), the
engine's step clock, the service's latency histogram and
``tools.profile_step``'s busy time, on the CPU."""

import asyncio
import io
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image, ImageFilter

from ics_tpu_torch.runtime.device_decode import STAGED_KEYS, stage_coefficient_batch
from ics_tpu_torch.runtime.engine import InferenceEngine, StepClock
from ics_tpu_torch.runtime.service import LATENCY_BUCKETS, InferenceService, latency_summary
from ics_tpu_torch.tools.profile_step import union_length
from ics_tpu_torch.utils import metrics
from ics_tpu_torch.utils.metrics import Histogram, registry, span, waited


def jpeg(seed: int) -> bytes:
    """A blurred 80x96 4:2:0 JPEG: the 512-px device-decode lane."""
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (80, 96, 3), np.uint8)).filter(
        ImageFilter.GaussianBlur(1))
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=90, subsampling=2)
    return buf.getvalue()


# every histogram and counter a served device-decode flush writes, and how
# many times: once a request or once a flush
PER_REQUEST = ("entropy_wait_ms", "entropy_decode_ms")
PER_FLUSH = ("dispatch_wait_ms", "dispatch_ms", "stage_ms", "copy_ms", "launch_ms",
             "resolve_wait_ms", "resolve_ms", "step_device_ms")


def _count(name: str) -> float:
    m = registry._metrics.get(name)
    if m is None:
        return 0
    return m.count if isinstance(m, Histogram) else m.value


def test_a_span_observes_its_histogram():
    before = _count("tracing_probe_ms")
    with span("tracing_probe"):
        time.sleep(0.01)
    hist = registry._metrics["tracing_probe_ms"]
    assert hist.count == before + 1 and hist.sum >= 10.0


def test_under_the_profiler_a_span_is_a_host_event_between_two_markers():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("marker.open"):
            pass
        with span("tracing_traced", lane="420/512px", images=3):
            time.sleep(0.002)
        with torch.profiler.record_function("marker.close"):
            pass
    events = {e.name: e for e in prof.events()}
    inner = events["ics.tracing_traced"]
    assert (events["marker.open"].time_range.end <= inner.time_range.start
            <= inner.time_range.end <= events["marker.close"].time_range.start)
    assert inner.time_range.elapsed_us() >= 2000


def test_with_the_profiler_off_a_span_never_enters_record_function(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a) or pytest.fail("entered"))
    assert not metrics.profiling()
    with span("tracing_off"):
        pass
    assert entered == [] and _count("tracing_off_ms") >= 1


def test_a_wait_across_an_executor_hand_off_holds_the_work_queued_ahead():
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        pool.submit(time.sleep, 0.05)               # the one worker is busy
        handed = time.perf_counter()
        before = registry.histogram("tracing_wait_ms", buckets=metrics.SPAN_BUCKETS).sum
        pool.submit(waited, "tracing_wait", handed).result()
    finally:
        pool.shutdown()
    assert registry._metrics["tracing_wait_ms"].sum - before >= 50.0 * 0.95


@pytest.mark.anyio
async def test_one_device_decode_flush_counts_each_span_and_counter_once():
    engine = InferenceEngine("resnet_tiny", num_classes=8, precision="fp32", buckets=(1, 4),
                             canvas=64, device="cpu")
    engine.warmup_coeff("420", 64, buckets=(4,))     # the flush's step is no compile
    service = InferenceService(engine, deadline_us=20_000)
    await service.start()
    blobs = [jpeg(seed) for seed in range(3)]
    names = PER_REQUEST + PER_FLUSH + ("copy_bytes", "dispatched_images", "resolved_images",
                                       "pad_ms", "pinned_flushes", "pipelined_flushes")
    before = {n: _count(n) for n in names}
    bytes_before = _count("copy_bytes")
    try:
        outs = await asyncio.gather(*(service.classify_bytes(b) for b in blobs))
    finally:
        await service.stop()
    assert [o["decode"] for o in outs] == ["device:420"] * 3
    assert service.coeff_batchers[("420", 64)].stats["flushes"] == 1
    grew = {n: _count(n) - before[n] for n in names if n != "copy_bytes"}
    # staged in a slot at the bucket: no padding, and on the CPU the slot is
    # not page-locked, so the flush is not counted as pinned; it had nothing
    # before it to overlap
    assert grew == {**{n: 3 for n in PER_REQUEST}, **{n: 1 for n in PER_FLUSH},
                    "dispatched_images": 3, "resolved_images": 3, "pad_ms": 0,
                    "pinned_flushes": 0, "pipelined_flushes": 0}
    # the bytes the copy was handed: the staged arrays padded to bucket 4
    from ics_tpu_torch.native import imgcodec

    staged = stage_coefficient_batch([imgcodec.jpeg_coefficients(b) for b in blobs],
                                     luma_blocks=64, mode="420")
    padded = sum(staged[k].nbytes // 3 * 4 for k in STAGED_KEYS)
    assert _count("copy_bytes") - bytes_before == padded
    status = service.status()
    assert status["device_clock"] == "host" and "total_device_ms" not in status
    assert status["batches"] == 1 and status["avg_device_ms"] == status["device_ms"] > 0
    assert status["latency"]["n"] == 3


@pytest.mark.anyio
async def test_the_pipelined_flushes_counter_follows_the_batchers_count():
    from ics_tpu_torch.runtime.batcher import DynamicBatcher

    def dispatch(images, _):
        def resolve():
            time.sleep(0.02)                        # the next flush dispatches meanwhile
            return np.zeros((len(images), 5), np.int64), np.zeros((len(images), 5), np.float32)
        return resolve

    batcher = DynamicBatcher(predict_staged=None, stage_batch=lambda images: (images, None),
                             max_batch=4, deadline_us=500, predict_dispatch=dispatch)
    before = _count("pipelined_flushes")
    await batcher.start()
    try:
        await asyncio.gather(*(batcher.submit(np.zeros((2, 2, 3), np.uint8)) for _ in range(24)))
    finally:
        await batcher.stop()
    assert batcher.stats["pipelined"] >= 1
    assert _count("pipelined_flushes") - before == batcher.stats["pipelined"]


def test_the_engine_keeps_warm_up_and_compiles_out_of_its_step_time():
    engine = InferenceEngine("resnet_tiny", num_classes=8, precision="fp32", buckets=(1,),
                             canvas=64, device="cpu")
    assert engine.status()["avg_device_ms"] is None
    before = _count("resolved_images")
    engine.warmup_coeff("420", 64)
    canvas = np.zeros((1, 64, 64, 3), np.uint8)
    sizes = np.full((1, 2), 64, np.int32)
    engine.predict_staged(canvas, sizes)             # the first call on a shape: a compile
    assert engine.status()["device_ms"] == 0.0 and _count("resolved_images") == before
    engine.predict_staged(canvas, sizes)
    status = engine.status()
    assert status["compiles"] == 1 and status["batches"] == 2
    assert status["avg_device_ms"] == status["device_ms"] > 0
    assert _count("resolved_images") == before + 1


def test_the_step_clock_credits_each_moment_of_the_stream_once():
    clock = StepClock(torch.device("cpu"))
    # two lanes on one stream: a step starts inside another and ends after
    # it, and the steps are fetched out of order
    steps = [(10.0, 50.0), (0.0, 20.0), (40.0, 70.0), (80.0, 90.0), (85.0, 88.0)]
    credits = [clock.credit(a, b) for a, b in steps]
    assert credits == [40.0, 10.0, 20.0, 10.0, 0.0]
    assert sum(credits) == union_length(steps) == 80.0
    clock.credit(100_000.0, 100_001.0)              # cover older than the horizon goes
    assert clock._covered == [(80.0, 90.0), (100_000.0, 100_001.0)]
    rng = np.random.default_rng(7)
    clock = StepClock(torch.device("cpu"))
    starts = np.arange(500) * 10.0 + rng.uniform(-30, 30, 500)
    steps = [(float(a), float(a + w)) for a, w in zip(starts, rng.uniform(0, 40, 500))]
    assert sum(clock.credit(a, b) for a, b in steps) == pytest.approx(union_length(steps))


def test_the_latency_histogram_reads_p50_and_p99_within_five_percent():
    rng = np.random.default_rng(20)
    for sample in (rng.lognormal(3.0, 1.0, 5000), rng.exponential(40.0, 800) + 5.0,
                   rng.uniform(18.0, 90.0, 300)):
        hist = Histogram("classify_latency_ms", buckets=LATENCY_BUCKETS)
        for v in sample:
            hist.observe(float(v))
        got = latency_summary([hist])
        assert got["n"] == len(sample)
        for q, key in ((50, "p50_ms"), (99, "p99_ms")):
            exact = float(np.percentile(sample, q))
            assert abs(got[key] - exact) <= 0.05 * exact, (key, got[key], exact)
    assert latency_summary([Histogram("empty", buckets=LATENCY_BUCKETS)]) == {}


def test_the_latency_record_keeps_every_request():
    service = InferenceService.__new__(InferenceService)
    service.latency = Histogram("classify_latency_ms", buckets=LATENCY_BUCKETS)
    for i in range(12_000):
        service._record_latency(1.0 + (i % 100))
    assert service.latency_percentiles()["n"] == 12_000


def test_histograms_of_two_replicas_merge():
    a, b = (Histogram("x", buckets=(1, 10)) for _ in range(2))
    a.observe(0.5)
    b.observe(5.0)
    b.observe(50.0)
    a.merge(b)
    assert (a.count, a.sum, a._counts) == (3, 55.5, [1, 1, 1])
    with pytest.raises(ValueError):
        a.merge(Histogram("y", buckets=(1, 2)))


def test_profile_step_counts_overlapping_kernels_once():
    assert union_length([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert union_length([(3, 4), (0, 1)]) == 2 and union_length([]) == 0
