"""The coefficient lanes' reused host staging slots
(``runtime.device_decode.StagingSlot``, ``StagingPool``), on the CPU.

A slot restaged flush after flush holds, in the rows a flush copies, the
bytes that the JAX package's fresh staging of the same images holds, padded
to the bucket as the engine padded it before slots (zero rows, zero tables,
sizes 64): over flushes whose images grow and shrink, in every sampling
mode, at buckets below the slot's rows. The engine answers a flush staged in
a slot as it answers the same batch staged fresh; a pool waits for a held
slot and counts the wait; a failed resolve's retry reads the slot's bytes
unchanged while the lane's next flush waits for the slot; the lanes take
turns to enqueue; no slot goes to two flushes at once under contention. The
normalize constants are made once a device, with the bits the step computed
before.
"""

import asyncio
import io
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image, ImageFilter

from ics_tpu.native import imgcodec as ref_codec
from ics_tpu.runtime import device_decode as ref
from ics_tpu_torch.native import imgcodec
from ics_tpu_torch.ops import preproc
from ics_tpu_torch.runtime import device_decode as port
from ics_tpu_torch.runtime.engine import InferenceEngine
from ics_tpu_torch.runtime.service import InferenceService
from ics_tpu_torch.utils.metrics import registry

pytestmark = pytest.mark.skipif(not ref_codec.available(), reason="native imgcodec not built")

SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


def jpeg(seed, h, w, mode="420") -> bytes:
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).filter(
        ImageFilter.GaussianBlur(1))
    buf = io.BytesIO()
    if mode == "gray":
        img.convert("L").save(buf, "JPEG", quality=90)
    else:
        img.save(buf, "JPEG", quality=90, subsampling=SUBSAMPLING[mode])
    return buf.getvalue()


def coefficients(seed, h, w, mode="420"):
    return imgcodec.jpeg_coefficients(jpeg(seed, h, w, mode))


def padded_reference(batch, luma_blocks, mode, rows):
    """The JAX package's staging of ``batch``, padded to ``rows`` as the
    engine padded a staged batch before it staged into slots."""
    staged = ref.stage_coefficient_batch(batch, luma_blocks=luma_blocks, mode=mode)
    n = len(batch)
    staged = {k: np.concatenate([v, np.zeros((rows - n, *v.shape[1:]), v.dtype)])
              for k, v in staged.items()}
    staged["sizes"][n:] = 64
    return staged


def _count(name: str) -> float:
    m = registry.get(name)
    return 0 if m is None else m.value


# (images, rows) a flush: images that grow and shrink on both axes, chroma
# that ends inside the canvas and at its edge, and buckets below the slot's
# eight rows, so each flush must clear what a larger earlier one left
FLUSHES = [
    ([(250, 256), (37, 53), (256, 256), (121, 9), (100, 130)], 8),
    ([(16, 128), (250, 30)], 4),
    ([(40, 40), (30, 250), (256, 200), (64, 64), (9, 121), (200, 256), (129, 97), (8, 8)], 8),
    ([(256, 256)], 1),
    ([(33, 17), (17, 33), (128, 96)], 4),
    ([(100, 130), (256, 256), (37, 53)], 8),
]


@pytest.mark.parametrize("mode", ["420", "422", "444", "gray"])
def test_a_reused_slot_holds_the_bytes_of_a_fresh_staging_padded_to_its_bucket(mode):
    slot = port.StagingSlot(mode, 32, rows=8)
    for f, (sizes, rows) in enumerate(FLUSHES):
        batch = [coefficients(10 * f + i, h, w, mode) for i, (h, w) in enumerate(sizes)]
        staged = port.stage_coefficient_batch(batch, luma_blocks=32, mode=mode, slot=slot,
                                              rows=rows)
        assert isinstance(staged, port.StagedBatch) and staged.slot is slot
        assert slot.staged_rows == rows
        want = padded_reference(batch, 32, mode, rows)
        for key in port.STAGED_KEYS:
            got = slot.arrays[key][:rows]
            assert got.dtype == want[key].dtype and got.shape == want[key].shape, key
            assert got.tobytes() == want[key].tobytes(), (f, key)
            # the batch handed on is the slot's first n rows, as they are
            assert staged[key].shape[0] == len(batch)
            assert np.shares_memory(staged[key], slot.arrays[key])
        # the rows a flush copies are the slot's tensors, the tables as int16
        assert slot.tensors["yq"][:rows].numpy().view(np.uint16).tobytes() == \
            want["yq"].tobytes()


def test_a_slot_refuses_what_a_fresh_staging_refuses():
    slot = port.StagingSlot("420", 16, rows=2)
    for batch, luma, mode in (([coefficients(0, 40, 40, "444")], 16, "420"),
                              ([coefficients(1, 200, 100)], 16, "420")):
        assert port.stage_coefficient_batch(batch, luma, mode, slot=port.StagingSlot(
            mode, luma, rows=2), rows=2) is None
    assert port.stage_coefficient_batch([coefficients(2, 40, 40)], 16, "420", slot=slot,
                                        rows=1) is not None


def tiny_engine(buckets=(1, 4, 8)):
    return InferenceEngine("resnet_tiny", num_classes=10, precision="fp32", buckets=buckets,
                           canvas=64, device="cpu", seed=4)


@pytest.mark.parametrize("mode", ["420", "gray"])
def test_a_flush_staged_in_a_slot_is_answered_as_one_staged_fresh(mode):
    engine = tiny_engine()
    engine.warmup_coeff(mode, 32, buckets=(8,))       # the lane's slots: 8 rows
    for f, (sizes, _) in enumerate(FLUSHES[:3]):
        batch = [coefficients(10 * f + i, h, w, mode) for i, (h, w) in enumerate(sizes)]
        staged = engine.stage_coefficients(batch, mode, 32)
        assert staged.slot.staged_rows == engine.bucket_for(len(batch))
        try:
            got = engine.predict_coeff_staged(staged, mode=mode)
        finally:
            engine.release_staged(staged)
        fresh = dict(port.stage_coefficient_batch(batch, luma_blocks=32, mode=mode))
        want = engine.predict_coeff_staged(fresh, mode=mode)
        for g, w in zip(got, want):
            assert g.tobytes() == w.tobytes()


def test_the_pool_makes_hands_out_waits_and_grows():
    pool = port.StagingPool("420", 16, pin=False)
    pool.reserve(4)
    assert pool._made == port.StagingPool.RESERVED == 2
    waits, grows = _count("staging_slot_waits"), _count("staging_slot_grows")
    held = [pool.acquire(4) for _ in range(2)]
    assert all(s.rows == 4 for s in held) and _count("staging_slot_grows") == grows
    held.append(pool.acquire(8))                      # a third slot, made by a flush
    assert pool._made == port.StagingPool.SLOTS == 3 and held[-1].rows == 8
    assert _count("staging_slot_grows") == grows + 1
    got = []
    waiter = threading.Thread(target=lambda: got.append(pool.acquire(4)))
    waiter.start()
    deadline = time.monotonic() + 10
    while _count("staging_slot_waits") == waits and time.monotonic() < deadline:
        time.sleep(0.005)
    assert _count("staging_slot_waits") == waits + 1 and not got
    pool.release(held[0])
    waiter.join(10)
    assert got == [held[0]]
    pool.release(held[1])
    assert pool.acquire(16) is held[1] and held[1].rows == 16   # grown for a larger flush
    assert _count("staging_slot_grows") == grows + 2


@pytest.mark.anyio
async def test_a_failed_resolve_retries_on_the_slot_while_the_next_flush_waits(monkeypatch):
    monkeypatch.setattr(port.StagingPool, "SLOTS", 1)
    engine = tiny_engine(buckets=(4,))
    step = engine._get_coeff_step("420")
    seen = []
    engine._coeff_steps["420"] = lambda *a: (seen.append([t.clone() for t in a]), step(*a))[1]
    real = engine.predict_coeff_staged_async
    dispatched = threading.Event()
    waits = _count("staging_slot_waits")

    def flaky(staged, mode="420", record=True):
        resolve = real(staged, mode, record)
        if dispatched.is_set():
            return resolve

        def fails():
            deadline = time.monotonic() + 20
            while _count("staging_slot_waits") == waits and time.monotonic() < deadline:
                time.sleep(0.005)                    # the next flush is waiting for the slot
            raise RuntimeError("injected resolve fault")

        dispatched.set()
        return fails

    monkeypatch.setattr(engine, "predict_coeff_staged_async", flaky)
    service = InferenceService(engine, deadline_us=500, pipelined=True)
    await service.start()
    blobs = [jpeg(1, 200, 150), jpeg(2, 90, 250)]
    try:
        first = asyncio.ensure_future(service.classify_bytes(blobs[0]))
        while not dispatched.is_set():
            await asyncio.sleep(0.005)
        second = await service.classify_bytes(blobs[1])
        first = await first
    finally:
        await service.stop()
    assert _count("staging_slot_waits") == waits + 1
    assert service.status()["device_errors"] == 1
    want = padded_reference([imgcodec.jpeg_coefficients(blobs[0])], 32 * 2, "420", 4)
    # the dispatch, the retry, then the next flush: the retry read the bytes
    # the dispatch read, the first image's, padded to bucket 4
    assert len(seen) == 3
    for key, a, b in zip(port.STAGED_KEYS, seen[0], seen[1]):
        assert a.numpy().tobytes() == b.numpy().tobytes() == want[key].tobytes(), key
    fresh = tiny_engine(buckets=(4,))
    for blob, out in zip(blobs, (first, second)):
        staged = port.stage_coefficient_batch([imgcodec.jpeg_coefficients(blob)], 64, "420")
        idx, scores = fresh.predict_coeff_staged(staged)
        assert out["top_classes"] == idx[0].tolist() and out["scores"] == scores[0].tolist()


def test_the_normalize_constants_are_made_once_a_device_with_the_step_s_bits():
    mean, std = preproc._norm_constants(preproc.IMAGENET_MEAN, preproc.IMAGENET_STD, "cpu")
    assert preproc._norm_constants(preproc.IMAGENET_MEAN, preproc.IMAGENET_STD,
                                   torch.device("cpu"))[0] is mean
    for got, values in ((mean, preproc.IMAGENET_MEAN), (std, preproc.IMAGENET_STD)):
        want = torch.tensor(values, dtype=torch.float32) * 255.0
        assert got.dtype == torch.float32 and got.numpy().tobytes() == want.numpy().tobytes()
        assert not got.is_inference()
    y = torch.rand((2, 5, 5, 3)) * 255
    with torch.inference_mode():
        out = preproc.normalize_pixels(y, dtype=torch.float32)
    assert torch.equal(out, (y - mean) / std)


def test_no_slot_is_handed_to_two_flushes_at_once_under_contention():
    """More threads than cores acquire, stage, check and release slots of one
    pool with the interpreter switching threads as often as it can: a slot
    held by two flushes at once would show another thread's marker."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    pool = port.StagingPool("gray", 8, pin=False)
    pool.reserve(2)
    batch = [coefficients(0, 40, 40, "gray")]

    def flushes(worker: int) -> int:
        for i in range(60):
            slot = pool.acquire(2)
            try:
                port.stage_coefficient_batch(batch, 8, "gray", slot=slot, rows=2)
                marker = worker * 1000 + i
                slot.arrays["sizes"][1] = marker
                time.sleep(0)
                assert int(slot.arrays["sizes"][1, 0]) == marker
            finally:
                pool.release(slot)
        return worker

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as ex:
            done = [f.result(timeout=60) for f in [ex.submit(flushes, w) for w in range(16)]]
    finally:
        sys.setswitchinterval(interval)
    assert sorted(done) == list(range(16))
    assert pool._made == port.StagingPool.SLOTS and len(pool._free) == pool._made


@pytest.mark.anyio
async def test_the_lanes_take_turns_to_enqueue_and_stage_concurrently(monkeypatch):
    """Flushes of the 512-px and 1,024-px lanes at once: no two are inside
    the engine's copy-and-launch together, and every answer comes back."""
    engine = tiny_engine(buckets=(1, 4))
    real = engine.predict_coeff_staged_async
    lock, inside, seen = threading.Lock(), [0], []

    def counted(staged, mode="420", record=True):
        with lock:
            inside[0] += 1
            seen.append(inside[0])
        try:
            time.sleep(0.02)                        # room for the other lane to come in
            return real(staged, mode, record)
        finally:
            with lock:
                inside[0] -= 1

    monkeypatch.setattr(engine, "predict_coeff_staged_async", counted)
    service = InferenceService(engine, deadline_us=500)
    await service.start()
    blobs = [jpeg(i, 300, 400) for i in range(4)] + [jpeg(10 + i, 700, 600) for i in range(4)]
    try:
        outs = await service.classify_many(blobs)
    finally:
        await service.stop()
    assert {o["decode"] for o in outs} == {"device:420"}
    assert set(service.coeff_batchers) == {("420", 64), ("420", 128)}
    assert len(seen) >= 2 and max(seen) == 1
