"""Serving through the port's device-decode lanes, mirroring
``tests/test_device_decode_serving.py``: which requests take which lane, the
per-lane stats, status and metric names, the background warm-up of every
lane and ``stop()`` during it, the one retry of a failed step, and startup
failing when the entropy decoder cannot be built (no silent host decode).
"""

import asyncio
import io

import httpx
import numpy as np
import pytest
from PIL import Image, ImageFilter

from ics_tpu_torch.core.config import settings
from ics_tpu_torch.db.engine import Database
from ics_tpu_torch.native import imgcodec
from ics_tpu_torch.runtime.engine import InferenceEngine
from ics_tpu_torch.runtime.service import InferenceService, InferenceServicePool


def jpeg(seed, h=80, w=96, subsampling=2, gray=False, **kw) -> bytes:
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).filter(
        ImageFilter.GaussianBlur(1))
    buf = io.BytesIO()
    if gray:
        img.convert("L").save(buf, "JPEG", quality=90, **kw)
    else:
        img.save(buf, "JPEG", quality=90, subsampling=subsampling, **kw)
    return buf.getvalue()


def png_bytes(seed, h=60, w=70) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)).save(
        buf, "PNG")
    return buf.getvalue()


def engine(buckets=(1, 4)):
    return InferenceEngine("resnet_tiny", num_classes=8, precision="fp32", buckets=buckets,
                           canvas=64, device="cpu")


@pytest.fixture()
async def svc():
    s = InferenceService(engine(), deadline_us=500)
    await s.start()
    yield s
    await s.stop()


REQUESTS = {
    "420": (dict(seed=1), "device:420", "device_decoded_420_512px"),
    "422": (dict(seed=3, h=60, w=64, subsampling=1), "device:422", "device_decoded_422_512px"),
    "444": (dict(seed=3, h=60, w=64, subsampling=0), "device:444", "device_decoded_444_512px"),
    "progressive": (dict(seed=7, h=60, w=64, progressive=True), "device:420",
                    "device_decoded_420_512px"),
    "restarts": (dict(seed=8, restart_marker_blocks=2), "device:420", "device_decoded_420_512px"),
    "gray": (dict(seed=6, h=60, w=64, gray=True), "device:gray", "device_decoded_gray_512px"),
    "wide": (dict(seed=4, h=600, w=600), "device:420", "device_decoded_420_1024px"),
    "wide_gray": (dict(seed=4, h=520, w=300, gray=True), "device:gray",
                  "device_decoded_gray_1024px"),
}


@pytest.mark.anyio
@pytest.mark.parametrize("case", sorted(REQUESTS))
async def test_jpeg_takes_its_device_lane(svc, case):
    kw, decode, key = REQUESTS[case]
    out = await svc.classify_bytes(jpeg(**kw))
    assert out["decode"] == decode
    assert len(out["top_classes"]) == 5 and out["model"] == "resnet_tiny"
    assert svc._stats["device_decoded"] == 1 and svc._stats[key] == 1
    assert svc._stats["host_decoded"] == 0
    st = svc.status()
    assert st["device_decode"] is True
    assert st["coeff_lanes"][key[len("device_decoded_"):]]["flushes"] == 1
    assert st["images"] == 1 and st["compiles"] == 1


@pytest.mark.anyio
@pytest.mark.parametrize("case", ["png", "giant", "cmyk", "not_an_image"])
async def test_other_images_take_the_host_lane(svc, case):
    if case == "png":
        blob = png_bytes(2)
    elif case == "giant":                       # past every luma bucket
        blob = jpeg(4, h=1100, w=80)
    elif case == "cmyk":                        # four components: no lane
        buf = io.BytesIO()
        Image.new("CMYK", (40, 32), (10, 20, 30, 40)).save(buf, "JPEG")
        blob = buf.getvalue()
    else:
        blob = b"\xff\xd8\xff" + b"\x00" * 40
    if case == "not_an_image":
        from ics_tpu_torch.runtime.decode import ImagemInvalida

        with pytest.raises(ImagemInvalida):
            await svc.classify_bytes(blob)
    else:
        out = await svc.classify_bytes(blob)
        assert out["decode"] == "host"
    assert svc._stats["host_decoded"] == 1 and svc._stats["device_decoded"] == 0
    assert svc.status()["coeff_lanes"] == {}
    assert svc._incoming.value == 0


@pytest.mark.anyio
@pytest.mark.parametrize("gray", [False, True])
async def test_device_and_host_lanes_agree(svc, gray):
    """Same image through both lanes -> same top-1 (decode fidelity)."""
    blob = jpeg(5, gray=gray)
    dev = await svc.classify_bytes(blob)
    svc.device_decode = False
    host = await svc.classify_bytes(blob)
    assert dev["decode"] == ("device:gray" if gray else "device:420")
    assert host["decode"] == "host"
    assert dev["top_classes"][0] == host["top_classes"][0]
    np.testing.assert_allclose(dev["scores"], host["scores"], rtol=5e-2, atol=5e-3)


@pytest.mark.anyio
async def test_a_batch_of_jpegs_shares_one_flush():
    s = InferenceService(engine(), deadline_us=50_000)
    await s.start()
    try:
        outs = await s.classify_many([jpeg(i) for i in range(4)])
        assert [o["decode"] for o in outs] == ["device:420"] * 4
        lane = s.status()["coeff_lanes"]["420_512px"]
        assert lane["flushes"] == 1 and lane["max_batch_seen"] == 4
    finally:
        await s.stop()


@pytest.mark.anyio
async def test_service_without_device_decode_host_decodes_jpegs():
    s = InferenceService(engine(), deadline_us=500, device_decode=False)
    await s.start()
    try:
        out = await s.classify_bytes(jpeg(1))
        assert out["decode"] == "host"
        assert s.status()["device_decode"] is False
    finally:
        await s.stop()


@pytest.mark.anyio
@pytest.mark.parametrize("pipelined", [False, True])
async def test_a_failed_step_is_retried_once_then_propagates(monkeypatch, pipelined):
    s = InferenceService(engine(), deadline_us=500, pipelined=pipelined)
    await s.start()
    real = s.engine.predict_coeff_staged_async
    failures = {"left": 1}

    def flaky(staged, mode="420", record=True):
        if failures["left"] > 0:
            failures["left"] -= 1
            raise RuntimeError("injected device fault")
        return real(staged, mode, record)

    monkeypatch.setattr(s.engine, "predict_coeff_staged_async", flaky)
    try:
        out = await s.classify_bytes(jpeg(1))
        assert out["decode"] == "device:420" and s.status()["device_errors"] == 1
        failures["left"] = 10
        with pytest.raises(RuntimeError, match="injected device fault"):
            await s.classify_bytes(jpeg(2))
        assert s._stats["host_decoded"] == 0       # no failure became a host decode
    finally:
        await s.stop()


class TestWarmAllLanes:
    @pytest.mark.anyio
    async def test_warm_start_warms_every_lane(self):
        """start(warm=True) runs 4:2:0 / 512 px at every bucket before it
        returns and every other (mode, luma) lane at the smallest bucket in
        the background."""
        eng = engine(buckets=(1, 2))
        s = InferenceService(eng, deadline_us=500)
        await s.start(warm=True)
        try:
            assert "420" in eng._coeff_steps
            assert {("coeff", "420", 64, 1), ("coeff", "420", 64, 2)} <= eng._compiled_shapes
            assert s.status()["decode_lanes_warming"] is True
            await s._lane_warm_task
            assert set(eng._coeff_steps) == {"420", "422", "444", "gray"}
            for mode in ("420", "422", "444", "gray"):
                for luma in (64, 128):
                    assert ("coeff", mode, luma, 1) in eng._compiled_shapes
            st = s.status()
            assert st["decode_lanes_warming"] is False and st["batches"] == 0
        finally:
            await s.stop()

    @pytest.mark.anyio
    async def test_stop_during_warm_up_cancels_and_detaches(self):
        s = InferenceService(engine(buckets=(1,)), deadline_us=500)
        await s.start(warm=True)
        task = s._lane_warm_task
        assert not task.done()
        await asyncio.wait_for(s.stop(), timeout=30)
        await asyncio.sleep(0)
        assert task.cancelled() or task.done()
        with pytest.raises(RuntimeError, match="stopped"):
            await s._get_coeff_lane("420", 64)

    @pytest.mark.anyio
    async def test_warm_up_waits_for_an_idle_window(self):
        s = InferenceService(engine(buckets=(1,)), deadline_us=500)
        s._inflight = 1
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        await s._await_idle_window(max_wait_s=0.6)
        assert loop.time() - t0 >= 0.5               # busy: waited to the cap
        s._inflight = 0
        t0 = loop.time()
        await s._await_idle_window(max_wait_s=5)
        assert loop.time() - t0 < 2


@pytest.fixture()
def unbuildable_entropy(monkeypatch):
    """The entropy decoder's build made to fail: an option the compiler
    refuses, so the digest names a library that does not exist yet."""
    monkeypatch.setattr(imgcodec, "CXX_FLAGS",
                        imgcodec.CXX_FLAGS + ("-fno-such-option-for-this-test",))
    monkeypatch.setattr(imgcodec, "_entropy", None)


def test_service_construction_fails_when_the_decoder_cannot_be_built(unbuildable_entropy):
    with pytest.raises(RuntimeError, match="jpeg_entropy.cpp failed") as err:
        InferenceService(engine())
    assert "no-such-option-for-this-test" in str(err.value)   # the compiler's output
    InferenceService(engine(), device_decode=False)              # the host lane alone builds


@pytest.mark.anyio
async def test_startup_fails_when_the_decoder_cannot_be_built(tmp_path, monkeypatch,
                                                              unbuildable_entropy):
    from ics_tpu_torch.core.config import reload_settings
    from ics_tpu_torch.main import create_app
    from ics_tpu_torch.runtime import service as service_mod

    monkeypatch.setattr(service_mod, "InferenceEngine",
                        lambda **kw: InferenceEngine(device="cpu", **kw))
    reload_settings(TPU_ENABLE_INFERENCE="true", TPU_DEFAULT_MODEL="resnet_tiny",
                    TPU_NUM_CLASSES="8", TPU_BATCH_BUCKETS="1", TPU_WARMUP_ON_STARTUP="false")
    try:
        app = create_app(db=Database(f"sqlite:///{tmp_path}/fail.db"))
        with pytest.raises(RuntimeError, match="no-such-option-for-this-test"):
            await app.startup()
        assert app.state.get("engine") is None
    finally:
        reload_settings()


@pytest.mark.anyio
async def test_pool_hands_device_decode_to_every_service():
    pool = InferenceServicePool("resnet_tiny", device_decode=False, num_classes=8,
                                precision="fp32", buckets=(1,), canvas=64, device="cpu")
    try:
        service = await pool.get("resnet_tiny")
        assert service.device_decode is False
        pool.device_decode = True
        other = await pool.get("resnet18")
        assert other.device_decode is True
    finally:
        await pool.stop()


@pytest.mark.anyio
async def test_status_and_metrics_name_every_lane(tmp_path):
    from ics_tpu_torch.main import create_app

    s = InferenceService(engine(), deadline_us=500)
    await s.start()
    app = create_app(db=Database(f"sqlite:///{tmp_path}/metrics.db"))
    app.state.engine = s
    await app.startup()
    try:
        async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                     base_url="http://t") as c:
            r = await c.post("/auth/login", data={"username": settings.ADMIN_EMAIL,
                                                  "password": settings.ADMIN_SENHA})
            h = {"Authorization": f"Bearer {r.json()['access_token']}"}
            files = [("files", ("a.jpg", jpeg(1), "image/jpeg")),
                     ("files", ("b.jpg", jpeg(2, subsampling=1), "image/jpeg")),
                     ("files", ("c.png", png_bytes(3), "image/png"))]
            r = await c.post("/inferencia/classificar", files=files, headers=h)
            assert r.status_code == 200, r.text
            assert [x["decode"] for x in r.json()["resultados"]] == \
                ["device:420", "device:422", "host"]
            st = (await c.get("/inferencia/status", headers=h)).json()
            text = (await c.get("/monitor/metrics")).text
    finally:
        await app.shutdown()
        await s.stop()
    assert st["device_decode"] is True
    assert set(st["coeff_lanes"]) == {"420_512px", "422_512px"}
    assert st["device_decoded"] == 2 and st["host_decoded"] == 1
    values = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            values[name] = float(value)
    assert values["tpu_device_decoded_total"] == 2 and values["tpu_host_decoded_total"] == 1
    for lane in ("420_512px", "422_512px", "pixel"):
        assert values[f"tpu_lane_flushes_{lane}_total"] >= 1
        assert f"tpu_lane_pipelined_{lane}_total" in values
