"""Classify-on-sync and embed-on-sync of the port against the JAX package's
(``tests/test_classify_on_sync.py``): the sync engine is the ingestion
front, and every image it downloads gets a model suggestion row and, under
``TPU_EMBED_ON_SYNC``, a stored embedding.

The reference app (``ics_tpu.main``, its JAX engine on the CPU) and the
port's app (a CPU engine carrying the reference engine's weights through
``weights.from_jax_variables``) sync the same ``FakeState`` through their own
sync engines and ``_make_classify_on_sync`` hooks. ``resnet_tiny`` in fp32,
once with ``TPU_DEVICE_DECODE`` off and once on. Tolerances: classes equal,
scores ``atol=2e-4, rtol=1e-4``; embeddings compared as stored (fp16): each
element equal or one fp16 ulp apart, since two fp32 values that agree to
~1e-6 may still round to neighbouring fp16 values (the fp32 features
themselves are held at ``atol=2e-4, rtol=1e-4`` in ``test_torch_embeddings.py``).

One image is held to less on the device-decode lanes: ``a.jpg`` is 4:2:0
with an even height and width, where the port continues the chroma past the
image's edge as libjpeg does and the reference reads the block padding (a
deliberate divergence, ``ROADMAP.md`` §3). Its last row and column differ,
so its scores move by up to ``EDGE_ATOL`` (1.5e-3 measured); its classes
must still be the reference's.
"""

import asyncio
import gc
import io
import weakref

import httpx
import jax
import numpy as np
import pytest
from PIL import Image

from tests.fake_nextcloud import FakeState, make_fake_nextcloud

SETTINGS = dict(
    TPU_ENABLE_INFERENCE="true",
    TPU_MESH_SHAPE="1",
    TPU_DEFAULT_MODEL="resnet_tiny",
    TPU_NUM_CLASSES="16",
    TPU_PRECISION="fp32",
    TPU_CANVAS="64",
    TPU_BATCH_BUCKETS="4",
    TPU_BATCH_DEADLINE_US="5000",
    TPU_WARMUP_ON_STARTUP="false",
)
ATOL, RTOL = 2e-4, 1e-4
EDGE_ATOL = 5e-3
EDGE_IMAGES = {"a.jpg"}   # 4:2:0, even height and width: the chroma-edge divergence


def _jpeg(seed: int, size, subsampling: int = 2, gray: bool = False) -> bytes:
    """Blurred noise (a photograph's spectrum more than white noise's)."""
    w, h = size
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1, 3), np.uint8)
    pil = Image.fromarray(img).resize((w, h), Image.BILINEAR)
    if gray:
        pil = pil.convert("L")
    buf = io.BytesIO()
    pil.save(buf, "JPEG", quality=90, subsampling=subsampling)
    return buf.getvalue()


def sync_state() -> FakeState:
    """Two folders: 4:2:0, 4:2:2, 4:4:4 and gray JPEGs of odd and even
    sizes, and a PNG (always the host lane)."""
    st = FakeState()
    st.add_image("plantas", "a.jpg", _jpeg(1, (64, 48)))
    st.add_image("plantas", "b.jpg", _jpeg(2, (77, 51), subsampling=1))
    st.add_image("plantas", "c.jpg", _jpeg(3, (50, 70), subsampling=0))
    st.add_image("animais", "d.jpg", _jpeg(4, (61, 45), gray=True))
    st.add_image("animais", "e.jpg", _jpeg(5, (81, 63)))
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(6).integers(0, 256, (40, 56, 3), np.uint8)).save(
        buf, "PNG")
    st.add_image("animais", "f.png", buf.getvalue()).content_type = "image/png"
    return st


def _client(top: str, state: FakeState):
    import importlib

    return importlib.import_module(f"{top}.sync.nextcloud_client").NextCloudClient(
        base_url="http://fake.test", username="tester", password="pw",
        user_path="/files/tester", max_retries=2, retry_delay=0.01,
        transport=httpx.ASGITransport(app=make_fake_nextcloud(state)),
    )


async def _wait_for(predicate, what: str, tries: int = 200):
    for _ in range(tries):
        if predicate():
            return
        await asyncio.sleep(0.05)
    pytest.fail(f"timed out waiting for {what}")


def _suggestions(db, models) -> dict:
    with db.session() as s:
        return {r.id_img: (r.modelo, r.classes, r.score)
                for r in s.query(models.SugestaoModelo).all()}


async def _run_reference(tmp_path, overrides: dict):
    """The reference app syncs ``sync_state()``; returns its rows and the
    weights of its engine as numpy."""
    from ics_tpu.core.config import reload_settings
    from ics_tpu.crud.embedding_crud import carregar_corpus
    from ics_tpu.db import models
    from ics_tpu.db.engine import Database
    from ics_tpu.main import _make_classify_on_sync, create_app
    from ics_tpu.sync.service import NextCloudSyncService

    reload_settings(**SETTINGS, **overrides)
    try:
        db = Database(f"sqlite:///{tmp_path}/ref.db")
        app = create_app(db=db)
        await app.startup()
        try:
            state = sync_state()
            client = _client("ics_tpu", state)
            sync = NextCloudSyncService(db, client=client,
                                        on_image_bytes=_make_classify_on_sync(app))
            await sync.sync_initial()
            n = sum(len(f) for f in state.folders.values())
            embed = overrides.get("TPU_EMBED_ON_SYNC") == "true"

            def done():
                with db.session() as s:
                    rows = len(carregar_corpus(s, "resnet_tiny")[0]) if embed else n
                return len(_suggestions(db, models)) == n and rows == n

            await _wait_for(done, "the reference's suggestions")
            with db.session() as s:
                corpus = carregar_corpus(s, "resnet_tiny")
            variables = jax.tree_util.tree_map(np.asarray, app.state.engine.engine.variables)
            await client.aclose()
            return _suggestions(db, models), corpus, variables
        finally:
            await app.shutdown()
    finally:
        reload_settings()


async def _port_app(tmp_path, variables, device_decode: bool):
    from ics_tpu_torch import weights
    from ics_tpu_torch.db.engine import Database
    from ics_tpu_torch.main import create_app
    from ics_tpu_torch.runtime.engine import InferenceEngine
    from ics_tpu_torch.runtime.service import InferenceService

    engine = InferenceEngine("resnet_tiny", num_classes=16, precision="fp32", buckets=(4,),
                             canvas=64, device="cpu",
                             state_dict=weights.from_jax_variables(variables))
    service = InferenceService(engine, deadline_us=5000, device_decode=device_decode)
    await service.start()
    app = create_app(db=Database(f"sqlite:///{tmp_path}/port.db"))
    app.state.engine = service
    await app.startup()
    return app, service


async def _run_port(tmp_path, variables, overrides: dict):
    from ics_tpu_torch.core.config import reload_settings
    from ics_tpu_torch.crud.embedding_crud import carregar_corpus
    from ics_tpu_torch.db import models
    from ics_tpu_torch.main import _make_classify_on_sync
    from ics_tpu_torch.sync.service import NextCloudSyncService

    reload_settings(**SETTINGS, **overrides)
    try:
        app, service = await _port_app(tmp_path, variables,
                                       overrides["TPU_DEVICE_DECODE"] == "true")
        try:
            db = app.state.db
            state = sync_state()
            client = _client("ics_tpu_torch", state)
            hook = _make_classify_on_sync(app)
            sync = NextCloudSyncService(db, client=client, on_image_bytes=hook)
            await sync.sync_initial()
            await _wait_for(lambda: not hook.tasks, "the port's on-sync tasks")
            with db.session() as s:
                corpus = carregar_corpus(s, "resnet_tiny")
            await client.aclose()
            return _suggestions(db, models), corpus, service.status()
        finally:
            await app.shutdown()
            await service.stop()
    finally:
        reload_settings()


def _assert_same_suggestions(port: dict, ref: dict, edge: frozenset = frozenset()) -> None:
    """``edge``: hashes of the images the chroma-edge divergence touches."""
    assert set(port) == set(ref) and len(port) == 6
    for h, (modelo, classes, score) in ref.items():
        p_modelo, p_classes, p_score = port[h]
        assert p_modelo == modelo == "resnet_tiny"
        assert [c["classe"] for c in p_classes] == [c["classe"] for c in classes], h
        atol = EDGE_ATOL if h in edge else ATOL
        np.testing.assert_allclose([c["score"] for c in p_classes],
                                   [c["score"] for c in classes], atol=atol, rtol=RTOL)
        np.testing.assert_allclose(p_score, score, atol=atol, rtol=RTOL)


@pytest.mark.parametrize("device_decode", ["false", "true"])
@pytest.mark.anyio
async def test_every_synced_image_gets_the_references_suggestion(tmp_path, device_decode):
    overrides = {"TPU_DEVICE_DECODE": device_decode}
    ref, _, variables = await _run_reference(tmp_path, overrides)
    port, _, status = await _run_port(tmp_path, variables, overrides)
    edge = frozenset()
    if device_decode == "true":
        from ics_tpu.core.security import sha256_hex

        edge = frozenset(sha256_hex(f.data) for folder in sync_state().folders.values()
                         for name, f in folder.items() if name in EDGE_IMAGES)
    _assert_same_suggestions(port, ref, edge)
    lanes = status["device_decoded"], status["host_decoded"]
    assert lanes == ((5, 1) if device_decode == "true" else (0, 6))


@pytest.mark.anyio
async def test_embed_on_sync_stores_the_references_embeddings(tmp_path):
    overrides = {"TPU_DEVICE_DECODE": "false", "TPU_EMBED_ON_SYNC": "true"}
    ref, (ref_hashes, ref_mat), variables = await _run_reference(tmp_path, overrides)
    port, (hashes, mat), status = await _run_port(tmp_path, variables, overrides)
    _assert_same_suggestions(port, ref)
    assert hashes == ref_hashes and len(hashes) == 6
    assert mat.dtype == ref_mat.dtype == np.float16
    np.testing.assert_array_max_ulp(mat, ref_mat, maxulp=1)
    np.testing.assert_allclose(np.linalg.norm(mat.astype(np.float32), axis=-1), 1.0, atol=5e-3)
    # each image classified and embedded once: the embed steps are the
    # engine's batches of 1 beside the classify flushes
    assert status["images"] == 12


@pytest.mark.anyio
async def test_on_sync_tasks_survive_a_collection(tmp_path):
    """The hook keeps every task it creates until the task ends: a
    ``gc.collect()`` while the tasks are pending leaves them alive, and
    each one stores its suggestion."""
    from ics_tpu.models.resnet import resnet_tiny
    from ics_tpu_torch.core import timezone as tz
    from ics_tpu_torch.core.security import sha256_hex
    from ics_tpu_torch.db import models
    from ics_tpu_torch.main import _make_classify_on_sync

    variables = jax.tree_util.tree_map(
        np.asarray, resnet_tiny(num_classes=16).init(jax.random.PRNGKey(0)))
    app, service = await _port_app(tmp_path, variables, device_decode=False)
    try:
        now = tz.utcnow()
        with app.state.db.session() as s:
            cnj = models.ConjuntoImagens(nome_conj="p", caminho_conj="/p", file_id="1",
                                         data_proc=now, data_sinc=now)
            s.add(cnj)
            s.flush()
            blobs = [_jpeg(i, (40, 30)) for i in range(3)]
            for i, blob in enumerate(blobs):
                s.add(models.Imagem(content_hash=sha256_hex(blob), nome_img=f"{i}.jpg",
                                    caminho_img=f"p/{i}.jpg", data_proc=now, data_sinc=now,
                                    id_cnj=cnj.id_cnj))
            s.commit()
        hook = _make_classify_on_sync(app)
        for blob in blobs:
            hook(sha256_hex(blob), blob)
        refs = [weakref.ref(t) for t in hook.tasks]
        assert len(refs) == 3
        gc.collect()
        assert all(r() is not None for r in refs)
        await _wait_for(lambda: not hook.tasks, "the on-sync tasks")
        assert set(_suggestions(app.state.db, models)) == {sha256_hex(b) for b in blobs}
    finally:
        await app.shutdown()
        await service.stop()


@pytest.mark.anyio
async def test_shutdown_drains_then_cancels_pending_tasks(tmp_path, monkeypatch):
    """Shutdown order: the scheduler, then the on-sync tasks (a wait, then
    cancelled), then the pool. A classify that never returns does not hold
    shutdown past the drain; one that meets a stopped service logs and
    ends."""
    from ics_tpu_torch import main as port_main

    monkeypatch.setattr(port_main._ClassifyOnSync, "DRAIN_S", 0.2)

    class Stuck:
        engine = None

        async def classify_bytes(self, data):
            await asyncio.Event().wait()

    class Stopped:
        async def classify_bytes(self, data):
            raise RuntimeError("batcher stopped before request was served")

    app = port_main.create_app()
    app.state.db = None
    for service, outcome in ((Stuck(), "cancelled"), (Stopped(), "ended")):
        app.state.engine = service
        hook = port_main._make_classify_on_sync(app)
        hook("ab" * 32, b"x")
        task = next(iter(hook.tasks))
        await asyncio.wait_for(hook.drain(), timeout=5)
        assert not hook.tasks and task.done()
        assert task.cancelled() == (outcome == "cancelled")


@pytest.mark.anyio
async def test_lifespan_serves_classify_and_embed_on_sync(tmp_path, monkeypatch, caplog):
    """``NEXTCLOUD_BASE_URL`` set: the app's own startup builds the sync
    engine with the classify-on-sync hook, runs the initial sync, and every
    synced image gets its suggestion and embedding; ``/monitor/status``
    shows the sync; no notice says either setting is not served; shutdown
    stops the scheduler before the inference service."""
    from ics_tpu.models.resnet import resnet_tiny
    from ics_tpu_torch.core.config import reload_settings, settings
    from ics_tpu_torch.crud.embedding_crud import carregar_corpus
    from ics_tpu_torch.db import models
    from ics_tpu_torch.sync import service as sync_service

    state = sync_state()
    monkeypatch.setattr(sync_service, "get_nextcloud_client",
                        lambda: _client("ics_tpu_torch", state))
    variables = jax.tree_util.tree_map(
        np.asarray, resnet_tiny(num_classes=16).init(jax.random.PRNGKey(0)))
    reload_settings(**SETTINGS, TPU_DEVICE_DECODE="true", TPU_EMBED_ON_SYNC="true",
                    NEXTCLOUD_BASE_URL="http://fake.test",
                    NEXTCLOUD_SYNC_INITIAL_ON_STARTUP="true")
    caplog.set_level("WARNING")
    try:
        app, service = await _port_app(tmp_path, variables, device_decode=True)
        try:
            db = app.state.db
            await _wait_for(lambda: len(_suggestions(db, models)) == 6, "suggestions")

            def embedded():
                with db.session() as s:
                    return len(carregar_corpus(s, "resnet_tiny")[0]) == 6

            await _wait_for(embedded, "embeddings")
            async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                         base_url="http://t") as c:
                r = await c.post("/auth/login", data={
                    "username": settings.ADMIN_EMAIL, "password": settings.ADMIN_SENHA})
                c.cookies.clear()
                h = {"Authorization": f"Bearer {r.json()['access_token']}"}
                status = (await c.get("/monitor/status", headers=h)).json()
                anonymous = await c.get("/monitor/status", headers={})
            assert anonymous.status_code == 401
            assert status["sync"]["enabled"] is True and status["sync"]["tasks"] == 4
            assert status["sync"]["last_sync_method"] == "initial"
            assert status["tpu"]["model"] == "resnet_tiny"
            assert status["tpu"]["device_decoded"] == 5
            scheduler = app.state.sync
        finally:
            await app.shutdown()
            await service.stop()
        assert scheduler._tasks == [] and scheduler._stop.is_set()
    finally:
        reload_settings()
    assert not [r for r in caplog.records if "not ported" in r.getMessage()
                or "not served" in r.getMessage()]


@pytest.mark.anyio
async def test_a_sync_during_the_lane_warm_up_is_answered_on_the_device_lanes(tmp_path):
    """The initial sync starts while the decode lanes still warm in the
    background: its JPEGs are answered on lanes made on demand, and the
    warm-up still warms every lane."""
    from ics_tpu.models.resnet import resnet_tiny
    from ics_tpu_torch import weights
    from ics_tpu_torch.core.config import reload_settings
    from ics_tpu_torch.db import models
    from ics_tpu_torch.db.engine import Database
    from ics_tpu_torch.main import _make_classify_on_sync, create_app
    from ics_tpu_torch.runtime.device_decode import LUMA_BUCKETS
    from ics_tpu_torch.runtime.engine import InferenceEngine
    from ics_tpu_torch.runtime.service import InferenceService
    from ics_tpu_torch.sync.service import NextCloudSyncService

    variables = jax.tree_util.tree_map(
        np.asarray, resnet_tiny(num_classes=16).init(jax.random.PRNGKey(0)))
    engine = InferenceEngine("resnet_tiny", num_classes=16, precision="fp32", buckets=(1, 2),
                             canvas=64, device="cpu",
                             state_dict=weights.from_jax_variables(variables))
    service = InferenceService(engine, deadline_us=5000, device_decode=True)
    reload_settings(**SETTINGS, TPU_DEVICE_DECODE="true")
    try:
        await service.start(warm=True)
        app = create_app(db=Database(f"sqlite:///{tmp_path}/warm.db"))
        app.state.engine = service
        await app.startup()
        try:
            assert service.status()["decode_lanes_warming"] is True
            hook = _make_classify_on_sync(app)
            client = _client("ics_tpu_torch", sync_state())
            await NextCloudSyncService(app.state.db, client=client,
                                       on_image_bytes=hook).sync_initial()
            await _wait_for(lambda: not hook.tasks, "the on-sync tasks")
            await client.aclose()
            assert len(_suggestions(app.state.db, models)) == 6
            st = service.status()
            assert (st["device_decoded"], st["host_decoded"]) == (5, 1)
            await asyncio.wait_for(service._lane_warm_task, timeout=120)
            assert {("coeff", mode, luma, 1) for mode in ("420", "422", "444", "gray")
                    for luma in LUMA_BUCKETS} <= engine._compiled_shapes
        finally:
            await app.shutdown()
    finally:
        await service.stop()
        reload_settings()
