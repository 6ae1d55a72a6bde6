"""The port's sync engine (``ics_tpu_torch.sync``) against the JAX package's
(``ics_tpu.sync``), as its reference.

Each case is one scenario of ``tests/test_sync_engine.py`` or
``tests/test_chaos_sync.py``, run twice from the same ``FakeState`` script
against ``tests/fake_nextcloud.py`` over ``httpx.ASGITransport``: once with
the reference's client, sync engine and database, once with the port's. The
two runs must return the same results and leave the same rows: conjuntos and
imagens (hash, path, dimensions, ``existe_no_nextcloud``, metadata), the sync
status row with its watermark, and the ``on_image_bytes`` calls in order.
Wall-clock times are compared as "set or not".
"""

import asyncio
import datetime as dt
import importlib
import re
import types

import httpx
import pytest

from tests.fake_nextcloud import FakeState, make_fake_nextcloud, make_jpeg

PACKAGES = ("ics_tpu", "ics_tpu_torch")
_TIME = re.compile(r"^\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\.\d+")


def _package(top: str):
    mod = lambda name: importlib.import_module(f"{top}.{name}")  # noqa: E731
    models = mod("db.models")
    return types.SimpleNamespace(
        top=top,
        Database=mod("db.engine").Database,
        ConjuntoImagens=models.ConjuntoImagens,
        Imagem=models.Imagem,
        SyncStatus=models.SyncStatus,
        SugestaoModelo=models.SugestaoModelo,
        sha256_hex=mod("core.security").sha256_hex,
        NextCloudClient=mod("sync.nextcloud_client").NextCloudClient,
        WebDAVSync=mod("sync.webdav_sync").WebDAVSync,
        ActivityAPISync=mod("sync.activity_sync").ActivityAPISync,
        NextCloudSyncService=mod("sync.service").NextCloudSyncService,
        SyncCache=mod("sync.sync_cache").SyncCache,
    )


def standard_state() -> FakeState:
    st = FakeState()
    st.add_folder("plantas")
    st.add_image("plantas", "a.jpg", make_jpeg(1))
    st.add_image("plantas", "b.jpg", make_jpeg(2))
    st.add_folder("animais")
    st.add_image("animais", "c.jpg", make_jpeg(3))
    return st


class Env:
    """One package's run: its client on the fake, its database, the hook."""

    def __init__(self, p, tmp_path, state: FakeState, retry_delay: float = 0.01):
        self.p = p
        self.state = state
        self.db = p.Database(f"sqlite:///{tmp_path}/{p.top}.db")
        self.db.create_all()
        self.calls: list = []
        self.client = self.make_client(state, retry_delay)

    def make_client(self, state, retry_delay=0.01):
        return self.p.NextCloudClient(
            base_url="http://fake.test", username="tester", password="pw",
            user_path="/files/tester", max_retries=2, retry_delay=retry_delay,
            transport=httpx.ASGITransport(app=make_fake_nextcloud(state)),
        )

    def hook(self, content_hash: str, data: bytes) -> None:
        self.calls.append((content_hash, len(data)))

    def service(self, **kwargs):
        kwargs.setdefault("on_image_bytes", self.hook)
        return self.p.NextCloudSyncService(self.db, client=self.client, **kwargs)


def _norm(value):
    """Times as "set"; everything else as it is, recursively."""
    if isinstance(value, (dt.datetime, dt.date)):
        return "<time>"
    if isinstance(value, str) and _TIME.match(value):
        return "<time>"
    if isinstance(value, dict):
        return {k: _norm(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_norm(v) for v in value]
    return value


def rows(env: Env) -> dict:
    p = env.p
    with env.db.session() as s:
        conjuntos = {c.id_cnj: c for c in s.query(p.ConjuntoImagens).all()}
        imagens = sorted(
            (i.content_hash, i.nome_img, i.caminho_img,
             conjuntos[i.id_cnj].nome_conj, bool(i.existe_no_nextcloud),
             _norm(i.metadados))
            for i in s.query(p.Imagem).all()
        )
        status = [
            {col: _norm(getattr(r, col)) for col in (
                "last_activity_api_sync", "last_activity_id", "last_webdav_sync",
                "webdav_initial_sync_start", "activity_api_available",
                "activity_api_failures", "webdav_failures", "server_offline",
                "sync_in_progress", "last_sync_status", "last_sync_error",
                "last_sync_method")}
            for r in s.query(p.SyncStatus).all()
        ]
        return {
            "conjuntos": sorted(
                (c.nome_conj, c.caminho_conj, c.file_id, bool(c.imagens_sincronizadas),
                 bool(c.existe_no_nextcloud)) for c in conjuntos.values()),
            "imagens": imagens,
            "sync_status": status,
            "hook_calls": list(env.calls),
        }


# ---- scenarios: each returns what its original test asserted on ------------

async def client_list_root_folders(env):
    items = await env.client.list_folder("", depth=1)
    folders = env.client.filter_folders(items)
    assert {f["name"] for f in folders} == {"plantas", "animais"}
    return sorted((f["name"], f["file_id"]) for f in folders)


async def client_list_images_and_download(env):
    items = await env.client.list_folder("plantas", depth=1)
    images = env.client.filter_images(items)
    assert {i["name"] for i in images} == {"a.jpg", "b.jpg"}
    data = await env.client.get_file("plantas/a.jpg")
    assert data == env.state.folders["plantas"]["a.jpg"].data
    return [_norm(i) for i in images], env.p.sha256_hex(data)


async def client_activity_fetch_and_health(env):
    env.state.record_event("file_created", "plantas/a.jpg")
    events = await env.client.fetch_activities(since=0)
    up = await env.client.check_server_health()
    env.state.fail_webdav = env.state.fail_activity = True
    down = await env.client.check_server_health()
    assert up["server_online"] is True and down["server_online"] is False
    return [e["object_name"] for e in events], _norm(up), _norm(down)


async def client_retry_then_fail(env):
    env.state.fail_webdav = True
    with pytest.raises(Exception) as exc:
        await env.client.list_folder("", depth=1)
    return type(exc.value).__name__


async def webdav_full_scan(env):
    stats = await env.p.WebDAVSync(env.client, env.db, on_image_bytes=env.hook).sync_all_folders()
    assert stats["folders_processed"] == 2 and stats["images_created"] == 3
    return stats


async def webdav_rescan_and_tombstones(env):
    sync = env.p.WebDAVSync(env.client, env.db, on_image_bytes=env.hook)
    first = await sync.sync_all_folders()
    second = await sync.sync_all_folders()
    assert second["images_created"] == 0 and second["images_updated"] == 3
    del env.state.folders["plantas"]["b.jpg"]
    env.state.folders.pop("animais")
    env.state.folder_ids.pop("animais")
    third = await sync.sync_all_folders()
    return first, second, third


async def webdav_duplicate_content(env):
    env.state.add_image("plantas", "dup.jpg", env.state.folders["plantas"]["a.jpg"].data)
    return await env.p.WebDAVSync(env.client, env.db, on_image_bytes=env.hook).sync_all_folders()


async def _scanned_then_activity(env, mutate):
    await env.p.WebDAVSync(env.client, env.db, on_image_bytes=env.hook).sync_all_folders()
    mutate(env.state)
    activity = env.p.ActivityAPISync(env.client, env.db, on_image_bytes=env.hook)
    events = await activity.fetch_events_since(0)
    return await activity.process_events(events)


def _file_created(st):
    st.add_image("plantas", "novo.jpg", make_jpeg(9))
    st.record_event("file_created", "plantas/novo.jpg")


def _file_deleted_and_changed(st):
    st.record_event("file_deleted", "plantas/a.jpg")
    st.folders["plantas"]["b.jpg"].etag = "v2"
    st.record_event("file_changed", "plantas/b.jpg")


def _folder_created(st):
    st.add_image("nova-pasta", "x.jpg", make_jpeg(42))
    st.record_event("folder_created", "nova-pasta")


def _folder_moved(st):
    # a folder renamed on the server: deleted under its old name, created
    # under the new one, its image moved with it
    st.folders["insetos"] = st.folders.pop("animais")
    st.folder_ids["insetos"] = st.folder_ids.pop("animais")
    st.record_event("folder_deleted", "animais")
    st.record_event("folder_created", "insetos")


def _file_moved(st):
    f = st.folders["plantas"].pop("a.jpg")
    st.folders["animais"]["a.jpg"] = f
    st.record_event("file_deleted", "plantas/a.jpg")
    st.record_event("file_created", "animais/a.jpg")


@pytest.mark.parametrize("mutate", [_file_created, _file_deleted_and_changed,
                                    _folder_created, _folder_moved, _file_moved],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.anyio
async def test_activity_events_leave_the_same_rows(tmp_path, mutate):
    await _same_in_both(tmp_path, lambda env: _scanned_then_activity(env, mutate))


async def activity_irrelevant_events_skipped(env):
    stats = await env.p.ActivityAPISync(env.client, env.db).process_events(
        [{"type": "comments", "object_name": "x"}])
    assert stats["events_skipped"] == 1
    return stats


async def hybrid_initial_sync_empty_db_with_replay(env):
    service = env.service()
    # an event that lands while the scan runs is replayed after it
    env.state.add_image("plantas", "tarde.jpg", make_jpeg(11))
    env.state.record_event("file_created", "plantas/tarde.jpg")
    result = await service.sync_initial()
    assert result["mode"] == "initial_full"
    return result, _norm(service.get_sync_status())


async def hybrid_initial_sync_nonempty_db_uses_activity(env):
    service = env.service()
    first = await service.sync_initial()
    env.state.add_image("animais", "d.jpg", make_jpeg(12))
    env.state.record_event("file_created", "animais/d.jpg")
    second = await service.sync_initial()
    assert second["mode"] == "activity_catchup"
    return first, second


async def hybrid_periodic_activity_then_fallback(env):
    service = env.service()
    await service.sync_initial()
    ok = await service.sync_periodic()
    env.state.fail_activity = True
    fallback = await service.sync_periodic()
    assert (ok["mode"], fallback["mode"]) == ("activity_api", "webdav")
    return ok, fallback


async def hybrid_offline_detection_and_recovery(env):
    service = env.service()
    await service.sync_initial()
    env.state.fail_activity = env.state.fail_webdav = True
    ticks = [await service.sync_periodic() for _ in range(3)]
    assert service.cache.is_server_offline() is True
    env.state.fail_activity = env.state.fail_webdav = False
    health = await service.run_health_check()
    assert service.cache.is_server_offline() is False
    return ticks, health


async def hybrid_sync_mutex(env):
    service = env.service()
    assert service.cache.try_acquire_sync() is True
    result = await service.sync_periodic()
    service.cache.release_sync()
    assert result.get("skipped") is True
    return result


async def cache_failure_threshold(env):
    cache = env.p.SyncCache(env.db)
    seen = [cache.is_activity_api_available()]
    for _ in range(3):
        seen.append(cache.record_activity_failure())
    seen.append(cache.is_activity_api_available())
    cache.record_activity_success()
    seen += [cache.is_activity_api_available(), cache.get().activity_api_failures]
    assert seen[-2:] == [True, 0]
    return seen


async def r3_incremental_channel_advances_past_watermark(env):
    await env.p.WebDAVSync(env.client, env.db).sync_all_folders()
    env.state.add_image("plantas", "n1.jpg", make_jpeg(41))
    env.state.record_event("file_created", "plantas/n1.jpg")
    activity = env.p.ActivityAPISync(env.client, env.db)
    events = await activity.fetch_events_since(0)
    watermark = max(e["activity_id"] for e in events)
    drained = await activity.fetch_events_since(watermark)
    env.state.add_image("plantas", "n2.jpg", make_jpeg(42))
    env.state.record_event("file_created", "plantas/n2.jpg")
    newer = await activity.fetch_events_since(watermark)
    assert drained == [] and [e["object_name"] for e in newer] == ["plantas/n2.jpg"]
    return watermark, [e["object_name"] for e in newer]


async def r3_fetch_paginates_beyond_one_page(env):
    class StubClient:
        async def fetch_activities(self, since=0, limit=200):
            ids = [i for i in range(1, 451) if i > since][:200]
            return [{"activity_id": i, "type": "file_changed", "object_name": f"f/{i}.jpg"}
                    for i in ids]

    events = await env.p.ActivityAPISync(StubClient(), env.db).fetch_events_since(0)
    assert len(events) == 450
    return [e["activity_id"] for e in events]


async def r3_events_applied_chronologically(env):
    await env.p.WebDAVSync(env.client, env.db).sync_all_folders()
    env.state.record_event("folder_deleted", "plantas")
    env.state.record_event("folder_created", "plantas")
    activity = env.p.ActivityAPISync(env.client, env.db, on_image_bytes=env.hook)
    events = sorted(await activity.fetch_events_since(0), key=lambda e: -e["activity_id"])
    return await activity.process_events(events)


async def r3_nested_delete_cannot_tombstone_root_namesake(env):
    await env.p.WebDAVSync(env.client, env.db).sync_all_folders()
    activity = env.p.ActivityAPISync(env.client, env.db)
    return activity.process_folder_deleted(
        {"type": "folder_deleted", "object_name": "archive/plantas"})


async def r3_moved_image_follows_its_new_conjunto(env):
    await env.p.WebDAVSync(env.client, env.db).sync_all_folders()
    data = env.state.folders["plantas"]["a.jpg"].data
    del env.state.folders["plantas"]["a.jpg"]
    env.state.add_image("insetos", "a.jpg", data)
    moved = await env.p.WebDAVSync(env.client, env.db, on_image_bytes=env.hook).sync_all_folders()
    again = await env.p.WebDAVSync(env.client, env.db).sync_all_folders()
    return moved, again


async def chaos_flapping_upstream_never_crashes_and_recovers(env):
    env.client = env.make_client(env.state, retry_delay=0.0)
    service = env.service()
    out = [await service.sync_initial()]
    for tick in range(12):
        env.state.fail_activity = env.state.fail_webdav = tick % 2 == 1
        out.append(await service.sync_periodic())
        if tick % 3 == 2:
            out.append(await service.run_health_check())
    env.state.fail_activity = env.state.fail_webdav = True
    for _ in range(4):
        out.append(await service.sync_periodic())
    assert service.cache.is_server_offline() is True
    env.state.fail_activity = env.state.fail_webdav = False
    out.append(await service.run_health_check())
    env.state.add_image("pasta", "novo.jpg", make_jpeg(99))
    env.state.record_event("file_created", "pasta/novo.jpg")
    result = await service.sync_periodic()
    assert "error" not in result and service.cache.is_sync_in_progress() is False
    return [_norm(o) for o in out] + [result]


async def chaos_mid_scan_failure_leaves_consistent_state(env):
    env.client = env.make_client(env.state, retry_delay=0.0)
    service = env.service()
    original_get = service.client.get_file
    calls = {"n": 0}

    async def flaky_get(path):
        calls["n"] += 1
        if calls["n"] == 1:
            env.state.fail_webdav = True  # die after the first download
        return await original_get(path)

    service.client.get_file = flaky_get
    out = [await service.sync_initial()]
    assert service.cache.is_sync_in_progress() is False
    env.state.fail_webdav = False
    service.client.get_file = original_get
    out.append(await service.sync_periodic())
    service.cache._update(last_webdav_sync=None, activity_api_available=False)
    out.append(await service.sync_periodic())
    return out


def _chaos_state():
    st = FakeState()
    st.add_image("pasta", "a.jpg", make_jpeg(1))
    return st


def _two_folder_state():
    st = FakeState()
    st.add_image("p1", "a.jpg", make_jpeg(1))
    st.add_image("p2", "b.jpg", make_jpeg(2))
    return st


SCENARIOS = {
    f.__name__: (f, state) for f, state in [
        (client_list_root_folders, standard_state),
        (client_list_images_and_download, standard_state),
        (client_activity_fetch_and_health, standard_state),
        (client_retry_then_fail, standard_state),
        (webdav_full_scan, standard_state),
        (webdav_rescan_and_tombstones, standard_state),
        (webdav_duplicate_content, standard_state),
        (activity_irrelevant_events_skipped, standard_state),
        (hybrid_initial_sync_empty_db_with_replay, standard_state),
        (hybrid_initial_sync_nonempty_db_uses_activity, standard_state),
        (hybrid_periodic_activity_then_fallback, standard_state),
        (hybrid_offline_detection_and_recovery, standard_state),
        (hybrid_sync_mutex, standard_state),
        (cache_failure_threshold, standard_state),
        (r3_incremental_channel_advances_past_watermark, standard_state),
        (r3_fetch_paginates_beyond_one_page, standard_state),
        (r3_events_applied_chronologically, standard_state),
        (r3_nested_delete_cannot_tombstone_root_namesake, standard_state),
        (r3_moved_image_follows_its_new_conjunto, standard_state),
        (chaos_flapping_upstream_never_crashes_and_recovers, _chaos_state),
        (chaos_mid_scan_failure_leaves_consistent_state, _two_folder_state),
    ]
}


async def _same_in_both(tmp_path, scenario, make_state=standard_state):
    runs = []
    for top in PACKAGES:
        d = tmp_path / top
        d.mkdir()
        env = Env(_package(top), d, make_state())
        try:
            out = await scenario(env)
        finally:
            await env.client.aclose()
        runs.append((_norm(out), rows(env)))
    (ref_out, ref_rows), (port_out, port_rows) = runs
    assert port_out == ref_out
    assert port_rows == ref_rows
    return port_out, port_rows


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.anyio
async def test_sync_scenario_leaves_the_same_rows(tmp_path, name):
    scenario, make_state = SCENARIOS[name]
    await _same_in_both(tmp_path, scenario, make_state)


@pytest.mark.anyio
async def test_full_scan_rows_hold_what_the_reference_test_pins(tmp_path):
    """The rows compared above are not empty of meaning: after a full scan
    the port holds three images by content hash, 64 px wide, in two
    synced conjuntos, and has offered each image's bytes to the hook once."""
    _, got = await _same_in_both(tmp_path, webdav_full_scan)
    hashes = {img[0] for img in got["imagens"]}
    assert len(hashes) == 3 and all(img[5]["image"]["width"] == 64 for img in got["imagens"])
    assert [c[3] for c in got["conjuntos"]] == [True, True]
    assert sorted(h for h, _ in got["hook_calls"]) == sorted(hashes)


@pytest.mark.anyio
async def test_tombstones_keep_rows_and_mark_them(tmp_path):
    _, got = await _same_in_both(tmp_path, webdav_rescan_and_tombstones)
    gone = {img[1] for img in got["imagens"] if not img[4]}
    assert gone == {"b.jpg", "c.jpg"} and len(got["imagens"]) == 3
    assert {c[0]: c[4] for c in got["conjuntos"]} == {"plantas": True, "animais": False}


@pytest.mark.anyio
async def test_the_initial_sync_records_its_watermark(tmp_path):
    _, got = await _same_in_both(tmp_path, hybrid_initial_sync_empty_db_with_replay)
    status = got["sync_status"][0]
    assert status["last_activity_id"] == 1 and status["last_sync_method"] == "initial"
    assert len(got["imagens"]) == 4


@pytest.mark.anyio
async def test_suggestions_converge_under_chaos_in_both(tmp_path, monkeypatch):
    """``test_chaos_sync.py::TestClassifyOnSyncChaos``: a flapping upstream and
    a flaky device step (every third dispatch raises); each package's sync
    engine and inference service on the CPU must leave one suggestion per
    image and absorb the faults."""
    left = []
    for top in PACKAGES:
        p = _package(top)
        engine_mod = importlib.import_module(f"{top}.runtime.engine")
        service_mod = importlib.import_module(f"{top}.runtime.service")
        registrar = importlib.import_module(f"{top}.crud.modelo_crud").registrar_sugestao
        kwargs = {"device": "cpu"} if top == "ics_tpu_torch" else {}
        engine = engine_mod.InferenceEngine("resnet_tiny", num_classes=8, precision="fp32",
                                            buckets=(1, 4), canvas=64, **kwargs)
        svc = service_mod.InferenceService(engine, deadline_us=500, device_decode=False)
        await svc.start()
        real_dispatch = engine.predict_staged_async
        calls = {"n": 0}

        def flaky(canvas, sizes, real=real_dispatch, calls=calls):
            calls["n"] += 1
            if calls["n"] % 3 == 1:
                raise RuntimeError("injected device fault")
            return real(canvas, sizes)

        monkeypatch.setattr(engine, "predict_staged_async", flaky)
        state = FakeState()
        for i in range(4):
            state.add_image("plantas", f"{i}.jpg", make_jpeg(i))
        d = tmp_path / top
        d.mkdir()
        env = Env(p, d, state)
        tasks = set()

        def hook(content_hash, data, env=env, svc=svc, tasks=tasks, registrar=registrar):
            async def classify_and_store():
                try:
                    result = await svc.classify_bytes(data)
                    with env.db.session() as s:
                        registrar(s, content_hash, modelo="resnet_tiny",
                                  classes=[{"classe": int(result["top_classes"][0]),
                                            "score": 1.0}], score=1.0)
                        s.commit()
                except Exception:
                    pass  # the app hook logs; chaos must not crash sync

            task = asyncio.get_running_loop().create_task(classify_and_store())
            tasks.add(task)
            task.add_done_callback(tasks.discard)

        sync = env.service(on_image_bytes=hook)
        for tick in range(6):
            state.fail_webdav = state.fail_activity = tick % 3 == 1
            await sync.sync_periodic()
            await asyncio.sleep(0.05)
        state.fail_webdav = state.fail_activity = False
        await sync._sync_via_webdav()
        for _ in range(200):
            if not tasks:
                break
            await asyncio.sleep(0.05)
        await svc.stop()
        await env.client.aclose()
        with env.db.session() as s:
            sug = sorted({r.id_img for r in s.query(p.SugestaoModelo).all()})
            assert s.query(p.Imagem).count() == 4
        assert len(sug) == 4 and svc._device_errors >= 1
        left.append((sug, rows(env)["imagens"]))
    assert left[0][0] == left[1][0]
    assert left[0][1] == left[1][1]


@pytest.mark.anyio
async def test_the_ports_fake_answers_as_the_test_fake(tmp_path):
    """``ics_tpu_torch.tools.fake_nextcloud`` (what ``chip_smoke.py`` serves)
    is a copy of ``tests/fake_nextcloud.py`` on the port's web framework: the
    same requests get the same answers, and a directory tree loads into the
    same state as the script that wrote it."""
    from ics_tpu_torch.tools import fake_nextcloud as port_fake

    for folder, names in (("plantas", ("a.jpg", "b.png")), ("animais", ("c.jpg",))):
        (tmp_path / folder).mkdir()
        for i, name in enumerate(names):
            (tmp_path / folder / name).write_bytes(make_jpeg(len(name) + i))
    (tmp_path / "plantas" / "notes.txt").write_text("not an image")
    port_state = port_fake.FakeState.from_directory(tmp_path)
    test_state = FakeState()
    for folder in ("animais", "plantas"):
        test_state.add_folder(folder)
        for path in sorted((tmp_path / folder).glob("*.*g")):
            f = test_state.add_image(folder, path.name, path.read_bytes())
            f.content_type = "image/png" if path.suffix == ".png" else "image/jpeg"
    for st in (port_state, test_state):
        st.record_event("file_created", "plantas/a.jpg")
        st.record_event("file_deleted", "animais/c.jpg")
    answers = []
    for app in (make_fake_nextcloud(test_state), port_fake.make_fake_nextcloud(port_state)):
        async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                     base_url="http://fake.test") as c:
            got = []
            for method, url in (
                ("PROPFIND", "/remote.php/dav/files/tester"),
                ("PROPFIND", "/remote.php/dav/files/tester/plantas"),
                ("PROPFIND", "/remote.php/dav/files/tester/nada"),
                ("GET", "/remote.php/dav/files/tester/plantas/b.png"),
                ("GET", "/remote.php/dav/files/tester/plantas/x.jpg"),
                ("GET", "/ocs/v2.php/apps/activity/api/v2/activity?since=0&sort=asc"),
                ("GET", "/ocs/v2.php/apps/activity/api/v2/activity?since=2"),
            ):
                r = await c.request(method, url)
                body = r.content
                if "activity" in url:
                    body = [{k: v for k, v in e.items() if k != "datetime"}
                            for e in r.json()["ocs"]["data"]]
                got.append((r.status_code, r.headers.get("content-type"), body))
            answers.append(got)
    assert answers[0] == answers[1]
