"""The port's job surface over HTTP on the CPU: the ``treinamento`` router,
``POST /inferencia/indexar`` and ``GET /monitor/painel``, mirroring the
reference's ``tests/test_train_serve_e2e.py`` (train -> register -> serve ->
suggest -> export and import; the SSE stream; the JSONL dataset export),
``tests/test_cancel_job.py`` (cancel, resume, gc through the routes),
``tests/test_embeddings.py::test_indexar_then_search`` and
``tests/test_observability.py::test_monitor_painel_serves_dashboard``; and the
route's validation answers held to the JAX app's, status and ``detail``.

The port's app runs a ``resnet_tiny`` service on the CPU placed before
startup, so the lifespan builds ``app.state.trainer`` on the engine's device
(the CPU) under ``TPU_WEIGHTS_DIR``; the bytes come from the seeded blobs.
"""

import asyncio
import io
import json
import tarfile

import httpx
import numpy as np
import pytest

from ics_tpu_torch.core.config import reload_settings, settings
from ics_tpu_torch.db.engine import Database
from tests.test_torch_job import seed_ambiente

# swin_micro (0.12 M parameters): the package that the export route packs
# holds every step the job kept, weights and optimizer state
SMALL = {"modelo": "swin_micro", "max_steps": 3, "batch_size": 4, "epochs": 50,
         "canvas": 64}


@pytest.fixture()
async def app(tmp_path):
    from ics_tpu_torch.main import create_app
    from ics_tpu_torch.runtime.engine import InferenceEngine
    from ics_tpu_torch.runtime.service import InferenceService, InferenceServicePool

    reload_settings(TPU_ENABLE_INFERENCE="true", TPU_DEFAULT_MODEL="resnet_tiny",
                    TPU_PRECISION="fp32", TPU_CANVAS="64", TPU_BATCH_BUCKETS="4",
                    TPU_DEVICE_DECODE="false", TPU_WEIGHTS_DIR=str(tmp_path / "weights"))
    kwargs = dict(num_classes=16, precision="fp32", buckets=(4,), canvas=64)
    service = InferenceService(InferenceEngine("resnet_tiny", device="cpu", **kwargs),
                               deadline_us=20_000, device_decode=False)
    await service.start()
    a = create_app(db=Database(f"sqlite:///{tmp_path}/treino.db"))
    a.state.engine = service
    a.state.engine_pool = InferenceServicePool("resnet_tiny", deadline_us=20_000,
                                               device_decode=False, device="cpu", **kwargs)
    a.state.engine_pool.add("resnet_tiny", service)
    try:
        await a.startup()
        assert a.state.trainer is not None and a.state.trainer.device == service.engine.device
        assert a.state.trainer.fetch_bytes is None          # no NEXTCLOUD_BASE_URL
        amb = seed_ambiente(a.state.db)
        a.state.trainer.fetch_bytes = lambda h, _p: amb["blobs"][h]
        a.state.amb = amb
        yield a
    finally:
        await a.shutdown()
        await a.state.engine_pool.stop()
        await service.stop()
        reload_settings()


async def _login(c, username=None, password=None) -> dict:
    r = await c.post("/auth/login", data={"username": username or settings.ADMIN_EMAIL,
                                          "password": password or settings.ADMIN_SENHA})
    assert r.status_code == 200, r.text
    c.cookies.clear()
    return {"Authorization": f"Bearer {r.json()['access_token']}"}


async def _wait(c, id_job, h) -> dict:
    for _ in range(1200):
        job = (await c.get(f"/treinamento/jobs/{id_job}", headers=h)).json()
        if job["status"] not in ("pendente", "executando"):
            return job
        await asyncio.sleep(0.05)
    raise AssertionError(job)


def _client(a):
    return httpx.AsyncClient(transport=httpx.ASGITransport(app=a), base_url="http://t",
                             timeout=120)


@pytest.mark.anyio
async def test_train_register_serve_suggest_export_import(app):
    amb, id_amb = app.state.amb, app.state.amb["id_amb"]
    async with _client(app) as c:
        admin = await _login(c)
        r = await c.post(f"/treinamento/ambiente/{id_amb}", json=SMALL, headers=admin)
        assert r.status_code == 202, r.text
        id_job = r.json()["id_job"]
        r = await c.post(f"/treinamento/ambiente/{id_amb}", json={}, headers=admin)
        assert r.status_code == 409
        job = await _wait(c, id_job, admin)
        assert job["status"] == "concluido", job
        assert job["passos"] == 3 and job["versao"] == 1
        assert all(np.isfinite(h["loss"]) for h in job["historico"])
        assert (await c.get("/treinamento/jobs", headers=admin)).json()["jobs"][0]["id_job"] \
            == id_job
        r = await c.get(f"/treinamento/modelos?id_amb={id_amb}", headers=admin)
        modelos = r.json()["modelos"]
        assert r.json()["total"] == 1 and modelos[0]["ativo"]
        met = modelos[0]["metricas"]
        assert modelos[0]["num_classes"] == 2 and met["exemplos"] == 8
        assert met["exemplos_eval"] == 1 and met["eval_accuracy"] == job["eval_accuracy"]
        assert met["temperatura"] == 1.0 and met["eval_calibracao"]["exemplos"] == 1
        cm = np.asarray(met["eval_por_classe"]["matriz_confusao"])
        assert cm.shape == (2, 2) and cm.sum() == 1
        assert {r["id_opc"] for r in met["eval_por_classe"]["por_classe"]} == set(amb["opcoes"])

        esp = await _login(c, "esp@x.com", "SenhaBoa1")
        image = amb["blobs"][amb["unlabeled"][0]]
        r = await c.post(f"/classificacoes/ambiente/{id_amb}/classificar-tpu",
                         files={"file": ("x.jpg", image, "image/jpeg")}, headers=esp)
        assert r.status_code == 200, r.text
        body = r.json()
        assert body["modelo_versao"] == 1 and body["model"] == "swin_micro"
        textos = [o["texto_opcao"] for o in body["opcoes"]]
        assert set(textos) == {"gato", "cão"}

        id_mod = modelos[0]["id_mod"]
        r = await c.post(f"/treinamento/modelos/{id_mod}/sugerir", headers=admin)
        assert r.status_code == 200, r.text
        assert r.json()["sugeridas"] == 9 and r.json()["pendentes"] == 0   # 1 already
        r = await c.post(f"/treinamento/modelos/{id_mod}/sugerir", headers=admin)
        assert r.json()["sugeridas"] == 0
        r = await c.get("/auditoria/logs?page_size=100", headers=admin)
        eventos = {log["nome_evento"] for log in r.json()["logs"]}
        assert {"iniciar_treinamento", "inferencia_tpu", "sugestoes_em_lote"} <= eventos

        r = await c.get(f"/treinamento/modelos/{id_mod}/exportar", headers=admin)
        assert r.status_code == 200 and r.headers["content-type"] == "application/gzip"
        pacote = r.content
        with tarfile.open(fileobj=io.BytesIO(pacote), mode="r:gz") as tar:
            names = tar.getnames()
        assert "modelo.json" in names and "ckpt/step_4.pt" not in names
        assert {"ckpt/step_1.pt", "ckpt/step_3.pt"} <= set(names)      # the port's steps
        amb2 = seed_ambiente(app.state.db, tag="i")
        r = await c.post(f"/treinamento/ambiente/{amb2['id_amb']}/importar",
                         files={"file": ("m.tar.gz", pacote, "application/gzip")},
                         headers=admin)
        assert r.status_code == 201, r.text
        imported = r.json()
        assert imported["ativo"] and imported["versao"] == 1
        assert imported["metricas"]["importado"] is True
        r = await c.post(f"/classificacoes/ambiente/{amb2['id_amb']}/classificar-tpu",
                         files={"file": ("x.jpg", image, "image/jpeg")}, headers=esp)
        assert r.status_code == 200, r.text
        body2 = r.json()
        assert body2["id_mod"] == imported["id_mod"]
        assert [o["texto_opcao"] for o in body2["opcoes"]] == textos
        np.testing.assert_array_equal([o["score"] for o in body2["opcoes"]],
                                      [o["score"] for o in body["opcoes"]])
        assert {o["id_opc"] for o in body2["opcoes"]}.isdisjoint(amb["opcoes"])
        amb3 = seed_ambiente(app.state.db, tag="p", textos=("gato", "peixe"))
        r = await c.post(f"/treinamento/ambiente/{amb3['id_amb']}/importar",
                         files={"file": ("m.tar.gz", pacote, "application/gzip")},
                         headers=admin)
        assert r.status_code == 422 and "cão" in r.json()["detail"]

        # re-evaluate, then promote back: the routes answer as the reference's
        r = await c.post("/treinamento/modelos/nao-existe/avaliar", headers=admin)
        assert r.status_code == 404
        r = await c.post(f"/treinamento/modelos/{id_mod}/avaliar", headers=admin)
        assert r.status_code == 202 and r.json()["tipo"] == "avaliacao"
        ev = await _wait(c, r.json()["id_job"], admin)
        assert ev["status"] == "concluido" and ev["resultado"]["exemplos"] == 8, ev
        r = await c.get(f"/treinamento/modelos?id_amb={id_amb}", headers=admin)
        assert "reavaliacao" in r.json()["modelos"][0]["metricas"]
        r = await c.post(f"/treinamento/modelos/{id_mod}/ativar", headers=admin)
        assert r.status_code == 200 and r.json()["ativo"]
        r = await c.post("/treinamento/modelos/nao-existe/ativar", headers=admin)
        assert r.status_code == 404


@pytest.mark.anyio
async def test_cancel_resume_and_gc_through_the_routes(app):
    id_amb = app.state.amb["id_amb"]
    async with _client(app) as c:
        admin = await _login(c)
        r = await c.post(f"/treinamento/ambiente/{id_amb}",
                         json={**SMALL, "max_steps": 10_000, "epochs": 10_000}, headers=admin)
        assert r.status_code == 202, r.text
        id_job = r.json()["id_job"]
        assert (await c.post("/treinamento/jobs/nope/cancelar", headers=admin)).status_code \
            == 404
        for _ in range(1200):
            if (await c.get(f"/treinamento/jobs/{id_job}", headers=admin)).json()["passos"]:
                break
            await asyncio.sleep(0.02)
        r = await c.post(f"/treinamento/jobs/{id_job}/cancelar", headers=admin)
        assert r.status_code == 202, r.text
        job = await _wait(c, id_job, admin)
        assert job["status"] == "cancelado" and job["id_mod"] is None
        assert (await c.get("/treinamento/modelos", headers=admin)).json()["total"] == 0
        r = await c.post(f"/treinamento/jobs/{id_job}/cancelar", headers=admin)
        assert r.status_code == 409
        r = await c.post(f"/treinamento/ambiente/{id_amb}",
                         json={**SMALL, "max_steps": 2, "retomar_de": id_job}, headers=admin)
        assert r.status_code == 202, r.text
        job2 = await _wait(c, r.json()["id_job"], admin)
        assert job2["status"] == "concluido", job2
        assert job2["historico"][0]["step"] == job["passos"] + 1
        r = await c.get("/auditoria/logs?nome_evento=cancelar_treinamento", headers=admin)
        assert r.status_code == 200
        r = await c.post("/treinamento/gc", headers=admin)
        assert r.status_code == 200 and r.json()["removidos"] == []


@pytest.mark.anyio
async def test_job_progress_sse_stream(app):
    id_amb = app.state.amb["id_amb"]
    async with _client(app) as c:
        admin = await _login(c)
        r = await c.get("/treinamento/jobs/nao-existe/stream", headers=admin)
        assert r.status_code == 404
        r = await c.post(f"/treinamento/ambiente/{id_amb}", json=SMALL, headers=admin)
        id_job = r.json()["id_job"]
        passos, fim, event = [], None, None
        async with c.stream("GET", f"/treinamento/jobs/{id_job}/stream",
                            headers=admin) as resp:
            assert resp.status_code == 200
            assert resp.headers["content-type"].startswith("text/event-stream")
            async for line in resp.aiter_lines():
                if line.startswith("event: "):
                    event = line[len("event: "):]
                elif line.startswith("data: "):
                    data = json.loads(line[len("data: "):])
                    if event == "passo":
                        passos.append(data)
                    elif event == "fim":
                        fim = data
                        break
        assert [p["step"] for p in passos] == [1, 2, 3]
        assert all(np.isfinite(p["loss"]) for p in passos)
        assert fim["status"] == "concluido" and fim["id_job"] == id_job and fim["versao"] == 1


@pytest.mark.anyio
async def test_labeled_dataset_export_jsonl(app):
    id_amb = app.state.amb["id_amb"]
    async with _client(app) as c:
        admin = await _login(c)
        r = await c.get("/treinamento/ambiente/nao-existe/dataset", headers=admin)
        assert r.status_code == 404
        r = await c.get(f"/treinamento/ambiente/{id_amb}/dataset", headers=admin)
        assert r.status_code == 200, r.text
        assert r.headers["content-type"].startswith("application/x-ndjson")
        assert "attachment" in r.headers.get("content-disposition", "")
        lines = [json.loads(line) for line in r.text.strip().split("\n")]
        header, rows = lines[0], lines[1:]
        assert header["ambiente"] == id_amb and header["imagens_rotuladas"] == 8
        assert {o["texto"] for o in header["opcoes"]} == {"gato", "cão"}
        assert len(rows) == 8 and all(row["caminho"].startswith("/nextcloud/images/")
                                      for row in rows)
        textos = [lab["texto"] for row in rows for lab in row["rotulos"]]
        assert textos.count("gato") == 4 and textos.count("cão") == 4
        esp = await _login(c, "esp@x.com", "SenhaBoa1")
        r = await c.get(f"/treinamento/ambiente/{id_amb}/dataset", headers=esp)
        assert r.status_code == 403


@pytest.mark.anyio
async def test_indexar_then_search(app):
    amb = app.state.amb
    async with _client(app) as c:
        admin = await _login(c)
        r = await c.post("/inferencia/indexar", json={"limite": 0}, headers=admin)
        assert r.status_code == 200, r.text
        assert r.json()["indexadas"] == 1 and r.json()["pendentes"] == 1   # clamped to 1
        r = await c.post("/inferencia/indexar", json={"limite": "x"}, headers=admin)
        assert r.status_code == 422
        r = await c.post("/inferencia/indexar", json={}, headers=admin)
        body = r.json()
        assert body["indexadas"] == 9 and body["pendentes"] == 0
        assert body["total_indexadas"] == 10 and body["modelo"] == "resnet_tiny"
        r = await c.post("/inferencia/indexar", json={}, headers=admin)
        assert r.json()["indexadas"] == 0
        query_hash, query = next(iter(amb["blobs"].items()))
        r = await c.post("/images/buscar-similares?limite=3",
                         files={"file": ("q.jpg", query, "image/jpeg")}, headers=admin)
        assert r.status_code == 200, r.text
        got = r.json()
        assert got["hash_consulta"] == query_hash and len(got["similares"]) == 3
        assert query_hash not in [s["content_hash"] for s in got["similares"]]
        r = await c.get("/auditoria/logs?page_size=100", headers=admin)
        assert "indexar_embeddings" in {log["nome_evento"] for log in r.json()["logs"]}
        app.state.trainer.fetch_bytes = None
        r = await c.post("/inferencia/indexar", json={}, headers=admin)
        assert r.status_code == 503


@pytest.mark.anyio
async def test_monitor_painel_serves_the_dashboard(app):
    async with _client(app) as c:
        r = await c.get("/monitor/painel")
        assert r.status_code == 401
        assert (await c.get("/")).json()["painel"] == "/monitor/painel"
        r = await c.post("/auth/login", data={"username": settings.ADMIN_EMAIL,
                                              "password": settings.ADMIN_SENHA})
        assert r.status_code == 200
        r = await c.get("/monitor/painel")
        assert r.status_code == 200 and r.headers["content-type"].startswith("text/html")
        html = r.text
        assert "/monitor/status" in html and "/treinamento/jobs" in html
        assert "EventSource" in html
        assert "http://" not in html and "https://" not in html


@pytest.mark.anyio
async def test_a_package_a_jax_deployment_exported_is_imported_and_answers_503(app, tmp_path):
    """A package whose ``ckpt/`` holds orbax steps (exported by a JAX
    deployment) imports and registers as the reference's; serving it and
    suggesting with it answer 503 naming the conversion tool until
    ``convert_checkpoints.py`` has run; then the version serves."""
    import convert_checkpoints
    from tests.test_torch_resume import _jax_step

    amb = app.state.amb
    _jax_step(tmp_path / "jax_ckpt", model="swin_micro")
    buf = io.BytesIO()
    meta = {"formato": 1, "nome_modelo": "swin_micro", "versao_origem": 4, "num_classes": 2,
            "passo": 3, "metricas": {"temperatura": 1.0},
            "classes": [{"indice": i, "texto": t} for i, t in enumerate(["gato", "cão"])]}
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        payload = json.dumps(meta).encode()
        info = tarfile.TarInfo("modelo.json")
        info.size = len(payload)
        tar.addfile(info, io.BytesIO(payload))
        for path in sorted((tmp_path / "jax_ckpt").rglob("*")):
            if path.is_file():
                tar.add(path, arcname=f"ckpt/{path.relative_to(tmp_path / 'jax_ckpt')}")
    async with _client(app) as c:
        admin = await _login(c)
        r = await c.post(f"/treinamento/ambiente/{amb['id_amb']}/importar",
                         files={"file": ("m.tar.gz", buf.getvalue(), "application/gzip")},
                         headers=admin)
        assert r.status_code == 201, r.text
        row = r.json()
        assert row["ativo"] and row["metricas"]["versao_origem"] == 4
        r = await c.post(f"/treinamento/modelos/{row['id_mod']}/sugerir", headers=admin)
        assert r.status_code == 503 and "convert_checkpoints.py" in r.json()["detail"]
        esp = await _login(c, "esp@x.com", "SenhaBoa1")
        image = amb["blobs"][amb["unlabeled"][0]]
        url = f"/classificacoes/ambiente/{amb['id_amb']}/classificar-tpu"
        r = await c.post(url, files={"file": ("x.jpg", image, "image/jpeg")}, headers=esp)
        assert r.status_code == 503 and "convert_checkpoints.py" in r.json()["detail"]
        with app.state.db.session() as s:
            directory = s.fetchone("SELECT dir_checkpoint FROM modelos_treinados "
                                   "WHERE id_mod = ?", [row["id_mod"]])["dir_checkpoint"]
        assert convert_checkpoints.convert_directory(directory) == [3]
        r = await c.post(url, files={"file": ("x.jpg", image, "image/jpeg")}, headers=esp)
        assert r.status_code == 200 and r.json()["id_mod"] == row["id_mod"], r.text


# the validation bodies of the reference's test_augmentation_route_params_validate
# and test_optimizer_route_params_validate
BAD_BODIES = [
    {"augmentar": "false"},
    {"augmentar": False, "mixup_alpha": 0.2},
    {"suavizacao_rotulo": 1.5},
    {"augmentar": False, "cutmix_alpha": 1.0},
    {"cutmix_alpha": -1.0},
    {"otimizador": "lion"},
    {"ema_decaimento": 1.5},
    {"ema_decaimento": "x"},
    {"acumular_gradientes": 0},
    {"acumular_gradientes": "x"},
]


@pytest.mark.anyio
@pytest.mark.parametrize("bad", BAD_BODIES,
                         ids=lambda bad: ",".join(f"{k}={v}" for k, v in bad.items()))
async def test_validation_answers_as_the_jax_app(tmp_path, bad):
    """The same malformed body to the reference's app and the port's, on one
    database, each with its own trainer: the same status and ``detail``, and
    no job started."""
    from ics_tpu.db.engine import Database as JaxDatabase
    from ics_tpu.main import create_app as create_jax_app
    from ics_tpu.train.job import TrainingJobManager as JaxManager
    from ics_tpu_torch.main import create_app
    from ics_tpu_torch.train.job import TrainingJobManager

    url = f"sqlite:///{tmp_path}/shared.db"
    apps = {"ref": create_jax_app(db=JaxDatabase(url)), "port": create_app(db=Database(url))}
    for a in apps.values():
        await a.startup()
    try:
        amb = seed_ambiente(apps["port"].state.db)
        fetch = lambda h, _p: amb["blobs"][h]          # noqa: E731
        apps["ref"].state.trainer = JaxManager(apps["ref"].state.db, tmp_path / "w_ref",
                                               fetch_bytes=fetch)
        apps["port"].state.trainer = TrainingJobManager(apps["port"].state.db,
                                                        tmp_path / "w_port", fetch_bytes=fetch,
                                                        device="cpu")
        answers = {}
        for k, a in apps.items():
            async with _client(a) as c:
                r = await c.post(f"/treinamento/ambiente/{amb['id_amb']}",
                                 json={"modelo": "resnet_tiny", **bad},
                                 headers=await _login(c))
                answers[k] = (r.status_code, r.json()["detail"])
                assert (await c.get("/treinamento/jobs",
                                    headers=await _login(c))).json()["jobs"] == []
        assert answers["port"] == answers["ref"]
        assert answers["port"][0] == 422
    finally:
        for a in apps.values():
            await a.shutdown()
