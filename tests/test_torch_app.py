"""The port's app: classify over HTTP with a CPU service, startup rules, and
the rule that ``ics_tpu_torch`` never imports JAX (the wider rule, nothing of
``ics_tpu`` either, is held in ``test_torch_standalone.py``)."""

import ast
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import httpx
import numpy as np
import pytest
from PIL import Image

from ics_tpu_torch.core.config import settings
from ics_tpu_torch.db.engine import Database

REPO = Path(__file__).resolve().parents[1]


def _jpeg(seed, h=48, w=40):
    buf = io.BytesIO()
    Image.fromarray(
        np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    ).save(buf, "JPEG")
    return buf.getvalue()


async def _admin(client):
    r = await client.post("/auth/login", data={
        "username": settings.ADMIN_EMAIL, "password": settings.ADMIN_SENHA,
    })
    assert r.status_code == 200, r.text
    client.cookies.clear()
    return {"Authorization": f"Bearer {r.json()['access_token']}"}


@pytest.fixture()
async def served(tmp_path):
    from ics_tpu_torch.main import create_app
    from ics_tpu_torch.runtime.engine import InferenceEngine
    from ics_tpu_torch.runtime.service import InferenceService, InferenceServicePool

    service = InferenceService(
        InferenceEngine("vit_tiny", num_classes=10, precision="fp32",
                        buckets=(1, 4), canvas=64, device="cpu"),
        deadline_us=20_000, device_decode=False,   # these tests pin the host lane
    )
    await service.start()
    app = create_app(db=Database(f"sqlite:///{tmp_path}/torch_app.db"))
    app.state.engine = service
    app.state.engine_pool = InferenceServicePool("vit_tiny", device="cpu")
    app.state.engine_pool.add("vit_tiny", service)
    await app.startup()
    client = httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                               base_url="http://test")
    try:
        yield app, client, service
    finally:
        await client.aclose()
        await app.shutdown()
        await service.stop()


@pytest.mark.anyio
async def test_classify_three_images_over_http(served):
    app, client, service = served
    h = await _admin(client)
    files = [("files", (f"img{i}.jpg", _jpeg(i), "image/jpeg")) for i in range(3)]
    r = await client.post("/inferencia/classificar", files=files, headers=h)
    assert r.status_code == 200, r.text
    body = r.json()
    assert body["total"] == 3
    for res in body["resultados"]:
        assert len(res["top_classes"]) == len(res["scores"]) == 5
        assert res["model"] == "vit_tiny" and res["decode"] == "host"
        assert all(0.0 < s < 1.0 for s in res["scores"])
    r = await client.get("/inferencia/status", headers=h)
    st = r.json()
    assert st["backend"] == "cpu" and st["images"] == 3
    assert st["batcher"]["queued"] == 3


@pytest.mark.anyio
async def test_routes_of_the_port(served):
    app, client, _ = served
    h = await _admin(client)
    r = await client.get("/inferencia/modelos", headers=h)
    names = [m["nome"] for m in r.json()["modelos"]]
    assert names == ["convnext_small", "convnext_tiny", "densenet121", "densenet169",
                     "efficientnet_b0", "efficientnet_b4",
                     "efficientnet_v2_m", "efficientnet_v2_s", "mobilenetv3_small",
                     "regnet_y_1_6gf", "regnet_y_400mf",
                     "resnet101", "resnet152", "resnet18", "resnet34", "resnet50",
                     "resnext50_32x4d", "swin_base", "swin_small", "swin_tiny", "vit_b16",
                     "vit_l16", "vit_s16", "wide_resnet50_2"]   # dev models stay hidden
    r = await client.post("/inferencia/classificar?modelo=vit_tiny", headers=h,
                          files=[("files", ("a.jpg", _jpeg(0), "image/jpeg"))])
    assert r.status_code == 422
    r = await client.post("/inferencia/classificar", headers=h,
                          files=[("files", ("a.jpg", b"not an image", "image/jpeg"))])
    assert r.status_code == 422
    r = await client.get("/inferencia/status?modelo=vit_tiny", headers=h)
    assert r.status_code == 200 and r.json()["model"] == "vit_tiny"
    r = await client.get("/inferencia/status?modelo=resnet50", headers=h)
    assert r.status_code == 404                           # known, but not built
    r = await client.post("/inferencia/kernels/zerar", headers=h)
    assert r.status_code == 200 and set(r.json()["anteriores"]) == {
        "flash_attention", "bottleneck_chain", "normalize_u8", "depthwise_conv",
        "window_attention", "flash_attention_bf16_exp", "depthwise_conv_dx",
        "window_attention_bwd"}
    r = await client.post("/inferencia/warmup", headers=h)
    assert r.status_code == 200 and r.json()["buckets"] == [1, 4]
    assert r.json()["replicas"] == 1                      # as the JAX route answers
    assert (await client.get("/health")).json()["status"] == "healthy"
    assert "tpu_images_total" in (await client.get("/monitor/metrics")).text
    paths = {route.path for route in app.router.routes}
    assert "/classificacoes/ambiente/{id_amb}/inicializar" in paths
    assert {"/classificacoes/ambiente/{id_amb}/explicar",
            "/classificacoes/ambiente/{id_amb}/classificar-tpu",
            "/monitor/latency-budget"} <= paths
    assert not any(p.startswith("/treinamento") for p in paths)
    assert {"/images/buscar-similares", "/images/{content_hash}/similares",
            "/images/buscar-por-hash", "/monitor/status",
            "/classificacoes/ambiente/{id_amb}/sugerir-vizinhos/{content_hash}"} <= paths
    assert "/inferencia/indexar" not in paths and "/monitor/painel" not in paths
    r = await client.get("/openapi.json")
    assert r.status_code == 200 and "/inferencia/classificar" in r.json()["paths"]


@pytest.fixture()
def public_dev_models():
    """One dev-size model per new family, registered at 64 px as public
    names, so that ``?modelo=`` reaches them."""
    import ics_tpu_torch.models.registry as registry
    from ics_tpu_torch.models import convnext, densenet, efficientnet, mobilenetv3, regnet, swin

    constructors = {
        "convnext_dev": lambda num_classes, device=None: convnext.ConvNeXt(
            (1, 1, 1, 1), (16, 32, 64, 128), num_classes, device=device),
        "mobilenetv3_dev": mobilenetv3.mobilenetv3_small,
        "efficientnet_dev": lambda num_classes, device=None: efficientnet.efficientnet_v1(
            0.25, 0.5, num_classes=num_classes, device=device),
        "swin_dev": swin.swin_micro,
        "densenet_dev": densenet.densenet_micro,
        "regnet_dev": regnet.regnet_micro,
    }
    for name, build in constructors.items():
        registry._REGISTRY[name] = registry.ModelSpec(name, build, 64, 64)
    try:
        yield sorted(constructors)
    finally:
        for name in constructors:
            del registry._REGISTRY[name]


@pytest.mark.anyio
@pytest.mark.parametrize("name", ["convnext_dev", "mobilenetv3_dev", "efficientnet_dev",
                                  "swin_dev", "densenet_dev", "regnet_dev"])
async def test_classify_with_modelo_builds_and_serves_the_new_families(
        served, public_dev_models, name):
    app, client, _ = served
    app.state.engine_pool.engine_kwargs.update(
        num_classes=10, precision="fp32", buckets=(1, 4), canvas=64)
    h = await _admin(client)
    files = [("files", (f"img{i}.jpg", _jpeg(i), "image/jpeg")) for i in range(2)]
    try:
        r = await client.post(f"/inferencia/classificar?modelo={name}", files=files, headers=h)
        assert r.status_code == 200, r.text
        for res in r.json()["resultados"]:
            assert res["model"] == name and len(set(res["top_classes"])) == 5
            assert all(0.0 < s < 1.0 for s in res["scores"])
            assert res["scores"] == sorted(res["scores"], reverse=True)
        st = (await client.get(f"/inferencia/status?modelo={name}", headers=h)).json()
        assert st["model"] == name and st["backend"] == "cpu" and st["images"] == 2
        assert st["kernel_launches"]["depthwise_conv"] == 0      # plain versions on the CPU
    finally:
        await app.state.engine_pool.stop()


@pytest.mark.anyio
async def test_engine_that_fails_to_build_fails_startup(tmp_path):
    from ics_tpu_torch.core.config import reload_settings
    from ics_tpu_torch.main import create_app

    reload_settings(TPU_ENABLE_INFERENCE="true", TPU_DEFAULT_MODEL="no_such_model")
    try:
        app = create_app(db=Database(f"sqlite:///{tmp_path}/fail.db"))
        with pytest.raises(KeyError, match="no_such_model"):
            await app.startup()
        assert app.state.get("engine") is None
    finally:
        reload_settings()


def test_package_has_no_jax_import():
    found = []
    for path in sorted((REPO / "ics_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            found += [f"{path.name}:{node.lineno}:{m}" for m in mods
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax")]
    assert found == []


_SERVE_ONE = r"""
import asyncio, io, json, sys
import httpx, numpy as np
from PIL import Image

async def main():
    from ics_tpu_torch.core.config import settings
    from ics_tpu_torch.db.engine import Database
    from ics_tpu_torch.main import create_app
    from ics_tpu_torch.runtime.engine import InferenceEngine
    from ics_tpu_torch.runtime.service import InferenceService

    service = InferenceService(InferenceEngine(
        "vit_tiny", num_classes=10, precision="fp32", buckets=(1,), canvas=64,
        device="cpu"))
    await service.start()
    app = create_app(db=Database(sys.argv[1]))
    app.state.engine = service
    await app.startup()
    buf = io.BytesIO()
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(buf, "PNG")
    async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                 base_url="http://t") as c:
        r = await c.post("/auth/login", data={
            "username": settings.ADMIN_EMAIL, "password": settings.ADMIN_SENHA})
        h = {"Authorization": "Bearer " + r.json()["access_token"]}
        r = await c.post("/inferencia/classificar", headers=h,
                         files=[("files", ("a.png", buf.getvalue(), "image/png"))])
    await app.shutdown()
    await service.stop()
    print(json.dumps({"status": r.status_code, "total": r.json()["total"],
                      "jax": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib"))}))

asyncio.run(main())
"""


def test_serving_a_classify_never_imports_jax(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(ENV="test", TPU_ENABLE_INFERENCE="false",
               PYTHONPATH=str(REPO), JWT_SECRET_KEY="test-secret")
    out = subprocess.run(
        [sys.executable, "-c", _SERVE_ONE, f"sqlite:///{tmp_path}/nojax.db"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"status": 200, "total": 1, "jax": []}


def test_from_settings_hands_fused_chains_on_and_says_device_decode_once(monkeypatch, caplog):
    """``TPU_DEVICE_DECODE`` is served now: the service takes it on, with the
    entropy decoder built, and no warning names it."""
    import logging

    from ics_tpu_torch.core.config import reload_settings
    from ics_tpu_torch.runtime import service as service_mod
    from ics_tpu_torch.runtime.engine import InferenceEngine

    built = []

    def cpu_engine(**kwargs):
        built.append(kwargs)
        return InferenceEngine(device="cpu", **kwargs)

    monkeypatch.setattr(service_mod, "InferenceEngine", cpu_engine)
    monkeypatch.setattr(service_mod, "_warned", set())
    reload_settings(TPU_DEFAULT_MODEL="resnet_tiny", TPU_FUSED_CHAINS="true",
                    TPU_DEVICE_DECODE="true", TPU_NUM_CLASSES="10", TPU_BATCH_BUCKETS="1,2")
    try:
        with caplog.at_level(logging.INFO, logger=service_mod.__name__):
            first = service_mod.InferenceService.from_settings()
            service_mod.InferenceService.from_settings()
    finally:
        reload_settings()
    assert [kw["fused_chains"] for kw in built] == [True, True]
    assert built[0]["model_name"] == "resnet_tiny" and built[0]["buckets"] == (1, 2)
    assert [r for r in caplog.records if "TPU_DEVICE_DECODE" in r.getMessage()] == []
    assert [r for r in caplog.records if r.levelno >= logging.WARNING] == []
    status = first.status()
    assert status["device_decode"] is True and status["fused_chains"] is True
    assert first.device_decode and status["coeff_lanes"] == {}


@pytest.mark.anyio
async def test_metrics_scrape_uses_the_reference_names(served):
    """``/monitor/metrics`` emits the JAX package's gauge names with the
    port's numbers; the kernel-launch gauges are the port's own."""
    app, client, service = served
    h = await _admin(client)
    files = [("files", (f"img{i}.jpg", _jpeg(i), "image/jpeg")) for i in range(3)]
    r = await client.post("/inferencia/classificar", files=files, headers=h)
    assert r.status_code == 200, r.text
    text = (await client.get("/monitor/metrics")).text
    values = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            values[name] = float(value)
    st = service.status()
    assert values["tpu_images_total"] == st["images"] == 3
    assert values["tpu_batches_total"] == st["batches"] >= 1
    assert values["tpu_host_decoded_total"] == 3
    assert values["tpu_lane_flushes_pixel_total"] == st["batcher"]["flushes"] >= 1
    assert values["tpu_pipelined_flushes_total"] == st["batcher"]["pipelined"]
    assert values["tpu_lane_pipelined_pixel_total"] == st["batcher"]["pipelined"]
    assert "gpu_kernel_launches_depthwise_conv_total" in values
    assert not any(name.startswith(("gpu_images", "gpu_batches")) for name in values)


@pytest.mark.anyio
@pytest.mark.parametrize("name", ["resnet18", "resnext50_32x4d"])
async def test_modelo_without_a_chain_path_is_served_under_fused_chains(served, name):
    """``TPU_FUSED_CHAINS`` is handed to every engine of the pool: a ResNet
    that fold cannot chain is built without chains and answers 200."""
    app, client, _ = served
    app.state.engine_pool.engine_kwargs.update(
        num_classes=10, precision="fp32", buckets=(1,), canvas=64, fused_chains=True)
    h = await _admin(client)
    try:
        r = await client.post(f"/inferencia/classificar?modelo={name}", headers=h,
                              files=[("files", ("a.jpg", _jpeg(0), "image/jpeg"))])
        assert r.status_code == 200, r.text
        assert r.json()["resultados"][0]["model"] == name
        st = (await client.get(f"/inferencia/status?modelo={name}", headers=h)).json()
        assert st["fused_chains"] is False
    finally:
        await app.state.engine_pool.stop()


@pytest.mark.anyio
@pytest.mark.parametrize("error", [ValueError("no chain path"), RuntimeError("pool stopped")])
async def test_modelo_that_cannot_be_built_answers_422(served, monkeypatch, error):
    """A build that raises RuntimeError or ValueError is the deployment not
    going with the client's model: 422 with the reason, as the JAX route."""
    app, client, _ = served

    async def refuse(name=None):
        raise error

    monkeypatch.setattr(app.state.engine_pool, "get", refuse)
    h = await _admin(client)
    r = await client.post("/inferencia/classificar?modelo=resnet50", headers=h,
                          files=[("files", ("a.jpg", _jpeg(0), "image/jpeg"))])
    assert r.status_code == 422
    assert "resnet50" in r.text and str(error) in r.text


_UNSERVED = {
    "TPU_SERVING_REPLICAS": ("2", "TPU_SERVING_REPLICAS"),
    "TPU_MESH_SHAPE": ("2,1", "TPU_MESH_SHAPE"),
    "TPU_PP_STAGES": ("2", "TPU_PP_STAGES"),
}
# served since the sync engine, classify-on-sync and the embed step were
# ported (NEXTCLOUD_BASE_URL with TPU_CLASSIFY_ON_SYNC at its default, on),
# and restart segments on worker threads: taken with no notice
_SERVED = {
    "TPU_EMBED_ON_SYNC": "true",
    "NEXTCLOUD_BASE_URL": "https://cloud.example.com",
    "TPU_DECODE_THREADS": "4",
}


@pytest.mark.parametrize("setting", sorted(_UNSERVED | _SERVED))
def test_settings_taken_but_not_served_are_said_once(monkeypatch, caplog, setting):
    import logging

    from ics_tpu_torch.core.config import reload_settings
    from ics_tpu_torch.runtime import service as service_mod

    value, word = _UNSERVED.get(setting, (_SERVED.get(setting), None))
    monkeypatch.setattr(service_mod, "_warned", set())
    reload_settings(**{"TPU_DEVICE_DECODE": "false", "NEXTCLOUD_BASE_URL": "",
                       setting: value})
    try:
        assert setting != "NEXTCLOUD_BASE_URL" or service_mod.settings.TPU_CLASSIFY_ON_SYNC
        with caplog.at_level(logging.INFO, logger=service_mod.__name__):
            service_mod.warn_unserved_settings()
            service_mod.warn_unserved_settings()
    finally:
        reload_settings()
    notices = [r for r in caplog.records if r.levelno == logging.WARNING]
    if setting in _SERVED:
        assert notices == []
        return
    assert len(notices) == 1 and word in notices[0].getMessage()
    assert "not ported yet" in notices[0].getMessage()


def test_default_settings_say_nothing_of_unserved_modules(monkeypatch, caplog):
    import logging

    from ics_tpu_torch.core.config import reload_settings
    from ics_tpu_torch.runtime import service as service_mod

    monkeypatch.setattr(service_mod, "_warned", set())
    reload_settings(TPU_DEVICE_DECODE="false", NEXTCLOUD_BASE_URL="")
    try:
        with caplog.at_level(logging.INFO, logger=service_mod.__name__):
            service_mod.warn_unserved_settings()
    finally:
        reload_settings()
    assert [r for r in caplog.records if r.levelno >= logging.WARNING] == []


@pytest.mark.anyio
async def test_lifespan_says_unserved_settings_before_the_engine_is_built(
        tmp_path, monkeypatch, caplog):
    import logging

    from ics_tpu_torch.core.config import reload_settings
    from ics_tpu_torch.main import create_app
    from ics_tpu_torch.runtime import service as service_mod

    monkeypatch.setattr(service_mod, "_warned", set())
    reload_settings(TPU_ENABLE_INFERENCE="true", TPU_DEFAULT_MODEL="no_such_model",
                    TPU_SERVING_REPLICAS="3", TPU_DEVICE_DECODE="false")
    try:
        app = create_app(db=Database(f"sqlite:///{tmp_path}/warn.db"))
        with caplog.at_level(logging.WARNING, logger=service_mod.__name__):
            with pytest.raises(KeyError, match="no_such_model"):
                await app.startup()
    finally:
        reload_settings()
    assert any("TPU_SERVING_REPLICAS=3" in r.getMessage() for r in caplog.records)


# ---- the serving extras against the reference's app on the same database -----------------

def _seed_ambiente(db, image: bytes) -> dict:
    """A specialist with access to an ambiente of three options, and
    ``image`` as a synced image, written through the reference's models."""
    from ics_tpu.core import timezone as tz
    from ics_tpu.core.security import hash_password, sha256_hex
    from ics_tpu.db import models as m

    now = tz.utcnow()
    with db.session() as s:
        esp = m.Usuario(nome_completo="Especialista", email="esp@x.com",
                        senha_hash=hash_password("SenhaBoa1"), data_criado=now, id_tipo=1)
        s.add(esp)
        s.flush()
        con = m.UsuarioConvencional(cpf="2" * 11, id_usu=esp.id_usu)
        s.add(con)
        s.flush()
        adm = s.fetchone("SELECT id_adm FROM usuarios_administradores LIMIT 1")
        cnj = m.ConjuntoImagens(nome_conj="f", caminho_conj="/f", file_id="1",
                                imagens_sincronizadas=True, data_proc=now, data_sinc=now)
        s.add(cnj)
        s.flush()
        amb = m.Ambiente(titulo_amb="Extras", descricao_questionario="d", data_criado=now,
                         id_adm=adm["id_adm"])
        s.add(amb)
        s.flush()
        s.add(m.AmbienteConjuntoImagens(id_amb=amb.id_amb, id_cnj=cnj.id_cnj, data_associado=now))
        s.add(m.UsuarioAmbiente(id_con=con.id_con, id_amb=amb.id_amb, data_associado=now))
        options = [m.Opcao(texto=t, id_amb=amb.id_amb) for t in ("gato", "cão", "pássaro")]
        s.add_all(options)
        s.add(m.Imagem(content_hash=sha256_hex(image), nome_img="a.jpg", caminho_img="f/a.jpg",
                       data_proc=now, data_sinc=now, id_cnj=cnj.id_cnj))
        s.commit()
        return {"id_amb": str(amb.id_amb), "options": [str(o.id_opc) for o in options],
                "hash": sha256_hex(image)}


def _register_version(db, amb: dict, directory, temperature=2.0, port_copy=True) -> None:
    """Version 1 of ``resnet_tiny`` over the ambiente's options, active, its
    weights in ``directory`` twice: orbax (the reference's manager) and
    ``torch.save`` (the port's), from one randomised tree; with
    ``port_copy=False`` orbax alone, as the JAX trainer leaves it."""
    from ics_tpu.core import timezone as tz
    from ics_tpu.db import models as m
    from ics_tpu.train.checkpoint import CheckpointManager as JaxManager
    from ics_tpu_torch import weights
    from ics_tpu_torch.train.checkpoint import CheckpointManager
    from tests.test_torch_engine_pairs import variables_of

    variables = variables_of("resnet_tiny", 3, seed=4)
    mgr = JaxManager(directory)
    mgr.save(3, variables)
    mgr.close()
    if port_copy:
        CheckpointManager(directory).save(3, weights.from_jax_variables(variables))
    with db.session() as s:
        s.add(m.ModeloTreinado(
            id_amb=amb["id_amb"], nome_modelo="resnet_tiny", versao=1, num_classes=3,
            class_map={o: i for i, o in enumerate(amb["options"])},
            dir_checkpoint=str(directory), passo=3, metricas={"temperatura": temperature},
            ativo=True, data_criado=tz.utcnow()))
        s.commit()


def _services(model: str):
    """(reference service and pool, port service and pool) of ``model`` on
    the same randomised weights, fp32, host decode."""
    from ics_tpu.runtime.service import InferenceService as JaxService
    from ics_tpu.runtime.service import InferenceServicePool as JaxPool
    from ics_tpu_torch.runtime.service import InferenceService, InferenceServicePool
    from tests.test_torch_engine_pairs import engine_pair

    jax_engine, engine = engine_pair(model, num_classes=8, buckets=(1, 4))
    kwargs = dict(num_classes=8, precision="fp32", buckets=(1, 4), canvas=64)
    return ((JaxService(jax_engine, deadline_us=20_000, device_decode=False),
             JaxPool(model, deadline_us=20_000, device_decode=False, **kwargs)),
            (InferenceService(engine, deadline_us=20_000, device_decode=False),
             InferenceServicePool(model, deadline_us=20_000, device_decode=False, device="cpu",
                                  **kwargs)))


@pytest.fixture()
async def both_apps(tmp_path, request):
    """The reference's app and the port's on one SQLite file, each serving
    ``request.param`` (default ``resnet_tiny``) on the same weights."""
    from ics_tpu.db.engine import Database as JaxDatabase
    from ics_tpu.main import create_app as create_jax_app
    from ics_tpu_torch.main import create_app

    url = f"sqlite:///{tmp_path}/shared.db"
    apps = {"ref": create_jax_app(db=JaxDatabase(url)), "port": create_app(db=Database(url))}
    for app in apps.values():
        await app.startup()
    image = _jpeg(11, 56, 60)
    amb = _seed_ambiente(apps["ref"].state.db, image)
    model = getattr(request, "param", "resnet_tiny")
    for app, (service, pool) in zip(apps.values(), _services(model)):
        await service.start()
        app.state.engine = service
        app.state.engine_pool = pool
    clients = {k: httpx.AsyncClient(transport=httpx.ASGITransport(app=a), base_url="http://t")
               for k, a in apps.items()}
    try:
        yield apps, clients, amb, image
    finally:
        for k, app in apps.items():
            await clients[k].aclose()
            await app.state.engine.stop()
            await app.state.engine_pool.stop()
            await app.shutdown()


async def _login(client, username="esp@x.com", password="SenhaBoa1"):
    r = await client.post("/auth/login", data={"username": username, "password": password})
    assert r.status_code == 200, r.text
    client.cookies.clear()
    return {"Authorization": f"Bearer {r.json()['access_token']}"}


async def _post_both(clients, path, image=None, field="file"):
    """The same request to both apps: {app: response}."""
    out = {}
    for k, c in clients.items():
        files = None if image is None else {field: ("a.jpg", image, "image/jpeg")}
        out[k] = await c.post(path, files=files, headers=await _login(c))
    return out


@pytest.mark.anyio
async def test_upload_routes_answer_503_and_422_as_the_reference(both_apps):
    apps, clients, amb, image = both_apps
    base = f"/classificacoes/ambiente/{amb['id_amb']}"
    for path in ("/classificar-tpu", "/explicar"):
        r = await _post_both(clients, base + path, image, field="outro")     # no file part
        assert r["ref"].status_code == r["port"].status_code == 422
        assert r["port"].json()["detail"] == r["ref"].json()["detail"]
    for path, detail in (("/explicar?suavizar=99", "suavizar deve estar"),
                         ("/explicar?suavizar=abc", "suavizar"),
                         (f"/explicar?id_opc={amb['options'][0]}", "modelo treinado")):
        r = await _post_both(clients, base + path, image)
        assert r["ref"].status_code == r["port"].status_code == 422, path
        assert detail in r["port"].json()["detail"] == r["ref"].json()["detail"]
    saved = {k: (a.state.engine, a.state.engine_pool) for k, a in apps.items()}
    for app in apps.values():
        app.state.engine = None
    try:
        for path in ("/classificar-tpu", "/explicar"):
            r = await _post_both(clients, base + path, image)
            assert r["ref"].status_code == r["port"].status_code == 503
        for c in clients.values():
            r = await c.post("/monitor/latency-budget", headers=await _admin(c))
            assert r.status_code == 503
    finally:
        for k, app in apps.items():
            app.state.engine, app.state.engine_pool = saved[k]


@pytest.mark.anyio
async def test_classificar_tpu_stores_the_suggestion_and_the_audit_row(both_apps):
    from ics_tpu_torch.db import models as m

    apps, clients, amb, image = both_apps
    db = apps["port"].state.db
    stored, answers = {}, {}
    for k, c in clients.items():
        for tta in ("", "?tta=true"):
            r = await c.post(f"/classificacoes/ambiente/{amb['id_amb']}/classificar-tpu{tta}",
                             files={"file": ("a.jpg", image, "image/jpeg")},
                             headers=await _login(c))
            assert r.status_code == 200, r.text
            answers[k, tta] = r.json()
        with db.session() as s:
            rows = s.query(m.SugestaoModelo).filter(
                m.SugestaoModelo.id_img == amb["hash"]).all()
            stored[k] = [(r.modelo, r.id_amb, [c["classe"] for c in r.classes]) for r in rows]
            events = s.fetchall(
                "SELECT l.detalhes FROM logs_auditoria l JOIN eventos_auditoria e "
                "ON l.evento_id = e.id_evento WHERE e.nome = 'inferencia_tpu'")
            stored[k, "audit"] = len(events)
    for tta in ("", "?tta=true"):
        ref, got = answers["ref", tta], answers["port", tta]
        assert set(got) == set(ref) and got.get("tta") == ref.get("tta")
        assert got["top_classes"] == ref["top_classes"] and got["model"] == "resnet_tiny"
        np.testing.assert_allclose(got["scores"], ref["scores"], atol=2e-4, rtol=1e-4)
    # one suggestion row of the default model (the port's upsert replaces the reference's)
    assert stored["ref"] == stored["port"] == [("resnet_tiny", None, stored["ref"][0][2])]
    assert stored["ref"][0][2] == answers["ref", "?tta=true"]["top_classes"]
    assert (stored["ref", "audit"], stored["port", "audit"]) == (2, 4)


@pytest.mark.anyio
async def test_a_trained_version_serves_both_routes_as_the_reference(both_apps, tmp_path):
    apps, clients, amb, image = both_apps
    _register_version(apps["ref"].state.db, amb, tmp_path / "v1")
    base = f"/classificacoes/ambiente/{amb['id_amb']}"
    target = amb["options"][1]
    for path in ("/classificar-tpu", "/classificar-tpu?tta=sim", "/explicar",
                 f"/explicar?id_opc={target}", "/explicar?suavizar=3"):
        r = await _post_both(clients, base + path, image)
        assert r["ref"].status_code == r["port"].status_code == 200, (path, r["port"].text)
        ref, got = r["ref"].json(), r["port"].json()
        assert set(got) - {"latency_ms"} == set(ref) - {"latency_ms"}, path
        assert got["modelo_versao"] == ref["modelo_versao"] == 1
        assert [o["id_opc"] for o in got["opcoes"]] == [o["id_opc"] for o in ref["opcoes"]]
        np.testing.assert_allclose([o["score"] for o in got["opcoes"]],
                                   [o["score"] for o in ref["opcoes"]], atol=2e-4, rtol=1e-4)
        if path.startswith("/classificar-tpu"):
            assert got["temperatura"] == ref["temperatura"] == 2.0
        elif "suavizar" in path:
            assert got["suavizacao"] == ref["suavizacao"] == 4
            assert got["metodo"] == ref["metodo"] == "smoothgrad"
        else:       # one sample: the same map
            np.testing.assert_allclose(got["mapa_saliencia"], ref["mapa_saliencia"], atol=2e-4)
            assert got.get("id_opc_explicado") == ref.get("id_opc_explicado")
    r = await _post_both(clients, base + "/explicar?id_opc=nao-existe", image)
    assert r["ref"].status_code == r["port"].status_code == 422
    assert r["port"].json()["detail"] == r["ref"].json()["detail"]
    from ics_tpu_torch.db import models as m

    with apps["port"].state.db.session() as s:
        rows = s.query(m.SugestaoModelo).filter(m.SugestaoModelo.id_amb == amb["id_amb"]).all()
        assert len(rows) == 1
        row = rows[0]
        assert row.versao == 1 and row.modelo == "resnet_tiny" and len(row.classes) == 3


@pytest.mark.anyio
async def test_a_version_the_jax_trainer_wrote_is_served_after_conversion(both_apps, tmp_path):
    """A version whose directory holds the JAX trainer's orbax steps alone:
    the reference serves it; the port answers 503 naming the conversion tool
    and the directory; once ``convert_checkpoints.py`` has run over the
    database, the port serves the reference's top-5 and scores."""
    import convert_checkpoints
    from ics_tpu_torch.train.checkpoint import CONVERSION_TOOL

    apps, clients, amb, image = both_apps
    directory = tmp_path / "jax_v1"
    _register_version(apps["ref"].state.db, amb, directory, port_copy=False)
    assert not list(directory.glob("step_*.pt"))
    base = f"/classificacoes/ambiente/{amb['id_amb']}"
    paths = ("/classificar-tpu", "/explicar")
    for path in paths:
        r = await _post_both(clients, base + path, image)
        assert r["ref"].status_code == 200, r["ref"].text
        assert r["port"].status_code == 503, r["port"].text
        detail = r["port"].json()["detail"]
        assert CONVERSION_TOOL in detail and str(directory) in detail
    assert convert_checkpoints.main(["--database-url", f"sqlite:///{tmp_path}/shared.db"]) == 0
    assert [p.name for p in directory.glob("step_*.pt")] == ["step_3.pt"]
    assert convert_checkpoints.convert_directory(directory) == []      # done once
    for path in paths:
        r = await _post_both(clients, base + path, image)
        assert r["ref"].status_code == r["port"].status_code == 200, (path, r["port"].text)
        ref, got = r["ref"].json(), r["port"].json()
        assert got["modelo_versao"] == ref["modelo_versao"] == 1
        assert [o["id_opc"] for o in got["opcoes"]] == [o["id_opc"] for o in ref["opcoes"]]
        np.testing.assert_allclose([o["score"] for o in got["opcoes"]],
                                   [o["score"] for o in ref["opcoes"]], atol=2e-4, rtol=1e-4)


def test_the_conversion_tool_writes_what_the_port_restores(tmp_path):
    """``convert_checkpoints.py`` on a directory: every orbax step gets its
    ``step_<n>.pt``, holding ``weights.from_jax_variables`` of that step's
    tree and its metadata as plain values; the port's manager raises the
    named error before and restores after; a directory with neither is an
    error (exit 1)."""
    import torch

    import convert_checkpoints
    from ics_tpu.train.checkpoint import CheckpointManager as JaxManager
    from ics_tpu_torch import weights
    from ics_tpu_torch.train.checkpoint import CheckpointManager, UnconvertedCheckpointError
    from tests.test_torch_engine_pairs import variables_of

    trees = {2: variables_of("resnet_tiny", 3, seed=1), 5: variables_of("resnet_tiny", 3, seed=2)}
    mgr = JaxManager(tmp_path / "v")
    for step, tree in trees.items():
        mgr.save(step, tree, metadata={"epoch": step, "acc": 0.5})
    mgr.close()
    with pytest.raises(UnconvertedCheckpointError, match="convert_checkpoints.py") as err:
        CheckpointManager(tmp_path / "v").restore()
    assert err.value.steps == [2, 5] and isinstance(err.value, FileNotFoundError)
    assert convert_checkpoints.main([str(tmp_path / "v")]) == 0
    port = CheckpointManager(tmp_path / "v")
    assert port.steps() == [2, 5]
    for step, tree in trees.items():
        got = port.restore(step)
        want = weights.from_jax_variables(tree)
        assert set(got["state_dict"]) == set(want)
        assert all(torch.equal(got["state_dict"][k], want[k]) for k in want)
        assert got["metadata"] == {"epoch": step, "acc": 0.5}
    (tmp_path / "empty").mkdir()
    assert convert_checkpoints.main([str(tmp_path / "empty")]) == 1


@pytest.mark.anyio
@pytest.mark.parametrize("both_apps", ["vit_tiny"], indirect=True)
async def test_vit_explicar_is_a_422_in_both_apps(both_apps):
    _, clients, amb, image = both_apps
    r = await _post_both(clients, f"/classificacoes/ambiente/{amb['id_amb']}/explicar", image)
    assert r["ref"].status_code == r["port"].status_code == 422
    assert r["ref"].json()["detail"] == "Imagem inválida ou não decodificável."
    # the one divergence: the port says why
    assert "vit_tiny" in r["port"].json()["detail"] and "gradiente" in r["port"].json()["detail"]
    r = await _post_both(clients, f"/classificacoes/ambiente/{amb['id_amb']}/classificar-tpu",
                         image)
    assert r["ref"].status_code == r["port"].status_code == 200


@pytest.mark.anyio
async def test_latency_budget_route_as_the_reference(both_apps):
    _, clients, _, _ = both_apps
    bodies = {}
    for k, c in clients.items():
        r = await c.post("/monitor/latency-budget", headers=await _login(c))
        assert r.status_code == 403                      # admin only
        r = await c.post("/monitor/latency-budget", headers=await _admin(c))
        assert r.status_code == 200, r.text
        bodies[k] = r.json()
    ref, got = bodies["ref"], bodies["port"]
    assert set(got) == set(ref) and set(got["componentes"]) == set(ref["componentes"])
    assert got["orcamento"] == ref["orcamento"]          # the cpu lines
    assert got["dentro_do_orcamento"] is True and got["violacoes"] == []
    metrics = (await clients["port"].get("/monitor/metrics")).text
    assert "latency_budget_device_step_b8_ms" in metrics
