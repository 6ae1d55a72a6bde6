"""The port's app: classify over HTTP with a CPU service, startup rules, and
the rule that ``ics_tpu_torch`` never imports JAX."""

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

from ics_tpu.core.config import settings
from ics_tpu.db.engine import Database

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
        deadline_us=20_000,
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
    assert names == ["vit_b16", "vit_l16", "vit_s16"]   # dev models stay hidden
    r = await client.post("/inferencia/classificar?modelo=vit_tiny", headers=h,
                          files=[("files", ("a.jpg", _jpeg(0), "image/jpeg"))])
    assert r.status_code == 422
    r = await client.post("/inferencia/classificar", headers=h,
                          files=[("files", ("a.jpg", b"not an image", "image/jpeg"))])
    assert r.status_code == 422
    r = await client.post("/inferencia/kernels/zerar", headers=h)
    assert r.status_code == 200 and set(r.json()["anteriores"]) == {"flash_attention"}
    r = await client.post("/inferencia/warmup", headers=h)
    assert r.status_code == 200 and r.json()["buckets"] == [1, 4]
    assert (await client.get("/health")).json()["status"] == "healthy"
    assert "gpu_images_total" in (await client.get("/monitor/metrics")).text
    paths = {route.path for route in app.router.routes}
    assert "/classificacoes/ambiente/{id_amb}/inicializar" in paths
    assert "/classificacoes/ambiente/{id_amb}/explicar" not in paths
    assert not any(p.startswith(("/images", "/treinamento")) for p in paths)
    assert "/inferencia/indexar" not in paths
    r = await client.get("/openapi.json")
    assert r.status_code == 200 and "/inferencia/classificar" in r.json()["paths"]


@pytest.mark.anyio
async def test_engine_that_fails_to_build_fails_startup(tmp_path):
    from ics_tpu.core.config import reload_settings
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
    from ics_tpu.core.config import settings
    from ics_tpu.db.engine import Database
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
