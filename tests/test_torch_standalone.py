"""The port stands on its own: ``ics_tpu_torch`` imports nothing of ``ics_tpu``
and no JAX, and each host tier it copied still answers as the original.

``ics_tpu`` is imported here only as the reference the copies are held
against; the served-classify check runs in a subprocess that starts with
neither package loaded.
"""

import ast
import importlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

REPO = Path(__file__).resolve().parents[1]
# the conversion tool at the root reads orbax with the JAX package: only its
# users import it, never the port
FORBIDDEN = ("ics_tpu", "jax", "jaxlib", "flax", "optax", "orbax", "convert_checkpoints")

# routes of ics_tpu.main.create_app() the port does not serve yet
# (ROADMAP.md, "Deferred from these modules")
DEFERRED_PREFIXES = ("/treinamento",)
DEFERRED_ROUTES = {
    ("POST", "/inferencia/indexar"),
    ("GET", "/monitor/painel"),
}
# routes only the port has
PORT_ONLY_ROUTES = {("POST", "/inferencia/kernels/zerar")}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("top", FORBIDDEN)
def test_no_module_of_the_port_imports(top):
    files = sorted((REPO / "ics_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 80
    found = [f"{path.relative_to(REPO)}:{line}: {mod}"
             for path in files for line, mod in _imports(path)
             if mod.split(".")[0] == top]
    assert found == []


def test_no_dynamic_import_names_the_jax_package():
    """``importlib.import_module("ics_tpu....")`` and ``__import__`` strings
    would pass the AST scan: the one dynamic import of the port, the
    migrations package, names the port's own."""
    from ics_tpu_torch.db import migrate

    assert migrate.MIGRATIONS_PACKAGE == "ics_tpu_torch.db.migrations"
    for path in sorted((REPO / "ics_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                value = node.value
                if value.startswith("ics_tpu.") or value == "ics_tpu":
                    pytest.fail(f"{path.relative_to(REPO)}:{node.lineno}: {value!r}")


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
        "resnet_tiny", num_classes=10, precision="fp32", buckets=(1,), canvas=64,
        device="cpu", fused_chains=True))
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
        docs = await c.get("/openapi.json")
    await app.shutdown()
    await service.stop()
    tops = ("ics_tpu", "jax", "jaxlib", "flax", "optax", "orbax")
    print(json.dumps({"status": r.status_code, "total": r.json()["total"],
                      "openapi": docs.status_code,
                      "loaded": sorted(m for m in sys.modules
                                       if m.split(".")[0] in tops)}))

asyncio.run(main())
"""


def test_serving_a_classify_loads_nothing_of_the_jax_package(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(ENV="test", TPU_ENABLE_INFERENCE="false",
               PYTHONPATH=str(REPO), JWT_SECRET_KEY="test-secret")
    out = subprocess.run(
        [sys.executable, "-c", _SERVE_ONE, f"sqlite:///{tmp_path}/alone.db"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"status": 200, "total": 1, "openapi": 200, "loaded": []}


# ---- each copied tier still answers as the original -----------------------------

def test_core_settings_have_the_same_defaults():
    from ics_tpu.core.config import Settings as Ref
    from ics_tpu_torch.core.config import Settings as Port

    ref = {name: field.default for name, field in Ref.model_fields.items()}
    port = {name: field.default for name, field in Port.model_fields.items()}
    assert port.pop("TPU_FUSED_CHAINS") is False     # the one setting the port adds
    assert port == ref
    assert port["TPU_DEFAULT_MODEL"] == "resnet50"


def test_app_route_table_is_the_reference_minus_the_deferred_routes():
    from ics_tpu.main import create_app as create_ref
    from ics_tpu_torch.main import create_app as create_port

    def table(app):
        return {(m, r.path) for r in app.router.routes for m in r.methods}

    ref, port = table(create_ref()), table(create_port())
    expected = {
        (m, p) for m, p in ref
        if (m, p) not in DEFERRED_ROUTES and not p.startswith(DEFERRED_PREFIXES)
    }
    assert port - PORT_ONLY_ROUTES == expected
    assert PORT_ONLY_ROUTES <= port
    assert DEFERRED_ROUTES <= ref                    # the list above is not stale


def test_core_security_tokens_and_hashes_cross_verify():
    from ics_tpu.core import security as ref
    from ics_tpu_torch.core import security as port

    assert port.verify_password("s3nha-Forte!", ref.hash_password("s3nha-Forte!"))
    assert ref.verify_password("s3nha-Forte!", port.hash_password("s3nha-Forte!"))
    assert not port.verify_password("outra", ref.hash_password("s3nha-Forte!"))
    assert port.sha256_hex(b"abc") == ref.sha256_hex(b"abc")


def test_core_validators_agree():
    from ics_tpu.core import validators as ref
    from ics_tpu_torch.core import validators as port

    for email in ("a@b.co", "sem-arroba", "x@y", "nome.sobrenome@exemplo.com.br"):
        assert port.validar_email(email) == ref.validar_email(email)
    for senha in ("curta", "SemNumero!", "Forte123!@#", "12345678"):
        assert port.validar_forca_senha(senha) == ref.validar_forca_senha(senha)


def test_db_schema_and_migrations_are_the_same():
    from ics_tpu.db import migrate as ref_migrate
    from ics_tpu.db import models as _ref_models  # noqa: F401 — fills the registry
    from ics_tpu.db.orm import MODEL_REGISTRY as ref_registry
    from ics_tpu.db.orm import create_table_sql as ref_sql
    from ics_tpu_torch.db import migrate as port_migrate
    from ics_tpu_torch.db import models as _port_models  # noqa: F401
    from ics_tpu_torch.db.orm import MODEL_REGISTRY as port_registry
    from ics_tpu_torch.db.orm import create_table_sql as port_sql

    assert sorted(port_registry) == sorted(ref_registry) and len(port_registry) >= 13
    for name in ref_registry:
        assert port_sql(port_registry[name]) == ref_sql(ref_registry[name])
    assert [m.revision for m in port_migrate._load_revisions()] == \
        [m.revision for m in ref_migrate._load_revisions()]
    assert all(m.__name__.startswith("ics_tpu_torch.") for m in port_migrate._load_revisions())


def test_db_seed_and_crud_roundtrip_on_the_ports_database(tmp_path):
    from ics_tpu_torch.crud import user_crud
    from ics_tpu_torch.db import seed
    from ics_tpu_torch.db.engine import Database
    from ics_tpu_torch.db.models import EventoAuditoria, TipoUsuario

    db = Database(f"sqlite:///{tmp_path}/port.db")
    db.create_all()
    seed.seed_all(db)
    session = db.open_session()
    try:
        assert session.query(TipoUsuario).count() >= 2
        assert session.query(EventoAuditoria).count() >= 10
        from ics_tpu_torch.core.config import settings

        admin = user_crud.get_user_by_email(session, settings.ADMIN_EMAIL)
        assert admin is not None and admin.email == settings.ADMIN_EMAIL
    finally:
        session.close()


def test_web_multipart_and_routing_agree():
    from ics_tpu.web import multipart as ref
    from ics_tpu.web.routing import Router as RefRouter
    from ics_tpu_torch.web import multipart as port
    from ics_tpu_torch.web.routing import Router as PortRouter

    body = (b"--XX\r\nContent-Disposition: form-data; name=\"a\"\r\n\r\n1\r\n"
            b"--XX\r\nContent-Disposition: form-data; name=\"files\"; filename=\"f.bin\"\r\n"
            b"Content-Type: application/octet-stream\r\n\r\n\x00\x01\x02\r\n--XX--\r\n")
    r = ref.parse_multipart(body, "multipart/form-data; boundary=XX")
    p = port.parse_multipart(body, "multipart/form-data; boundary=XX")
    assert p.get("a") == r.get("a") == "1"
    assert [(k, f.filename, f.data) for k, f in p.files] == \
        [(k, f.filename, f.data) for k, f in r.files]

    async def handler(request):
        return None

    found = []
    for router_cls in (RefRouter, PortRouter):
        router = router_cls(prefix="/x")
        router.get("/item/{item_id}/raw/{rest:path}")(handler)
        route, params = router.find("GET", "/x/item/7/raw/a/b.png/")
        missing, allowed = router.find("POST", "/x/item/7/raw/a")
        found.append((route.path, params, missing, allowed))
    assert found[0] == found[1]
    assert found[1][1]["item_id"] == "7" and found[1][3] == {"GET"}


def test_schemas_validate_the_same_payloads():
    from ics_tpu.schemas import auth_schema as ref
    from ics_tpu_torch.schemas import auth_schema as port

    names = [n for n in dir(ref) if isinstance(getattr(ref, n), type)
             and getattr(ref, n).__module__ == ref.__name__
             and hasattr(getattr(ref, n), "model_fields")]
    assert names and all(hasattr(port, n) for n in names)
    for n in names:
        assert getattr(port, n).model_json_schema() == getattr(ref, n).model_json_schema()


def test_openapi_contracts_cover_the_same_operations():
    from ics_tpu.api.openapi_contracts import CONTRACTS as ref
    from ics_tpu_torch.api.openapi_contracts import CONTRACTS as port

    assert set(port) == set(ref)


def test_utils_metrics_expose_the_same_text():
    from ics_tpu.utils.metrics import Registry as Ref
    from ics_tpu_torch.utils.metrics import Registry as Port

    texts = []
    for cls in (Ref, Port):
        reg = cls()
        reg.counter("reqs_total", "requests").inc()
        reg.gauge("depth", "queue depth").set(3)
        reg.histogram("ms", "latency", buckets=(1, 10)).observe(2.5)
        texts.append(reg.expose())
    assert texts[0] == texts[1] and "reqs_total 1" in texts[1]


def test_runtime_decode_and_staging_agree():
    from ics_tpu.runtime import decode as ref
    from ics_tpu_torch.runtime import decode as port

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in [(64, 64), (300, 200), (1500, 40)]]
    for a, b in zip(ref.stage_batch(imgs), port.stage_batch(imgs)):
        np.testing.assert_array_equal(a, b)
    blobs = []
    for fmt in ("PNG", "JPEG"):
        buf = io.BytesIO()
        Image.fromarray(imgs[0]).save(buf, fmt)
        blobs.append(buf.getvalue())
    for blob in blobs:
        np.testing.assert_array_equal(port.decode_image(blob), ref.decode_image(blob))
    with pytest.raises(port.ImagemInvalida):
        port.decode_image(b"not an image")


@pytest.mark.anyio
async def test_runtime_batcher_batches_like_the_original():
    from ics_tpu.runtime.batcher import DynamicBatcher as Ref
    from ics_tpu_torch.runtime.batcher import DynamicBatcher as Port
    import asyncio

    results = []
    for cls in (Ref, Port):
        seen = []

        def predict(canvas, sizes, seen=seen):
            seen.append(len(canvas))
            return np.arange(len(canvas))[:, None], np.ones((len(canvas), 1), np.float32)

        batcher = cls(predict_staged=predict,
                      stage_batch=lambda imgs: (np.stack(imgs), np.zeros((len(imgs), 2), np.int32)),
                      max_batch=4, deadline_us=20_000)
        await batcher.start()
        try:
            out = await asyncio.gather(*(batcher.submit(np.zeros((2, 2, 3), np.uint8))
                                         for _ in range(4)))
        finally:
            await batcher.stop()
        results.append((sorted(int(i[0]) for i, _ in out), sum(seen)))
    assert results[0] == results[1] == ([0, 1, 2, 3], 4)


def test_native_shim_is_the_ports_own_copy():
    ref = importlib.import_module("ics_tpu.native.imgcodec")
    port = importlib.import_module("ics_tpu_torch.native.imgcodec")
    assert Path(port.__file__).parent == REPO / "ics_tpu_torch" / "native"
    assert port._SO.parent == Path(port.__file__).parent
    for name in ("imgcodec.cpp", "jpeg_entropy.cpp", "coeff_header.h", "Makefile"):
        assert (Path(port.__file__).parent / name).exists()
    # the coefficient path is the port's own decoder: no libjpeg, and the
    # libjpeg shim keeps host decode only
    assert not (Path(port.__file__).parent / "jpeg_mt.cpp").exists()
    entropy = (Path(port.__file__).parent / "jpeg_entropy.cpp").read_text()
    assert "jpeglib.h" not in entropy and "png.h" not in entropy
    assert not any(flag.startswith("-l") for flag in port.CXX_FLAGS)
    assert "icstpu_jpeg_coeffs" not in (Path(port.__file__).parent / "imgcodec.cpp").read_text()
    assert port.entropy_library_path().parent == REPO / "build" / "ics_tpu_torch"
    assert port.sha256_hex(b"abc") == ref.sha256_hex(b"abc")


def test_model_spec_and_registry_sizes_follow_the_jax_registry():
    from ics_tpu.models import registry as ref
    from ics_tpu_torch.models import registry as port

    assert [f for f in port.ModelSpec.__dataclass_fields__] == \
        [f for f in ref.ModelSpec.__dataclass_fields__]
    for name in port.list_models():
        r, p = ref.get_model(name), port.get_model(name)
        assert (p.image_size, p.resize_short, p.dev_only) == \
            (r.image_size, r.resize_short, r.dev_only), name
    assert {"resnet50", "resnet_tiny", "resnext50_32x4d", "wide_resnet50_2"} <= set(port.list_models())


def test_registry_is_the_jax_registry_minus_what_is_not_ported():
    """Every model of the JAX registry but the two TPU-only MXU-width ViTs,
    with equal sizes and flags (no model waits for a later slice)."""
    from ics_tpu.models import registry as ref
    from ics_tpu_torch.models import registry as port

    waiting: set = set()
    tpu_only = {"vit_b16_h6d128", "vit_l16_h8d128"}
    assert waiting | tpu_only <= set(ref.list_models())
    assert port.list_models() == sorted(set(ref.list_models()) - waiting - tpu_only)
    assert port.list_models(include_dev=False) == sorted(
        set(ref.list_models(include_dev=False)) - waiting - tpu_only)
    for name in port.list_models():
        r, p = ref.get_model(name), port.get_model(name)
        assert (p.image_size, p.resize_short, p.dev_only) == \
            (r.image_size, r.resize_short, r.dev_only), name
    sizes = {n: (port.get_model(n).image_size, port.get_model(n).resize_short)
             for n in ("efficientnet_b4", "efficientnet_v2_s", "efficientnet_v2_m", "swin_micro")}
    assert sizes == {"efficientnet_b4": (380, 412), "efficientnet_v2_s": (384, 384),
                     "efficientnet_v2_m": (480, 480), "swin_micro": (64, 64)}
    assert port.get_model("swin_micro").dev_only


@pytest.mark.parametrize("module", [
    "ics_tpu_torch.ops.depthwise", "ics_tpu_torch.ops.window_attention",
    "ics_tpu_torch.models.convnext", "ics_tpu_torch.models.mobilenetv3",
    "ics_tpu_torch.models.efficientnet", "ics_tpu_torch.models.swin",
    "ics_tpu_torch.tools.bench_vit_attn", "ics_tpu_torch.tools.bench_depthwise",
    "ics_tpu_torch.tools.bench_window", "ics_tpu_torch.ops.jpeg_decode",
    "ics_tpu_torch.runtime.device_decode", "ics_tpu_torch.native.imgcodec",
    "ics_tpu_torch.tools.bench_decode",
    "ics_tpu_torch.sync.event_cache", "ics_tpu_torch.sync.sync_cache",
    "ics_tpu_torch.sync.webdav_sync", "ics_tpu_torch.sync.activity_sync",
    "ics_tpu_torch.sync.service", "ics_tpu_torch.sync.scheduler",
    "ics_tpu_torch.runtime.embedding_index", "ics_tpu_torch.runtime.knn_suggest",
    "ics_tpu_torch.api.routes.images", "ics_tpu_torch.tools.fake_nextcloud",
    "ics_tpu_torch.api.routes.classificacoes",
    "ics_tpu_torch.models.densenet", "ics_tpu_torch.models.regnet",
    "ics_tpu_torch.train.pretrained",
])
def test_new_modules_import_alone_and_build_nothing_at_import(module):
    """Each module of this slice imports in a fresh interpreter with no JAX
    and no ``ics_tpu`` loaded, and importing it neither builds nor loads a
    kernel library (there is no nvcc where the tests run)."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "from ics_tpu_torch.ops import _build\n"
        "tops = ('ics_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'triton',"
        " 'convert_checkpoints')\n"
        "from ics_tpu_torch.native import imgcodec\n"
        "print(json.dumps({'loaded': sorted(m for m in sys.modules if m.split('.')[0] in tops),"
        " 'libraries': sorted(_build._loaded) + ([] if imgcodec._entropy is None else ['entropy'])}))\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"loaded": [], "libraries": []}


def test_kernel_sources_of_this_slice_are_plain_cuda_with_a_c_interface():
    csrc = REPO / "ics_tpu_torch" / "ops" / "csrc"
    from ics_tpu_torch.ops import _build

    assert set(_build.KERNELS) == {p.stem for p in csrc.glob("*.cu")} == {
        "flash_attention", "bottleneck_chain", "normalize_u8", "depthwise_conv",
        "window_attention", "window_attention_bwd"}
    for name, symbol in (("depthwise_conv", "ics_depthwise_conv"),
                         ("window_attention", "ics_window_attention"),
                         ("window_attention_bwd", "ics_window_attention_bwd")):
        text = (csrc / f"{name}.cu").read_text()
        assert f"int {symbol}(" in text and 'extern "C"' in text
        for library in ("torch/", "ATen", "cudnn", "cublas", "cutlass"):
            assert library not in text, (name, library)
    flash = (csrc / "flash_attention.cu").read_text()
    assert "template <int D, bool kBf16Exp>" in flash        # one kernel, a template parameter


SYNC_MODULES = ("event_cache", "sync_cache", "webdav_sync", "activity_sync", "service",
                "scheduler", "nextcloud_client")


def _public_names(module) -> dict:
    return {name: type(obj).__name__ for name, obj in vars(module).items()
            if not name.startswith("_") and getattr(obj, "__module__", None) == module.__name__}


@pytest.mark.anyio
async def test_nextcloud_client_is_importable_without_the_sync_engine(tmp_path):
    """The port's sync engine is its own copy: every module of the JAX
    package's ``sync/`` has a counterpart under ``ics_tpu_torch/sync`` with the
    same public classes and functions, importing only the port, and a full
    scan of the same fake NextCloud leaves the same images in both.
    (``tests/test_torch_sync_engine.py`` holds every scenario.)"""
    import httpx

    from tests.fake_nextcloud import FakeState, make_fake_nextcloud, make_jpeg

    assert sorted(p.stem for p in (REPO / "ics_tpu" / "sync").glob("*.py")
                  if p.stem != "__init__") == sorted(SYNC_MODULES)
    for name in SYNC_MODULES:
        ref = importlib.import_module(f"ics_tpu.sync.{name}")
        port = importlib.import_module(f"ics_tpu_torch.sync.{name}")
        assert Path(port.__file__).parent == REPO / "ics_tpu_torch" / "sync"
        assert _public_names(port) == _public_names(ref), name
    found = []
    for top in ("ics_tpu", "ics_tpu_torch"):
        importlib.import_module(f"{top}.db.models")
        db = importlib.import_module(f"{top}.db.engine").Database(
            f"sqlite:///{tmp_path}/{top}.db")
        db.create_all()
        state = FakeState()
        state.add_image("plantas", "a.jpg", make_jpeg(1))
        state.add_image("animais", "b.jpg", make_jpeg(2))
        client = importlib.import_module(f"{top}.sync.nextcloud_client").NextCloudClient(
            base_url="http://fake.test", username="tester", password="pw",
            user_path="/files/tester", max_retries=1, retry_delay=0.0,
            transport=httpx.ASGITransport(app=make_fake_nextcloud(state)))
        seen = []
        webdav = importlib.import_module(f"{top}.sync.webdav_sync").WebDAVSync(
            client, db, on_image_bytes=lambda h, data: seen.append(h))
        stats = await webdav.sync_all_folders()
        await client.aclose()
        found.append((stats, seen))
    assert found[0] == found[1] and found[1][0]["images_created"] == 2


def test_profile_step_names_every_kernel_of_the_port():
    """``tools.profile_step`` sorts device time by kernel name: every
    ``__global__`` function of ``ops/csrc`` must fall into its "port kernels"
    group, or the tool counts a hand-written kernel as glue."""
    import re

    from ics_tpu_torch.tools import profile_step

    names = []
    for src in sorted((REPO / "ics_tpu_torch" / "ops" / "csrc").glob("*.cu")):
        names += re.findall(r"__global__[^;{]*?\b(\w+_kernel)\s*\(", src.read_text())
    assert len(names) >= 11
    for name in names:
        assert profile_step.group_of(name) == "port kernels", name
    needles = dict(profile_step.GROUPS)["port kernels"]
    for needle in needles:
        assert any(needle in name for name in names), needle   # and no stale name stays
