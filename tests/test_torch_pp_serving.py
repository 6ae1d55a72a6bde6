"""Pipeline parallelism as a serving path of the port, against the cases of
the JAX package's ``tests/test_pp_serving.py``, on the CPU.

The visible devices are 8 CPU positions here (``parallel.mesh.
visible_devices`` patched), as the reference's tests run on 8 virtual CPU
devices; settings go through ``reload_settings`` as there. The pipelined
engine's answers are held against the JAX package's pipelined engine on the
same bridged weights and canvas (top-5 equal, scores within atol 2e-4,
rtol 1e-4) and against the port's unpipelined engine.
"""

import asyncio
import io

import jax
import numpy as np
import pytest
import torch

from ics_tpu_torch.core.config import reload_settings, settings
from ics_tpu_torch.parallel import mesh as mesh_mod
from ics_tpu_torch.parallel.mesh import make_mesh

ATOL, RTOL = 2e-4, 1e-4
SMALL = dict(num_classes=8, precision="fp32", canvas=64)


@pytest.fixture(autouse=True)
def _eight_cpu_positions(monkeypatch):
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda: [torch.device("cpu")] * 8)
    yield
    reload_settings()


def _blobs(n, rng):
    from PIL import Image

    out = []
    for _ in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (48, 48, 3), np.uint8), "RGB").save(
            buf, "JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def _service(**env):
    from ics_tpu_torch.runtime.service import InferenceService

    reload_settings(TPU_PP_STAGES="4", TPU_PP_MICROBATCHES="2", TPU_DEFAULT_MODEL="vit_tiny",
                    TPU_BATCH_BUCKETS="4",
                    TPU_DEVICE_DECODE="true",   # must be turned off by PP
                    TPU_BATCH_DEADLINE_US="20000", **env)
    return InferenceService.from_settings(**SMALL)


class TestPPSettingsBoot:
    def test_mesh_from_settings_builds_pp_axis(self):
        reload_settings(TPU_PP_STAGES="4")
        mesh = mesh_mod.mesh_from_settings(settings)
        assert mesh is not None and mesh.axis_names == ("pp",)
        assert mesh.shape["pp"] == 4

    def test_pp_conflicts_with_explicit_mesh_shape(self):
        reload_settings(TPU_PP_STAGES="4", TPU_MESH_SHAPE="4,2")
        with pytest.raises(RuntimeError, match="mutuamente"):
            mesh_mod.mesh_from_settings(settings)

    def test_pp_needs_enough_devices(self):
        reload_settings(TPU_PP_STAGES="16")
        with pytest.raises(RuntimeError, match="16"):
            mesh_mod.mesh_from_settings(settings)

    def test_pp_rejects_non_transformer_model(self):
        from ics_tpu_torch.runtime.service import InferenceService

        reload_settings(TPU_PP_STAGES="4", TPU_DEFAULT_MODEL="resnet_tiny")
        with pytest.raises(ValueError, match="ViT"):
            InferenceService.from_settings(**SMALL)

    def test_pp_rejects_indivisible_depth(self):
        from ics_tpu_torch.runtime.service import InferenceService

        reload_settings(TPU_PP_STAGES="3", TPU_DEFAULT_MODEL="vit_tiny")   # depth 8
        with pytest.raises(ValueError, match="profundidade"):
            InferenceService.from_settings(**SMALL)


class TestPPServing:
    def test_serves_batch_through_pipeline(self):
        service = _service()
        engine = service.engine
        assert engine.mesh is not None and engine.mesh.axis_names == ("pp",)
        assert engine.pp_microbatches == 2 and engine.buckets == (4,)
        assert service.device_decode is False
        assert engine.status()["devices"] == 4

        async def serve():
            await service.start()
            try:
                return await service.classify_many(_blobs(4, np.random.default_rng(0)))
            finally:
                await service.stop()

        results = asyncio.run(serve())
        assert len(results) == 4 and all(r["decode"] == "host" for r in results)
        assert all(np.isfinite(r["scores"]).all() for r in results)
        assert service.batcher.stats["flushes"] >= 1

    def test_pp_predictions_match_the_reference_and_the_unpipelined_engine(self):
        from ics_tpu.models.registry import get_model as jax_get_model
        from ics_tpu.parallel.mesh import make_mesh as jax_make_mesh
        from ics_tpu.runtime.engine import InferenceEngine as JaxEngine
        from ics_tpu_torch import weights
        from ics_tpu_torch.runtime.engine import InferenceEngine

        variables = jax.tree_util.tree_map(
            np.asarray, jax_get_model("vit_tiny").build(num_classes=8).init(
                jax.random.PRNGKey(3)))
        state = weights.from_jax_variables(variables)
        pp = _service(TPU_WARMUP_ON_STARTUP="false").engine
        pp.model.load_state_dict(state)          # the staged blocks are the model's own
        ref = JaxEngine("vit_tiny", buckets=(4,), variables=variables, pp_microbatches=2,
                        mesh=jax_make_mesh((4,), ("pp",), devices=jax.devices()[:4]), **SMALL)
        plain = InferenceEngine("vit_tiny", buckets=(4,), state_dict=state, device="cpu",
                                **SMALL)
        rng = np.random.default_rng(1)
        canvas = rng.integers(0, 256, (4, 64, 64, 3), np.uint8)
        sizes = np.full((4, 2), 56, np.int32)
        idx, scores = pp.predict_staged(canvas, sizes)
        for want_idx, want_scores in (ref.predict_staged(canvas, sizes),
                                      plain.predict_staged(canvas, sizes)):
            np.testing.assert_array_equal(idx, want_idx)
            np.testing.assert_allclose(scores, want_scores, atol=ATOL, rtol=RTOL)

    def test_buckets_round_to_microbatches(self):
        from ics_tpu_torch.runtime.engine import InferenceEngine

        engine = InferenceEngine("vit_tiny", buckets=(1, 3, 7), pp_microbatches=4,
                                 mesh=make_mesh((4,), ("pp",), devices=["cpu"] * 4), **SMALL)
        assert engine.buckets == (4, 8)

    def test_coeff_lane_refused_under_pp(self):
        service = _service()
        with pytest.raises(RuntimeError, match="pipeline"):
            service.engine._get_coeff_step("420")


class TestPPComposesWithReplicas:
    @pytest.mark.anyio
    async def test_pp_stages_honored_inside_each_replica(self):
        from ics_tpu_torch.runtime.hedging import HedgedInferenceService

        reload_settings(TPU_PP_STAGES="4", TPU_PP_MICROBATCHES="2", TPU_SERVING_REPLICAS="2",
                        TPU_DEFAULT_MODEL="vit_tiny", TPU_BATCH_BUCKETS="4",
                        TPU_DEVICE_DECODE="true", TPU_BATCH_DEADLINE_US="20000")
        hedged = HedgedInferenceService.from_settings(**SMALL)
        assert len(hedged.replicas) == 2
        for r in hedged.replicas:
            assert r.engine.mesh.axis_names == ("pp",) and r.engine.mesh.shape["pp"] == 4
            assert r.engine.pp_microbatches == 2 and r.device_decode is False
        await hedged.start()
        try:
            out = await hedged.classify_many(_blobs(2, np.random.default_rng(3)))
            assert len(out) == 2 and all(np.isfinite(r["scores"]).all() for r in out)
        finally:
            await hedged.stop()

    def test_pp_replica_group_size_mismatch_fails_loudly(self):
        from ics_tpu_torch.runtime.hedging import HedgedInferenceService

        reload_settings(TPU_PP_STAGES="4", TPU_SERVING_REPLICAS="4",   # 8 / 4 = 2 a group
                        TPU_DEFAULT_MODEL="vit_tiny")
        with pytest.raises(RuntimeError, match="exatamente 4"):
            HedgedInferenceService.from_settings(**SMALL)


class TestPPDiagnosticGuards:
    def test_tta_explain_embed_fail_cleanly_under_pp(self):
        from ics_tpu_torch.runtime.engine import InferenceEngine

        engine = InferenceEngine("vit_tiny", buckets=(4,), pp_microbatches=2,
                                 mesh=make_mesh((4,), ("pp",), devices=["cpu"] * 4), **SMALL)
        canvas = np.zeros((4, 64, 64, 3), np.uint8)
        sizes = np.full((4, 2), 48, np.int32)
        with pytest.raises(RuntimeError, match="TTA"):
            engine.predict_staged_tta(canvas, sizes)
        with pytest.raises(RuntimeError, match="pipeline"):
            engine.embed_staged(canvas, sizes)
        with pytest.raises(RuntimeError, match="explicar"):
            engine.explain_staged(canvas, sizes)

    @pytest.mark.anyio
    async def test_pool_disables_device_decode_under_pp(self):
        from ics_tpu_torch.runtime.service import InferenceServicePool

        pool = InferenceServicePool(
            default_model="vit_tiny", deadline_us=20000, device_decode=True,
            buckets=(4,), mesh=make_mesh((4,), ("pp",), devices=["cpu"] * 4),
            pp_microbatches=2, **SMALL)
        svc = await pool.get("vit_tiny")
        try:
            assert svc.engine.pp_microbatches == 2 and svc.device_decode is False
            out = await svc.classify_bytes(_blobs(1, np.random.default_rng(4))[0])
            assert np.isfinite(out["scores"]).all()
        finally:
            await pool.stop()


@pytest.mark.anyio
async def test_a_model_the_pipeline_cannot_serve_answers_422(tmp_path):
    """``?modelo=`` of a non-ViT on a PP deployment: the pool's build raises
    the engine's ValueError, which the route answers 422, as the reference's."""
    import httpx

    from ics_tpu_torch.db.engine import Database
    from ics_tpu_torch.main import create_app
    from ics_tpu_torch.runtime.service import InferenceServicePool

    service = _service()
    await service.start()
    app = create_app(db=Database(f"sqlite:///{tmp_path}/pp.db"))
    app.state.engine = service
    app.state.engine_pool = InferenceServicePool(
        "vit_tiny", deadline_us=20000, device_decode=True, buckets=(4,),
        mesh=service.engine.mesh, pp_microbatches=2, **SMALL)
    app.state.engine_pool.add("vit_tiny", service)
    await app.startup()
    client = httpx.AsyncClient(transport=httpx.ASGITransport(app=app), base_url="http://test")
    try:
        r = await client.post("/auth/login", data={"username": settings.ADMIN_EMAIL,
                                                   "password": settings.ADMIN_SENHA})
        client.cookies.clear()
        h = {"Authorization": f"Bearer {r.json()['access_token']}"}
        blob = _blobs(1, np.random.default_rng(5))[0]
        r = await client.post("/inferencia/classificar?modelo=resnet18", headers=h,
                              files=[("files", ("a.jpg", blob, "image/jpeg"))])
        assert r.status_code == 422 and "ViT" in r.text
        r = await client.post("/inferencia/classificar", headers=h,
                              files=[("files", ("a.jpg", blob, "image/jpeg"))])
        assert r.status_code == 200 and r.json()["resultados"][0]["decode"] == "host"
    finally:
        await client.aclose()
        await app.shutdown()
        await service.stop()
