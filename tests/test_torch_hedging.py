"""Replica-level serving with request hedging in the port
(``ics_tpu_torch.runtime.hedging``), with the cases of the JAX package's
``tests/test_hedging.py``, on two CPU replicas of ``resnet_tiny``.

Each replica is a full ``InferenceService`` with its own batcher, pinned to
its device by a one-position mesh. One answer is held against the JAX
package's hedged service on the same bridged weights and JPEG: top-5 equal,
scores within atol 2e-4, rtol 1e-4.
"""

import asyncio
import io

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from ics_tpu_torch.runtime.hedging import HedgedInferenceService, partition_devices

pytestmark = pytest.mark.anyio
CPU2 = [torch.device("cpu")] * 2
SMALL = dict(model_name="resnet_tiny", num_classes=8, precision="fp32", buckets=(1, 4),
             canvas=64)


def _jpeg(rng, side=48) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (side, side, 3), np.uint8), "RGB").save(
        buf, "JPEG", quality=90)
    return buf.getvalue()


def _settings(replicas=2, hedge_ms=60_000.0):
    # the default hedge timer is huge: the tests that assert "no hedge fired"
    # must not race a cold first call
    from ics_tpu_torch.core.config import reload_settings

    return reload_settings(TPU_SERVING_REPLICAS=str(replicas), TPU_HEDGE_MS=str(hedge_ms),
                           TPU_DEVICE_DECODE="false")


def _make_service(replicas=2, hedge_ms=60_000.0, **overrides):
    return HedgedInferenceService.from_settings(
        settings=_settings(replicas, hedge_ms), devices=CPU2, **{**SMALL, **overrides})


@pytest.fixture(autouse=True)
def _restore_settings():
    yield
    from ics_tpu_torch.core.config import reload_settings

    reload_settings()


class TestPartition:
    def test_even_split_disjoint(self):
        devices = [torch.device("cuda", i) for i in range(8)]
        groups = partition_devices(devices, 2)
        assert [len(g) for g in groups] == [4, 4]
        assert len({d.index for g in groups for d in g}) == 8
        from ics_tpu.runtime.hedging import partition_devices as jax_partition

        assert [[d.index for d in g] for g in groups] == [
            [d.id for d in g] for g in jax_partition(jax.devices(), 2)]

    def test_uneven_is_loud(self):
        with pytest.raises(RuntimeError, match="cannot partition"):
            partition_devices([torch.device("cuda", i) for i in range(8)], 3)

    def test_single_replica_rejected(self):
        with pytest.raises(ValueError):
            partition_devices(CPU2, 1)

    def test_too_few_cards_refused_with_the_reference_message(self):
        from ics_tpu.runtime.hedging import partition_devices as jax_partition

        with pytest.raises(RuntimeError) as ref:
            jax_partition(jax.devices()[:1], 2)
        with pytest.raises(RuntimeError) as got:
            HedgedInferenceService.from_settings(settings=_settings(), devices=[CPU2[0]], **SMALL)
        assert str(got.value) == str(ref.value)


class TestHedgedServing:
    async def test_round_robin_spreads_requests(self):
        service = _make_service()
        for r in service.replicas:
            assert r.engine.mesh.shape == {"data": 1} and r.engine.status()["devices"] == 1
        await service.start()
        try:
            rng = np.random.default_rng(0)
            for _ in range(4):
                result = await service.classify_bytes(_jpeg(rng))
                assert len(result["top_classes"]) == 5
            # 4 requests, 2 replicas, a huge hedge timer -> 2 images each
            assert [r.engine._stats["images"] for r in service.replicas] == [2, 2]
            assert service._stats["hedges_fired"] == 0
        finally:
            await service.stop()

    async def test_straggler_hedges_to_next_replica(self):
        service = _make_service(hedge_ms=50.0)
        await service.start()
        try:
            blob = _jpeg(np.random.default_rng(1))
            # warm both replicas so the race below measures hedging
            service.hedge_s = 60.0
            await service.classify_bytes(blob)
            await service.classify_bytes(blob)
            service.hedge_s = 0.05
            service._stats["hedges_fired"] = service._stats["hedges_won"] = 0
            real = service.replicas[0].classify_bytes

            async def slow(data):
                await asyncio.sleep(2.0)
                return await real(data)

            service.replicas[0].classify_bytes = slow
            t0 = asyncio.get_running_loop().time()
            result = await service.classify_bytes(blob)
            dt = asyncio.get_running_loop().time() - t0
            assert result["hedged"] is True
            assert dt < 1.9   # the backup answered; the sleep was not waited out
            assert service._stats["hedges_fired"] == 1 and service._stats["hedges_won"] == 1
        finally:
            await service.stop()

    async def test_replica_failure_hedges_immediately(self):
        service = _make_service()
        await service.start()
        try:
            async def boom(data):
                raise RuntimeError("replica down")

            service.replicas[0].classify_bytes = boom
            result = await service.classify_bytes(_jpeg(np.random.default_rng(2)))
            assert result["hedged"] is True and service._stats["hedges_fired"] == 1
        finally:
            await service.stop()

    async def test_both_replicas_failing_raises(self):
        service = _make_service(hedge_ms=50.0)
        await service.start()
        try:
            async def boom(data):
                raise RuntimeError("replica down")

            for r in service.replicas:
                r.classify_bytes = boom
            with pytest.raises(RuntimeError, match="replica down"):
                await service.classify_bytes(b"\xff\xd8junk")
            assert service._stats["hedge_failures"] == 1
        finally:
            await service.stop()

    async def test_input_error_is_not_hedged(self):
        from ics_tpu_torch.runtime.decode import ImagemInvalida

        service = _make_service()
        await service.start()
        try:
            with pytest.raises(ImagemInvalida):
                await service.classify_bytes(b"this is not an image")
            assert service._stats["hedges_fired"] == 0
            assert service._stats["hedge_failures"] == 0
            assert service._stats["input_errors"] == 1

            async def boom(data):   # infra failures still hedge
                raise RuntimeError("replica down")

            service.replicas[0].classify_bytes = boom
            service._rr = 0
            result = await service.classify_bytes(_jpeg(np.random.default_rng(5)))
            assert result["hedged"] is True
        finally:
            await service.stop()

    async def test_status_reports_replicas_and_hedges(self):
        service = _make_service()
        await service.start()
        try:
            rng = np.random.default_rng(3)
            await service.classify_bytes(_jpeg(rng))
            await service.classify_bytes(_jpeg(rng))
            status = service.status()
            assert status["serving_replicas"] == 2 and len(status["replicas"]) == 2
            assert status["hedging"]["hedges_fired"] == 0
            assert status["latency"]["n"] == 2
            assert status["images"] == 2 == sum(r["images"] for r in status["replicas"])
            assert status.get("device_decoded", 0) + status.get("host_decoded", 0) == 2
        finally:
            await service.stop()

    async def test_diagnostic_requests_round_robin_without_hedging(self):
        service = _make_service()
        await service.start()
        try:
            rng = np.random.default_rng(1)
            for _ in range(2):
                out = await service.explain_bytes(_jpeg(rng))
                assert out["grade"] == 16 and np.asarray(out["mapa_saliencia"]).shape == (16, 16)
            assert (await service.classify_bytes_tta(_jpeg(rng)))["tta"] is True
            assert (await service.embed_bytes(_jpeg(rng))).shape == (service.engine.embed_dim,)
            assert [r.engine._stats["images"] for r in service.replicas] == [2, 2]
            assert service._stats["hedges_fired"] == 0
        finally:
            await service.stop()


async def test_answer_equals_the_jax_hedged_service():
    from ics_tpu.core.config import reload_settings as jax_reload
    from ics_tpu.models.registry import get_model
    from ics_tpu.runtime.hedging import HedgedInferenceService as JaxHedged
    from ics_tpu_torch import weights

    variables = jax.tree_util.tree_map(
        np.asarray, get_model("resnet_tiny").build(num_classes=8).init(jax.random.PRNGKey(9)))
    blob = _jpeg(np.random.default_rng(7), side=56)
    jax_settings = jax_reload(TPU_SERVING_REPLICAS="2", TPU_HEDGE_MS="60000",
                              TPU_DEVICE_DECODE="false")
    try:
        ref = JaxHedged.from_settings(settings=jax_settings, variables=variables, **SMALL)
        await ref.start()
        try:
            want = await ref.classify_bytes(blob)
        finally:
            await ref.stop()
    finally:
        jax_reload()
    port = _make_service(state_dict=weights.from_jax_variables(variables))
    await port.start()
    try:
        got = await port.classify_bytes(blob)
    finally:
        await port.stop()
    assert got["top_classes"] == want["top_classes"]
    np.testing.assert_allclose(got["scores"], want["scores"], atol=2e-4, rtol=1e-4)


class TestAppWiring:
    async def test_lifespan_builds_hedged_service(self, tmp_path, monkeypatch):
        """TPU_SERVING_REPLICAS > 1 makes the app serve through the hedged
        service, its pool hedging the models it builds: the settings are the
        switch. The visible devices are two CPU positions here."""
        from ics_tpu_torch.core.config import reload_settings
        from ics_tpu_torch.db.engine import Database
        from ics_tpu_torch.main import create_app
        from ics_tpu_torch.parallel import mesh as mesh_mod

        monkeypatch.setattr(mesh_mod, "visible_devices", lambda: CPU2)
        reload_settings(TPU_ENABLE_INFERENCE="true", TPU_SERVING_REPLICAS="2",
                        TPU_DEFAULT_MODEL="resnet_tiny", TPU_NUM_CLASSES="8",
                        TPU_PRECISION="fp32", TPU_BATCH_BUCKETS="1,4", TPU_CANVAS="64",
                        TPU_WARMUP_ON_STARTUP="false", TPU_DEVICE_DECODE="false")
        app = create_app(db=Database(f"sqlite:///{tmp_path}/hedge.sqlite"))
        await app.startup()
        try:
            assert isinstance(app.state.engine, HedgedInferenceService)
            pool = app.state.engine_pool
            assert [m.size for m in pool.replica_meshes] == [1, 1]
            result = await app.state.engine.classify_bytes(_jpeg(np.random.default_rng(4)))
            assert len(result["top_classes"]) == 5
            assert isinstance(await pool.get("vit_tiny"), HedgedInferenceService)
        finally:
            await app.shutdown()

    async def test_too_few_cards_fail_startup_with_the_reference_message(self, tmp_path,
                                                                          monkeypatch):
        from ics_tpu_torch.core.config import reload_settings
        from ics_tpu_torch.db.engine import Database
        from ics_tpu_torch.main import create_app
        from ics_tpu_torch.parallel import mesh as mesh_mod

        monkeypatch.setattr(mesh_mod, "visible_devices", lambda: [torch.device("cuda", 0)])
        reload_settings(TPU_ENABLE_INFERENCE="true", TPU_SERVING_REPLICAS="2",
                        TPU_DEVICE_DECODE="false")
        app = create_app(db=Database(f"sqlite:///{tmp_path}/one_card.sqlite"))
        with pytest.raises(RuntimeError, match="TPU_SERVING_REPLICAS=2 cannot partition 1 "
                                               r"visible device\(s\) into equal groups"):
            await app.startup()
