"""Test-time augmentation of the port against the JAX package's, on the CPU
(mirrors ``tests/test_tta.py``).

Same randomised weights (``tests/test_torch_engine_pairs.py``), same staged uint8
canvases, fp32: the port's TTA top-k equals the JAX engine's and its scores
agree to atol 2e-4, rtol 1e-4 (the bar of the engine parity tests), on
``resnet_tiny``, a one-block-a-stage ConvNeXt, ``swin_micro``, ``densenet_micro``
and ``regnet_micro``, through the
resize lane and the fixed-size lane. Then the step's own contract: the mean
of the image's and its flip's probabilities, flip invariance of a symmetric
image, probabilities that sum to 1, padding rows cut away, the step recorded
under ``("tta", bucket, canvas)``, and the service's batch of 1.
"""

import asyncio
import io

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_engine_pairs import dev_models, engine_pair


@pytest.fixture(scope="module", params=["resnet_tiny", "convnext_dev", "swin_micro",
                                        "densenet_micro", "regnet_micro"])
def pair(request):
    with dev_models():
        return engine_pair(request.param, num_classes=6, buckets=(1, 4))


@pytest.mark.parametrize("side", [48, 64])     # 64: the fixed-size lane of a 64 px model
def test_tta_matches_the_jax_engine(pair, side):
    jax_engine, engine = pair
    rng = np.random.default_rng(side)
    canvas = rng.integers(0, 256, (3, 64, 64, 3), np.uint8)
    sizes = np.full((3, 2), side, np.int32)
    ref_idx, ref_scores = jax_engine.predict_staged_tta(canvas, sizes)
    idx, scores = engine.predict_staged_tta(canvas, sizes)
    assert idx.shape == scores.shape == (3, 5)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(scores, ref_scores, atol=2e-4, rtol=1e-4)
    assert ("tta", 4, 64) in engine._compiled_shapes


@pytest.fixture(scope="module")
def engine():
    return engine_pair("resnet_tiny", num_classes=5, buckets=(1, 4))[1]


def _full_probs(engine, canvas, sizes):
    """The whole probability row (num_classes <= k: the top-k is all of it)."""
    idx, scores = engine.predict_staged(canvas, sizes)
    probs = np.zeros((canvas.shape[0], engine.num_classes))
    for r in range(canvas.shape[0]):
        probs[r, idx[r]] = scores[r]
    return probs


def test_tta_is_the_mean_of_the_image_and_its_flip(engine):
    # the image fills the canvas, so the preprocessing commutes with the flip
    canvas = np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3), np.uint8)
    sizes = np.full((1, 2), 64, np.int32)
    expected = 0.5 * (_full_probs(engine, canvas, sizes)
                      + _full_probs(engine, canvas[:, :, ::-1].copy(), sizes))
    idx, scores = engine.predict_staged_tta(canvas, sizes)
    got = np.zeros_like(expected)
    got[0, idx[0]] = scores[0]
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-6)
    assert scores.sum() == pytest.approx(1.0, abs=1e-5) and (scores >= 0).all()


def test_a_symmetric_image_is_invariant(engine):
    half = np.random.default_rng(1).integers(0, 256, (1, 64, 32, 3), np.uint8)
    canvas = np.concatenate([half, half[:, :, ::-1]], axis=2)
    sizes = np.full((1, 2), 64, np.int32)
    idx, scores = engine.predict_staged_tta(canvas, sizes)
    got = np.zeros((1, engine.num_classes))
    got[0, idx[0]] = scores[0]
    np.testing.assert_allclose(got, _full_probs(engine, canvas, sizes), rtol=1e-4, atol=1e-6)


def test_padding_rows_change_nothing(engine):
    canvas = np.random.default_rng(2).integers(0, 256, (3, 64, 64, 3), np.uint8)
    sizes = np.asarray([[64, 64], [40, 50], [64, 30]], np.int32)
    idx, scores = engine.predict_staged_tta(canvas, sizes)     # bucket 4: one padding row
    one_idx, one_scores = engine.predict_staged_tta(canvas[1:2], sizes[1:2])
    assert idx.shape == (3, 5)
    np.testing.assert_array_equal(one_idx[0], idx[1])
    np.testing.assert_allclose(one_scores[0], scores[1], atol=1e-6)


def test_classify_bytes_tta():
    from ics_tpu_torch.runtime.engine import InferenceEngine
    from ics_tpu_torch.runtime.service import InferenceService

    service = InferenceService(
        InferenceEngine("resnet_tiny", num_classes=5, precision="fp32", buckets=(1,),
                        canvas=64, device="cpu"),
        deadline_us=1000, device_decode=False)
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(3).integers(0, 256, (48, 48, 3), np.uint8)).save(
        buf, "JPEG", quality=90)

    async def run():
        await service.start()
        try:
            return await service.classify_bytes_tta(buf.getvalue())
        finally:
            await service.stop()

    result = asyncio.run(run())
    assert result["tta"] is True and result["model"] == "resnet_tiny"
    assert result["decode"] == "host" and len(result["top_classes"]) == 5
    assert sum(result["scores"]) == pytest.approx(1.0, abs=1e-5)
    assert service.engine.status()["images"] == 1
    assert torch.is_inference_mode_enabled() is False
