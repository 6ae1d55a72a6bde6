"""Inference engine of the port against the JAX package's, on the CPU.

Same bridged weights, same staged uint8 canvases: the fp32 step (resize,
crop, normalize, ViT, softmax, top-5) must give the same top-5 classes
with scores within 1e-4. Then the engine's own contract: bucket padding,
the resolver of ``predict_staged_async``, compile accounting and the
multi-label scoring.
"""

import jax
import numpy as np
import pytest
import torch

from ics_tpu.runtime.decode import stage_batch
from ics_tpu.runtime.engine import InferenceEngine as JaxEngine
from ics_tpu_torch import weights
from ics_tpu_torch.runtime.engine import InferenceEngine


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    sizes = [(64, 64), (120, 90), (40, 200), (256, 256), (33, 47)][:n]
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in sizes]


@pytest.fixture(scope="module")
def variables():
    from ics_tpu.models.vit import vit_tiny

    return jax.tree_util.tree_map(
        np.asarray, vit_tiny(num_classes=10).init(jax.random.PRNGKey(7))
    )


def test_top5_matches_jax_engine_fp32(variables):
    canvas, sizes = stage_batch(_images(5), canvas=None)
    ref_idx, ref_scores = JaxEngine(
        "vit_tiny", num_classes=10, precision="fp32", buckets=(8,),
        canvas=256, variables=variables,
    ).predict_staged(canvas, sizes)
    idx, scores = InferenceEngine(
        "vit_tiny", num_classes=10, precision="fp32", buckets=(8,), canvas=256,
        state_dict=weights.from_jax_variables(variables), device="cpu",
    ).predict_staged(canvas, sizes)
    assert idx.shape == scores.shape == (5, 5)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(scores, ref_scores, atol=1e-4, rtol=0)


@pytest.fixture()
def engine():
    return InferenceEngine("vit_tiny", num_classes=10, precision="fp32",
                           buckets=(1, 4), canvas=64, device="cpu")


def test_bucket_padding_and_resolver_contract(engine):
    assert engine.bucket_for(1) == 1
    assert engine.bucket_for(3) == 4
    assert engine.bucket_for(9) == 4
    canvas, sizes = stage_batch(_images(3, seed=1), canvas=256)
    resolve = engine.predict_staged_async(canvas, sizes)
    assert callable(resolve)
    assert engine.status()["batches"] == 0       # telemetry lands on resolve
    idx, scores = resolve()
    assert idx.shape == scores.shape == (3, 5)   # padding rows are cut away
    assert np.all(np.diff(scores, axis=1) <= 0)
    st = engine.status()
    assert (st["batches"], st["images"], st["compiles"]) == (1, 3, 1)
    assert (4, 256) in engine._compiled_shapes
    # the same shape again is no compile; padding rows change nothing
    idx1, scores1 = engine.predict_staged(canvas[:1], sizes[:1])
    st = engine.status()
    assert (st["batches"], st["images"], st["compiles"]) == (2, 4, 2)
    engine.predict_staged(canvas[:2], sizes[:2])
    assert engine.status()["compiles"] == 2
    np.testing.assert_array_equal(idx1[0], idx[0])
    np.testing.assert_allclose(scores1[0], scores[0], atol=1e-6)


def test_status_and_warmup(engine):
    engine.warmup()
    st = engine.status()
    assert st["backend"] == "cpu" and st["devices"] == 1
    assert st["buckets"] == [1, 4] and st["batches"] == 0
    assert {(1, 64), (4, 64)} <= engine._compiled_shapes
    assert set(st["kernel_launches"]) == {"flash_attention"}


def test_multi_label_scores_every_class_with_sigmoid():
    eng = InferenceEngine("vit_tiny", num_classes=7, precision="fp32", buckets=(2,),
                          canvas=64, multi_label=True, device="cpu")
    canvas, sizes = stage_batch(_images(2, seed=2), canvas=256)
    idx, scores = eng.predict_staged(canvas, sizes)
    assert idx.shape == (2, 7)
    assert sorted(idx[0].tolist()) == list(range(7))
    assert np.all((scores > 0) & (scores < 1))
    assert not np.allclose(scores.sum(axis=1), 1.0)


def test_same_seed_same_weights_across_engines():
    a = InferenceEngine("vit_tiny", num_classes=10, precision="bf16", device="cpu", seed=5)
    b = InferenceEngine("vit_tiny", num_classes=10, precision="bf16", device="cpu", seed=5)
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert pa.dtype == torch.bfloat16
        assert torch.equal(pa, pb)


def test_rejects_unknown_precision_and_model():
    with pytest.raises(ValueError, match="precision"):
        InferenceEngine("vit_tiny", precision="fp8", device="cpu")
    with pytest.raises(KeyError, match="resnet50"):
        InferenceEngine("resnet50", device="cpu")
