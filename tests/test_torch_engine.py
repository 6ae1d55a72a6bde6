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
    assert set(st["kernel_launches"]) == {
        "flash_attention", "bottleneck_chain", "normalize_u8", "depthwise_conv",
        "window_attention", "flash_attention_bf16_exp", "depthwise_conv_dx",
        "window_attention_bwd", "depthwise_conv_dw", "window_attention_dtable"}
    assert st["fused_chains"] is False


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
    with pytest.raises(KeyError, match="vit_b16_h4d192"):
        InferenceEngine("vit_b16_h4d192", device="cpu")


# ---- ResNet, fused chains and the fixed-size lane --------------------------------

@pytest.fixture(scope="module")
def resnet_variables():
    from ics_tpu.models.resnet import resnet_tiny

    return jax.tree_util.tree_map(
        np.asarray, resnet_tiny(num_classes=10).init(jax.random.PRNGKey(3))
    )


@pytest.mark.parametrize("fused_chains", [False, True])
def test_resnet_top5_matches_jax_engine_fp32(resnet_variables, fused_chains):
    canvas, sizes = stage_batch(_images(5), canvas=None)
    ref_idx, ref_scores = JaxEngine(
        "resnet_tiny", num_classes=10, precision="fp32", buckets=(8,),
        canvas=256, variables=resnet_variables,
    ).predict_staged(canvas, sizes)
    eng = InferenceEngine(
        "resnet_tiny", num_classes=10, precision="fp32", buckets=(8,), canvas=256,
        state_dict=weights.from_jax_variables(resnet_variables), device="cpu",
        fused_chains=fused_chains,
    )
    idx, scores = eng.predict_staged(canvas, sizes)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(scores, ref_scores, atol=1e-4, rtol=0)
    assert eng.status()["fused_chains"] is fused_chains


def test_fused_chains_reaches_fold():
    """The flag is handed to fold() for models that fold can chain, and is a
    no-op for every other model, the ResNets without a chain path included."""
    import ics_tpu_torch.models.registry as registry
    from ics_tpu_torch.models import resnet

    spec = registry.ModelSpec(
        "resnet_2211", lambda num_classes, device=None: resnet.ResNet(
            (2, 2, 1, 1), num_classes, device=device), 64, 64, dev_only=True)
    registry._REGISTRY[spec.name] = spec
    try:
        on = InferenceEngine(spec.name, num_classes=10, precision="bf16", device="cpu",
                             fused_chains=True)
        off = InferenceEngine(spec.name, num_classes=10, precision="bf16", device="cpu")
    finally:
        del registry._REGISTRY[spec.name]
    assert sorted(on.model.chains) == ["0", "1"] and len(off.model.chains) == 0
    assert on.status()["fused_chains"] is True and off.status()["fused_chains"] is False
    # the engine's cast leaves the chain's fp32 scales and bf16 weights alone
    assert on.model.chains["0"].s1.dtype == torch.float32
    assert on.model.chains["0"].w1.dtype == torch.bfloat16
    assert on.model.stem.conv.weight.dtype == torch.bfloat16
    # same seed, same images: chains on and off agree on the top class
    canvas, sizes = stage_batch(_images(3, seed=5), canvas=256)
    np.testing.assert_array_equal(on.predict_staged(canvas, sizes)[0][:, 0],
                                  off.predict_staged(canvas, sizes)[0][:, 0])
    vit = InferenceEngine("vit_tiny", num_classes=10, device="cpu", fused_chains=True)
    assert vit.status()["fused_chains"] is False
    # a deployment-wide TPU_FUSED_CHAINS must not keep these from being served
    basic = InferenceEngine("resnet18", num_classes=4, device="cpu", fused_chains=True)
    assert basic.status()["fused_chains"] is False and len(basic.model.chains) == 0


def _exact(n, side, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (side, side, 3), np.uint8) for _ in range(n)]


def test_fixed_size_lane_is_taken_exactly_when_the_conditions_hold(monkeypatch):
    import ics_tpu_torch.runtime.engine as engine_mod

    calls = []
    real = engine_mod.normalize_u8
    monkeypatch.setattr(engine_mod, "normalize_u8",
                        lambda x, **kw: calls.append(tuple(x.shape)) or real(x, **kw))
    # a vit_tiny-like spec (resize_short == image_size == 64)
    eng = InferenceEngine("vit_tiny", num_classes=10, precision="fp32", buckets=(1, 4),
                          canvas=128, device="cpu")
    canvas, sizes = stage_batch(_exact(3, 64), canvas=128)
    idx, scores = eng.predict_staged(canvas, sizes)
    assert calls == [(4, 64, 64, 3)]                 # padded to the bucket, windowed
    assert (4, 128, "fixed") in eng._compiled_shapes and (4, 128) not in eng._compiled_shapes
    # its results equal the resize lane's
    ref_idx, ref_scores = eng._step(*eng._to_device(*eng._pad(canvas, sizes)[:2]))
    np.testing.assert_array_equal(idx, ref_idx.numpy()[:3])
    np.testing.assert_allclose(scores, ref_scores.numpy()[:3], atol=1e-5, rtol=0)
    assert len(calls) == 1
    # one real row of another size: the resize lane
    mixed, mixed_sizes = stage_batch(_exact(2, 64) + _exact(1, 63), canvas=128)
    eng.predict_staged(mixed, mixed_sizes)
    assert len(calls) == 1 and (4, 128) in eng._compiled_shapes
    # padding rows do not count: one exact image in bucket 4 of a larger bucket set
    eng.predict_staged(canvas[:1], sizes[:1])
    assert calls[-1] == (1, 64, 64, 3)
    # a canvas smaller than the window cannot hold it
    assert not eng._fixed_size(np.zeros((1, 32, 32, 3), np.uint8), np.full((1, 2), 64))
    # a 224/256 model never takes the lane, whatever the images
    res = InferenceEngine("vit_s16", num_classes=4, precision="fp32", buckets=(1,),
                          canvas=256, device="cpu")
    assert not res._fixed_size(*stage_batch(_exact(1, 224), canvas=256))
    assert not res._fixed_size(*stage_batch(_exact(1, 256), canvas=256))


def test_fixed_size_lane_preprocessing_equals_the_resize_lane_fp32():
    from ics_tpu_torch.ops.normalize import normalize_u8
    from ics_tpu_torch.ops.preproc import preprocess_batch

    canvas, sizes = stage_batch(_exact(2, 384, seed=3), canvas=512)
    resized = preprocess_batch(torch.from_numpy(canvas), torch.from_numpy(sizes),
                               out_size=384, resize_short=384, dtype=torch.float32)
    fixed = normalize_u8(torch.from_numpy(canvas)[:, :384, :384], dtype=torch.float32)
    np.testing.assert_allclose(fixed.numpy(), resized.numpy(), atol=1e-5, rtol=0)


def test_warmup_covers_the_fixed_size_lane():
    eng = InferenceEngine("resnet_tiny", num_classes=10, precision="fp32", buckets=(1, 2),
                          canvas=64, device="cpu")
    eng.warmup()
    assert {(1, 64), (2, 64), (1, 64, "fixed"), (2, 64, "fixed")} <= eng._compiled_shapes
    assert eng.status()["batches"] == 0
    # a warmed lane is no compile when traffic arrives
    eng.predict_staged(*stage_batch(_exact(2, 64), canvas=64))
    assert eng.status()["compiles"] == 0
    big = InferenceEngine("vit_s16", num_classes=4, precision="fp32", buckets=(1,),
                          canvas=256, device="cpu")
    assert big.spec.resize_short != big.spec.image_size


# ---- the depthwise families and Swin at dev size ---------------------------------

def _dev_constructors():
    """(JAX constructor, port constructor) of one dev-size model per family."""
    from ics_tpu.models import convnext as jconvnext
    from ics_tpu.models import efficientnet as jeffnet
    from ics_tpu.models import mobilenetv3 as jmbv3
    from ics_tpu.models import swin as jswin
    from ics_tpu_torch.models import convnext, efficientnet, mobilenetv3, swin

    dims = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128))
    return {
        "convnext_dev": (
            lambda num_classes: jconvnext.ConvNeXt(num_classes=num_classes, **dims),
            lambda num_classes, device=None: convnext.ConvNeXt(
                num_classes=num_classes, device=device, **dims)),
        "mobilenetv3_dev": (jmbv3.mobilenetv3_small, mobilenetv3.mobilenetv3_small),
        "efficientnet_dev": (
            lambda num_classes: jeffnet.EfficientNet(0.25, 0.5, num_classes=num_classes),
            lambda num_classes, device=None: efficientnet.efficientnet_v1(
                0.25, 0.5, num_classes=num_classes, device=device)),
        "swin_dev": (jswin.swin_micro, swin.swin_micro),
    }


@pytest.fixture()
def dev_models():
    """The four dev-size models registered at 64 px in both registries."""
    import ics_tpu.models.registry as jax_registry
    import ics_tpu_torch.models.registry as registry

    jax_registry.list_models()                       # fills the JAX registry first
    constructors = _dev_constructors()
    for name, (jbuild, tbuild) in constructors.items():
        jax_registry.register_model(name, jbuild, 64, 64, dev_only=True)
        registry._REGISTRY[name] = registry.ModelSpec(name, tbuild, 64, 64, dev_only=True)
    try:
        yield constructors
    finally:
        for name in constructors:
            del jax_registry._REGISTRY[name]
            del registry._REGISTRY[name]


@pytest.mark.parametrize("name", ["convnext_dev", "mobilenetv3_dev", "efficientnet_dev",
                                  "swin_dev"])
def test_depthwise_and_swin_top5_match_jax_engine_fp32(dev_models, name):
    jbuild, _ = dev_models[name]
    variables = jax.tree_util.tree_map(
        np.asarray, jbuild(num_classes=10).init(jax.random.PRNGKey(11)))
    canvas, sizes = stage_batch(_images(5), canvas=None)
    kw = dict(num_classes=10, precision="fp32", buckets=(8,), canvas=256)
    ref_idx, ref_scores = JaxEngine(name, variables=variables, **kw).predict_staged(canvas, sizes)
    eng = InferenceEngine(name, state_dict=weights.from_jax_variables(variables),
                          device="cpu", **kw)
    idx, scores = eng.predict_staged(canvas, sizes)
    assert idx.shape == scores.shape == (5, 5)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(scores, ref_scores, atol=1e-4, rtol=0)
    st = eng.status()
    assert st["fused_chains"] is False and st["kernel_launches"]["depthwise_conv"] == \
        st["kernel_launches"]["window_attention"] == 0      # the CPU takes the plain versions


@pytest.mark.parametrize("name", ["convnext_tiny", "swin_tiny", "mobilenetv3_small",
                                  "efficientnet_b4", "efficientnet_v2_s"])
def test_engine_builds_the_new_zoo_models_by_name(name):
    """Shapes only: the registered constructor, folded, on the meta device."""
    from ics_tpu_torch.models.registry import get_model

    spec = get_model(name)
    model = spec.build(num_classes=5, device="meta").fold()
    assert model.num_classes == 5 and callable(model.apply_folded)
    assert not hasattr(model, "chains")              # fused_chains stays a ResNet matter
