"""The explain step of the port against the JAX package's, on the CPU
(mirrors ``tests/test_explain.py``).

Same randomised weights (``tests/test_torch_engine_pairs.py``), same staged uint8
canvas, fp32. At n = 1 (vanilla gradient) the port's heat map must lie
within 1e-4 of the JAX step's, with the same top-k and scores within 1e-5,
on ``resnet_tiny``, a one-block-a-stage ConvNeXt, ``swin_micro``, ``densenet_micro``
and ``regnet_micro`` (the
port's CPU path: the plain versions of the depthwise and window-attention
kernels, differentiated by autograd). The 16x16 resize is held to
``jax.image.resize(..., "linear")`` at 1e-5 on 224, 384 and 256 px maps.
SmoothGrad noise cannot be drawn as JAX draws it, so at n > 1 the map is
held to the mean of the port's own vanilla gradients of its noisy copies
(1e-5), recomputed here from the same generator. Then the rules of the
step: the clean copy gives the top-k, a seed gives one map, the sample count
quantizes up into {1, 4, 8, 16}, a class past the last is clipped. A model
whose path runs a kernel with no backward (ViT's flash attention, ResNet's
fused chains) raises ``KernelHasNoGradient`` on the CPU as on the card; and
no kernel entry returns, under grad, an output cut off from its inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu_torch.ops import KernelHasNoGradient
from ics_tpu_torch.runtime.engine import EXPLAIN_GRID, InferenceEngine, _resize_linear
from tests.test_torch_engine_pairs import dev_models, engine_pair


@pytest.fixture(scope="module")
def staged():
    rng = np.random.default_rng(7)
    canvas = rng.integers(0, 256, (1, 64, 64, 3), np.uint8)
    sizes = np.asarray([[48, 56]], np.int32)
    return canvas, sizes


@pytest.fixture(scope="module", params=["resnet_tiny", "convnext_dev", "swin_micro",
                                        "densenet_micro", "regnet_micro"])
def pair(request):
    with dev_models():
        return engine_pair(request.param, num_classes=6)


@pytest.mark.parametrize("class_idx", [-1, 2])
@pytest.mark.parametrize("side", [None, 64])    # 64: the port's fixed-size lane
def test_heat_matches_the_jax_step(pair, staged, class_idx, side):
    jax_engine, engine = pair
    if side is not None:
        staged = (staged[0], np.full((1, 2), side, np.int32))
        assert engine._fixed_size(*staged)
    ref_idx, ref_scores, ref_heat = jax_engine.explain_staged(*staged, class_idx=class_idx)
    idx, scores, heat = engine.explain_staged(*staged, class_idx=class_idx)
    assert heat.shape == (EXPLAIN_GRID, EXPLAIN_GRID) and heat.dtype == np.float32
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(scores, ref_scores, atol=1e-5, rtol=0)
    np.testing.assert_allclose(heat, np.asarray(ref_heat), atol=1e-4, rtol=0)
    assert heat.min() == pytest.approx(0.0, abs=1e-6)
    assert heat.max() == pytest.approx(1.0, abs=1e-6)


def test_explain_after_serving_steps(pair, staged):
    """A server has run its steps under inference_mode before the first
    explain (tensors cached by the modules then are inference tensors); the
    explain step gives the same map after them."""
    _, engine = pair
    before = engine.explain_staged(*staged, smooth_samples=4, seed=2)
    engine.warmup()
    engine.predict_staged_tta(*staged)
    after = engine.explain_staged(*staged, smooth_samples=4, seed=2)
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("side", [224, 384, 256])
def test_resize_is_jax_image_resize(side):
    heat = np.random.default_rng(side).random((side, side)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(heat), (EXPLAIN_GRID, EXPLAIN_GRID), "linear"))
    got = _resize_linear(torch.from_numpy(heat), EXPLAIN_GRID).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def engine():
    return engine_pair("resnet_tiny", num_classes=4)[1]


def _vanilla_heats(engine, staged, noise):
    """Per-copy channel max-abs of d logit_c / d x, the class from the clean
    copy, on the port's model: the SmoothGrad step written out."""
    x0 = engine._preprocess(*engine._to_device(*staged), False)[0]
    xs = (x0[None] + noise).detach().requires_grad_()
    logits = engine.model.apply_folded(xs).float()
    c = int(logits[0].argmax())
    (g,) = torch.autograd.grad(logits[:, c].sum(), xs)
    return g.abs().amax(dim=-1)


def test_smoothgrad_is_the_mean_of_the_copies_vanilla_gradients(engine, staged):
    n, seed = 4, 11
    x0 = engine._preprocess(*engine._to_device(*staged), False)[0]
    noise = 0.1 * (x0.max() - x0.min()) * torch.randn(
        (n, *x0.shape), generator=torch.Generator().manual_seed(seed))
    noise[0] = 0.0
    heat = _resize_linear(_vanilla_heats(engine, staged, noise).mean(dim=0), EXPLAIN_GRID)
    heat = ((heat - heat.min()) / (heat.max() - heat.min())).numpy()
    _, _, got = engine.explain_staged(*staged, smooth_samples=n, seed=seed)
    np.testing.assert_allclose(got, heat, atol=1e-5, rtol=0)


def test_smoothgrad_top_k_comes_from_the_clean_copy(engine, staged):
    idx_v, scores_v, heat_v = engine.explain_staged(*staged)
    idx_s, scores_s, heat_s = engine.explain_staged(*staged, smooth_samples=8, seed=3)
    np.testing.assert_array_equal(idx_v, idx_s)
    # the clean copy rides in a batch of 8: other sums than at batch 1
    np.testing.assert_allclose(scores_v, scores_s, rtol=1e-5, atol=1e-6)
    assert heat_s.min() == pytest.approx(0.0, abs=1e-6)
    assert heat_s.max() == pytest.approx(1.0, abs=1e-6)
    assert not np.allclose(heat_v, heat_s)


def test_smoothgrad_is_deterministic_given_seed(engine, staged):
    _, _, h1 = engine.explain_staged(*staged, smooth_samples=8, seed=5)
    _, _, h2 = engine.explain_staged(*staged, smooth_samples=8, seed=5)
    _, _, h3 = engine.explain_staged(*staged, smooth_samples=8, seed=6)
    np.testing.assert_array_equal(h1, h2)
    assert not np.allclose(h1, h3)


@pytest.mark.parametrize("asked,served", [(1, 1), (2, 4), (3, 4), (4, 4), (5, 8), (9, 16),
                                          (16, 16), (40, 16)])
def test_sample_count_quantizes_up(asked, served):
    assert InferenceEngine.quantize_smooth(asked) == served


def test_explain_records_its_steps_under_the_reference_keys(engine, staged):
    engine.explain_staged(*staged, smooth_samples=3)
    engine.explain_staged(*staged, smooth_samples=9)
    assert {("explain", 4, 64), ("explain", 16, 64)} <= engine._compiled_shapes
    assert not any(k[:2] in (("explain", 3), ("explain", 9)) for k in engine._compiled_shapes)


def test_out_of_range_class_is_clipped(engine, staged):
    _, _, h_hi = engine.explain_staged(*staged, class_idx=99)
    _, _, h_last = engine.explain_staged(*staged, class_idx=3)
    np.testing.assert_array_equal(h_hi, h_last)
    _, _, h0 = engine.explain_staged(*staged, class_idx=0)
    assert not np.allclose(h0, h_last)


def test_the_default_explains_the_top_class(engine, staged):
    idx, _, heat = engine.explain_staged(*staged)
    _, _, heat_top = engine.explain_staged(*staged, class_idx=int(idx[0]))
    np.testing.assert_array_equal(heat, heat_top)


@pytest.mark.parametrize("name,kwargs", [("vit_tiny", {}), ("vit_d128_micro", {}),
                                         ("resnet_2211", {"fused_chains": True})])
def test_kernels_with_no_backward_raise_on_the_cpu(staged, name, kwargs):
    with dev_models():
        eng = InferenceEngine(name, num_classes=4, precision="fp32", buckets=(1,), canvas=64,
                              device="cpu", **kwargs)
    if kwargs:
        assert eng.fused_chains and len(eng.model.chains) > 0
    with pytest.raises(KernelHasNoGradient):
        eng.explain_staged(*staged)
    idx, _ = eng.predict_staged(*staged)            # the forward still serves
    assert idx.shape == (1, 4)


def test_the_jax_step_fails_on_the_vit_as_a_bad_image(staged):
    """The reference's gradient through its flash kernel fails with a
    ValueError, which its route answers as a bad image: the port's
    KernelHasNoGradient keeps the status and says why."""
    from ics_tpu.runtime.engine import InferenceEngine as JaxEngine

    jax_engine = JaxEngine("vit_tiny", num_classes=4, precision="fp32", buckets=(1,),
                           canvas=64)
    with pytest.raises(ValueError):
        jax_engine.explain_staged(*staged)


def test_the_served_model_requires_no_parameter_gradient(engine):
    assert not any(p.requires_grad for p in engine.model.parameters())


# ---- the latent fault: no kernel entry cuts its output off from its inputs --------------

def _entries():
    from ics_tpu_torch.models.resnet import ResNet
    from ics_tpu_torch.models.swin import _relative_position_index, _shift_attn_mask
    from ics_tpu_torch.ops import attention, bottleneck, depthwise, window_attention

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, 8, 16), generator=g)
    w = torch.randn((3, 3, 16), generator=g)
    q, k, v = (torch.randn((2, 2, 16, 16), generator=g) for _ in range(3))
    qkv = torch.randn((2, 8, 8, 3, 2, 16), generator=g)
    table = torch.randn((49, 2), generator=g)
    index = torch.from_numpy(_relative_position_index(4)).to(torch.int16)
    mask = torch.from_numpy(_shift_attn_mask(8, 4, 2))
    model = ResNet((2, 2, 1, 1), 4).init_weights(torch.Generator().manual_seed(1))
    packed = next(iter(model.fold(fused_chains=True).chains.values()))
    x_chain = torch.randn((1, 8, 8, packed.packed()["w1"].shape[1]), generator=g)
    return {
        "depthwise_conv": (lambda t: depthwise.depthwise_conv(t, w), x),
        "window_attention": (lambda t: window_attention.window_attention(
            t, k, v, torch.zeros((2, 16, 16))), q),
        "window_attention_qkv": (lambda t: window_attention.window_attention_qkv(
            t, table, index, mask, 4, 2, 0.25), qkv),
        "flash_attention": (lambda t: attention.flash_attention(t, k, v), q),
        "flash_attention_qkv": (lambda t: attention.flash_attention_qkv(
            t.permute(0, 2, 1, 3).unsqueeze(2).expand(-1, -1, 3, -1, -1)), q),
        "bottleneck_chain": (lambda t: bottleneck.bottleneck_chain(t, packed), x_chain),
    }


@pytest.mark.parametrize("name", ["depthwise_conv", "window_attention", "window_attention_qkv",
                                  "flash_attention", "flash_attention_qkv",
                                  "bottleneck_chain"])
def test_under_grad_every_kernel_entry_has_a_grad_fn_or_raises(name):
    fn, x = _entries()[name]
    x = x.clone().requires_grad_()
    try:
        out = fn(x)
    except KernelHasNoGradient:
        assert name in ("flash_attention", "flash_attention_qkv", "bottleneck_chain")
        return
    assert out.grad_fn is not None
    (g,) = torch.autograd.grad(out.sum(), x)
    assert g.shape == x.shape and bool(torch.isfinite(g).all()) and g.abs().sum() > 0
    with torch.no_grad():                                # grad off: every entry serves
        assert fn(x).grad_fn is None


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_qkv", "bottleneck_chain"])
def test_entries_with_no_backward_serve_with_grad_off(name):
    fn, x = _entries()[name]
    with torch.no_grad():
        assert fn(x.clone().requires_grad_()).shape[0] == x.shape[0]
    assert fn(x).grad_fn is None                         # no input requires grad
