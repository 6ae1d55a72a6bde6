"""EfficientNet of the port against the JAX package's, weights bridged by
``weights.py`` with ``load_state_dict(strict=True)``.

Two small models at 64 px: a V1 stack at width multiple 0.25 (every
``MBConv`` row of the B0 table, one repeat each) and a V2 stack with one
``FusedMBConv`` stage without expansion, one with, and two ``MBConv``
stages. The JAX models are initialised from a PRNG key; BatchNorm parameters
and running statistics are then drawn from a numpy seed. On the CPU the
port's depthwise convolutions are ``F.conv2d``, as in the JAX model.

- fp32: ``forward`` (eval) and ``fold`` + ``apply_folded`` against the JAX
  model: atol 2e-4, rtol 1e-4 on logits divided by their largest magnitude.
- bf16: the top-1 class agrees with the fp32 reference on every image, and the
  port's largest logit deviation from it is at most twice the JAX model's own
  bf16-vs-fp32 gap on the same input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.models import efficientnet as jax_effnet
from ics_tpu_torch import weights
from ics_tpu_torch.models import efficientnet as torch_effnet

V2_SMALL_SPEC = [
    ("fused", 1, 8, 3, 1, 1),
    ("fused", 4, 16, 3, 2, 2),
    ("mb", 4, 24, 3, 2, 2),
    ("mb", 6, 32, 3, 1, 1),
]


def _randomise_batchnorm(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _randomise_batchnorm(v, rng, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomise_batchnorm(v, rng, path + (i,)) for i, v in enumerate(tree)]
    draw = {
        "gamma": lambda s: rng.uniform(0.5, 1.5, s),
        "beta": lambda s: rng.normal(0, 0.1, s),
        "mean": lambda s: rng.normal(0, 0.1, s),
        "var": lambda s: rng.uniform(0.5, 1.5, s),
        "b": lambda s: rng.normal(0, 0.1, s),
    }.get(path[-1])
    return np.asarray(tree) if draw is None else draw(tree.shape).astype(np.float32)


def _build(kind):
    if kind == "v1_w025":
        return (jax_effnet.EfficientNet(0.25, 0.5, num_classes=10),
                torch_effnet.efficientnet_v1(0.25, 0.5, num_classes=10))
    return (jax_effnet.EfficientNetV2(spec=V2_SMALL_SPEC, stem_ch=8, head_ch=64, num_classes=10),
            torch_effnet.efficientnet_v2(spec=V2_SMALL_SPEC, stem_ch=8, head_ch=64,
                                         num_classes=10))


@pytest.fixture(scope="module", params=["v1_w025", "v2_fused"])
def pair(request):
    jmodel, tmodel = _build(request.param)
    variables = _randomise_batchnorm(
        jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
        np.random.default_rng(5))
    tmodel.load_state_dict(weights.from_jax_variables(variables), strict=True)
    x = np.random.default_rng(1).standard_normal((4, 64, 64, 3)).astype(np.float32)
    return request.param, jmodel, variables, tmodel.eval(), x


def _close(out, ref):
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=2e-4, rtol=1e-4)


def test_blocks_follow_the_jax_model(pair):
    kind, jmodel, variables, tmodel, _ = pair
    sd = tmodel.state_dict()
    shapes = weights.mapped_shapes(variables)
    assert set(shapes) == set(sd)
    assert all(tuple(sd[k].shape) == shapes[k] for k in sd)
    assert len(tmodel.blocks) == len(jmodel.blocks)
    for tblk, jblk in zip(tmodel.blocks, jmodel.blocks):
        assert type(tblk).__name__ == type(jblk).__name__
        assert tblk.use_residual == jblk.use_residual
        assert (tblk.exp is None) == (jblk.expand is None)
        assert tblk.proj.bn.eps == jblk.project.bn.eps == (1e-5 if kind == "v1_w025" else 1e-3)
        if isinstance(tblk, torch_effnet.MBConv):
            assert tblk.dw.conv.depthwise == (jblk.depthwise.conv.stride == (1, 1))
            assert tblk.se.fc1.weight.shape[0] == jblk.se.fc1.out_dim
    assert tmodel.stem.bn.eps == jmodel.stem.bn.eps


def test_forward_and_folded_match_jax_fp32(pair):
    _, jmodel, variables, tmodel, x = pair
    ref, _ = jmodel.apply(variables, jnp.asarray(x), training=False)
    ref_folded = jmodel.apply_folded(jmodel.fold(variables), jnp.asarray(x))
    with torch.inference_mode():
        out = tmodel(torch.from_numpy(x)).numpy()
        out_folded = tmodel.fold().apply_folded(torch.from_numpy(x)).numpy()
    assert out.shape == (4, 10)
    _close(out, np.asarray(ref))
    _close(out_folded, np.asarray(ref_folded))
    _close(out_folded, out)


def test_folded_bf16_top1_and_deviation_against_jax(pair):
    _, jmodel, variables, tmodel, x = pair
    ref = np.asarray(jmodel.apply_folded(jmodel.fold(variables), jnp.asarray(x)))
    jfolded = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), jmodel.fold(variables))
    jax_bf16 = np.asarray(jmodel.apply_folded(
        jfolded, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.inference_mode():
        out = tmodel.fold().to(torch.bfloat16).apply_folded(
            torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
        tmodel.to(torch.float32)
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
    jax_gap = np.abs(jax_bf16 - ref).max()
    assert np.abs(out - ref).max() <= 2 * jax_gap, (np.abs(out - ref).max(), jax_gap)


@pytest.mark.parametrize("name", [
    "efficientnet_b0", "efficientnet_b4", "efficientnet_v2_s", "efficientnet_v2_m"])
def test_zoo_constructors_map_the_jax_trees_shape_for_shape(name):
    jmodel = getattr(jax_effnet, name)(num_classes=7)
    shapes = weights.mapped_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    tmodel = getattr(torch_effnet, name)(num_classes=7, device="meta")
    sd = tmodel.state_dict()
    assert set(sd) == set(shapes)
    assert all(tuple(sd[k].shape) == shapes[k] for k in sd)
    stride1 = sum(isinstance(b, jax_effnet.MBConv) and b.depthwise.conv.stride == (1, 1)
                  for b in jmodel.blocks)
    assert sum(getattr(m, "depthwise", False) for m in tmodel.modules()) == stride1


def test_b4_widths_and_rounding_rules():
    model = torch_effnet.efficientnet_b4(num_classes=4, device="meta")
    assert len(model.blocks) == 32
    assert max(b.dw.conv.weight.shape[0] for b in model.blocks) == 2688   # 1.4 x 320 x 6
    assert model.conv_head.conv.weight.shape[0] == 1792
    for args in ((32, 1.4), (16, 1.4), (320, 1.4), (24, 0.25), (1280, 1.0)):
        assert torch_effnet.round_filters(*args) == jax_effnet.round_filters(*args)
    assert torch_effnet.round_repeats(3, 1.8) == jax_effnet.round_repeats(3, 1.8) == 6
