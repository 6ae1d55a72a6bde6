"""ConvNeXt of the port against the JAX package's, weights bridged by
``weights.py`` with ``load_state_dict(strict=True)``.

A narrow ConvNeXt (one block a stage, dims 16-128) at 64 px. The JAX model is
initialised from a PRNG key; the layer scales (1e-6 at initialisation, which
would hide the blocks) and the biases are then drawn from a numpy seed.
Parameters cross as numpy arrays and both forwards see the same seeded NHWC
input. On the CPU the port's depthwise convolution is ``F.conv2d``, which is
what the JAX model computes.

- fp32: ``forward`` and ``fold`` + ``apply_folded`` against the JAX ``apply``
  and ``apply_folded``: atol 2e-4, rtol 1e-4 on logits divided by their largest
  magnitude (the repo's torch-gold bar).
- bf16: the top-1 class agrees with the fp32 reference on every image, and the
  port's largest logit deviation from it is at most twice the JAX model's own
  bf16-vs-fp32 gap on the same input (the two round at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.models import convnext as jax_convnext
from ics_tpu_torch import weights
from ics_tpu_torch.models import convnext as torch_convnext

DEPTHS, DIMS = (1, 1, 2, 1), (16, 32, 64, 128)


def _randomise(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _randomise(v, rng, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomise(v, rng, path + (i,)) for i, v in enumerate(tree)]
    if path[-1] == "gamma":
        return rng.uniform(0.5, 1.5, tree.shape).astype(np.float32)
    if path[-1] in ("b", "beta"):
        return rng.normal(0, 0.1, tree.shape).astype(np.float32)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_convnext.ConvNeXt(DEPTHS, DIMS, num_classes=10)
    variables = _randomise(
        jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
        np.random.default_rng(5))
    tmodel = torch_convnext.ConvNeXt(DEPTHS, DIMS, num_classes=10)
    tmodel.load_state_dict(weights.from_jax_variables(variables), strict=True)
    x = np.random.default_rng(1).standard_normal((4, 64, 64, 3)).astype(np.float32)
    return jmodel, variables, tmodel.eval(), x


def _close(out, ref):
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=2e-4, rtol=1e-4)


def test_layer_scale_gamma_keeps_its_name_and_norm_gammas_become_weights(pair):
    """``_LEAF_NAMES`` maps a normalisation's ``gamma`` to ``weight``; the
    block's own ``gamma`` (the layer scale) has no ``beta`` beside it and must
    stay ``gamma``."""
    _, variables, tmodel, _ = pair
    sd = weights.from_jax_variables(variables)
    assert set(sd) == set(tmodel.state_dict())
    block = variables["params"]["stages"][2][1]
    np.testing.assert_array_equal(sd["stages.2.1.gamma"].numpy(), block["gamma"])
    np.testing.assert_array_equal(sd["stages.2.1.ln.weight"].numpy(), block["ln"]["gamma"])
    assert "stages.2.1.weight" not in sd and "stages.2.1.ln.gamma" not in sd
    # depthwise HWIO [7,7,1,C] -> OIHW [C,1,7,7]
    np.testing.assert_array_equal(
        sd["stages.2.1.dwconv.weight"].numpy(), block["dwconv"]["w"].transpose(3, 2, 0, 1))
    assert tuple(sd["stages.2.1.dwconv.weight"].shape) == (64, 1, 7, 7)
    np.testing.assert_array_equal(
        sd["down.1.conv.bias"].numpy(), variables["params"]["down"][1]["conv"]["b"])


def test_forward_and_folded_match_jax_fp32(pair):
    jmodel, variables, tmodel, x = pair
    ref, _ = jmodel.apply(variables, jnp.asarray(x), training=False)
    ref_folded = jmodel.apply_folded(jmodel.fold(variables), jnp.asarray(x))
    with torch.inference_mode():
        out = tmodel(torch.from_numpy(x)).numpy()
        out_folded = tmodel.fold().apply_folded(torch.from_numpy(x)).numpy()
    assert out.shape == (4, 10)
    _close(out, np.asarray(ref))
    _close(out_folded, np.asarray(ref_folded))


def test_bf16_top1_and_deviation_against_jax(pair):
    jmodel, variables, tmodel, x = pair
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


def test_every_block_has_one_depthwise_conv_for_the_kernel():
    model = torch_convnext.convnext_tiny(num_classes=4, device="meta")
    dw = [m for m in model.modules() if getattr(m, "depthwise", False)]
    assert len(dw) == 18 == sum(model.depths)
    assert all(m.bias is not None and m.weight.shape[-1] == 7 for m in dw)
    assert not model.stem.depthwise and not model.down[0].conv.depthwise


@pytest.mark.parametrize("name", ["convnext_tiny", "convnext_small"])
def test_zoo_constructors_map_the_jax_trees_shape_for_shape(name):
    jmodel = getattr(jax_convnext, name)(num_classes=7)
    shapes = weights.mapped_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    sd = getattr(torch_convnext, name)(num_classes=7, device="meta").state_dict()
    assert set(sd) == set(shapes)
    assert all(tuple(sd[k].shape) == shapes[k] for k in sd)


def test_init_weights_draws_the_jax_initialisers_distributions():
    model = torch_convnext.ConvNeXt(DEPTHS, DIMS, num_classes=16).init_weights(
        torch.Generator().manual_seed(0))
    block = model.stages[3][0]
    assert bool((block.gamma == 1e-6).all())
    assert abs(block.dwconv.weight.std().item() - (2.0 / 49) ** 0.5) < 2e-2
    assert bool((block.dwconv.bias == 0).all() and (block.ln.weight == 1).all())
    assert abs(model.head.weight.std().item() - 0.02 * 0.88) < 2e-3   # normal cut at 2 sigma
