"""MobileNetV3-Small of the port against the JAX package's, weights bridged by
``weights.py`` with ``load_state_dict(strict=True)``.

The full model (it is small) at 64 px. The JAX model is initialised from a
PRNG key; BatchNorm parameters and running statistics are then drawn from a
numpy seed so that folding has something to fold. On the CPU the port's
depthwise convolutions are ``F.conv2d``, which is what the JAX model computes.

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

from ics_tpu.models import mobilenetv3 as jax_mbv3
from ics_tpu_torch import weights
from ics_tpu_torch.models import mobilenetv3 as torch_mbv3


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


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_mbv3.mobilenetv3_small(num_classes=10)
    variables = _randomise_batchnorm(
        jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
        np.random.default_rng(5))
    tmodel = torch_mbv3.mobilenetv3_small(num_classes=10)
    tmodel.load_state_dict(weights.from_jax_variables(variables), strict=True)
    x = np.random.default_rng(1).standard_normal((4, 64, 64, 3)).astype(np.float32)
    return jmodel, variables, tmodel.eval(), x


def _close(out, ref):
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=2e-4, rtol=1e-4)


def test_state_dict_carries_params_and_running_statistics(pair):
    _, variables, tmodel, _ = pair
    sd = tmodel.state_dict()
    shapes = weights.mapped_shapes(variables)
    assert set(shapes) == set(sd)
    assert all(tuple(sd[k].shape) == shapes[k] for k in sd)
    blk = variables["params"]["blocks"][4]
    np.testing.assert_array_equal(
        sd["blocks.4.dw.conv.weight"].numpy(), blk["dw"]["conv"]["w"].transpose(3, 2, 0, 1))
    assert tuple(sd["blocks.4.dw.conv.weight"].shape) == (240, 1, 5, 5)
    np.testing.assert_array_equal(sd["blocks.4.se.fc1.bias"].numpy(), blk["se"]["fc1"]["b"])
    np.testing.assert_array_equal(
        sd["blocks.4.dw.bn.running_var"].numpy(),
        variables["state"]["blocks"][4]["dw"]["bn"]["var"])
    assert "blocks.0.exp.conv.weight" not in sd        # exp == in_ch: no expansion


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
    _close(out_folded, out)


def test_folded_bf16_top1_and_deviation_against_jax(pair):
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


def test_the_stride_1_blocks_and_no_other_carry_a_depthwise_conv_for_the_kernel():
    model = torch_mbv3.mobilenetv3_small(num_classes=4, device="meta")
    flags = [blk.dw.conv.depthwise for blk in model.blocks]
    assert flags == [stride == 1 for *_, stride in torch_mbv3.SMALL_SPEC]
    assert sum(flags) == 7 and len(flags) == 11
    assert sum(getattr(m, "depthwise", False) for m in model.modules()) == 7
    # symmetric k // 2 padding at every stride, eps 1e-3, squeeze width a multiple of 8
    assert all(blk.dw.conv.padding == blk.dw.conv.weight.shape[-1] // 2 for blk in model.blocks)
    assert all(blk.dw.bn.eps == 1e-3 for blk in model.blocks)
    assert model.blocks[4].se.fc1.weight.shape[0] == 64
    assert torch_mbv3.SMALL_SPEC == jax_mbv3.SMALL_SPEC
    assert [torch_mbv3._divisible(v) for v in (4, 60, 36, 144)] == \
        [jax_mbv3._divisible(v) for v in (4, 60, 36, 144)]


def test_init_weights_fills_every_parameter_and_statistic():
    model = torch_mbv3.mobilenetv3_small(num_classes=16).init_weights(
        torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(t).all()) for t in model.state_dict().values())
    w = model.blocks[9].dw.conv.weight
    assert abs(w.std().item() - (2.0 / 25) ** 0.5) < 1e-2
    bn = model.stem.bn
    assert bool((bn.weight == 1).all() and (bn.running_var == 1).all())
